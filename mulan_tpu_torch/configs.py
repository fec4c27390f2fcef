"""Experiment configurations for the PyTorch port (standard library only).

Counterparts of the `ml_collections` files `mulan_tpu/configs/
cifar10_conditioned.py` and `tiny_synthetic.py`, which cannot be imported
where only PyTorch is installed. Field names and values are the JAX
package's; `tests/test_torch_train.py` holds them against those files field
by field. `lr_gamma_network_scale` and `optimizer.gradient_clip_norm` are
read with `config.get` defaults in JAX (1.0 and None) and are fields here.

Only fields the port reads are kept. JAX's `training.substeps` (its
super-step; `Experiment.train_step` is one step), `steps_per_eval`,
`steps_per_save` and `profile` (the JAX loop's schedule of evaluations,
checkpoints and traces) and `data.data_dir` and `ignore_cache` (the TFDS
source) have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from mulan_tpu_torch.models.config import (ModelConfig, flagship_config,
                                           tiny_config)


@dataclasses.dataclass(frozen=True)
class DataConfig:
  dataset: str = 'cifar10'
  synthetic_seed: int = 0
  synthetic_examples: int = 4096


@dataclasses.dataclass(frozen=True)
class TrainingConfig:
  seed: int = 1
  num_steps_lr_warmup: int = 100
  num_steps_train: int = 10_000_000
  num_steps_eval: int = 100
  batch_size_train: int = 128
  batch_size_eval: int = 128
  steps_per_logging: int = 1000
  fsdp: int = 1
  tp: int = 1


@dataclasses.dataclass(frozen=True)
class AdamWArgs:
  b1: float = 0.9
  b2: float = 0.99
  eps: float = 1e-8
  weight_decay: float = 0.01


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
  name: str = 'adamw'
  args: AdamWArgs = AdamWArgs()
  learning_rate: float = 2e-4
  lr_decay: bool = False
  ema_rate: float = 0.9999
  gradient_clip_norm: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class Config:
  model: ModelConfig
  data: DataConfig = DataConfig()
  training: TrainingConfig = TrainingConfig()
  optimizer: OptimizerConfig = OptimizerConfig()
  vdm_type: str = 'mulan_velocity'
  ckpt_restore_dir: str = 'None'
  lr_gamma_network_scale: float = 1.0


def cifar10_conditioned() -> Config:
  """The flagship: MuLAN-velocity on CIFAR-10 at batch 128."""
  return Config(model=flagship_config())


def tiny_synthetic() -> Config:
  """`mulan_tpu/configs/tiny_synthetic.py`: 8x8 synthetic images, 16
  channels, 2 layers, float32, 4 steps of batch 8."""
  return Config(
      model=tiny_config(sm_n_embd=16),
      data=DataConfig(dataset='synthetic', synthetic_examples=256),
      training=TrainingConfig(
          num_steps_train=4, num_steps_eval=2, batch_size_train=8,
          batch_size_eval=8, steps_per_logging=2))


def replace(config: Config, **sections) -> Config:
  """`config` with fields of its sections replaced, e.g.
  `replace(cfg, training={'seed': 3}, model={'sm_pdrop': 0.0})`; a
  non-dict value replaces a top-level field."""
  updates = {}
  for name, value in sections.items():
    if isinstance(value, dict):
      updates[name] = dataclasses.replace(getattr(config, name), **value)
    else:
      updates[name] = value
  return dataclasses.replace(config, **updates)
