"""Experiment configurations for the PyTorch port (standard library only).

Counterparts of the `ml_collections` files `mulan_tpu/configs/
cifar10_conditioned.py`, `vdm_cifar10.py`, `imagenet32.py` and
`tiny_synthetic.py`, which cannot be imported
where only PyTorch is installed. Field names and values are the JAX
package's; `tests/test_torch_train.py` holds them against those files field
by field. `lr_gamma_network_scale` and `optimizer.gradient_clip_norm` are
read with `config.get` defaults in JAX (1.0 and None) and are fields here.

Only fields the port reads are kept. JAX's `data.data_dir` and
`ignore_cache` (the TFDS source) have no counterpart here.
`training.substeps` is the optimizer steps of one super-step
(`Experiment.train_superstep`). `training.nan_guard` is read with a
`config.get` default (False) in JAX and is a field here, as are
`optimizer.fused` and `optimizer.stacked` (`optimizer.get(name, False)`).
`get_config` finds a config by its name or by the path of a JAX config
file, and `override` applies a `--config.<section>.<field>` string from the
command line.
"""

from __future__ import annotations

import ast
import dataclasses
import os
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
  # Optimizer steps a super-step (one batch of the iterator, one guard
  # read, the unit of logging, evaluation and saving).
  substeps: int = 1000
  num_steps_lr_warmup: int = 100
  num_steps_train: int = 10_000_000
  num_steps_eval: int = 100
  batch_size_train: int = 128
  batch_size_eval: int = 128
  steps_per_logging: int = 1000
  steps_per_eval: int = 10_000
  steps_per_save: int = 10_000
  fsdp: int = 1
  tp: int = 1
  # Trace the run's second super-step with torch.profiler into
  # <workdir>/profile (rank 0).
  profile: bool = False
  # Read every scalar after each super-step and raise FloatingPointError
  # naming the first non-finite one and its substep.
  nan_guard: bool = False


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
  # AdamW's other implementations (`train/optimizer.py`): torch's fused
  # kernel, or its multi-tensor (foreach) path.
  fused: bool = False
  stacked: bool = False


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


def vdm_cifar10() -> Config:
  """The baseline VDM on CIFAR-10 (`mulan_tpu/configs/vdm_cifar10.py`): the
  flagship's score UNet, training and optimizer, with the scalar monotone
  MLP schedule and no latent."""
  base = cifar10_conditioned()
  return dataclasses.replace(
      base, vdm_type='vdm', model=dataclasses.replace(
          base.model, gamma_type='learnable_nnet', z_conditioning=False))


def imagenet32() -> Config:
  """MuLAN-epsilon on ImageNet32 (`mulan_tpu/configs/imagenet32.py`): the
  flagship with a 256-channel score UNet (one attention head, so head_dim
  256), the epsilon parameterization and batch 512. The port cannot read
  the TFDS dataset it names: pass `--config.data.dataset=synthetic` (or
  `npz:<dir>` / `npy:<dir>`)."""
  base = cifar10_conditioned()
  return dataclasses.replace(
      base, vdm_type='mulan_epsilon',
      data=dataclasses.replace(base.data, dataset='imagenet32'),
      model=dataclasses.replace(base.model, sm_n_embd=256, latent_k=15),
      training=dataclasses.replace(
          base.training, num_steps_train=2_000_000, batch_size_train=512,
          batch_size_eval=512),
      lr_gamma_network_scale=1.0)


def tiny_synthetic() -> Config:
  """`mulan_tpu/configs/tiny_synthetic.py`: 8x8 synthetic images, 16
  channels, 2 layers, float32, 4 steps of batch 8 in super-steps of 2."""
  return Config(
      model=tiny_config(sm_n_embd=16),
      data=DataConfig(dataset='synthetic', synthetic_examples=256),
      training=TrainingConfig(
          substeps=2, num_steps_train=4, num_steps_eval=2,
          batch_size_train=8, batch_size_eval=8, steps_per_logging=2,
          steps_per_eval=4, steps_per_save=4))


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


CONFIGS = {'cifar10_conditioned': cifar10_conditioned,
           'vdm_cifar10': vdm_cifar10,
           'imagenet32': imagenet32,
           'tiny_synthetic': tiny_synthetic}


def get_config(name: str) -> Config:
  """A config by name, or by the path of its JAX file (e.g.
  `mulan_tpu/configs/tiny_synthetic.py`), which is mapped by its basename."""
  key = os.path.basename(name).removesuffix('.py')
  if key not in CONFIGS:
    raise ValueError(f'unknown config {name!r}; the port has '
                     f'{sorted(CONFIGS)}')
  return CONFIGS[key]()


def _parse(text: str, current):
  """`text` as a value of the type of `current`."""
  if isinstance(current, bool):
    if text.lower() not in ('true', 'false', '1', '0'):
      raise ValueError(f'not a bool: {text!r}')
    return text.lower() in ('true', '1')
  if isinstance(current, (int, float)) and not isinstance(current, bool):
    value = ast.literal_eval(text)
    if isinstance(current, int) and not isinstance(value, int):
      raise ValueError(f'not an int: {text!r}')
    return type(current)(value)
  if isinstance(current, str):
    return text
  try:  # None or another type: a Python literal, else the string
    return ast.literal_eval(text)
  except (ValueError, SyntaxError):
    return text


def override(config: Config, dotted: str, text: str) -> Config:
  """`config` with the field at `dotted` (e.g. `training.seed`,
  `optimizer.args.b2`, `ckpt_restore_dir`) set from the string `text`."""
  *path, field = dotted.split('.')
  sections = [config]
  for name in path:
    sections.append(getattr(sections[-1], name))
  if not dataclasses.is_dataclass(sections[-1]) or field not in {
      f.name for f in dataclasses.fields(sections[-1])}:
    raise ValueError(f'unknown config field {dotted!r}')
  value = _parse(text, getattr(sections[-1], field))
  for section, name in zip(sections[::-1], [field, *path[::-1]]):
    value = dataclasses.replace(section, **{name: value})
  return value


def from_command_line(name: str, overrides) -> Config:
  """`get_config(name)` with `--config.<section>.<field>=<value>`
  arguments applied in order; any other argument raises."""
  config = get_config(name)
  for arg in overrides:
    if not arg.startswith('--config.') or '=' not in arg:
      raise ValueError(f'unrecognized argument {arg!r}')
    dotted, text = arg[len('--config.'):].split('=', 1)
    config = override(config, dotted, text)
  return config
