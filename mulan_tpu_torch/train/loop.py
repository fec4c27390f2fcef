"""Experiment: train and evaluate MuLAN-velocity on one device, counterpart
of `mulan_tpu/train/loop.py:Experiment` (its loss, train step, eval step,
training loop and sampler).

One call of `train_step` is one optimizer step: the ELBO in bits per
dimension with dropout on, its gradient, the two-group AdamW update and the
EMA update. JAX's super-step (`substeps` steps under one `lax.scan`) has no
counterpart: PyTorch runs eagerly, so the data iterator's substeps axis is 1.
Evaluation and sampling run on the EMA parameters and are deterministic.
Checkpoints and device meshes are not ported (ROADMAP.md Queue A,
checkpoint reader and parallelism).

Randomness: the diffusion noise is drawn from a `torch.Generator` on the
device, seeded by `training.seed`; the per-step dropout seeds come from a
CPU generator with the same seed, so that drawing them never waits for the
device. Neither reproduces `jax.random`'s streams; tests hand both packages
the same noise instead.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from mulan_tpu_torch import data as data_lib
from mulan_tpu_torch import params as params_lib
from mulan_tpu_torch.configs import Config
from mulan_tpu_torch.models import build_model, resolve_device
from mulan_tpu_torch.train.optimizer import make_lr_schedule, make_optimizer
from mulan_tpu_torch.train.state import TrainState
from mulan_tpu_torch.utils.metrics import ScalarWriter, image_grid


def _not_ported(what: str, entry: str):
  return NotImplementedError(f'{what} is not ported yet; see ROADMAP.md '
                             f'Queue A, {entry}')


class Experiment:
  """Train and evaluate a MuLAN-velocity model on `device` (the card unless
  the caller asks for the CPU). `state` replaces the seeded initial
  parameters (a state_dict, e.g. from `params.from_flax`)."""

  def __init__(self, config: Config, *, device='cuda', state=None):
    self.config = config
    self.device = resolve_device(device)
    cfg = config.model
    training = config.training
    if config.vdm_type != 'mulan_velocity':
      raise _not_ported(f'vdm_type={config.vdm_type!r}', 'model variants')
    if training.fsdp != 1 or training.tp != 1:
      raise _not_ported('fsdp / tp meshes', 'parallelism')
    if config.ckpt_restore_dir not in (None, 'None', ''):
      raise _not_ported('restoring a checkpoint', 'checkpoint reader')

    seed = training.seed
    if state is None:
      state = params_lib.init_params(cfg, torch.Generator().manual_seed(seed))
    self.model = build_model(cfg, device=self.device, state=state).train()
    self.lr_schedule = make_lr_schedule(
        config.optimizer.learning_rate, training.num_steps_lr_warmup,
        training.num_steps_train, config.optimizer.lr_decay)
    optimizer = make_optimizer(self.model.named_parameters(),
                               config.optimizer, self.lr_schedule,
                               config.lr_gamma_network_scale)
    self.state = TrainState.create(self.model, optimizer)

    splits = {split: data_lib.source(
        config.data.dataset, split, cfg.image_shape,
        seed=config.data.synthetic_seed,
        examples=config.data.synthetic_examples)
              for split in ('train', 'eval')}
    self.train_iter = data_lib.train_iterator(
        *splits['train'], batch_size=training.batch_size_train, substeps=1,
        seed=seed)
    self.eval_iter = data_lib.eval_iterator(
        *splits['eval'], batch_size=training.batch_size_eval,
        seed=seed + 7919)

    self.generator = torch.Generator(self.device).manual_seed(seed)
    self._dropout_seeds = torch.Generator().manual_seed(seed)
    self.writer = ScalarWriter()

  # -- loss and steps -----------------------------------------------------------

  def _dropout_seed(self) -> int:
    return int(torch.randint(2 ** 31 - 1, (),
                             generator=self._dropout_seeds))

  def loss_fn(self, model, batch, *, train: bool, noise=None):
    """(bpd, scalars): the mean ELBO in bits per dimension and its six
    terms (`loop.py:116-141`). `noise` may hold explicit `t`, `eps0`, `eps`,
    `topk_noise` and `dropout_seed` for `MuLAN.elbo`; without it they are
    drawn from the experiment's generators."""
    images = torch.as_tensor(batch['images'], device=self.device)
    if noise is None:
      out = model(images, generator=self.generator, deterministic=not train,
                  dropout_seed=self._dropout_seed() if train else None)
    else:
      noise = dict(noise)
      seed = noise.pop('dropout_seed', None)
      if train and seed is None:
        seed = self._dropout_seed()
      out = model.elbo(images, noise.pop('t'), generator=self.generator,
                       deterministic=not train, dropout_seed=seed, **noise)
    rescale = 1.0 / (self.config.model.n_pixels * math.log(2.0))
    bpd_latent = out.loss_klz.mean() * rescale
    bpd_recon = out.loss_recon.mean() * rescale
    bpd_diff = out.loss_diff.mean() * rescale
    bpd = bpd_recon + bpd_latent + bpd_diff
    scalars = {'bpd': bpd, 'bpd_latent': bpd_latent, 'bpd_recon': bpd_recon,
               'bpd_diff': bpd_diff, 'var0': out.var_0, 'var': out.var_1}
    return bpd, scalars

  def train_step(self, batch, noise=None) -> Dict[str, torch.Tensor]:
    """One optimizer step on one batch (images (B, H, W, C) uint8); the
    scalars stay on the device."""
    bpd, scalars = self.loss_fn(self.model, batch, train=True, noise=noise)
    self.state.optimizer.zero_grad()
    bpd.backward()
    self.state.apply_gradients(self.config.optimizer.ema_rate)
    return {k: v.detach() for k, v in scalars.items()}

  @torch.no_grad()
  def eval_step(self, batch, noise=None) -> Dict[str, torch.Tensor]:
    """The scalars of the EMA model on one batch, deterministic."""
    return self.loss_fn(self.state.ema_model, batch, train=False,
                        noise=noise)[1]

  # -- loops ----------------------------------------------------------------------

  def train(self, num_steps: int) -> List[Dict[str, float]]:
    """`num_steps` train steps on the training iterator. Logs the scalars
    every `training.steps_per_logging` steps and after the last one, and
    returns every step's scalars (read from the device at the end)."""
    every = self.config.training.steps_per_logging
    history = []
    last_t, last_step = time.perf_counter(), self.state.step
    for i in range(num_steps):
      batch = {k: v[0] for k, v in next(self.train_iter).items()}
      history.append(self.train_step(batch))
      step = self.state.step
      if step % every == 0 or i == num_steps - 1:
        scalars = {'train_' + k: float(v) for k, v in history[-1].items()}
        now = time.perf_counter()
        scalars['steps_per_sec'] = (step - last_step) / (now - last_t)
        last_t, last_step = now, step
        self.writer.write_scalars(step, scalars)
    return [{k: float(v) for k, v in s.items()} for s in history]

  def evaluate(self, num_steps: Optional[int] = None) -> Dict[str, float]:
    """Mean EMA scalars over `num_steps` eval batches (default
    `training.num_steps_eval`), read from the device once at the end."""
    if num_steps is None:
      num_steps = self.config.training.num_steps_eval
    all_scalars = [self.eval_step(next(self.eval_iter))
                   for _ in range(num_steps)]
    means = {'eval_' + k: float(torch.stack([s[k] for s in all_scalars])
                                .mean()) for k in all_scalars[0]}
    self.writer.write_scalars(self.state.step, means)
    return means

  @torch.inference_mode()
  def draw_samples(self, batch_size: Optional[int] = None,
                   T: int = 1000) -> np.ndarray:
    """An image grid of T unconditional ancestral steps of the EMA model
    (`mulan_tpu/train/loop.py:201-216`): from `sigma_prior` times a
    standard normal, through `MuLAN.sample`, then the argmax decode."""
    if batch_size is None:
      batch_size = min(64, self.config.training.batch_size_eval)
    model = self.state.ema_model
    cfg = model.config
    z = cfg.sigma_prior * model._randn((batch_size, *cfg.image_shape),
                                       self.generator)
    for i in range(T):
      z = model.sample(i, T, z, generator=self.generator)
    images = model.generate_x(z).to(torch.uint8).cpu().numpy()
    grid = image_grid(images)
    self.writer.write_images(self.state.step, {'samples': grid[None]})
    return grid
