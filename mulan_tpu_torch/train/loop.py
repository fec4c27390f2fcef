"""Experiment: train and evaluate the model of `config.vdm_type` (the
baseline VDM or MuLAN-velocity) on one device, counterpart of
`mulan_tpu/train/loop.py:Experiment` (its loss, train step, eval step,
training loop with checkpoints, standalone evaluation and sampler).

One call of `train_step` is one optimizer step: the ELBO in bits per
dimension with dropout on, its gradient, the two-group AdamW update and the
EMA update. JAX's super-step (`substeps` steps under one `lax.scan`) has no
counterpart: PyTorch runs eagerly, so the data iterator's substeps axis is 1
and `train_and_evaluate`'s "first super-step" is step 1. Evaluation and
sampling run on the EMA parameters and are deterministic. Device meshes are
not ported (ROADMAP.md Queue A, parallelism).

Randomness is keyed as JAX's is: the noise of train step s (the diffusion
noise and the dropout seed) is a function of (`training.seed`, s) alone,
that of eval batch i of every evaluation of (seed, i), and the in-training
sampler always starts from the same key. Before each, the experiment's
device generator is reseeded from `step_key` (host work, no launch). So a
run resumed from a checkpoint draws what the uninterrupted run drew. The
streams are not `jax.random`'s; tests hand both packages the same noise.
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from mulan_tpu_torch import data as data_lib
from mulan_tpu_torch import params as params_lib
from mulan_tpu_torch.configs import Config
from mulan_tpu_torch.models import build_model, resolve_device
from mulan_tpu_torch.train import checkpoint as ckpt_lib
from mulan_tpu_torch.train.optimizer import make_lr_schedule, make_optimizer
from mulan_tpu_torch.train.state import TrainState
from mulan_tpu_torch.utils.metrics import ScalarWriter, image_grid, write_png

# The streams of `step_key`: train steps, eval batches, the sampler, the
# ODE likelihood's solves (`evals/nll_ode.py`).
TRAIN, EVAL, SAMPLE, ODE = 0, 1, 2, 3


def step_key(seed: int, stream: int, *index: int) -> int:
  """A 63-bit generator seed that depends on (seed, stream, *index) alone,
  the counterpart of `jax.random.fold_in` (numpy's SeedSequence hash)."""
  words = np.random.SeedSequence((seed, stream, *index)).generate_state(
      2, np.uint32)
  return (int(words[0]) << 31) ^ int(words[1])


def create_train_state(config: Config, device, state=None):
  """(the model in training mode, its TrainState with a fresh two-group
  AdamW) on `device`; `state` replaces the parameters seeded by
  `training.seed` (a state_dict, e.g. from `params.from_flax`)."""
  training = config.training
  if state is None:
    state = params_lib.init_params(
        config.model, torch.Generator().manual_seed(training.seed),
        vdm_type=config.vdm_type)
  model = build_model(config.vdm_type, config.model, device=device,
                      state=state).train()
  lr_schedule = make_lr_schedule(
      config.optimizer.learning_rate, training.num_steps_lr_warmup,
      training.num_steps_train, config.optimizer.lr_decay)
  optimizer = make_optimizer(model.named_parameters(), config.optimizer,
                             lr_schedule, config.lr_gamma_network_scale)
  return model, TrainState.create(model, optimizer)


def mean_scalars(all_scalars: List[Dict[str, torch.Tensor]]
                 ) -> Dict[str, float]:
  """{'eval_' + name: mean over the batches}, read from the device once."""
  if not all_scalars:
    raise ValueError('no eval batches')
  means = torch.stack([torch.stack([s[k] for s in all_scalars]).mean()
                       for k in all_scalars[0]]).tolist()
  return {'eval_' + k: v for k, v in zip(all_scalars[0], means)}


def _not_ported(what: str, entry: str):
  return NotImplementedError(f'{what} is not ported yet; see ROADMAP.md '
                             f'Queue A, {entry}')


class Experiment:
  """Train and evaluate the model of `config.vdm_type` on `device` (the
  card unless the caller asks for the CPU). `state` replaces the seeded
  initial parameters (a state_dict, e.g. from `params.from_flax`)."""

  def __init__(self, config: Config, *, device='cuda', state=None):
    self.config = config
    self.device = resolve_device(device)
    training = config.training
    if training.fsdp != 1 or training.tp != 1:
      raise _not_ported('fsdp / tp meshes', 'parallelism')

    seed = training.seed
    self.model, self.state = create_train_state(config, self.device, state)
    if config.ckpt_restore_dir not in (None, 'None', ''):
      ckpt_lib.restore_partial_into(self.state, config.ckpt_restore_dir)

    splits = {split: data_lib.config_source(config, split)
              for split in ('train', 'eval')}
    self.train_iter = data_lib.train_iterator(
        *splits['train'], batch_size=training.batch_size_train, substeps=1,
        seed=seed)
    self.eval_iter = data_lib.eval_iterator(
        *splits['eval'], batch_size=training.batch_size_eval,
        seed=seed + 7919)

    self.generator = torch.Generator(self.device)
    self.writer = ScalarWriter()

  # -- loss and steps -----------------------------------------------------------

  def reseed(self, stream: int, index: int) -> int:
    """Reseeds the device generator from (training.seed, stream, index) and
    returns the dropout seed of the same key."""
    key = step_key(self.config.training.seed, stream, index)
    self.generator.manual_seed(key)
    return key % (2 ** 31 - 1)

  def loss_fn(self, model, batch, *, train: bool, noise=None,
              dropout_seed: Optional[int] = None):
    """(bpd, scalars): the mean ELBO in bits per dimension and its six
    terms (`loop.py:116-141`). `noise` may hold explicit `t`, `eps0`, `eps`,
    `topk_noise` (MuLAN) and `dropout_seed` for the model's `elbo`; what it
    does not hold is drawn from the experiment's generator."""
    images = torch.as_tensor(batch['images'], device=self.device)
    noise = dict(noise or {})
    dropout_seed = noise.pop('dropout_seed', dropout_seed)
    kwargs = dict(generator=self.generator, deterministic=not train,
                  dropout_seed=dropout_seed if train else None)
    if 't' in noise:
      out = model.elbo(images, noise.pop('t'), **kwargs, **noise)
    else:
      out = model(images, **kwargs)
    rescale = 1.0 / (self.config.model.n_pixels * math.log(2.0))
    bpd_latent = out.loss_klz.mean() * rescale
    bpd_recon = out.loss_recon.mean() * rescale
    bpd_diff = out.loss_diff.mean() * rescale
    bpd = bpd_recon + bpd_latent + bpd_diff
    scalars = {'bpd': bpd, 'bpd_latent': bpd_latent, 'bpd_recon': bpd_recon,
               'bpd_diff': bpd_diff, 'var0': out.var_0, 'var': out.var_1}
    return bpd, scalars

  def train_step(self, batch, noise=None) -> Dict[str, torch.Tensor]:
    """One optimizer step on one batch (images (B, H, W, C) uint8), its
    noise keyed by the step; the scalars stay on the device."""
    seed = self.reseed(TRAIN, self.state.step)
    bpd, scalars = self.loss_fn(self.model, batch, train=True, noise=noise,
                                dropout_seed=seed)
    self.state.optimizer.zero_grad()
    bpd.backward()
    self.state.apply_gradients(self.config.optimizer.ema_rate)
    return {k: v.detach() for k, v in scalars.items()}

  @torch.no_grad()
  def eval_step(self, batch, index: int = 0,
                noise=None) -> Dict[str, torch.Tensor]:
    """The scalars of the EMA model on one batch, deterministic, the noise
    keyed by the batch's index within its evaluation."""
    self.reseed(EVAL, index)
    return self.loss_fn(self.state.ema_model, batch, train=False,
                        noise=noise)[1]

  # -- loops ----------------------------------------------------------------------

  def _train_batch(self):
    return {k: v[0] for k, v in next(self.train_iter).items()}

  def train(self, num_steps: int) -> List[Dict[str, float]]:
    """`num_steps` train steps on the training iterator. Logs the scalars
    every `training.steps_per_logging` steps and after the last one, and
    returns every step's scalars (read from the device at the end)."""
    every = self.config.training.steps_per_logging
    history = []
    last_t, last_step = time.perf_counter(), self.state.step
    for i in range(num_steps):
      history.append(self.train_step(self._train_batch()))
      step = self.state.step
      if step % every == 0 or i == num_steps - 1:
        last_t, last_step = self._log_train(history[-1], last_t, last_step)
    return [{k: float(v) for k, v in s.items()} for s in history]

  def _log_train(self, scalars, last_t: float, last_step: int):
    step = self.state.step
    scalars = {'train_' + k: float(v) for k, v in scalars.items()}
    now = time.perf_counter()
    scalars['steps_per_sec'] = (step - last_step) / (now - last_t)
    self.writer.write_scalars(step, scalars)
    return now, step

  def train_and_evaluate(self, workdir: str, *,
                         max_to_keep: int = 100) -> None:
    """Trains to `training.num_steps_train` (`loop.py:232-305`): resumes
    from the latest checkpoint in `<workdir>/checkpoints`, logs every
    `steps_per_logging` steps, evaluates and draws samples after step 1,
    every `steps_per_eval` steps and at the last, and saves every
    `steps_per_save` steps and at the last (keeping `max_to_keep`)."""
    training = self.config.training
    ckpt = ckpt_lib.CheckpointManager(os.path.join(workdir, 'checkpoints'),
                                      max_to_keep)
    if ckpt.latest_step() is not None:
      ckpt.restore(self.state)
    step = self.state.step
    last_t, last_step = time.perf_counter(), step
    while step < training.num_steps_train:
      is_last = step + 1 >= training.num_steps_train
      scalars = self.train_step(self._train_batch())
      step = self.state.step
      if step % training.steps_per_logging == 0 or is_last:
        last_t, last_step = self._log_train(scalars, last_t, last_step)
      if step % training.steps_per_eval == 0 or is_last or step == 1:
        self.writer.write_scalars(step, self.run_eval())
        self.draw_samples()
      if step % training.steps_per_save == 0 or is_last:
        ckpt.save(step, self.state)

  def run_eval(self, num_steps: Optional[int] = None) -> Dict[str, float]:
    """Mean EMA scalars over `num_steps` eval batches (default
    `training.num_steps_eval`), batch i keyed by i; read from the device
    once at the end."""
    if num_steps is None:
      num_steps = self.config.training.num_steps_eval
    return mean_scalars([self.eval_step(next(self.eval_iter), i)
                         for i in range(num_steps)])

  def evaluate(self, logdir: str, checkpoint_dir: str) -> Dict[str, float]:
    """Standalone evaluation of a checkpoint's EMA parameters
    (`loop.py:334-352`): the eval scalars and a sample grid, written as
    `<logdir>/eval/samples_<step>.png`."""
    restored = ckpt_lib.CheckpointManager(checkpoint_dir).restore_dict()
    self.state.load_tensors('ema_params', restored['ema_params'])
    step = int(restored['step'])
    scalars = self.run_eval()
    self.writer.write_scalars(step, scalars)
    grid = self.draw_samples()
    os.makedirs(os.path.join(logdir, 'eval'), exist_ok=True)
    write_png(os.path.join(logdir, 'eval', f'samples_{step}.png'), grid)
    return scalars

  @torch.inference_mode()
  def draw_samples(self, batch_size: Optional[int] = None,
                   T: int = 1000) -> np.ndarray:
    """An image grid of T unconditional ancestral steps of the EMA model
    (`mulan_tpu/train/loop.py:201-216`): from `sigma_prior` times a
    standard normal, through the model's `sample`, then the decode. The
    noise starts from the same key every call."""
    if batch_size is None:
      batch_size = min(64, self.config.training.batch_size_eval)
    self.reseed(SAMPLE, 0)
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
