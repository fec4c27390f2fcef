"""Experiment: train and evaluate the model of `config.vdm_type` (the
baseline VDM, MuLAN-epsilon or MuLAN-velocity) on one device or across
processes, counterpart of `mulan_tpu/train/loop.py:Experiment` (its loss,
train step, eval step, training loop with checkpoints, standalone
evaluation and sampler).

One call of `train_step` is one optimizer step: the ELBO in bits per
dimension with dropout on, its gradient, the two-group AdamW update and the
EMA update. `train_superstep` is JAX's super-step (`substeps` steps under
one `lax.scan`, `loop.py:149-160`): the iterator's super-batch of
`training.substeps` batches goes to the device in one copy, and
`train_step` runs on each of its batches in turn, the scalars stacked on
the device. `train` and `train_and_evaluate` run whole super-steps, and
log, guard, evaluate, save and profile at super-step boundaries, as JAX's
loop does. Evaluation and sampling run on the EMA parameters and are
deterministic.

Under `torch.distributed` the experiment runs on a mesh, as JAX's runs on
its device mesh (`parallel/mesh.py`): ('data',) with DDP, or ('data',
'fsdp') with FSDP2 (`training.fsdp` ranks a group), either with a 'tensor'
axis of `training.tp` ranks (`parallel/tensor.py`: each rank of a tensor
group holds its channels of the score UNet and the group shares its
rows). Each rank takes its shard of the data in batches of the global
batch size over the batch axes, and computes exactly its rows of what one
process computes on the global batch (the batch coordinates' batches
concatenated in order): the noise and the dropout masks are the global
batch's, cut to its rows (`parallel.mesh.Rows`) and, in the score UNet,
to its channels; gradients are averaged over the batch axes, the logged
scalars are the global means and the samples are gathered.

Randomness is keyed as JAX's is: the noise of train step s (the diffusion
noise and the dropout seed) is a function of (`training.seed`, s) alone,
that of eval batch i of every evaluation of (seed, i), and the in-training
sampler always starts from the same key. Before each, the experiment's
device generator is reseeded from `step_key` (host work, no launch). So a
run resumed from a checkpoint draws what the uninterrupted run drew. The
streams are not `jax.random`'s; tests hand both packages the same noise.

`train_and_evaluate` writes its scalars, the sample grids and the config's
hparams through `utils.metrics.create_writer` (stdout, and TensorBoard on
rank 0 where it imports). Debug options of the loops: `training.nan_guard`
reads every substep's scalars after each super-step and raises
FloatingPointError naming the first non-finite one and its substep
(`loop.py:167-190`); `training.profile` traces the run's second super-step
with `torch.profiler` into `<workdir>/profile` on rank 0
(`loop.py:253-269`). Every super-step runs inside the span 'train', each
step inside the unit 'step' with its spans 'forward', 'backward',
'optimizer' and 'ema' (`utils/tracing.py`); under the profiler each span
is an annotation.
"""

from __future__ import annotations

import contextlib
import copy
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
from mulan_tpu_torch.parallel import mesh as mesh_lib
from mulan_tpu_torch.parallel import tensor as tensor_lib
from mulan_tpu_torch.parallel import wrap
from mulan_tpu_torch.train import checkpoint as ckpt_lib
from mulan_tpu_torch.train.optimizer import make_lr_schedule, make_optimizer
from mulan_tpu_torch.train.state import TrainState
from mulan_tpu_torch.utils import metrics as metrics_lib
from mulan_tpu_torch.utils import tracing
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


def create_train_state(config: Config, device, state=None, mesh=None):
  """(the model in training mode, its TrainState with a fresh two-group
  AdamW) on `device`; `state` replaces the parameters seeded by
  `training.seed` (a one-process state_dict, e.g. from
  `params.from_flax`). On a mesh with 'tensor' the model holds this rank's
  slices of the score UNet; with 'fsdp' the model and its EMA are sharded
  (`parallel/wrap.py`) before the optimizer is made."""
  training = config.training
  if state is None:
    state = params_lib.init_params(
        config.model, torch.Generator().manual_seed(training.seed),
        vdm_type=config.vdm_type)
  tensor = tensor_lib.tensor_group(mesh)
  model = build_model(config.vdm_type, config.model, device=device,
                      state=state, tensor=tensor).train()
  ema_model = copy.deepcopy(model).requires_grad_(False).eval()
  if mesh_lib.has_fsdp(mesh):
    wrap.shard_model(model, mesh)
    wrap.shard_model(ema_model, mesh)
  lr_schedule = make_lr_schedule(
      config.optimizer.learning_rate, training.num_steps_lr_warmup,
      training.num_steps_train, config.optimizer.lr_decay)
  optimizer = make_optimizer(model.named_parameters(), config.optimizer,
                             lr_schedule, config.lr_gamma_network_scale,
                             tensor)
  return model, TrainState.create(model, optimizer, ema_model)


def mean_scalars(all_scalars: List[Dict[str, torch.Tensor]]
                 ) -> Dict[str, float]:
  """{'eval_' + name: mean over the batches}, read from the device once."""
  if not all_scalars:
    raise ValueError('no eval batches')
  means = torch.stack([torch.stack([s[k] for s in all_scalars]).mean()
                       for k in all_scalars[0]]).tolist()
  return {'eval_' + k: v for k, v in zip(all_scalars[0], means)}


class Experiment:
  """Train and evaluate the model of `config.vdm_type` on `device` (the
  card unless the caller asks for the CPU). `state` replaces the seeded
  initial parameters (a state_dict, e.g. from `params.from_flax`).

  `mesh` (`parallel.mesh.create_mesh`) runs it across the processes of
  the default group, DDP on ('data',), FSDP2 with 'fsdp', the score UNet
  column-parallel with 'tensor'; without one, a process group that is up
  (or `training.fsdp` or `training.tp` > 1) makes the mesh of
  `training.fsdp` and `training.tp` over every rank, as JAX's
  constructor does."""

  def __init__(self, config: Config, *, device='cuda', state=None,
               mesh=None):
    self.config = config
    self.device = resolve_device(device)
    training = config.training
    if mesh is None and (mesh_lib.is_distributed() or training.fsdp != 1
                         or training.tp != 1):
      mesh = mesh_lib.create_mesh(fsdp=training.fsdp, tp=training.tp,
                                  device_type=self.device.type)
    self.mesh = mesh
    self.tensor = tensor_lib.tensor_group(mesh)

    seed = training.seed
    self.model, self.state = create_train_state(config, self.device, state,
                                                mesh)
    # What a train step calls: DDP on a ('data',) mesh.
    self.train_model = self.model
    if mesh is not None and not mesh_lib.has_fsdp(mesh):
      self.train_model = wrap.data_parallel(self.model, mesh)
    if config.ckpt_restore_dir not in (None, 'None', ''):
      ckpt_lib.restore_partial_into(self.state, config.ckpt_restore_dir)

    self.train_iter, self.eval_iter = data_lib.create_dataset(config, seed,
                                                              mesh)
    self.train_rows = self.rows(training.batch_size_train)
    self.eval_rows = self.rows(training.batch_size_eval)

    self.generator = torch.Generator(self.device)
    self.writer = ScalarWriter(enabled=mesh_lib.rank() == 0)

  def rows(self, global_batch: int) -> Optional[mesh_lib.Rows]:
    """This rank's rows of a global batch on the mesh (None without
    one)."""
    if self.mesh is None:
      return None
    return mesh_lib.row_window(mesh_lib.local_batch_size(
        global_batch, mesh_lib.batch_world(self.mesh)), self.mesh)

  # -- loss and steps -----------------------------------------------------------

  def reseed(self, stream: int, index: int) -> int:
    """Reseeds the device generator from (training.seed, stream, index) and
    returns the dropout seed of the same key."""
    key = step_key(self.config.training.seed, stream, index)
    self.generator.manual_seed(key)
    return key % (2 ** 31 - 1)

  def loss_fn(self, model, batch, *, train: bool, noise=None,
              dropout_seed: Optional[int] = None, step: int = 0,
              rows: Optional[mesh_lib.Rows] = None):
    """(bpd, scalars): the mean ELBO in bits per dimension and its six
    terms (`loop.py:116-141`), with the batch's `labels` and
    `conditioning` (when it has them) and `step`. `noise` may hold explicit
    `t`, `eps0`, `eps`, `latent_noise` (MuLAN) and `dropout_seed` for the
    model's `elbo`; what it does not hold is drawn from the experiment's
    generator, at the global batch's shape cut to `rows` when given (the
    batch is then those rows of the global batch). The model is called
    through its `forward`, as data-parallel wrappers need."""
    images = torch.as_tensor(batch['images'], device=self.device)
    noise = dict(noise or {})
    dropout_seed = noise.pop('dropout_seed', dropout_seed)
    out = model(images, noise.pop('t', None), labels=batch.get('labels'),
                conditioning=batch.get('conditioning'), step=step,
                generator=self.generator, deterministic=not train,
                dropout_seed=dropout_seed if train else None, rows=rows,
                **noise)
    rescale = 1.0 / (self.config.model.n_pixels * math.log(2.0))
    bpd_latent = out.loss_klz.mean() * rescale
    bpd_recon = out.loss_recon.mean() * rescale
    bpd_diff = out.loss_diff.mean() * rescale
    bpd = bpd_recon + bpd_latent + bpd_diff
    scalars = {'bpd': bpd, 'bpd_latent': bpd_latent, 'bpd_recon': bpd_recon,
               'bpd_diff': bpd_diff, 'var0': out.var_0, 'var': out.var_1}
    return bpd, scalars

  def train_step(self, batch, noise=None) -> Dict[str, torch.Tensor]:
    """One optimizer step on one batch (images (B, H, W, C) uint8, and
    labels and conditioning (B,) when the model reads them), its noise
    keyed by the step, the ELBO at the step before the update
    (`loop.py:150-152`); the scalars stay on the device. On a mesh the
    batch is this rank's rows of the global batch, and the scalars are the
    global batch's."""
    step = self.state.step
    with tracing.unit('step', step):
      seed = self.reseed(TRAIN, step)
      with tracing.span('forward'):
        bpd, scalars = self.loss_fn(self.train_model, batch, train=True,
                                    noise=noise, dropout_seed=seed,
                                    step=step, rows=self.train_rows)
      self.state.optimizer.zero_grad()
      with tracing.span('backward'):
        bpd.backward()
      if mesh_lib.has_fsdp(self.mesh):
        wrap.average_plain_grads(self.state.params.values(), self.mesh)
      if self.tensor is not None:
        wrap.average_whole_grads(self.state.params, self.tensor)
      self.state.apply_gradients(self.config.optimizer.ema_rate)
      return self._global({k: v.detach() for k, v in scalars.items()})

  def _global(self, scalars):
    """The scalars' means over the ranks on a mesh (the global batch's
    means: every rank holds as many rows)."""
    return scalars if self.mesh is None else mesh_lib.mean_over_ranks(
        scalars, self.mesh)

  @torch.no_grad()
  def eval_step(self, batch, index: int = 0,
                noise=None) -> Dict[str, torch.Tensor]:
    """The scalars of the EMA model on one batch, deterministic, the noise
    keyed by the batch's index within its evaluation, which is also the
    ELBO's step, as JAX's eval step passes it (`loop.py:199-202`)."""
    self.reseed(EVAL, index)
    return self._global(self.loss_fn(self.state.ema_model, batch,
                                     train=False, noise=noise, step=index,
                                     rows=self.eval_rows)[1])

  # -- loops ----------------------------------------------------------------------

  def _put_superbatch(self, superbatch) -> Dict[str, torch.Tensor]:
    """A super-batch's arrays ((substeps, B, ...) numpy) on the device, one
    copy each: from pinned memory and not blocking the host on the card."""
    out = {}
    with tracing.span('put'):
      for k, v in superbatch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if self.device.type == 'cuda':
          t = t.pin_memory().to(self.device, non_blocking=True)
        out[k] = t
    return out

  def train_superstep(self, superbatch) -> Dict[str, torch.Tensor]:
    """One super-step (`_p_superstep`, `loop.py:149-160`): the super-batch
    ((substeps, B, ...) arrays, this rank's rows of every substep on a
    mesh) goes to the device in one copy, then `train_step` runs on each
    substep's batch in turn, each keyed by its own step. Returns the
    per-substep scalars stacked on the device, {name: (substeps,)}; the
    host reads nothing. Runs inside the span 'train' (`utils/tracing.py`),
    which the profiler sees as an annotation."""
    with tracing.span('train'):
      batches = self._put_superbatch(superbatch)
      history = [self.train_step({k: v[i] for k, v in batches.items()})
                 for i in range(len(batches['images']))]
      return {k: torch.stack([h[k] for h in history]) for k in history[0]}

  def _guarded_superstep(self) -> Dict[str, torch.Tensor]:
    """One super-step on the training iterator, with `training.nan_guard`
    its scalars checked."""
    scalars = self.train_superstep(next(self.train_iter))
    if self.config.training.nan_guard:
      self._nan_guard(scalars)
    return scalars

  def _nan_guard(self, scalars: Dict[str, torch.Tensor]) -> None:
    """JAX's `guarded_superstep` (`loop.py:176-188`): reads the super-step's
    scalars ({name: (substeps,)} or one step's {name: ()}) in one device
    read and raises FloatingPointError naming the first non-finite name in
    sorted order, its first bad substep and the state's step after the
    super-step, in JAX's words."""
    names = sorted(scalars)
    values = torch.stack([scalars[k].float().reshape(-1) for k in names]
                         ).cpu().numpy()
    for name, row in zip(names, values):
      finite = np.isfinite(row)
      if not finite.all():
        bad = int(np.argmin(finite))
        raise FloatingPointError(
            f'nan_guard: non-finite {name!r} at substep {bad} of the '
            f'super-step ending at step {self.state.step} '
            f'(value {row[bad]!r})')

  def train(self, num_steps: int) -> List[Dict[str, float]]:
    """`num_steps` train steps on the training iterator, in whole
    super-steps of `training.substeps` (a `num_steps` that is not a
    multiple of it raises ValueError). Logs the super-step's mean scalars
    after each super-step that ends at a multiple of
    `training.steps_per_logging` and after the last, and returns every
    step's scalars (read from the device at the end). It takes no workdir,
    so it logs to stdout only (`self.writer`); the TensorBoard writer is
    `train_and_evaluate`'s and `evaluate`'s."""
    training = self.config.training
    if num_steps % training.substeps:
      raise ValueError(
          f'train({num_steps}): the steps must be a multiple of '
          f'training.substeps = {training.substeps}: train runs whole '
          'super-steps')
    n = num_steps // training.substeps
    history = []
    last_t, last_step = time.perf_counter(), self.state.step
    for i in range(n):
      history.append(self._guarded_superstep())
      if self.state.step % training.steps_per_logging == 0 or i == n - 1:
        last_t, last_step = self._log_train(self.writer, history[-1], last_t,
                                            last_step)
    if not history:
      return []
    names = list(history[0])
    values = torch.stack([torch.cat([h[k] for h in history]).double()
                          for k in names]).tolist()
    return [dict(zip(names, step)) for step in zip(*values)]

  def _log_train(self, writer, scalars, last_t: float, last_step: int):
    """Writes the super-step's float32 means as 'train_' + name
    (`loop.py:276`) and the steps a second since the last log, over the
    steps actually taken."""
    step = self.state.step
    means = torch.stack([v.float().mean() for v in scalars.values()]
                        ).tolist()
    scalars = {'train_' + k: v for k, v in zip(scalars, means)}
    now = time.perf_counter()
    scalars['steps_per_sec'] = (step - last_step) / (now - last_t)
    writer.write_scalars(step, scalars)
    return now, step

  def train_and_evaluate(self, workdir: str, *,
                         max_to_keep: int = 100) -> None:
    """Trains to `training.num_steps_train` in super-steps of
    `training.substeps` (`loop.py:232-305`): resumes from the latest
    checkpoint in `<workdir>/checkpoints`, writes the config's hparams when
    it starts at step 0, and after each super-step logs the super-step's
    mean scalars when the step is a multiple of `steps_per_logging`,
    evaluates and draws samples after the first super-step, at multiples
    of `steps_per_eval` and at the last, and saves at multiples of
    `steps_per_save` and at the last (keeping `max_to_keep`). The scalars
    and samples go to `create_writer(workdir, rank)`. With
    `training.profile`, rank 0 traces the run's second super-step into
    `<workdir>/profile/train_<step>.pt.trace.json`, `<step>` the step it
    starts at."""
    training = self.config.training
    substeps = training.substeps
    ckpt = ckpt_lib.CheckpointManager(os.path.join(workdir, 'checkpoints'),
                                      max_to_keep)
    if ckpt.latest_step() is not None:
      ckpt.restore(self.state)
    step = self.state.step
    rank = mesh_lib.rank()
    writer = metrics_lib.create_writer(workdir, rank)
    try:
      if step == 0 and rank == 0:
        writer.write_hparams(self.config)
      profile_at = step + substeps if training.profile and rank == 0 else None
      last_t, last_step = time.perf_counter(), step
      while step < training.num_steps_train:
        is_last = step + substeps >= training.num_steps_train
        with (self._profiled(os.path.join(workdir, 'profile'), step)
              if step == profile_at else contextlib.nullcontext()):
          scalars = self._guarded_superstep()
        if self.state.step != step + substeps:
          raise AssertionError((self.state.step, step, substeps))
        step = self.state.step
        if step % training.steps_per_logging == 0 or is_last:
          last_t, last_step = self._log_train(writer, scalars, last_t,
                                              last_step)
        if (step % training.steps_per_eval == 0 or is_last
            or step == substeps):
          writer.write_scalars(step, self.run_eval())
          writer.write_images(step, {'samples': self.draw_samples()[None]})
        if step % training.steps_per_save == 0 or is_last:
          ckpt.save(step, self.state)
      writer.flush()
    finally:
      writer.close()

  @contextlib.contextmanager
  def _profiled(self, logdir: str, step: int):
    """Traces what runs inside, CPU and CUDA, into
    `<logdir>/train_<step>.pt.trace.json` (a Chrome trace); the device's
    work is waited for before the trace stops."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if self.device.type == 'cuda':
      activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
      yield
      if self.device.type == 'cuda':
        torch.cuda.synchronize(self.device)
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir,
                                          f'train_{step}.pt.trace.json'))

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
    (`loop.py:334-352`): the eval scalars and a sample grid, through
    `create_writer(<logdir>/eval, rank)` and as
    `<logdir>/eval/samples_<step>.png`."""
    restored = ckpt_lib.CheckpointManager(checkpoint_dir).restore_dict()
    self.state.load_tensors('ema_params', restored['ema_params'])
    step = int(restored['step'])
    eval_dir = os.path.join(logdir, 'eval')
    writer = metrics_lib.create_writer(eval_dir, mesh_lib.rank())
    try:
      scalars = self.run_eval()
      writer.write_scalars(step, scalars)
      grid = self.draw_samples()
      writer.write_images(step, {'samples': grid[None]})
    finally:
      writer.close()
    if mesh_lib.rank() == 0:
      os.makedirs(eval_dir, exist_ok=True)
      write_png(os.path.join(eval_dir, f'samples_{step}.png'), grid)
    return scalars

  @torch.inference_mode()
  def draw_samples(self, batch_size: Optional[int] = None,
                   T: int = 1000) -> np.ndarray:
    """An image grid of T unconditional ancestral steps of the EMA model
    (`mulan_tpu/train/loop.py:201-216`): from `sigma_prior` times a
    standard normal, through the model's `sample`, then the decode. The
    noise starts from the same key every call. On a mesh each rank draws
    its rows of the `batch_size` samples and every rank gets the grid of
    all of them (`loop.py:323-332`)."""
    if batch_size is None:
      batch_size = min(64, self.config.training.batch_size_eval)
    rows = self.rows(batch_size)
    local = batch_size if rows is None else rows.count
    self.reseed(SAMPLE, 0)
    model = self.state.ema_model
    cfg = model.config
    z = cfg.sigma_prior * model._noise((local, *cfg.image_shape),
                                       self.generator, rows)
    for i in range(T):
      z = model.sample(i, T, z, generator=self.generator, rows=rows)
    images = model.generate_x(z, self.generator, rows=rows)
    images = mesh_lib.all_gather_rows(images.to(torch.uint8),
                                      mesh=self.mesh).cpu().numpy()
    return image_grid(images)
