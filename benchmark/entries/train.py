"""Entry `train`: `Experiment.train_superstep(next(ex.train_iter))` in a
loop, the program's own training path with its input pipeline.

Set-up makes the images (an npz the program reads as `npz:<dir>`) and the
weights from the seed, builds one `Experiment`, and drives it through its
first `check_calls` super-steps on the window's own call and feed: those
are the warm-up and the steps the check reads (each step's loss, the
optimizer's first moment right after its first step, every leaf's
change). The same object then runs the window: nothing synchronises
inside it; a CUDA event is recorded after each super-step and read after
the window. After the window, with the program freed, the reference
follows the same first steps in float32 and the readings are compared.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import compare, flops, inputs, stats
from benchmark.harness import device as device_lib
from benchmark.harness import trace as trace_lib
from benchmark.harness.runner import Check, Outcome
from benchmark.reference import mulan as ref
from benchmark.reference import train as ref_train

GIB = 2 ** 30


@dataclasses.dataclass
class Readings:
  """The first steps as one side saw them."""
  losses: List[float]
  moment: Dict[str, float]
  change: Dict[str, float]
  first_grad: Dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Prepared:
  model: ref.Model
  config: object
  experiment: object
  weights_seed: int
  batches: List[np.ndarray]
  program: Readings


def prepare(ctx) -> Prepared:
  """Set-up: inputs, weights, the Experiment, its first super-steps."""
  from mulan_tpu_torch import configs
  from mulan_tpu_torch.train.loop import Experiment
  cell, dev = ctx.cell, ctx.device
  spec, traffic = cell.config, cell.traffic
  model = ref.Model.from_config(spec['model'], spec['vdm_type'])
  dataset = inputs.write_dataset(ctx.seed, ctx.tmpdir, spec['train_examples'],
                                 spec['eval_examples'], model.image_size,
                                 model.channels)
  cfg = inputs.program_config(configs, spec, {
      'data.dataset': dataset, 'training.seed': ctx.seed,
      'training.substeps': traffic['substeps'],
      'training.batch_size_train': traffic['batch']})
  wseed = inputs.stream_seed(ctx.seed, inputs.WEIGHTS)
  weights = ref.make_weights(model, wseed, dev)
  ex = Experiment(cfg, device=dev, state=weights)
  batches, losses, moment = [], [], {}
  with read_after_first_step(ex, moment):
    for i in range(traffic['check_calls']):
      superbatch = next(ex.train_iter)
      out = ex.train_superstep(superbatch)
      batches.extend(np.asarray(superbatch['images']))
      losses.extend(out['bpd'].double().tolist())
      if not moment:
        # No optimizer step ran: the state holds no moment.
        moment.update(optimizer_moment(ex))
  change = compare.change_norms(ex.state.params, weights)
  del weights
  return Prepared(model, cfg, ex, wseed, batches,
                  Readings(losses, moment, change))


@contextlib.contextmanager
def read_after_first_step(ex, moment: Dict[str, float]):
  """Fills `moment` with `optimizer_moment` right after the optimizer's
  first step, inside the call that runs it: the first gradient as the
  optimizer got it, also where a super-step runs several steps in one
  call. The step itself is the program's, unchanged."""
  opt = ex.state.optimizer
  step = opt.step

  def step_then_read(*args, **kwargs):
    out = step(*args, **kwargs)
    if not moment:
      moment.update(optimizer_moment(ex))
    return out
  opt.step = step_then_read
  try:
    yield
  finally:
    del opt.step


def optimizer_moment(ex) -> Dict[str, float]:
  """Each leaf's norm of the optimizer's first moment, from the state the
  program saves (`TrainState.state_dict`); 0 for a leaf it holds none
  of."""
  opt = ex.state.optimizer
  state = opt.state_dict()['state']
  held = compare.norms({opt.names[i]: st['exp_avg']
                        for i, st in state.items()}) if state else {}
  return {name: held.get(name, 0.0) for name in opt.names}


def window(ctx, ex) -> Dict:
  """The measured window; returns its timings."""
  dev = ctx.device
  device_lib.synchronize(dev)
  device_lib.reset_peak(dev)
  setup_s = time.perf_counter() - ctx.t_start
  marks = device_lib.Marks(dev)
  marks.mark()
  t0 = time.perf_counter()
  waits, calls, bpds = [], [], []
  while time.perf_counter() - t0 < ctx.seconds:
    a = time.perf_counter()
    superbatch = next(ex.train_iter)
    b = time.perf_counter()
    bpds.append(ex.train_superstep(superbatch)['bpd'])
    c = time.perf_counter()
    marks.mark()
    waits.append(b - a)
    calls.append(c - b)
  device_lib.synchronize(dev)
  wall = time.perf_counter() - t0
  peak = device_lib.peak_bytes(dev)
  bpd = torch.cat(bpds).double()
  return {'setup_s': setup_s, 'seconds': wall, 'calls': len(calls),
          'input_s': waits, 'call_s': calls, 'event_ms': marks.intervals_ms(),
          'peak_bytes': peak, 'steps': len(bpd),
          'failed': int((~torch.isfinite(bpd)).sum())}


def traced_calls(ctx, ex, n: int) -> Dict:
  def call(i):
    with trace_lib.span('input'):
      superbatch = next(ex.train_iter)
    with trace_lib.span('call'):
      ex.train_superstep(superbatch)
  return trace_lib.profile(call, n, ctx.device)


def adamw(cfg) -> ref_train.AdamW:
  o = cfg.optimizer
  if o.gradient_clip_norm is not None or o.lr_decay:
    raise ValueError('the reference optimizer has no clipping or decay')
  return ref_train.AdamW(
      learning_rate=o.learning_rate, warmup=cfg.training.num_steps_lr_warmup,
      b1=o.args.b1, b2=o.args.b2, eps=o.args.eps,
      weight_decay=o.args.weight_decay, ema_rate=o.ema_rate)


def reference(ctx, prep: Prepared, num=ref.FLOAT32, fault='') -> Readings:
  """The reference's readings of the first steps, in float32 (or `num`)."""
  dev = ctx.device
  traffic = ctx.cell.traffic
  with ref_train.full_float32():
    w0 = ref.make_weights(prep.model, prep.weights_seed, dev)
    images = [torch.as_tensor(b, device=dev) for b in prep.batches]
    traj = ref_train.follow(prep.model, adamw(prep.config), w0, images,
                            ctx.seed, 1, num, fault,
                            traffic.get('rows_per_block', 32))
    change = compare.change_norms(traj.state.params, w0)
  return Readings(traj.losses, compare.norms(traj.moment), change,
                  compare.norms(traj.first_grad))


# The leaves each number compares. The latent encoder's gradient reaches
# it only through the top-k's soft part, and rounding alone moves its
# leaves' norms by up to tens of percent; the schedule network's move by a
# few percent, as far as float8's do; and a leaf of a few elements (the
# output convolution's 3 biases) sums cancelling terms, so that its norm
# swings with rounding from seed to seed (PERF.md, the check). The moment
# compares the score UNet's leaves of MOMENT_MIN_SIZE elements or more
# (every convolution, dense and attention weight; no bias or GroupNorm
# parameter); the change, the score UNet's and the schedule's leaves.
MOMENT_MIN_SIZE = 4096
CHANGE_LEAVES = ('score_model.', 'gamma.')


def moment_leaves(model: ref.Model):
  return {k for k, shape in ref.param_shapes(model).items()
          if k.startswith('score_model.') and math.prod(shape) >= MOMENT_MIN_SIZE}


def _only(norms: Dict[str, float], keep) -> Dict[str, float]:
  return {k: v for k, v in norms.items() if keep(k)}


def numbers(model: ref.Model, program: Readings, reference: Readings,
            loss_steps: Optional[int] = None) -> Dict[str, float]:
  """loss: the worst relative gap of a checked step's loss, over the first
  `loss_steps` checked steps (all when None); moment: the worst gap of the
  optimizer's first moment after the first step over the score UNet's
  large leaves; change: the worst gap of the parameters' change over the
  checked steps over the score UNet's and the schedule's leaves, those
  with a negligible reference gradient left out."""
  big = moment_leaves(model)
  def changed(k):
    return k.startswith(CHANGE_LEAVES)
  n = loss_steps or len(reference.losses)
  return {
      'loss': compare.worst_relative(program.losses[:n],
                                     reference.losses[:n]),
      'moment': compare.worst_leaf(_only(program.moment, big.__contains__),
                                   _only(reference.moment,
                                         big.__contains__))[0],
      'change': compare.worst_leaf(
          _only(program.change, changed), _only(reference.change, changed),
          compare.negligible(reference.first_grad))[0],
  }


def leaf_detail(model: ref.Model, program: Readings, reference: Readings,
                top: int = 6):
  """The worst leaves of the moment and the change, and the median leaf's
  gap, by top-level module."""
  out = {}
  for name, p, r, skip in (
      ('moment', program.moment, reference.moment, ()),
      ('change', program.change, reference.change,
       compare.negligible(reference.first_grad))):
    gaps = compare.leaf_gaps(p, r, skip)
    out[name] = {'worst': [[g, k] for g, k in gaps[:top]],
                 'median_gap': statistics.median(g for g, _ in gaps)}
    big = moment_leaves(model)
    for group in ('score_model', 'encoder_model', 'gamma', 'large'):
      part = [(g, k) for g, k in gaps
              if (k in big if group == 'large' else k.startswith(group))]
      if part:
        out[name][group] = [part[0][0], part[0][1],
                            statistics.median(g for g, _ in part)]
  return out


def run(ctx) -> Outcome:
  traffic = ctx.cell.traffic
  prep = prepare(ctx)
  ctx.say('first steps', prep.program.losses)
  timed = window(ctx, prep.experiment)
  record = {'entry': 'train', 'window': timed,
            'on_card': ctx.device.type == 'cuda',
            'steps_per_call': traffic['substeps'],
            'flops_per_step': flops.train_step(prep.model, traffic['batch']),
            'peak_flops': flops.PEAK_BF16_FLOPS, 'trace': None}
  if ctx.trace:
    record['trace'] = traced_calls(ctx, prep.experiment,
                                   traffic['trace_calls'])
  prep.experiment = None
  gc.collect()
  device_lib.free_memory(ctx.device)
  got = numbers(prep.model, prep.program, reference(ctx, prep),
                ctx.cell.workload.get('loss_steps'))
  checks = [Check(name, value, ctx.cell.limits[name])
            for name, value in got.items()]
  steps = timed['steps']
  rate = stats.rate(steps * traffic['batch'], timed['seconds'])
  # The cell's BENCHMARK.json entry says under which name it reports the
  # rate: a host-paced cell's spreads more from run to run.
  e2e = {
      'train_images_per_s': rate,
      'paced_train_images_per_s': rate,
      'peak_mem_gib': timed['peak_bytes'] / GIB,
      'setup_s': timed['setup_s'],
  }
  ctx.say('window', {k: v for k, v in e2e.items()},
          f'{timed["calls"]} calls', f'{steps} steps')
  return Outcome(e2e, record, checks, steps, timed['failed'],
                 timed['peak_bytes'])
