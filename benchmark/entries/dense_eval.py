"""Entry `dense_eval`: `evals.vlb.eval_bpd_dense(ema_model, [batch],
n_timesteps)` on successive batches of the program's evaluation iterator,
each call's noise from a generator the harness seeds for that call.

Set-up makes the images and weights from the seed, builds one
`Experiment` and warms up with one call on the traffic's warm-up images
(whole chunks at the window's shape). Each call ends in the program's own
read of its mean; the window runs whole calls until `--seconds` have
passed, and the rate is over the time to the end of the last one. After
the window a call drawn from the seed is computed again by the reference
in float32, from the same images and the same generator key.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict

import numpy as np
import torch

from benchmark.harness import flops, inputs, stats
from benchmark.harness import device as device_lib
from benchmark.harness import trace as trace_lib
from benchmark.harness.runner import Check, Outcome
from benchmark.reference import mulan as ref
from benchmark.reference import train as ref_train

GIB = 2 ** 30
# The key index of the warm-up call, apart from the window's calls.
WARMUP_CALL = 10 ** 9


def call_key(seed: int, index: int) -> int:
  """The generator seed of call `index` of a run."""
  return ref.step_key(inputs.stream_seed(seed, inputs.CALLS), 0, index)


class Evaluator:
  """The program's EMA model and evaluation iterator, and its call."""

  def __init__(self, ctx):
    from mulan_tpu_torch import configs
    from mulan_tpu_torch.evals import vlb
    from mulan_tpu_torch.train.loop import Experiment
    spec, traffic = ctx.cell.config, ctx.cell.traffic
    self.traffic = traffic
    self.model = ref.Model.from_config(spec['model'], spec['vdm_type'])
    dataset = inputs.write_dataset(ctx.seed, ctx.tmpdir,
                                   spec['train_examples'],
                                   spec['eval_examples'],
                                   self.model.image_size, self.model.channels)
    self.config = inputs.program_config(configs, spec, {
        'data.dataset': dataset, 'training.seed': ctx.seed,
        'training.batch_size_eval': traffic['batch']})
    self.weights_seed = inputs.stream_seed(ctx.seed, inputs.WEIGHTS)
    weights = ref.make_weights(self.model, self.weights_seed, ctx.device)
    self.experiment = Experiment(self.config, device=ctx.device,
                                 state=weights)
    del weights
    self.vlb = vlb
    self.generator = torch.Generator(ctx.device)

  def __call__(self, images: np.ndarray, key: int) -> float:
    self.generator.manual_seed(key)
    return self.vlb.eval_bpd_dense(
        self.experiment.state.ema_model, [{'images': images}],
        n_timesteps=self.traffic['n_timesteps'],
        images_per_chunk=self.traffic['images_per_chunk'],
        generator=self.generator)

  def next_images(self) -> np.ndarray:
    return np.asarray(next(self.experiment.eval_iter)['images'])

  def reference(self, ctx, images: np.ndarray, key: int,
                num=ref.FLOAT32) -> torch.Tensor:
    """The reference's per-image bpd of a call, in float32 (or `num`)."""
    with ref_train.full_float32():
      w = ref.make_weights(self.model, self.weights_seed, ctx.device)
      return ref_train.dense_call_per_image(
          self.model, w, torch.as_tensor(images, device=ctx.device), key,
          self.traffic['n_timesteps'], self.traffic['images_per_chunk'],
          num, self.traffic.get('rows_per_block', 512))

  def mean(self, per_image: torch.Tensor, fault: str = '') -> float:
    return ref_train.dense_call_bpd(per_image,
                                    self.traffic['images_per_chunk'], fault)


def window(ctx, ev: Evaluator) -> Dict:
  dev = ctx.device
  device_lib.synchronize(dev)
  device_lib.reset_peak(dev)
  setup_s = time.perf_counter() - ctx.t_start
  t0 = time.perf_counter()
  calls, values, images, ends = [], [], [], []
  while time.perf_counter() - t0 < ctx.seconds:
    batch = ev.next_images()
    a = time.perf_counter()
    values.append(ev(batch, call_key(ctx.seed, len(values))))
    b = time.perf_counter()
    calls.append(b - a)
    images.append(batch)
    ends.append(b - t0)
  return {'setup_s': setup_s, 'seconds': ends[-1], 'call_s': calls,
          'values': values, 'images': images,
          'peak_bytes': device_lib.peak_bytes(dev)}


def traced_calls(ctx, ev: Evaluator, n: int, first: int) -> Dict:
  def call(i):
    batch = ev.next_images()
    with trace_lib.span('call'):
      ev(batch, call_key(ctx.seed, first + i))
  return trace_lib.profile(call, n, ctx.device)


def sampled_call(seed: int, calls: int) -> int:
  """The window's call that the reference computes again."""
  rng = np.random.default_rng(inputs.stream_seed(seed, inputs.SAMPLE))
  return int(rng.integers(calls))


def run(ctx) -> Outcome:
  traffic = ctx.cell.traffic
  ev = Evaluator(ctx)
  warm = ev.next_images()[:traffic['warmup_images']]
  ev(warm, call_key(ctx.seed, WARMUP_CALL))
  timed = window(ctx, ev)
  chunks_per_call = math.ceil(traffic['batch'] / traffic['images_per_chunk'])
  record = {'entry': 'dense_eval', 'window': timed,
            'on_card': ctx.device.type == 'cuda',
            'chunks_per_call': chunks_per_call,
            'flops_per_chunk': flops.dense_chunk(
                ev.model, traffic['images_per_chunk'], traffic['n_timesteps']),
            'peak_flops': flops.PEAK_BF16_FLOPS, 'trace': None}
  if ctx.trace:
    record['trace'] = traced_calls(ctx, ev, traffic['trace_calls'],
                                   len(timed['values']))
  ev.experiment = None
  gc.collect()
  device_lib.free_memory(ctx.device)
  n = len(timed['values'])
  i = sampled_call(ctx.seed, n)
  want = ev.mean(ev.reference(ctx, timed['images'][i],
                              call_key(ctx.seed, i)))
  got = timed['values'][i]
  ctx.say(f'call {i} of {n}: program {got!r}, reference {want!r}')
  checks = [Check('bpd', abs(got - want) / abs(want),
                  ctx.cell.limits['bpd'])]
  rows = n * traffic['batch'] * traffic['n_timesteps']
  e2e = {'eval_rows_per_s': stats.rate(rows, timed['seconds']),
         'peak_mem_gib': timed['peak_bytes'] / GIB,
         'setup_s': timed['setup_s']}
  ctx.say('window', e2e, f'{n} calls')
  failed = sum(not math.isfinite(v) for v in timed['values'])
  return Outcome(e2e, record, checks, n, failed, timed['peak_bytes'])
