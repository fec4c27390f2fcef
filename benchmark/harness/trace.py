"""The traced part of a `--trace 1` run: a few calls of the window's own
entry under `torch.profiler`, reduced to device intervals, the harness's
spans and the breakdown.

The harness marks its own spans with `record_function('bench.<name>')`:
the call into the program and, for training, the wait for the next batch.
The program's kernels are named by the category table below (copied from
the port's `chip_smoke.py`) and by their own names.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from benchmark.harness import stats

# Kernel name -> category, the first match wins.
CATEGORIES = (
    ('K1 flash attention', ('flash_fwd',)),
    ('K2 flash attention dK dV', ('flash_bwd_dkv',)),
    ('K3 flash attention dQ', ('flash_bwd_dq',)),
    ('K4/K5 decoder', ('decoder_logprob',)),
    ('K6/K7 dropout masks', ('dropout_mask',)),
    ('K8 GroupNorm+swish backward', ('gn_swish_bwd',)),
    ('K8 GroupNorm+swish', ('gn_swish',)),
    ('layout transposes', ('nchwToNhwc', 'nhwcToNchw', 'transpose')),
    ('convolutions and GEMMs', ('conv', 'xmma', 'gemm', 'cutlass', 'sm90',
                                'dgrad', 'wgrad', 'implicit', 'nvjet')),
    ('GroupNorm', ('group_norm', 'GroupNorm', 'RowwiseMoments',
                   'ComputeFused', 'compute_stats', 'GammaBeta',
                   'ComputeInternalGradients', 'ComputeBackwardFused')),
    ('optimizer and EMA', ('multi_tensor', 'foreach', 'lerp')),
    ('collectives and FSDP2 copies', ('nccl', 'chunk_cat',
                                      'split_with_sizes')),
    ('concat', ('CatArray',)),
    ('reductions', ('reduce',)),
    ('elementwise', ('elementwise', 'vectorized', 'unrolled')),
)
LAYOUT = 'layout transposes'
SPAN_PREFIX = 'bench.'
# Host operations that wait for the device: the end of the host's part of
# a call that reads a result.
SYNC_OPS = ('aten::_local_scalar_dense', 'aten::item')


def category(name: str) -> str:
  return next((c for c, keys in CATEGORIES if any(k in name for k in keys)),
              'other')


def is_copy(name: str) -> bool:
  return name.startswith(('Memcpy', 'Memset'))


def span(name: str):
  """A harness span, visible to the profiler when one runs."""
  return torch.profiler.record_function(SPAN_PREFIX + name)


def profile(calls: Callable[[int], None], n: int, device) -> Dict:
  """Runs calls(0) .. calls(n - 1) under the profiler and waits for the
  device; returns the trace's record (times in seconds, from the first
  harness span's start)."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity
  activities = [ProfilerActivity.CPU]
  if device.type == 'cuda':
    activities.append(ProfilerActivity.CUDA)
  if device.type == 'cuda':
    torch.cuda.synchronize(device)
  with torch.profiler.profile(activities=activities) as prof:
    for i in range(n):
      calls(i)
    if device.type == 'cuda':
      torch.cuda.synchronize(device)
  ops, spans, syncs = [], [], []
  for e in prof.profiler.kineto_results.events():
    name = e.name()
    if e.device_type() == DeviceType.CUDA:
      if not e.is_user_annotation():
        ops.append((name, e.start_ns(), e.end_ns()))
    elif e.is_user_annotation() and name.startswith(SPAN_PREFIX):
      spans.append((name[len(SPAN_PREFIX):], e.start_ns(), e.end_ns()))
    elif name in SYNC_OPS:
      syncs.append((e.start_ns(), e.end_ns()))
  return reduce(ops, spans, syncs, n)


def reduce(ops: List[Tuple[str, int, int]],
           spans: List[Tuple[str, int, int]],
           syncs: List[Tuple[int, int]], calls: int) -> Dict:
  """The record of a traced stretch: device ops and harness spans as
  (name, start ns, end ns), the host's waits for the device."""
  if not spans:
    raise ValueError('the trace holds no harness span')
  lo = min(s for _, s, _ in spans)
  hi = max([e for _, _, e in spans] + [e for _, _, e in ops])
  inside = [(n, max(s, lo), min(e, hi)) for n, s, e in ops if e > lo and s < hi]
  busy_ns = stats.union_length((s, e) for _, s, e in inside)
  by_cat: Dict[str, float] = {}
  by_name: Dict[str, float] = {}
  kernels, kernel_s = 0, 0.0
  for n, s, e in inside:
    by_cat[category(n)] = by_cat.get(category(n), 0.0) + (e - s) / 1e9
    by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
    if not is_copy(n):
      kernels += 1
      kernel_s += (e - s) / 1e9
  idle = stats.gaps(((s, e) for _, s, e in inside), lo, hi)
  labelled = sorted(((_label(spans, (a + b) / 2), (b - a) / 1e9)
                     for a, b in idle), key=lambda kv: -kv[1])
  top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
  return {
      'calls': calls,
      'window_s': (hi - lo) / 1e9,
      'busy_s': busy_ns / 1e9,
      'kernels': kernels,
      'kernel_s': kernel_s,
      'by_category_s': dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
      'spans': [(n, (s - lo) / 1e9, (e - lo) / 1e9) for n, s, e in spans],
      'syncs': [((s - lo) / 1e9, (e - lo) / 1e9) for s, e in syncs],
      'breakdown': {
          'device_ops': [[f'{category(n)}: {n[:96]}', s] for n, s in top],
          'idle_gaps': [[label, s] for label, s in labelled[:10]],
      },
  }


def _label(spans, t: float) -> str:
  """The innermost harness span that holds time t, or 'outside'."""
  holding = [(e - s, n) for n, s, e in spans if s <= t <= e]
  return min(holding)[1] if holding else 'outside the harness spans'
