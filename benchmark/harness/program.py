"""The readers of the per-layer metrics that the program records itself:
the spans and kernel counts of its recorder
(`mulan_tpu_torch/utils/tracing.py`), read in the process after a
`--trace 1` run.

A span's metric is its time a unit over the measured window: the last W
units the recorder kept with `profiled` false, W the window's steps
(training) or chunks (the dense VLB); a device time, over those of them
that the recorder timed on the device (one in `TIMED_EVERY`). No program
unit runs after the traced calls, which ran under the profiler. A
kernel's roofline share is the least time its counted work needs on the
card (`harness/roofline.py`, from the shapes and types each launch
recorded in the traced calls' units) over its category's device time in
the traced calls' trace, in %.

Each reader returns None where the program records nothing to read: no
recorder, fewer units than the window's, a span missing or its device time
not resolved (on the CPU none is), or a category that reads no time.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

from benchmark.harness import roofline

K1_CATEGORY = 'K1 flash attention'
K6_CATEGORY = 'K6/K7 dropout masks'


def _recorder():
  try:
    from mulan_tpu_torch.utils import tracing
  except ImportError:
    return None
  return tracing


def _kind(record) -> Optional[str]:
  return {'train': 'step', 'dense_eval': 'chunk'}.get(record['entry'])


def window_units(record, recorder=None) -> Optional[List[dict]]:
  """The recorder's units of the measured window, or None."""
  recorder = recorder or _recorder()
  kind = _kind(record)
  if recorder is None or kind is None:
    return None
  w = record['window']
  n = (w['steps'] if kind == 'step'
       else len(w['values']) * record['chunks_per_call'])
  kept = [u for u in recorder.units(kind) if not u['profiled']]
  return kept[-n:] if n and len(kept) >= n else None


def traced_units(record, recorder=None) -> Optional[List[dict]]:
  """The recorder's units of the traced calls (profiled), or None."""
  recorder = recorder or _recorder()
  kind, t = _kind(record), record.get('trace')
  if recorder is None or kind is None or not t:
    return None
  n = t['calls'] * (record['steps_per_call'] if kind == 'step'
                    else record['chunks_per_call'])
  kept = [u for u in recorder.units(kind) if u['profiled']]
  return kept[-n:] if len(kept) >= n else None


def span_ms(record, names: Iterable[str], clock: str, recorder=None
            ) -> Optional[float]:
  """The summed time (`clock`: 'host_ms' or 'device_ms') of the spans
  named `names` a unit of the window."""
  units = window_units(record, recorder)
  if units and clock == 'device_ms':
    units = [u for u in units if u['timed']]
  if not units:
    return None
  spans = [s for u in units for s in u['spans'] if s['name'] in names]
  if not spans or any(s[clock] is None for s in spans):
    return None
  return sum(s[clock] for s in spans) / len(units)


def self_ms(record, name: str, recorder=None) -> Optional[float]:
  """The device time of span `name` less its children's, a unit of the
  window that the recorder timed on the device."""
  recorder = recorder or _recorder()
  units = window_units(record, recorder)
  units = [u for u in units or () if u['timed']]
  parts = [recorder.self_ms(u, name) for u in units]
  if not parts or any(p is None for p in parts):
    return None
  return sum(parts) / len(units)


def kernel_bound_s(kernel: str, work: dict) -> float:
  """The least time one launch of `kernel` with `work` (what its wrapper
  recorded) needs on the card."""
  dtype = str(work['dtype']).replace('torch.', '')
  if kernel == 'flash_attention':
    b, h, t, d = work['b'], work['h'], work['t'], work['d']
    moved = 4 * b * h * t * d * roofline.ELEMENT_BYTES[dtype]  # q, k, v, o
    return roofline.bound_s(roofline.attention_fwd_flops(b, h, t, d), moved,
                            dtype)
  if kernel in ('dropout_mask', 'dropout_mask_batch'):
    return roofline.bound_s(0.0, roofline.mask_bytes(
        work['elements'], dtype, work['masks']), dtype)
  raise ValueError(f'no bound for kernel {kernel!r}')


def roofline_share(record, kernels, category: str, recorder=None
                   ) -> Optional[float]:
  """The counted work of `kernels` in the traced calls, as the least time
  it needs, over the device time of their category there, in %."""
  t = record.get('trace')
  units = traced_units(record, recorder)
  spent = t['by_category_s'].get(category) if t else None
  if units is None or not spent:
    return None
  bound = sum(n * kernel_bound_s(kernel, dict(work))
              for u in units
              for (kernel, _, work), n in u['counts'].items()
              if kernel in kernels)
  return 100.0 * bound / spent if bound else None


def _train(read):
  def reader(record):
    return read(record) if record['entry'] == 'train' else None
  return reader


def _dense(read):
  def reader(record):
    return read(record) if record['entry'] == 'dense_eval' else None
  return reader


put_host_ms = _train(lambda r: span_ms(r, ('put',), 'host_ms'))
forward_host_ms = _train(lambda r: span_ms(r, ('forward',), 'host_ms'))
backward_host_ms = _train(lambda r: span_ms(r, ('backward',), 'host_ms'))
optimizer_host_ms = _train(lambda r: span_ms(r, ('optimizer',), 'host_ms'))
ema_host_ms = _train(lambda r: span_ms(r, ('ema',), 'host_ms'))
forward_device_ms = _train(lambda r: span_ms(r, ('forward',), 'device_ms'))
backward_device_ms = _train(lambda r: span_ms(r, ('backward',), 'device_ms'))
optimizer_device_ms = _train(
    lambda r: span_ms(r, ('optimizer',), 'device_ms'))
ema_device_ms = _train(lambda r: span_ms(r, ('ema',), 'device_ms'))
k6_roofline = _train(lambda r: roofline_share(
    r, ('dropout_mask', 'dropout_mask_batch'), K6_CATEGORY))

latent_device_ms = _dense(
    lambda r: span_ms(r, ('encoder', 'latent'), 'device_ms'))
schedule_device_ms = _dense(lambda r: span_ms(r, ('schedule',), 'device_ms'))
score_device_ms = _dense(lambda r: span_ms(r, ('score',), 'device_ms'))
decoder_device_ms = _dense(lambda r: span_ms(r, ('decoder',), 'device_ms'))
elbo_self_device_ms = _dense(lambda r: self_ms(r, 'elbo'))
k1_roofline = _dense(
    lambda r: roofline_share(r, ('flash_attention',), K1_CATEGORY))
