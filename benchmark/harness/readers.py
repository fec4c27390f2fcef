"""The readers of the per-layer metrics: each takes the record of a
`--trace 1` run (`entries/*.py`: the measured window's host spans and
timings, and `trace` from `harness/trace.py`) and returns the metric, or
None where the record holds nothing to read. Each metric's file under
`benchmark/metrics/` names the reader it uses."""

from benchmark.harness import stats
from benchmark.harness import trace


def host_ms_per_chunk(record):
  """Host milliseconds a dense-VLB chunk: from the start of a traced
  `eval_bpd_dense` call to the host's read of its result (the last
  `aten::item` in the call), over the call's chunks."""
  t = record.get('trace')
  if record['entry'] != 'dense_eval' or not t:
    return None
  spent = []
  for name, lo, hi in t['spans']:
    if name != 'call':
      continue
    reads = [s for s, _ in t['syncs'] if lo <= s <= hi]
    if reads:
      spent.append(max(reads) - lo)
  if not spent:
    return None
  return 1e3 * sum(spent) / (len(spent) * record['chunks_per_call'])


def host_ms_per_step(record):
  """Host milliseconds a train step spends inside `train_superstep`
  (dispatch, autograd, the optimizer and EMA calls; it includes the host's
  waits when the launch queue is full), over every step of the measured
  window."""
  if record['entry'] != 'train':
    return None
  w = record['window']
  return 1e3 * sum(w['call_s']) / w['steps']


def idle_share_eval(record):
  """The share of a dense-VLB chunk's time in which no operation ran on
  the device, in %: 1 - (the union of device intervals a chunk in the
  traced calls) / (the wall time a chunk in the measured window). The
  profiler slows the host but not the device's work, so the device's
  time is read in the trace and the wall time without it."""
  t = record.get('trace')
  if record['entry'] != 'dense_eval' or not t or not t['kernels']:
    return None
  w = record['window']
  chunks = len(w['values']) * record['chunks_per_call']
  busy = t['busy_s'] / (t['calls'] * record['chunks_per_call'])
  return 100.0 * (1.0 - busy / (w['seconds'] / chunks))


def idle_share(record):
  """The share of a train step's time in which no operation ran on the
  device, in %: 1 - (the union of device intervals a step in the traced
  calls) / (the wall time a step in the measured window), as
  `idle_share_eval` reads it."""
  t = record.get('trace')
  if record['entry'] != 'train' or not t or not t['kernels']:
    return None
  w = record['window']
  busy = t['busy_s'] / (t['calls'] * record['steps_per_call'])
  return 100.0 * (1.0 - busy / (w['seconds'] / w['steps']))


def input_wait_ms(record):
  """Host milliseconds a train step spends in `next(train_iter)`: the wait
  for the program's input pipeline (`data.py`, its prefetch thread), over
  every step of the measured window."""
  if record['entry'] != 'train':
    return None
  w = record['window']
  return 1e3 * sum(w['input_s']) / w['steps']


def kernel_ms_per_chunk(record):
  """Milliseconds of device kernels a dense-VLB chunk, summed over the
  kernels of the traced calls."""
  t = record.get('trace')
  if record['entry'] != 'dense_eval' or not t or not t['kernels']:
    return None
  return 1e3 * t['kernel_s'] / (t['calls'] * record['chunks_per_call'])


def kernel_ms_per_step(record):
  """Milliseconds of device kernels a train step, summed over the kernels of
  the traced calls (overlapping kernels counted each)."""
  t = record.get('trace')
  if record['entry'] != 'train' or not t or not t['kernels']:
    return None
  return 1e3 * t['kernel_s'] / (t['calls'] * record['steps_per_call'])


def launches_per_step(record):
  """Device kernels a train step launches, counted in the traced calls
  (copies and fills left out)."""
  t = record.get('trace')
  if record['entry'] != 'train' or not t or not t['kernels']:
    return None
  return t['kernels'] / (t['calls'] * record['steps_per_call'])


def layout_ms_per_step(record):
  """Milliseconds a train step of the NCHW <-> NHWC layout transposes that
  cuDNN runs around the convolutions (the category table's 'layout
  transposes'), in the traced calls."""
  t = record.get('trace')
  if record['entry'] != 'train' or not t or not t['kernels']:
    return None
  layout = t['by_category_s'].get(trace.LAYOUT)
  if not layout:
    return None
  return 1e3 * layout / (t['calls'] * record['steps_per_call'])


def mfu_eval(record):
  """The dense VLB's share of the card's bf16 peak: the FLOPs a chunk needs
  (`harness/flops.py`) times the chunks a second of the measured window,
  over 989 TFLOP/s, in %."""
  if record['entry'] != 'dense_eval' or not record['on_card']:
    return None
  w = record['window']
  chunks = len(w['values']) * record['chunks_per_call']
  achieved = record['flops_per_chunk'] * chunks / w['seconds']
  return 100.0 * achieved / record['peak_flops']


def mfu(record):
  """The train step's share of the card's bf16 peak: the FLOPs a step needs
  (`harness/flops.py`, from the configuration's shapes) times the steps a
  second of the measured window, over 989 TFLOP/s, in %."""
  if record['entry'] != 'train' or not record['on_card']:
    return None
  w = record['window']
  achieved = record['flops_per_step'] * w['steps'] / w['seconds']
  return 100.0 * achieved / record['peak_flops']


def step_ms_p90(record):
  """The 90th percentile (nearest rank) over every step of the measured
  window of the interval between consecutive step-end CUDA events, the
  first from an event at the window's start: the tail of a host-paced
  step."""
  if record['entry'] != 'train' or not record['on_card']:
    return None
  per_step = record['steps_per_call']
  return stats.percentile([ms / per_step for ms in
                           record['window']['event_ms']], 90)
