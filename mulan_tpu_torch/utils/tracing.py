"""The port's one recorder of where time goes and what the hand-written
kernels are asked to do. It is always on, and has no switch and no
exporter: whoever wants the numbers calls `units`.

- `unit(kind, id)` opens the root span of one unit of work: a train step
  (`kind` 'step', id the step) or a dense-VLB chunk ('chunk', id a running
  index). Its record, {'kind', 'id', 'profiled', 'timed', 'spans',
  'counts'}, holds every span opened inside it as {'name', 'parent',
  'host_ms', 'device_ms'} and its kernel launches as {(kernel, route,
  work): launches}. Spans that enclose a unit, or ran just before it
  inside the same outer span (a super-step's `train` and `put`), are
  recorded in that unit. The last `UNITS_KEPT` records are kept.
- `span(name)` times a block of code on the host clock
  (`time.perf_counter_ns`). In a timed unit (once CUDA is initialised,
  every `TIMED_EVERY`-th unit the process opens) each of the unit's spans
  also records a pair of timing events on the stream current when the
  unit opened, taken from a bounded pool; their device ms are resolved
  with `query()` when a later unit starts or when the records are read,
  so resolution never waits for the device. Each CUDA event call costs
  2-8 us on an H100's host, and the 20 events of a train step add some
  170 us to its dispatch: one unit in `TIMED_EVERY` bears that. 'device_ms' is None
  elsewhere, on the CPU and until resolved. While `torch.profiler` runs,
  a span also enters `record_function(name)`, so it lies on the
  profiler's timeline (and in `training.profile`'s Chrome trace) beside
  the kernels it launched.
- `count(kernel, route, **work)` records one launch of a hand-written
  kernel with the arguments its work follows from (shapes and dtype), in
  the open unit and in the process's totals (`launches`).

Spans and units nest as `with` blocks on one thread; a kernel launched
from autograd's thread while the caller waits in `backward()` counts in
the caller's open unit.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional

import torch

UNITS_KEPT = 4096
TIMED_EVERY = 16
EVENTS_KEPT = 1024  # timing events a device, at most


class _Span:
  """One span (a unit's root span where `kind` is set): a `with` block."""
  __slots__ = ('recorder', 'entry', 'kind', 'id', 'attached', 'events',
               'annotation', 't0', 'outer_unit')

  def __init__(self, recorder, name, kind=None, id=None):
    self.recorder, self.kind, self.id = recorder, kind, id
    self.entry = {'name': name, 'parent': None, 'host_ms': None,
                  'device_ms': None}

  def __enter__(self):
    rec, entry = self.recorder, self.entry
    if rec._open:
      entry['parent'] = rec._open[-1].entry['name']
    unit = rec._unit
    self.attached = unit is not None
    if self.attached:
      unit['spans'].append(entry)
    self.annotation = None
    if torch.autograd._profiler_enabled():
      self.annotation = torch.profiler.record_function(entry['name'])
      self.annotation.__enter__()
    if self.kind is not None:
      unit = rec._open_unit(self)
    self.events = rec._event_pair() if unit and unit['timed'] else None
    rec._open.append(self)
    self.t0 = time.perf_counter_ns()
    return self

  def __exit__(self, *exc):
    t1 = time.perf_counter_ns()
    rec, entry = self.recorder, self.entry
    if self.events is not None:
      start, end, stream = self.events
      end.record(stream)
      rec._pending.append((entry, start, end, stream.device_index))
    entry['host_ms'] = (t1 - self.t0) / 1e6
    rec._open.pop()
    if self.kind is not None:
      rec._unit = self.outer_unit
    if self.annotation is not None:
      self.annotation.__exit__(None, None, None)
    if not self.attached:
      if rec._open:
        rec._loose.append(entry)
      else:
        rec._loose = []
    return False


class Recorder:
  """Spans, units and kernel counts of one process (`RECORDER`)."""

  def __init__(self):
    self._units = collections.deque(maxlen=UNITS_KEPT)
    self._open: List[_Span] = []  # innermost last
    self._loose: List[dict] = []  # closed outside a unit, inside a span
    self._unit: Optional[dict] = None
    self._launches = collections.Counter()
    self._opened = collections.Counter()  # unit ids by kind
    self._entered = 0  # units of every kind
    self._pending = collections.deque()  # (entry, start, end, device)
    self._stream = None  # of the innermost timed unit
    self._free: Dict[int, list] = {}
    self._made: Dict[int, int] = {}

  def span(self, name: str) -> _Span:
    return _Span(self, name)

  def unit(self, kind: str, id: Optional[int] = None) -> _Span:
    """The root span of a unit; `id` defaults to the count of `kind`'s
    units opened before it in the process."""
    if id is None:
      id = self._opened[kind]
    self._opened[kind] += 1
    return _Span(self, kind, kind, id)

  def count(self, kernel: str, route: Optional[str] = None, **work) -> None:
    self._launches[kernel, route] += 1
    if self._unit is not None:
      counts = self._unit['counts']
      key = (kernel, route, tuple(sorted(work.items())))
      counts[key] = counts.get(key, 0) + 1

  def launches(self) -> collections.Counter:
    """{(kernel, route): launches} since the process started."""
    return collections.Counter(self._launches)

  def units(self, kind: Optional[str] = None) -> List[dict]:
    """The kept records of `kind` (all kinds if None), oldest first, with
    every device time the device has finished resolved."""
    self._resolve()
    return [u for u in self._units if kind is None or u['kind'] == kind]

  def _open_unit(self, s: _Span) -> dict:
    """Starts the record of unit `s`, holding the open spans outside any
    unit and those closed since inside them; returns it."""
    self._resolve()
    timed = (self._entered % TIMED_EVERY == 0
             and torch.cuda.is_initialized())
    self._entered += 1
    record = {'kind': s.kind, 'id': s.id,
              'profiled': s.annotation is not None, 'timed': timed,
              'spans': [], 'counts': {}}
    for o in self._open:
      if not o.attached:
        record['spans'].append(o.entry)
        o.attached = True
    record['spans'] += self._loose
    record['spans'].append(s.entry)
    self._loose = []
    s.attached = True
    s.outer_unit, self._unit = self._unit, record
    self._units.append(record)
    if timed:
      self._stream = torch.cuda.current_stream()
    return record

  def _event_pair(self):
    """(start recorded now, end, stream) on the timed unit's stream, or
    None when its device's pool is spent."""
    stream = self._stream
    dev = stream.device_index
    free = self._free.setdefault(dev, [])
    if len(free) < 2:
      self._resolve()
    if len(free) < 2:
      made = self._made.get(dev, 0)
      if made + 2 > EVENTS_KEPT:
        return None
      self._made[dev] = made + 2
      free += [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    start, end = free.pop(), free.pop()
    start.record(stream)
    return start, end, stream

  def _resolve(self) -> None:
    """Device times of the spans whose end the device has passed, in the
    order their ends were recorded; stops at the first it has not."""
    while self._pending:
      entry, start, end, dev = self._pending[0]
      if not end.query():
        return
      entry['device_ms'] = start.elapsed_time(end)
      self._pending.popleft()
      self._free[dev] += (start, end)


def self_ms(record: dict, name: str, clock: str = 'device_ms'
            ) -> Optional[float]:
  """The time of `name`'s spans in a unit's record less that of their
  children (the spans whose parent is `name`); None where a time is
  missing or the record has no such span."""
  spans = [s for s in record['spans'] if s['name'] == name]
  parts = spans + [s for s in record['spans'] if s['parent'] == name]
  if not spans or any(s[clock] is None for s in parts):
    return None
  return (sum(s[clock] for s in spans)
          - sum(s[clock] for s in parts[len(spans):]))


RECORDER = Recorder()
span = RECORDER.span
unit = RECORDER.unit
count = RECORDER.count
launches = RECORDER.launches
units = RECORDER.units
