"""The recorder (`mulan_tpu_torch/utils/tracing.py`) on the CPU: spans'
nesting, parents, units and self time, the bound on units kept, the
kernel counts, the program's spans in a tiny super-step and dense VLB (and
under `torch.profiler` as annotations), and the benchmark's readers of the
recorder (`benchmark/harness/program.py`) on synthetic units.
"""

import types

import numpy as np
import pytest
import torch

from benchmark.harness import program, roofline
from mulan_tpu_torch import configs
from mulan_tpu_torch.evals import vlb
from mulan_tpu_torch.train.loop import Experiment
from mulan_tpu_torch.utils import tracing
import torch_port_helpers  # noqa: F401  (caps torch threads)


def _spans(record):
  return [(s['name'], s['parent']) for s in record['spans']]


def test_spans_nest_into_units_with_parents_ids_and_self_time():
  rec = tracing.Recorder()
  with rec.span('dropped'):  # no unit opens inside: not recorded
    with rec.span('inner'):
      pass
  with rec.span('train'):
    with rec.span('put'):
      pass
    for step in (7, 8):
      with rec.unit('step', step):
        with rec.span('forward'):
          with rec.span('elbo'):
            with rec.span('score'):
              sum(range(20000))
            sum(range(20000))
  with rec.unit('chunk'), rec.unit('chunk', 5), rec.unit('chunk'):
    pass
  first, second = rec.units('step')
  assert (first['kind'], first['id'], second['id']) == ('step', 7, 8)
  assert _spans(first) == [('train', None), ('put', 'train'),
                           ('step', 'train'), ('forward', 'step'),
                           ('elbo', 'forward'), ('score', 'elbo')]
  assert _spans(second) == _spans(first)[2:]
  assert not first['profiled'] and first['counts'] == {}
  host = {s['name']: s['host_ms'] for s in first['spans']}
  assert host['train'] >= host['step'] >= host['forward'] >= host['elbo'] \
      >= host['score'] > 0
  assert all(s['device_ms'] is None for s in first['spans'])  # the CPU
  assert tracing.self_ms(first, 'elbo', 'host_ms') == pytest.approx(
      host['elbo'] - host['score'])
  assert tracing.self_ms(first, 'elbo') is None  # no device time
  assert tracing.self_ms(first, 'missing', 'host_ms') is None
  assert [u['id'] for u in rec.units('chunk')] == [0, 5, 2]
  assert [u['kind'] for u in rec.units()] == ['step'] * 2 + ['chunk'] * 3


def test_units_kept_are_the_last_4096():
  rec = tracing.Recorder()
  for i in range(tracing.UNITS_KEPT + 5):
    with rec.unit('step', i):
      pass
  kept = rec.units('step')
  assert len(kept) == 4096
  assert (kept[0]['id'], kept[-1]['id']) == (5, 4100)


def test_one_unit_in_16_is_timed_on_the_device(monkeypatch):
  """Once CUDA is initialised, the 1st, 17th, 33rd ... unit opened records
  timing events for its spans; the others, and every unit on the CPU,
  the host clock alone."""
  rec = tracing.Recorder()
  with rec.unit('step', 0):
    pass
  assert not rec.units()[0]['timed']  # CUDA not initialised
  monkeypatch.setattr(torch.cuda, 'is_initialized', lambda: True)
  monkeypatch.setattr(torch.cuda, 'current_stream',
                      lambda: types.SimpleNamespace(device_index=0))
  monkeypatch.setattr(tracing.Recorder, '_event_pair', lambda self: None)
  for i in range(1, 34):
    with rec.unit('step', i):
      pass
  assert [u['id'] for u in rec.units() if u['timed']] == [16, 32]
  assert tracing.TIMED_EVERY == 16


def test_counts_go_to_the_open_unit_and_the_totals():
  rec = tracing.Recorder()
  rec.count('dropout_mask', elements=8, dtype=torch.bfloat16, masks=1)
  with rec.unit('step', 0):
    for _ in range(3):
      rec.count('flash_attention', 'sm90', b=2, h=1, t=16, d=8,
                dtype=torch.bfloat16)
    rec.count('gn_swish_bwd', 'ring', elements=64, dtype=torch.float32)
  assert rec.launches() == {('dropout_mask', None): 1,
                            ('flash_attention', 'sm90'): 3,
                            ('gn_swish_bwd', 'ring'): 1}
  (unit,) = rec.units()
  assert unit['counts'] == {
      ('flash_attention', 'sm90', (('b', 2), ('d', 8),
                                   ('dtype', torch.bfloat16), ('h', 1),
                                   ('t', 16))): 3,
      ('gn_swish_bwd', 'ring', (('dtype', torch.float32),
                                ('elements', 64))): 1}


def _annotations(prof):
  return [(e.name(), e.start_ns(), e.end_ns())
          for e in prof.profiler.kineto_results.events()
          if e.is_user_annotation()]


def test_a_superstep_records_its_spans_and_annotates_them_when_profiled():
  """A tiny super-step of 2 steps: 'put' once, in the first step's unit
  with 'train'; each step's 'forward', 'backward', 'optimizer' and 'ema';
  `profiled` only under torch.profiler, where the four lie inside the one
  'train' annotation."""
  ex = Experiment(configs.tiny_synthetic(), device='cpu')
  ex.train_superstep(next(ex.train_iter))
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
    ex.train_superstep(next(ex.train_iter))
  units = tracing.units('step')[-4:]
  assert [(u['id'], u['profiled']) for u in units] == [
      (0, False), (1, False), (2, True), (3, True)]
  step = [('step', 'train'), ('forward', 'step'), ('elbo', 'forward'),
          ('latent', 'elbo'), ('schedule', 'elbo'), ('decoder', 'elbo'),
          ('score', 'elbo'), ('backward', 'step'), ('optimizer', 'step'),
          ('ema', 'step')]
  for first, second in (units[:2], units[2:]):
    assert _spans(first) == [('train', None), ('put', 'train')] + step
    assert _spans(second) == step
  marks = _annotations(prof)
  (train,) = [m for m in marks if m[0] == 'train']
  for name in ('put', 'forward', 'backward', 'optimizer', 'ema'):
    inside = [m for m in marks if m[0] == name]
    assert len(inside) == (1 if name == 'put' else 2), name
    assert all(train[1] <= s <= e <= train[2] for _, s, e in inside), name


def test_dense_chunks_record_the_encoder_and_the_elbos_parts():
  cfg = configs.tiny_synthetic()
  ex = Experiment(cfg, device='cpu')
  images = np.asarray(next(ex.eval_iter)['images'])[:4]
  before = len(tracing.units('chunk'))
  vlb.eval_bpd_dense(ex.state.ema_model, [{'images': images}],
                     n_timesteps=2, images_per_chunk=2,
                     generator=torch.Generator().manual_seed(0))
  chunks = tracing.units('chunk')[before:]
  assert len(chunks) == 2
  assert chunks[1]['id'] == chunks[0]['id'] + 1
  encoder = ([('encoder', 'chunk')] if vlb._shares_encoder(ex.state.ema_model)
             else [])
  assert _spans(chunks[0]) == [('chunk', None)] + encoder + [
      ('elbo', 'chunk'), ('latent', 'elbo'), ('schedule', 'elbo'),
      ('decoder', 'elbo'), ('score', 'elbo')]


# -- the benchmark's readers of the recorder ------------------------------------


def _unit(kind, i, profiled, device_ms, counts=None, timed=True):
  """A unit whose spans take `device_ms` {name: ms} (None where not
  `timed`) and half that on the host, each a child of the unit's root,
  'score' a child of 'elbo'."""
  spans = [{'name': kind, 'parent': None, 'host_ms': 100.0,
            'device_ms': 100.0 if timed else None}]
  for name, ms in device_ms.items():
    spans.append({'name': name, 'parent': 'elbo' if name == 'score' else kind,
                  'host_ms': ms / 2, 'device_ms': ms if timed else None})
  return {'kind': kind, 'id': i, 'profiled': profiled, 'timed': timed,
          'spans': spans, 'counts': counts or {}}


def _fake_recorder(units):
  return types.SimpleNamespace(
      units=lambda kind: [u for u in units if u['kind'] == kind],
      self_ms=tracing.self_ms)


K1_WORK = (('b', 512), ('d', 128), ('dtype', torch.bfloat16), ('h', 1),
           ('t', 1024))


def test_readers_take_the_windows_units_and_compute_by_hand():
  """Set-up's units, then the window's 2 calls of 2 chunks (the last not
  timed on the device), then the one traced call's 2 chunks: the span
  readers read the window's 4 on the host and its 3 timed on the device,
  the roofline the traced 2 against the category's time."""
  setup = [_unit('chunk', i, False, {'elbo': 1000.0, 'score': 1000.0})
           for i in range(3)]
  window = [_unit('chunk', 3 + i, False,
                  {'encoder': 1.0, 'elbo': 10.0 + i, 'score': 6.0},
                  timed=i < 3)
            for i in range(4)]
  traced = [_unit('chunk', 7 + i, True, {'elbo': 5.0},
                  {('flash_attention', 'sm90', K1_WORK): 1,
                   ('flash_attention', 'sm90', (('b', 4),) + K1_WORK[1:]): 1,
                   ('decoder_logprob', None, (('pixels', 9),)): 1})
            for i in range(2)]
  rec = _fake_recorder(setup + window + traced)
  record = {'entry': 'dense_eval', 'chunks_per_call': 2,
            'window': {'values': [0.0, 0.0]},
            'trace': {'calls': 1, 'by_category_s': {
                program.K1_CATEGORY: 2e-3}}}
  assert program.window_units(record, rec) == window
  assert program.traced_units(record, rec) == traced
  assert program.span_ms(record, ('encoder', 'score'), 'device_ms',
                         rec) == 7.0
  assert program.span_ms(record, ('elbo',), 'host_ms', rec) == 5.75
  # elbo's self time on the device: (10 + 11 + 12) / 3 less the score's 6.
  assert program.self_ms(record, 'elbo', rec) == 5.0
  by_hand = 0.0
  for b in (512, 4):
    flops = 4 * b * 1024 * 1024 * 128
    moved = 4 * b * 1024 * 128 * 2
    by_hand += max(flops / 989e12, moved / 3.35e12)
  got = program.roofline_share(record, ('flash_attention',),
                               program.K1_CATEGORY, rec)
  assert got == pytest.approx(100 * 2 * by_hand / 2e-3)
  assert by_hand == pytest.approx(
      roofline.attention_fwd_flops(516, 1, 1024, 128) / 989e12)


def test_readers_read_nothing_where_units_or_times_are_missing():
  window = [_unit('step', i, False, {'forward': 3.0}) for i in range(3)]
  rec = _fake_recorder(window)
  record = {'entry': 'train', 'steps_per_call': 1,
            'window': {'steps': 3}, 'trace': None}
  for u in window:
    u['timed'] = False
  assert program.span_ms(record, ('forward',), 'host_ms', rec) == 1.5
  assert program.span_ms(record, ('forward',), 'device_ms', rec) is None
  assert program.self_ms(record, 'forward', rec) is None
  for u in window:
    u['timed'] = True
  record = {'entry': 'train', 'steps_per_call': 1,
            'window': {'steps': 3},
            'trace': {'calls': 1, 'by_category_s': {}}}
  assert program.span_ms(record, ('forward',), 'device_ms', rec) == 3.0
  assert program.span_ms(record, ('put',), 'host_ms', rec) is None
  record['window']['steps'] = 4  # more steps than units kept
  assert program.span_ms(record, ('forward',), 'device_ms', rec) is None
  record['window']['steps'] = 3
  window[1]['spans'][1]['device_ms'] = None  # not resolved
  assert program.span_ms(record, ('forward',), 'device_ms', rec) is None
  # No traced unit, and a category that reads no time.
  assert program.roofline_share(record, ('dropout_mask',),
                                program.K6_CATEGORY, rec) is None
  assert program.k6_roofline({'entry': 'dense_eval'}) is None


@pytest.mark.parametrize('entry', ['train', 'dense_eval'])
def test_k8_roofline_reads_the_counted_groupnorm_swish_work(entry):
  """`k8_roofline.train` and `.eval` (`benchmark/harness/gn_roofline.py`)
  on synthetic traced units: the counted K8 launches' bytes (the forward's
  x and y; in training also the backward's x, dy and dx) at 3.35 TB/s over
  K8's categories' time, by hand; None where nothing was counted or the
  categories read no time (the program before K8 ran its unfused sites),
  and in the other entry's cells."""
  from benchmark.harness import gn_roofline
  kind = 'step' if entry == 'train' else 'chunk'
  elements = 128 * 256 * 32 * 32
  work = (('arithmetic', 'unfused'), ('dtype', torch.bfloat16),
          ('elements', elements))
  counts = {('gn_swish', None, work): 3, ('gn_swish_bwd', 'ring', work): 3,
            ('flash_attention', 'sm90', K1_WORK): 1}
  rec = _fake_recorder([_unit(kind, i, True, {}, counts) for i in range(2)])
  categories = {gn_roofline.FWD_CATEGORY: 1e-3, gn_roofline.BWD_CATEGORY:
                2e-3}
  record = {'entry': entry, 'steps_per_call': 2, 'chunks_per_call': 2,
            'trace': {'calls': 1, 'by_category_s': categories}}
  fwd = 6 * 2 * elements * 2 / 3.35e12
  bwd = 6 * 3 * elements * 2 / 3.35e12
  if entry == 'train':
    kernels, cats, want = (('gn_swish', 'gn_swish_bwd'), tuple(categories),
                           100 * (fwd + bwd) / 3e-3)
  else:
    kernels, cats, want = (('gn_swish',), (gn_roofline.FWD_CATEGORY,),
                           100 * fwd / 1e-3)
  assert gn_roofline.share(record, kernels, cats, rec) == pytest.approx(want)
  assert fwd == pytest.approx(roofline.gn_swish_bytes(6 * elements)
                              / 3.35e12)
  empty = _fake_recorder([_unit(kind, i, True, {}, {}) for i in range(2)])
  assert gn_roofline.share(record, kernels, cats, empty) is None
  record['trace']['by_category_s'] = {}
  assert gn_roofline.share(record, kernels, cats, rec) is None
  other = {'train': gn_roofline.dense_eval, 'dense_eval': gn_roofline.train}
  assert other[entry]({'entry': entry}) is None
