"""The attention kernels' routes, their C entry points, the build's cache
key and the kernel ablation specs, on the CPU (no nvcc, no card).

`attention_route(dtype, head_dim)` picks the C entry point of K1, K2 and K3
alike: the 'sm90' route (TMA-fed, warp-specialised wgmma kernels) for
bfloat16 with head_dim <= 256, the 'simt' route for float32. The kernels
themselves are held against the plain versions on the card by
chip_smoke.py, which also asserts that every K1, K2 and K3 launch of the
flagship's paths (head_dim 128) and of imagenet32's (head_dim 256) took the
'sm90' route.
"""

import json
import pathlib
import re
import shutil

import pytest
import torch

from mulan_tpu_torch.ops import _build
from mulan_tpu_torch.ops import flash_attention as attn_ops
import torch_port_helpers  # noqa: F401  (caps torch threads)

WRAPPERS = (attn_ops.flash_attention, attn_ops.flash_attention_bwd_dkv,
            attn_ops.flash_attention_bwd_dq)


ROUTE_TABLE = [
    (torch.bfloat16, 128, 'sm90'),  # the flagship's
    (torch.bfloat16, 64, 'sm90'),
    (torch.bfloat16, 40, 'sm90'),  # a 64-column box
    (torch.bfloat16, 8, 'sm90'),
    (torch.bfloat16, 136, 'sm90'),
    (torch.bfloat16, 200, 'sm90'),  # ragged in D
    (torch.bfloat16, 256, 'sm90'),  # imagenet32's
    (torch.float32, 256, 'simt'),
    (torch.float32, 128, 'simt'),
    (torch.float32, 64, 'simt'),
]


@pytest.mark.parametrize('dtype, head_dim, route', ROUTE_TABLE)
def test_route_table(dtype, head_dim, route):
  assert attn_ops.attention_route(dtype, head_dim) == route
  assert route in attn_ops.ROUTES


def _call_fwd(q, rows):
  return attn_ops.flash_attention_fwd(q, q, q, 0.5, return_lse=True)


def _call_dkv(q, rows):
  return attn_ops.flash_attention_bwd_dkv(q, q, q, q, rows, rows, 0.5)


def _call_dq(q, rows):
  return attn_ops.flash_attention_bwd_dq(q, q, q, q, rows, rows, 0.5)


@pytest.mark.parametrize('entry, wrapper, call', [
    ('mulan_flash_attention_fwd', attn_ops.flash_attention, _call_fwd),
    ('mulan_flash_attention_bwd_dkv', attn_ops.flash_attention_bwd_dkv,
     _call_dkv),
    ('mulan_flash_attention_bwd_dq', attn_ops.flash_attention_bwd_dq,
     _call_dq),
], ids=('fwd', 'dkv', 'dq'))
@pytest.mark.parametrize('dtype, head_dim, route', ROUTE_TABLE)
def test_wrapper_calls_its_routes_entry_point(monkeypatch, entry, wrapper,
                                              call, dtype, head_dim, route):
  """Each wrapper calls `{entry}_{route}` once, with arguments that its
  ctypes signature takes (is_bf16 = 0 on 'simt', which runs float32), and
  counts the launch on that route. The card is stood in for by meta
  tensors, a recording library and a null stream."""
  calls = []

  class Library:
    def __getattr__(self, name):
      return lambda *args: calls.append((name, args)) or 0
  monkeypatch.setattr(_build, 'load_library', Library)
  monkeypatch.setattr(attn_ops, '_check_inputs', lambda *a: None)
  monkeypatch.setattr(attn_ops, '_check_rows', lambda *a: None)
  monkeypatch.setattr(attn_ops, '_stream', lambda t: None)
  monkeypatch.setattr(wrapper, 'launches', 0)
  monkeypatch.setattr(wrapper, 'launches_by_route',
                      dict.fromkeys(attn_ops.ROUTES, 0))
  q = torch.empty((2, 3, 16, head_dim), dtype=dtype, device='meta')
  call(q, torch.empty((2, 3, 16), device='meta'))
  (name, args), = calls
  assert name == f'{entry}_{route}'
  argtypes = _build._SIGNATURES[name]
  assert len(args) == len(argtypes), (name, args)
  for arg, argtype in zip(args, argtypes):
    argtype.from_param(arg)  # raises on an argument of the wrong type
  scale_at = argtypes.index(_build._F)  # after batch*heads, tokens, head_dim
  assert args[scale_at - 3:scale_at + 1] == (6, 16, head_dim, 0.5)
  assert args[scale_at + 1:-1] == ((0,) if route == 'simt' else ())
  assert wrapper.launches == 1
  assert wrapper.launches_by_route == {r: int(r == route)
                                       for r in attn_ops.ROUTES}


def test_every_wrapper_counts_by_route():
  for wrapper in WRAPPERS:
    assert set(wrapper.launches_by_route) == set(attn_ops.ROUTES)


def _entry_points():
  """{name: number of parameters} of every extern "C" function in csrc/."""
  found = {}
  for path in _build._CSRC.glob('*.cu'):
    text = path.read_text()
    for m in re.finditer(r'extern "C" [\w ]+?\*?\s*(mulan_\w+)\(([^)]*)\)',
                         text):
      found[m.group(1)] = len([a for a in m.group(2).split(',') if a.strip()])
  return found


def test_signatures_match_the_sources():
  """Every ctypes signature names an entry point of csrc/ with as many
  parameters, and each route of K1, K2 and K3 has its own entry point."""
  entries = _entry_points()
  for name, argtypes in _build._SIGNATURES.items():
    assert entries.get(name) == len(argtypes), (name, entries.get(name))
  for entry in ('mulan_flash_attention_fwd', 'mulan_flash_attention_bwd_dkv',
                'mulan_flash_attention_bwd_dq'):
    assert entry not in entries, entry  # no entry point chooses in C
    for route in attn_ops.ROUTES:
      assert f'{entry}_{route}' in _build._SIGNATURES, (entry, route)


def test_tensor_core_kernels_are_the_sm90_ones():
  """flash_fwd_mma, flash_bwd_dkv_mma, flash_bwd_dq_mma and every mma.sync
  are gone; the sm90 kernels keep the flash_fwd / flash_bwd prefixes by
  which profiles file them."""
  text = ''.join(p.read_text() for p in _build._CSRC.iterdir())
  for gone in ('flash_fwd_mma', 'flash_bwd_dkv_mma', 'flash_bwd_dq_mma',
               'mma.sync', 'mma_bf16', 'load_rows_t', 'kLdT'):
    assert gone not in text, gone
  for kernel in ('flash_fwd_sm90', 'flash_bwd_dkv_sm90', 'flash_bwd_dq_sm90',
                 'flash_fwd_sm90_d256', 'flash_bwd_dkv_sm90_d256',
                 'flash_bwd_dq_sm90_d256', 'flash_fwd_simt', 'flash_bwd_dkv',
                 'flash_bwd_dq'):
    assert re.search(rf'\b{kernel}\s*\(', text), kernel
  assert '#include "sm90.cuh"' in (_build._CSRC /
                                   'flash_attention.cu').read_text()
  assert '#include "sm90.cuh"' in (_build._CSRC /
                                   'flash_attention_bwd.cu').read_text()


_ABLATIONS = sorted((pathlib.Path(_build.__file__).parent / 'ablations')
                    .glob('*.json'))


def test_every_kernel_redesign_has_an_ablation_spec():
  names = {p.name for p in _ABLATIONS}
  assert {'k1_fwd.json', 'k2_dkv.json', 'k3_dq.json', 'k1_fwd_d256.json',
          'k2_dkv_d256.json', 'k3_dq_d256.json', 'k4_decoder.json',
          'k5_bwd.json', 'k6_mask.json', 'k8_gn.json',
          'k8_bwd.json'} <= names, names


@pytest.mark.parametrize('spec_path', _ABLATIONS, ids=lambda p: p.stem)
def test_ablation_spec_matches_the_sources(spec_path):
  """A spec names an existing source and known entry points, and every
  variant's `old` text occurs in csrc/ (a stale ablation fails here, not on
  the card); 'tree' is the source as it is."""
  spec = json.loads(spec_path.read_text())
  assert (_build._CSRC / spec['file']).is_file(), spec['file']
  assert spec['entries'], spec_path
  source = (_build._CSRC / spec['file']).read_text()
  for entry in spec['entries']:
    assert entry in _build._SIGNATURES, entry
    assert re.search(rf'extern "C" [\w ]+?\*?\s*{entry}\(', source), entry
  assert spec['variants']['tree'] == []
  texts = [p.read_text() for p in _build._CSRC.iterdir()]
  for name, subs in spec['variants'].items():
    for old, new in subs:
      assert old != new, (name, old)
      assert any(old in text for text in texts), (name, old[:60])
  if 'show' in spec:
    assert re.search(rf'\b{spec["show"]}\s*\(', source), spec['show']
  if 'shape' in spec:  # (B, H, T, D) of the attention kernels' inputs
    assert len(spec['shape']) == 4, spec['shape']
    assert all(e.startswith('mulan_flash_attention') for e in
               spec['entries']), spec['entries']


def test_ablation_inputs_take_a_specs_shape():
  """The D <= 256 specs time K1, K2 and K3 at imagenet32's train-step
  shape."""
  from mulan_tpu_torch.ops import ablate
  for name in ('k1_fwd_d256.json', 'k2_dkv_d256.json', 'k3_dq_d256.json'):
    spec = json.loads((_ABLATIONS[0].parent / name).read_text())
    assert spec['shape'] == [128, 1, 1024, 256], name
  inputs = ablate.make_inputs(torch.device('cpu'), (2, 1, 16, 256))
  q, k, v, do, lse, di = inputs['attn']
  assert q.shape == do.shape == (2, 1, 16, 256) and q.dtype == torch.bfloat16
  assert lse.shape == di.shape == (2, 1, 16)


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
  copy = tmp_path / 'csrc'
  shutil.copytree(_build._CSRC, copy)
  monkeypatch.setattr(_build, '_CSRC', copy)
  return copy


@pytest.mark.parametrize('name', ['sm90.cuh', 'flash_attention.cu'])
def test_library_path_follows_every_source(csrc_copy, name):
  """An edit to a header alone gives another library, as one to a .cu
  does; undoing it gives the first one back."""
  before = _build._library_path()
  path = csrc_copy / name
  text = path.read_text()
  path.write_text(text + '\n// edited\n')
  edited = _build._library_path()
  assert edited != before
  assert edited.parent.parent == before.parent.parent == _build._BUILD
  path.write_text(text)
  assert _build._library_path() == before


def test_library_path_follows_a_new_file_and_the_flags(csrc_copy,
                                                      monkeypatch):
  before = _build._library_path()
  (csrc_copy / 'extra.cuh').write_text('#pragma once\n')
  with_header = _build._library_path()
  assert with_header != before
  monkeypatch.setattr(_build, 'NVCC_FLAGS', (*_build.NVCC_FLAGS, '-lineinfo'))
  assert _build._library_path() != with_header


def _qkv(device, dtype=torch.float32, shape=(1, 1, 8, 8)):
  return tuple(torch.zeros(shape, dtype=dtype, device=device)
               for _ in range(4))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_wrappers_raise_off_cpu_and_cuda(dtype):
  """A tensor on neither device never takes the plain version or a
  kernel: every wrapper raises, whatever its route would be."""
  q, k, v, do = _qkv('meta', dtype)
  rows = torch.zeros((1, 1, 8), device='meta')
  with pytest.raises(ValueError, match='unsupported device'):
    attn_ops.flash_attention(q, k, v, 1.0)
  with pytest.raises(ValueError, match='unsupported device'):
    attn_ops.flash_attention_fwd(q, k, v, 1.0, return_lse=True)
  with pytest.raises(ValueError, match='unsupported device'):
    attn_ops.flash_attention_bwd_dkv(q, k, v, do, rows, rows, 1.0)
  with pytest.raises(ValueError, match='unsupported device'):
    attn_ops.flash_attention_bwd_dq(q, k, v, do, rows, rows, 1.0)
  with pytest.raises(ValueError, match='unsupported device'):
    attn_ops.flash_attention_bwd(q, k, v, q, rows, do, 1.0)


def test_kernel_wrappers_take_no_cpu_tensors():
  """K2's and K3's wrappers launch kernels only; the CPU's plain backward
  is reached through flash_attention_bwd."""
  q, k, v, do = _qkv('cpu', torch.bfloat16)
  rows = torch.zeros((1, 1, 8))
  with pytest.raises(ValueError, match='unsupported device'):
    attn_ops.flash_attention_bwd_dkv(q, k, v, do, rows, rows, 1.0)
  with pytest.raises(ValueError, match='unsupported device'):
    attn_ops.flash_attention_bwd_dq(q, k, v, do, rows, rows, 1.0)


@pytest.mark.parametrize('dtype, head_dim', [(torch.bfloat16, 128),
                                             (torch.float32, 32)])
def test_cpu_calls_launch_nothing(dtype, head_dim):
  """The plain versions on the CPU count no launch on any route."""
  shape = (2, 1, 16, head_dim)
  gen = torch.Generator().manual_seed(0)
  q, k, v, do = (torch.randn(shape, generator=gen).to(dtype)
                 for _ in range(4))
  before = [(w.launches, dict(w.launches_by_route)) for w in WRAPPERS]
  o, lse = attn_ops.flash_attention_fwd(q, k, v, head_dim ** -0.5,
                                        return_lse=True)
  grads = attn_ops.flash_attention_bwd(q, k, v, o, lse, do, head_dim ** -0.5)
  assert o.shape == shape and lse.shape == shape[:3]
  assert all(g.shape == shape and g.dtype == dtype for g in grads)
  assert [(w.launches, dict(w.launches_by_route)) for w in WRAPPERS] == before
