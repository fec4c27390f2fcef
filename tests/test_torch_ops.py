"""The port's kernel modules (mulan_tpu_torch/ops) against the JAX package.

On the CPU the wrappers run their plain PyTorch versions; the CUDA kernels
themselves are held against those plain versions on the card by
chip_smoke.py. JAX runs its Pallas paths as its own tests do off-TPU: the
decoder kernel in interpret mode, flash attention through `_reference_fwd`
(interpret=True). Inputs are float32 from numpy seeds.
"""

from jax.experimental.pallas.ops.tpu import flash_attention as fa
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mulan_tpu.models import encdec as jax_encdec
from mulan_tpu.ops import flash_bwd
from mulan_tpu.ops.decoder_logprob import decoder_logprob as jax_decoder
from mulan_tpu_torch.ops import decoder_logprob as dec_ops
from mulan_tpu_torch.ops import flash_attention as attn_ops
from mulan_tpu_torch.utils import tracing
import torch_port_helpers  # noqa: F401  (caps torch threads)

# Float32 on both sides; only the order of the sums differs.
RTOL, ATOL = 1e-5, 1e-6


@pytest.mark.parametrize('shape', [(2, 1, 64, 32), (3, 2, 60, 16),
                                   (1, 1, 100, 8)])
def test_flash_attention_plain_matches_jax(shape):
  """Includes T=60 and T=100, which leave a ragged last 64-row tile."""
  rs = np.random.RandomState(0)
  q, k, v = (rs.standard_normal(shape).astype(np.float32) for _ in range(3))
  scale = shape[-1] ** -0.5
  sizes = fa.BlockSizes.get_default(*shape[:3], shape[2], shape[3])
  want = flash_bwd.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), scale, sizes,
                                   interpret=True)
  tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
  before = tracing.launches()
  got = attn_ops.flash_attention(tq, tk, tv, scale)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                             atol=ATOL)
  np.testing.assert_array_equal(
      got.numpy(), attn_ops.flash_attention_plain(tq, tk, tv, scale).numpy())
  assert tracing.launches() == before  # no kernel on the CPU


@pytest.mark.parametrize('shape', [(2, 1, 130, 256), (1, 2, 100, 256)])
def test_flash_attention_plain_lse_matches_jax_reference_fwd(shape):
  """The plain forward with its row log-sum-exp at head_dim 256, which K1's
  kernel for 128 < D <= 256 is held against on the card, against JAX's
  `_reference_fwd` (the interpret path of `_fwd`, which saves l and m under
  AD): o, and the lse against m + log l. T = 130 and 100 leave a ragged last
  80-key tile."""
  rs = np.random.RandomState(1)
  q, k, v = (rs.standard_normal(shape).astype(np.float32) for _ in range(3))
  scale = shape[-1] ** -0.5
  want_o, l, m = flash_bwd._reference_fwd(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), scale)
  got_o, got_lse = attn_ops.flash_attention_plain(
      *(torch.from_numpy(a) for a in (q, k, v)), scale, return_lse=True)
  assert got_lse.shape == shape[:3] and got_lse.dtype == torch.float32
  np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=RTOL,
                             atol=ATOL)
  np.testing.assert_allclose(got_lse.numpy(), np.asarray(m + jnp.log(l)),
                             rtol=RTOL, atol=ATOL)


def test_wrappers_raise_off_cpu_and_cuda():
  """A tensor that is not on the CPU never takes the plain version."""
  q = torch.empty((1, 1, 8, 8), device='meta')
  with pytest.raises(ValueError, match='unsupported device'):
    attn_ops.flash_attention(q, q, q, 1.0)
  x = torch.empty((1, 4, 4, 3), device='meta')
  with pytest.raises(ValueError, match='unsupported device'):
    dec_ops.decoder_logprob(x, x, x)


@pytest.mark.parametrize('g0_kind', ['per_pixel', 'per_example', 'scalar'])
def test_decoder_logprob_matches_jax(g0_kind):
  rs = np.random.RandomState(1)
  shape = (3, 4, 4, 3)
  x = rs.randint(0, 256, size=shape).astype(np.float32)
  g0 = {'per_pixel': rs.uniform(-13.3, 5.0, size=shape),
        'per_example': rs.uniform(-13.3, 5.0, size=(3, 1, 1, 1)),
        'scalar': np.array(-13.3)}[g0_kind].astype(np.float32)
  z = (2 * (x + 0.5) / 256 - 1 + np.exp(0.5 * g0)
       * rs.standard_normal(shape)).astype(np.float32)
  want_kernel = jax_decoder(jnp.asarray(x), jnp.asarray(z), jnp.asarray(g0),
                            256)
  want_plain = jax_encdec.logprob(jnp.asarray(x), jnp.asarray(z),
                                  jnp.asarray(g0), 256)
  before = tracing.launches()
  got = dec_ops.decoder_logprob(torch.from_numpy(x), torch.from_numpy(z),
                                torch.from_numpy(g0))
  assert got.shape == (3,)
  # Sums of 48 per-pixel terms of up to ~1e4 nats at gamma_min.
  np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel),
                             rtol=RTOL, atol=1e-3)
  np.testing.assert_allclose(got.numpy(), np.asarray(want_plain), rtol=RTOL,
                             atol=1e-3)
  assert tracing.launches() == before


def test_encode_matches_jax():
  x = np.arange(256, dtype=np.float32) + np.float32(0.3)
  np.testing.assert_array_equal(
      dec_ops.encode(torch.from_numpy(x), 256).numpy(),
      np.asarray(jax_encdec.encode(jnp.asarray(x), 256)))


def test_logsumexp_window_drops_only_vanishing_terms():
  """K4's window (`logsumexp_window`, computed in float32 as the kernel
  does) against the full 256-bin sum in float64, for g0 over [gamma_min,
  gamma_max] and z over [-1.5, 1.5] with the bin edges among them: every
  bin left out has l_v - max_v l_v < -104, so the windowed logsumexp is the
  full one to float64 rounding; at gamma_min the window is 9 bins inside
  the vocab's range."""
  vocab = 256
  rs = np.random.RandomState(0)
  g0 = np.concatenate([np.linspace(-13.3, 5.0, 37), rs.uniform(-13.3, 5.0,
                                                               11)])
  edges = -1.0 + 2.0 * np.arange(0, vocab + 1, 17) / vocab
  z = np.concatenate([np.linspace(-1.5, 1.5, 401), rs.uniform(-1.5, 1.5, 97),
                      edges, edges + 1e-6, edges - 1e-6])
  g0, z = (a.ravel() for a in np.meshgrid(g0, z))
  first, last = dec_ops.logsumexp_window(
      torch.from_numpy(z.astype(np.float32)),
      torch.from_numpy(g0.astype(np.float32)), vocab)
  first, last = first.numpy()[:, None], last.numpy()[:, None]
  v = np.arange(vocab)
  e = 2.0 * (v + 0.5) / vocab - 1.0
  logits = -0.5 * ((z[:, None] - e) * np.exp(-0.5 * g0[:, None])) ** 2
  rel = logits - logits.max(axis=1, keepdims=True)
  inside = (v >= first) & (v <= last)
  assert (rel[~inside] < -104).all(), rel[~inside].max()
  full = np.log(np.exp(rel).sum(axis=1))
  window = np.log(np.where(inside, np.exp(rel), 0.0).sum(axis=1))
  np.testing.assert_allclose(window, full, rtol=0, atol=1e-15)
  at_min = (g0 == -13.3) & (np.abs(z) < 1 - 4 * 2 / vocab)
  assert at_min.any()
  assert ((last - first)[at_min] == 8).all()


# -- K8 in the unfused arithmetic (the unfused GroupNorm -> swish sites) ------


def _gn_inputs(shape, dtype, seed):
  gen = torch.Generator().manual_seed(seed)
  x = (2 * torch.randn(shape, generator=gen) + 0.5).to(dtype)
  dy = torch.randn(shape, generator=gen).to(dtype)
  w = 1 + 0.1 * torch.randn(shape[1], generator=gen)
  b = 0.1 * torch.randn(shape[1], generator=gen)
  return x, dy, w, b


# The twin against the pair on the CPU. Float32: nothing is rounded between
# the steps, only the sums' orders differ. bf16: the CPU's GroupNorm applies
# its float32 mean and rstd where the card's (and the twin) apply them
# rounded to bf16, which moves an output by up to ~0.3% of the largest
# (measured: 0.25-0.33%) beyond its one ulp; autograd rounds silu's
# gradient to bf16 where the closed form keeps it in float32 (0.4-0.6% of
# the largest dx, 0.2-0.4% of dweight's and dbias's).
UNFUSED_FWD_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -7,
                                                                 2 ** -7)}
UNFUSED_BWD_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -5}


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape, groups', [((2, 64, 8, 8), 32),
                                           ((3, 48, 5, 7), 16),
                                           ((4, 128, 16, 16), 32)])
def test_gn_swish_unfused_plain_matches_the_pair(shape, groups, dtype):
  """The plain twin of the unfused arithmetic against F.silu(F.group_norm(x,
  G, w.to(x.dtype), b.to(x.dtype), 1e-6)) and its closed-form backward
  against autograd of the pair: the output elementwise (rtol, and atol as
  a share of the largest output), dx, dweight and dbias as max |twin -
  autograd| over max |autograd| (UNFUSED_*)."""
  import torch.nn.functional as F
  from mulan_tpu_torch.ops import groupnorm_swish as gn_ops
  x, dy, w, b = _gn_inputs(shape, dtype, 5)
  xg, wg, bg = (t.clone().requires_grad_() for t in (x, w, b))
  want = F.silu(F.group_norm(xg, groups, wg.to(dtype), bg.to(dtype), 1e-6))
  auto = torch.autograd.grad(want, (xg, wg, bg), dy)
  out, stats = gn_ops.gn_swish_plain(x, w, b, groups, 1e-6, True, 'unfused')
  assert out.dtype == dtype and stats.dtype == torch.float32
  # The statistics are those of the pair's type.
  assert torch.equal(stats, stats.to(dtype).float())
  rtol, atol = UNFUSED_FWD_TOL[dtype]
  want = want.detach().float()
  np.testing.assert_allclose(out.float().numpy(), want.numpy(), rtol=rtol,
                             atol=atol * want.abs().max().item())
  got = gn_ops.gn_swish_bwd_plain(x, w, b, dy, groups, 1e-6, stats,
                                  'unfused')
  assert [t.dtype for t in got] == [dtype, torch.float32, torch.float32]
  for g, a in zip(got, auto):
    err = ((g.float() - a.float()).abs().max()
           / a.float().abs().max()).item()
    assert err <= UNFUSED_BWD_RTOL[dtype], err


@pytest.mark.parametrize('kind', ['fwd', 'ring', 'regs'])
def test_gn_swish_unfused_reaches_the_kernels_and_the_count(monkeypatch,
                                                            kind):
  """On the card the wrappers pass the arithmetic to the C entry point
  (the flag after is_bf16: 1 for 'unfused', 0 for 'fused') with arguments
  its ctypes signature takes, and count each launch with the arithmetic in
  its work (the card stood in for by meta tensors, a recording library and
  a null stream)."""
  from mulan_tpu_torch.ops import groupnorm_swish as gn_ops
  calls = []

  class Library:
    def __getattr__(self, name):
      return lambda *args: calls.append((name, args)) or 0
  monkeypatch.setattr(gn_ops._build, 'load_library', Library)
  monkeypatch.setattr(gn_ops, '_check_args', lambda *a: None)
  monkeypatch.setattr(gn_ops, '_stream', lambda t: None)
  monkeypatch.setattr(gn_ops, '_counters', lambda d, s, g: torch.empty(
      g, dtype=torch.int32, device='meta'))
  shape, groups = ((2, 64, 8, 8), 32) if kind != 'regs' else (
      (2, 64, 5, 7), 32)
  x = torch.empty(shape, dtype=torch.bfloat16, device='meta')
  w = torch.empty(shape[1], device='meta')
  stats = torch.empty((shape[0], groups, 2), device='meta')
  for arithmetic in gn_ops.ARITHMETICS:
    calls.clear()
    with tracing.unit('k8_arithmetic'):
      if kind == 'fwd':
        gn_ops.gn_swish_fwd(x, w, w, groups, 1e-6, True, arithmetic)
      else:
        gn_ops.gn_swish_bwd(x, w, w, x, groups, 1e-6, stats, arithmetic)
    (name, args), = calls
    assert name == {'fwd': 'mulan_gn_swish', 'ring': 'mulan_gn_swish_bwd',
                    'regs': 'mulan_gn_swish_bwd_regs'}[kind]
    argtypes = gn_ops._build._SIGNATURES[name]
    assert len(args) == len(argtypes)
    for arg, argtype in zip(args, argtypes):
      argtype.from_param(arg)
    assert args[-3:-1] == (1, int(arithmetic == 'unfused'))
    (key, n), = tracing.units('k8_arithmetic')[-1]['counts'].items()
    assert key[0] == ('gn_swish' if kind == 'fwd' else 'gn_swish_bwd')
    assert n == 1 and dict(key[2])['arithmetic'] == arithmetic
  with pytest.raises(ValueError, match='arithmetic'):
    gn_ops.gn_swish_fwd(x, w, w, groups, 1e-6, False, 'bf16')


# (case, what the site runs): K8's wrappers in the unfused arithmetic with
# `use_kernels` off the CPU, whatever x is (the wrappers refuse on the card
# what the kernels do not take, and a site never falls back), gathered
# channels too; the fused arithmetic under `fused_swish`; F.silu of the
# GroupNorm without `use_kernels` and on the CPU.
ROUTES = [('takes', 'unfused'), ('fused_swish', 'fused'),
          ('no_kernels', None), ('channels_last', 'unfused'),
          ('float16', 'unfused'), ('run_too_long', 'unfused'),
          ('gathered', 'unfused'), ('cpu', None)]


@pytest.mark.parametrize('case, arithmetic', ROUTES)
def test_gn_swish_sites_take_k8_where_it_takes_x(monkeypatch, case,
                                                 arithmetic):
  """`GroupNormF32.gn_swish`'s route, meta tensors standing in for the
  card's (CPU ones in 'cpu') and K8's wrappers substituted by recorders
  that return tensors of the shapes the kernels give: with `use_kernels`
  a site calls the wrappers, forward and backward, in the unfused
  arithmetic, for layouts, types and group runs the kernels refuse too,
  where `_check_args` raises for that reason and not only for the device
  (so the card raises there rather than falling back); the gathered
  tensor-parallel path calls them on the gathered channels; `use_kernels`
  off and CPU tensors run F.silu of the GroupNorm, and `fused_swish` the
  fused arithmetic. The output has x's type in every case."""
  from mulan_tpu_torch.models.layers import GroupNormF32
  from mulan_tpu_torch.ops import groupnorm_swish as gn_ops
  calls = []

  def fwd(x, weight, bias, num_groups, eps, stats, arithmetic):
    calls.append(('gn_swish_fwd', arithmetic))
    out = torch.empty_like(x)
    st = torch.empty((x.shape[0], num_groups, 2), device=x.device)
    return (out, st) if stats else out

  def bwd(x, weight, bias, dy, num_groups, eps, stats, arithmetic):
    calls.append(('gn_swish_bwd', arithmetic))
    return torch.empty_like(x), torch.empty_like(weight), torch.empty_like(
        bias)
  monkeypatch.setattr(gn_ops, 'gn_swish_fwd', fwd)
  monkeypatch.setattr(gn_ops, 'gn_swish_bwd', bwd)
  channels, size = (32, 256) if case == 'run_too_long' else (64, 8)
  dtype = torch.float16 if case == 'float16' else torch.bfloat16
  device = 'cpu' if case == 'cpu' else 'meta'
  norm = GroupNormF32(channels, fused_swish=case == 'fused_swish',
                      use_kernels=case != 'no_kernels').to(device)
  # Without a tensor group the gather hands back x itself.
  norm.gathered = case == 'gathered'
  x = torch.empty((2, channels, size, size), dtype=dtype, device=device)
  if case == 'channels_last':
    x = x.to(memory_format=torch.channels_last)
  refusal = ('unsupported device' if case in ('takes', 'gathered')
             else 'contiguous NCHW' if case in ('channels_last', 'float16')
             else 'exceeds' if case == 'run_too_long' else None)
  if refusal is not None:
    with pytest.raises(ValueError, match=refusal):
      gn_ops._check_args('gn_swish', x, norm.num_groups, norm.weight,
                         norm.bias)
  x.requires_grad_()
  out = norm.gn_swish(x)
  out.float().square().sum().backward()
  assert out.dtype == dtype and x.grad.dtype == dtype
  want = [] if arithmetic is None else [('gn_swish_fwd', arithmetic),
                                        ('gn_swish_bwd', arithmetic)]
  assert calls == want
