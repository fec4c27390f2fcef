"""The port's backward kernels' modules and its dropout against the JAX
package, float32 on the CPU.

On the CPU the wrappers run their plain PyTorch versions (the CUDA kernels
are held against those on the card by chip_smoke.py). JAX runs its Pallas
backward kernels in interpret mode, as its own tests do off-TPU: the flash
dK/dV and dQ kernels through `flash_bwd.flash_attention(..., interpret=True)`
and the decoder's closed-form backward through `decoder_logprob`.
"""

from jax.experimental.pallas.ops.tpu import flash_attention as fa
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mulan_tpu.models import layers as jax_layers
from mulan_tpu.ops import dropout as jax_dropout
from mulan_tpu.ops import flash_bwd
from mulan_tpu.ops.decoder_logprob import decoder_logprob as jax_decoder
from mulan_tpu_torch.models import layers
from mulan_tpu_torch.ops import decoder_logprob as dec_ops
from mulan_tpu_torch.ops import dropout as drop_ops
from mulan_tpu_torch.ops import flash_attention as attn_ops
from mulan_tpu_torch.utils import tracing
from torch_port_helpers import (init_flax_module, load_torch_module, nchw,
                                nhwc, to_torch)

# Float32 on both sides; only the order of the sums differs.
RTOL, ATOL = 1e-5, 1e-6


def _rand(shape, seed):
  return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def _blocks64():
  """Pallas block sizes of 64 everywhere (they must divide T)."""
  return fa.BlockSizes(
      block_q=64, block_k_major=64, block_k=64, block_b=1,
      block_q_major_dkv=64, block_k_major_dkv=64, block_k_dkv=64,
      block_q_dkv=64, block_k_major_dq=64, block_k_dq=64, block_q_dq=64)


@pytest.mark.parametrize('shape', [(2, 1, 128, 32), (1, 2, 64, 16),
                                   (1, 1, 128, 256)])
def test_flash_attention_backward_matches_jax(shape):
  """jax.vjp through the Pallas dK/dV and dQ kernels (interpret mode)
  against the port's autograd function (plain forward with its row
  log-sum-exp, then `flash_attention_bwd_plain`); head_dim 256 is
  imagenet32's, where K2 and K3 take the 'sm90' route on the card."""
  q, k, v, do = (_rand(shape, i) for i in range(4))
  scale = shape[-1] ** -0.5
  out, vjp = jax.vjp(
      lambda a, b, c: flash_bwd.flash_attention(a, b, c, scale, _blocks64(),
                                                interpret=True),
      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
  want = vjp(jnp.asarray(do))
  tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
  before = tracing.launches()
  got_out = attn_ops.flash_attention(tq, tk, tv, scale)
  got = torch.autograd.grad(got_out, (tq, tk, tv), torch.from_numpy(do))
  np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out),
                             rtol=RTOL, atol=ATOL)
  for name, g, w in zip(('dq', 'dk', 'dv'), got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                               atol=ATOL, err_msg=name)
  assert tracing.launches() == before


def test_flash_attention_plain_lse_and_backward():
  """The plain forward's lse is the log-sum-exp of the scaled logits, and
  the plain backward equals autograd through the einsum forward, at a
  ragged T."""
  shape = (2, 1, 60, 16)
  q, k, v, do = (torch.from_numpy(_rand(shape, 10 + i)) for i in range(4))
  scale = 0.3
  o, lse = attn_ops.flash_attention_plain(q, k, v, scale, return_lse=True)
  torch.testing.assert_close(
      lse, torch.logsumexp(scale * q @ k.transpose(-1, -2), dim=-1))
  grads = attn_ops.flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
  leaves = [t.clone().requires_grad_() for t in (q, k, v)]
  want = torch.autograd.grad(attn_ops.flash_attention_plain(*leaves, scale),
                             leaves, do)
  # P = exp(s - lse) against softmax(s): each weight differs by f32
  # rounding, and dS = P (dP - di) cancels, so 1e-5 of the largest entry.
  for g, w in zip(grads, want):
    torch.testing.assert_close(g, w, rtol=1e-4,
                               atol=1e-5 * w.abs().max().item())


@pytest.mark.parametrize('g0_kind', ['per_pixel', 'per_example', 'scalar'])
def test_decoder_logprob_backward_matches_jax(g0_kind):
  """The closed-form backward; the per-example and scalar g0 are summed
  back to their shapes (`mulan_tpu/ops/decoder_logprob.py:161-168`)."""
  rs = np.random.RandomState(2)
  shape = (3, 4, 4, 3)
  x = rs.randint(0, 256, size=shape).astype(np.float32)
  g0 = {'per_pixel': rs.uniform(-13.3, 5.0, size=shape),
        'per_example': rs.uniform(-13.3, 5.0, size=(3, 1, 1, 1)),
        'scalar': np.array(-4.0)}[g0_kind].astype(np.float32)
  z = (2 * (x + 0.5) / 256 - 1 + np.exp(0.5 * g0)
       * rs.standard_normal(shape)).astype(np.float32)
  ct = rs.standard_normal(3).astype(np.float32)
  _, vjp = jax.vjp(lambda zz, gg: jax_decoder(jnp.asarray(x), zz, gg, 256),
                   jnp.asarray(z), jnp.asarray(g0))
  want_dz, want_dg = vjp(jnp.asarray(ct))
  tz = torch.from_numpy(z).requires_grad_()
  tg = torch.from_numpy(g0).requires_grad_()
  before = tracing.launches()
  dz, dg = torch.autograd.grad(
      dec_ops.decoder_logprob(torch.from_numpy(x), tz, tg), (tz, tg),
      torch.from_numpy(ct))
  assert dg.shape == g0.shape
  # dz = e^-g0 (e_x - E_p[e]) cancels: f32 rounding of E_p[e] times
  # e^-g0 (up to 6e5), so the tolerance is relative to the largest entry.
  for got, want in ((dz, want_dz), (dg, want_dg)):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())
  assert tracing.launches() == before


def test_decoder_backward_wrapper_raises_off_cpu_and_cuda():
  x = torch.empty((1, 4, 4, 3), device='meta')
  with pytest.raises(ValueError, match='unsupported device'):
    dec_ops.decoder_logprob_bwd(x, x, x, torch.empty((1,), device='meta'))
  with pytest.raises(ValueError, match='unsupported device'):
    drop_ops.dropout_mask(0, 0, (8,), 0.1, torch.float32, 'meta')


# -- dropout ----------------------------------------------------------------


def _philox_scalar(counter, key):
  """Philox4x32-10 on Python ints (Salmon et al., SC'11)."""
  m0, m1 = 0xD2511F53, 0xCD9E8D57
  w0, w1 = 0x9E3779B9, 0xBB67AE85
  c = list(counter)
  k0, k1 = key
  for r in range(10):
    if r:
      k0, k1 = (k0 + w0) & 0xFFFFFFFF, (k1 + w1) & 0xFFFFFFFF
    p0, p1 = m0 * c[0], m1 * c[2]
    c = [(p1 >> 32) ^ c[1] ^ k0, p1 & 0xFFFFFFFF, (p0 >> 32) ^ c[3] ^ k1,
         p0 & 0xFFFFFFFF]
  return c


def test_philox_matches_scalar_reference_and_known_answer():
  assert _philox_scalar([0] * 4, (0, 0)) == [
      0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]  # Random123's vector
  rs = np.random.RandomState(3)
  counters = rs.randint(0, 2 ** 32, size=(4, 50), dtype=np.uint64)
  counters[:, 0] = 0xFFFFFFFF
  key = (0xDEADBEEF, 123457)
  got = drop_ops.philox4x32_10(
      [torch.from_numpy(c.astype(np.int64)) for c in counters], key)
  for j in range(counters.shape[1]):
    want = _philox_scalar([int(c) for c in counters[:, j]], key)
    assert [int(g[j]) for g in got] == want
  zero = torch.zeros(1, dtype=torch.int64)
  assert [int(w[0]) for w in drop_ops.philox4x32_10([zero] * 4, (0, 0))] == [
      0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


@pytest.mark.parametrize('rate', [0.1, 0.3, 1 / 3, 0.5, 0.99999])
def test_effective_rate_matches_jax(rate):
  assert drop_ops.effective_rate(rate) == jax_dropout.effective_rate(rate)
  assert drop_ops.keep_scale(rate) == 1.0 / (
      1.0 - jax_dropout.effective_rate(rate))


@pytest.mark.parametrize('rate', [0.0, 1e-5, 0.05, 0.1, 0.2, 0.25, 1 / 3, 0.5,
                                  0.9, 0.99999])
def test_kernel_constants_are_cached_per_rate(rate):
  """The kernels' (threshold16, keep scale) come from a cache, once per
  rate, and equal what the wrappers computed on every call before."""
  want = (drop_ops.threshold16(rate),
          float(torch.tensor(drop_ops.keep_scale(rate), dtype=torch.float32)))
  got = drop_ops.kernel_constants(rate)
  assert got == want and type(got[0]) is int and type(got[1]) is float
  hits = drop_ops.kernel_constants.cache_info().hits
  assert drop_ops.kernel_constants(rate) is got
  assert drop_ops.kernel_constants.cache_info().hits == hits + 1


def test_mask_values_keep_share_and_mean():
  n, rate = 10 ** 6, 0.1
  mask = drop_ops.dropout_mask_plain(7, 3, (n,), rate, torch.float32)
  scale = drop_ops.keep_scale(rate)
  assert mask.unique().tolist() == [0.0, pytest.approx(scale)]
  p_keep = 1 - drop_ops.effective_rate(rate)
  sigma = np.sqrt(p_keep * (1 - p_keep) / n)
  assert abs((mask != 0).double().mean().item() - p_keep) < 5 * sigma
  assert abs(mask.double().mean().item() - 1.0) < 5 * scale * sigma
  bf16 = drop_ops.dropout_mask_plain(7, 3, (n,), rate, torch.bfloat16)
  assert torch.equal(bf16 != 0, mask != 0)
  assert bf16.unique().tolist() == [0.0, torch.tensor(
      scale, dtype=torch.bfloat16).item()]


def test_mask_streams_repeat_and_decorrelate():
  """The same (seed, site) gives the same mask; another seed or site an
  uncorrelated one (agreement p^2 + (1 - p)^2 within 5 sigma)."""
  n, rate = 2 ** 18, 0.3
  base = drop_ops.dropout_mask_plain(11, 4, (n,), rate, torch.float32) != 0
  again = drop_ops.dropout_mask_plain(11, 4, (n,), rate, torch.float32)
  assert torch.equal(base, again != 0)
  p = drop_ops.effective_rate(rate)
  agree = p * p + (1 - p) ** 2
  sigma = np.sqrt(agree * (1 - agree) / n)
  for seed, site in ((12, 4), (11, 5), (11 + 2 ** 31, 4)):
    other = drop_ops.dropout_mask_plain(seed, site, (n,), rate,
                                        torch.float32) != 0
    share = (base == other).double().mean().item()
    assert abs(share - agree) < 5 * sigma, (seed, site, share)


def test_dropout_backward_regenerates_the_forward_mask():
  """The gradient of sum(dropout(x)) is the mask itself."""
  x = torch.randn((2, 8, 4, 4), requires_grad=True)
  y = drop_ops.dropout(x, 5, 9, 0.25, use_kernel=True)
  (grad,) = torch.autograd.grad(y.sum(), x)
  mask = drop_ops.dropout_mask_plain(5, 9, x.shape, 0.25, x.dtype)
  assert torch.equal(grad, mask)
  torch.testing.assert_close(y, x * mask, rtol=0, atol=0)


def test_resnet_block_dropout_mask_matches_flax():
  """An explicit pre-scaled mask after the second GN-swish, as the flax
  block's `dropout_mask` argument applies it, and its gradient."""
  x = _rand((2, 4, 4, 32), 20)
  cond = _rand((2, 24), 21)
  mask = (np.random.RandomState(22).uniform(size=(2, 4, 4, 32)) >= 0.3) / 0.7
  mask = mask.astype(np.float32)
  module = jax_layers.ResnetBlock(out_ch=32, pdrop=0.3)
  params, flat = init_flax_module(module, jnp.asarray(x), jnp.asarray(cond))
  want, vjp = jax.vjp(
      lambda xx: module.apply({'params': params}, xx, jnp.asarray(cond),
                              False, jnp.asarray(mask)), jnp.asarray(x))
  (want_dx,) = vjp(jnp.asarray(_rand((2, 4, 4, 32), 23)))
  port = load_torch_module(layers.ResnetBlock(32, 32, 24, pdrop=0.3), flat)
  tx = nchw(x).requires_grad_()
  got = port(tx, to_torch(cond), dropout_mask=nchw(mask))
  (dx,) = torch.autograd.grad(got, tx, nchw(_rand((2, 4, 4, 32), 23)))
  np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=RTOL,
                             atol=1e-5)
  np.testing.assert_allclose(nhwc(dx), np.asarray(want_dx), rtol=RTOL,
                             atol=1e-5)
