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
