"""The port's execution-policy variants against the JAX package, on the CPU:
the fused GroupNorm+swish (K8's module), the batched dropout masks (K7's
module), `with_attention` and `remat`.

JAX runs its fused GroupNorm+swish Pallas kernel in interpret mode, as its
own tests do off-TPU; on the CPU the port's wrappers run their plain
versions. Models share one flax init, transplanted with `params.from_flax`;
the JAX side draws its noise through the patched `jax.random` and its
dropout masks through patched `_hw_mask` / `hw_mask_batch`, and the port is
handed the same arrays.
"""

import dataclasses

from flax.traverse_util import flatten_dict
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mulan_tpu.models import layers as jax_layers
from mulan_tpu.models.config import ModelConfig as JaxModelConfig
from mulan_tpu.ops import dropout as jax_dropout
from mulan_tpu.ops.groupnorm_swish import fused_gn_swish
from mulan_tpu_torch import configs, params
from mulan_tpu_torch.models import build_model, layers
from mulan_tpu_torch.models.config import ModelConfig, tiny_config
from mulan_tpu_torch.models.mulan import MuLAN
from mulan_tpu_torch.ops import dropout as drop_ops
from mulan_tpu_torch.ops import groupnorm_swish as gn_ops
from parity_helpers import frozen_randomness
from test_torch_model import _elbo_pair
from test_torch_train import (GRAD_ATOL_FRAC, GRAD_RTOL, _batch, _fake_mask,
                              _inject_masks, _jax_loss_and_grads, _pair,
                              _port_noise, _train_config)
from torch_port_helpers import (init_flax_module, load_torch_module,
                                mulan_pair, nchw, nhwc, to_torch)

# Float32 on both sides; only the order of the sums differs.
RTOL, ATOL = 1e-5, 1e-5
# bf16: both compute in float32 and cast once, so the outputs differ by at
# most one bf16 ulp, 2^-7 of the value at most (8 significant bits), where
# the float32 results straddle a rounding boundary.
BF16_ULP = 2.0 ** -7
# The gamma network's gradients carry the largest float32 differences
# (`test_torch_train.GRAD_RTOL`); with attention blocks after every UNet
# block they reach 2.3e-4 to 5.8e-4 of the model's largest gradient on three
# batches, with remat or without, in `dense_out_a.bias`: d loss / d gamma_t
# passes through the sin and cos of the time embedding at up to 1000 rad.
GAMMA_ATOL_FRAC_ATTN = 1e-3


def _rand(shape, seed, scale=1.0, shift=0.0):
  rs = np.random.RandomState(seed)
  return (scale * rs.standard_normal(shape) + shift).astype(np.float32)


def _affine(c, seed):
  return 1.0 + 0.1 * _rand((c,), seed), 0.1 * _rand((c,), seed + 1)


# -- the fused GroupNorm+swish (K8's module) ----------------------------------


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape', [(2, 8, 8, 128), (3, 4, 8, 32),
                                   (2, 4, 4, 48)])
def test_gn_swish_plain_matches_pallas_kernel(shape, dtype):
  """NHWC for the Pallas kernel, NCHW for the port; C = 48 has 16 groups."""
  c = shape[-1]
  groups = jax_layers.num_groups_for(c)
  x = _rand(shape, 0, scale=2.0, shift=0.5)
  scale, bias = _affine(c, 1)
  want = fused_gn_swish(jnp.asarray(x, dtype), jnp.asarray(scale),
                        jnp.asarray(bias), groups, 1e-6, True)
  got = gn_ops.gn_swish_plain(nchw(x).to(getattr(torch, dtype)),
                              to_torch(scale), to_torch(bias), groups)
  assert got.dtype == getattr(torch, dtype)
  got = nhwc(got.float())
  want = np.asarray(want, np.float32)
  if dtype == 'float32':
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
  else:
    np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=1e-6)


@pytest.mark.parametrize('shape', [(2, 4, 8, 64), (2, 4, 4, 48)])
def test_gn_swish_gradients_match_jax_custom_vjp(shape):
  """The backward differentiates the float32 formula, as JAX's `_bwd`."""
  c = shape[-1]
  groups = jax_layers.num_groups_for(c)
  x = _rand(shape, 2, scale=2.0)
  scale, bias = _affine(c, 3)

  def loss(xx, s, b):
    return jnp.sum(jnp.square(fused_gn_swish(xx, s, b, groups, 1e-6, True)))

  want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale),
                                           jnp.asarray(bias))
  inputs = [nchw(x).requires_grad_(), to_torch(scale).requires_grad_(),
            to_torch(bias).requires_grad_()]
  out = gn_ops.gn_swish(*inputs, groups, 1e-6, use_kernel=True)
  got = torch.autograd.grad(out.square().sum(), inputs)
  for g, w, name in zip((nhwc(got[0]), got[1].numpy(), got[2].numpy()), want,
                        ('x', 'scale', 'bias')):
    np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-5,
                               err_msg=name)


def test_gn_swish_bf16_gradient_types():
  """dx in x's type, dweight and dbias float32."""
  x = nchw(_rand((2, 4, 4, 32), 4)).to(torch.bfloat16).requires_grad_()
  w = torch.ones(32, requires_grad=True)
  b = torch.zeros(32, requires_grad=True)
  out = gn_ops.gn_swish(x, w, b, 32, use_kernel=True)
  assert out.dtype == torch.bfloat16
  dx, dw, db = torch.autograd.grad(out.float().sum(), (x, w, b))
  assert (dx.dtype, dw.dtype, db.dtype) == (torch.bfloat16, torch.float32,
                                            torch.float32)


@pytest.mark.parametrize('shape', [(2, 4, 8, 64), (2, 4, 4, 48)])
def test_gn_swish_bwd_plain_matches_jax_custom_vjp(shape):
  """The closed form against the vjp of JAX's `fused_gn_swish` (its `_bwd`
  differentiates `_gn_swish_reference`) for a random cotangent, float32.
  Only the order of the sums differs; dx cancels two group means against
  w g, so it is held at the tolerance of the existing gradient test."""
  c = shape[-1]
  groups = jax_layers.num_groups_for(c)
  x, dy = _rand(shape, 5, scale=2.0, shift=0.5), _rand(shape, 6)
  scale, bias = _affine(c, 7)
  _, vjp = jax.vjp(lambda xx, s, b: fused_gn_swish(xx, s, b, groups, 1e-6,
                                                    True),
                   jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
  want = vjp(jnp.asarray(dy))
  got = gn_ops.gn_swish_bwd_plain(nchw(x), to_torch(scale), to_torch(bias),
                                  nchw(dy), groups)
  for g, w, name in zip((nhwc(got[0]), got[1].numpy(), got[2].numpy()), want,
                        ('x', 'scale', 'bias')):
    np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-5,
                               err_msg=name)


def test_gn_swish_bwd_plain_bf16_matches_jax_custom_vjp():
  """bf16 x and cotangent: both upcast and compute in float32, dx is cast
  back to bf16 (one bf16 ulp apart where the float32 results straddle a
  rounding boundary), dweight and dbias stay float32."""
  shape, groups = (2, 4, 4, 32), 32
  x = jnp.asarray(_rand(shape, 8, scale=2.0), jnp.bfloat16)
  dy = jnp.asarray(_rand(shape, 9), jnp.bfloat16)
  scale, bias = _affine(32, 10)
  _, vjp = jax.vjp(lambda xx, s, b: fused_gn_swish(xx, s, b, groups, 1e-6,
                                                    True),
                   x, jnp.asarray(scale), jnp.asarray(bias))
  want = vjp(dy)
  got = gn_ops.gn_swish_bwd_plain(
      nchw(np.asarray(x, np.float32)).to(torch.bfloat16), to_torch(scale),
      to_torch(bias), nchw(np.asarray(dy, np.float32)).to(torch.bfloat16),
      groups)
  assert (got[0].dtype, got[1].dtype, got[2].dtype) == (
      torch.bfloat16, torch.float32, torch.float32)
  assert want[0].dtype == jnp.bfloat16
  dx_want = np.asarray(want[0], np.float32)
  np.testing.assert_allclose(nhwc(got[0].float()), dx_want, rtol=BF16_ULP,
                             atol=1e-5 * np.abs(dx_want).max())
  for g, w in zip(got[1:], want[1:]):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                               atol=1e-5)


def test_gn_swish_backward_routes_through_gn_swish_bwd(monkeypatch):
  """With use_kernel the autograd backward calls `gn_swish_bwd` (on the CPU
  its plain version), without it `gn_swish_bwd_plain`, once a call."""
  calls = []

  def counting(name, fn):
    def wrapped(*args):
      calls.append(name)
      return fn(*args)
    return wrapped
  monkeypatch.setattr(gn_ops, 'gn_swish_bwd',
                      counting('kernel', gn_ops.gn_swish_bwd))
  monkeypatch.setattr(gn_ops, 'gn_swish_bwd_plain',
                      counting('plain', gn_ops.gn_swish_bwd_plain))
  x = nchw(_rand((2, 4, 4, 32), 11)).requires_grad_()
  w = torch.ones(32, requires_grad=True)
  b = torch.zeros(32, requires_grad=True)
  gn_ops.gn_swish(x, w, b, 32, use_kernel=True).sum().backward()
  assert calls == ['kernel', 'plain']  # gn_swish_bwd's CPU path
  calls.clear()
  gn_ops.gn_swish(x, w, b, 32, use_kernel=False).sum().backward()
  assert calls == ['plain']


def test_gn_swish_backward_takes_the_forwards_statistics(monkeypatch):
  """Under autograd the forward's (B, G, 2) statistics are saved and handed
  to the backward, which reduces nothing again: `group_stats` runs once a
  call, with the kernel's wrapper and with the plain path alike."""
  stats_calls, handed = [], []
  real_stats = gn_ops.group_stats

  def counting_stats(*args):
    stats_calls.append(args)
    return real_stats(*args)
  monkeypatch.setattr(gn_ops, 'group_stats', counting_stats)
  for name in ('gn_swish_bwd', 'gn_swish_bwd_plain'):
    real = getattr(gn_ops, name)

    def recording(*args, real=real):
      handed.append(args[6])
      return real(*args)
    monkeypatch.setattr(gn_ops, name, recording)
  x = nchw(_rand((2, 4, 4, 32), 12)).requires_grad_()
  w = torch.ones(32, requires_grad=True)
  b = torch.zeros(32, requires_grad=True)
  for use_kernel in (True, False):
    stats_calls.clear()
    handed.clear()
    gn_ops.gn_swish(x, w, b, 32, 1e-6, use_kernel).sum().backward()
    assert len(stats_calls) == 1, use_kernel
    # gn_swish_bwd's CPU path hands them on to the plain version.
    assert len(handed) == (2 if use_kernel else 1)
    for stats in handed:
      assert stats.shape == (2, 32, 2) and stats.dtype == torch.float32
      assert torch.equal(stats, real_stats(x.detach(), 32, 1e-6))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_gn_swish_bwd_plain_uses_the_given_statistics(dtype):
  """The closed form with the forward's statistics gives the bits it gives
  reducing x itself, and other statistics give another dx."""
  x = nchw(_rand((2, 4, 4, 48), 13, scale=2.0, shift=0.5)).to(dtype)
  dy = nchw(_rand((2, 4, 4, 48), 14)).to(dtype)
  w, b = map(to_torch, _affine(48, 15))
  out, stats = gn_ops.gn_swish_plain(x, w, b, 16, 1e-6, True)
  assert torch.equal(out, gn_ops.gn_swish_plain(x, w, b, 16))
  assert torch.equal(stats, gn_ops.group_stats(x, 16, 1e-6))
  given = gn_ops.gn_swish_bwd_plain(x, w, b, dy, 16, 1e-6, stats)
  own = gn_ops.gn_swish_bwd_plain(x, w, b, dy, 16)
  assert all(torch.equal(g, o) for g, o in zip(given, own))
  shifted = stats + torch.tensor([0.25, 0.0])
  assert not torch.equal(
      gn_ops.gn_swish_bwd_plain(x, w, b, dy, 16, 1e-6, shifted)[0], own[0])


def test_gn_swish_bf16_gradients_match_jax_custom_vjp():
  """gn_swish under autograd (the forward's statistics handed to the
  backward) against the vjp of JAX's `fused_gn_swish` in bf16: dx one bf16
  ulp apart where the float32 results straddle a rounding boundary, as
  `test_gn_swish_bwd_plain_bf16_matches_jax_custom_vjp`."""
  shape, groups = (2, 4, 4, 64), 32
  x = jnp.asarray(_rand(shape, 16, scale=2.0, shift=0.5), jnp.bfloat16)
  dy = jnp.asarray(_rand(shape, 17), jnp.bfloat16)
  scale, bias = _affine(64, 18)
  _, vjp = jax.vjp(lambda xx, s, b: fused_gn_swish(xx, s, b, groups, 1e-6,
                                                    True),
                   x, jnp.asarray(scale), jnp.asarray(bias))
  want = vjp(dy)
  inputs = [nchw(np.asarray(x, np.float32)).to(torch.bfloat16)
            .requires_grad_(), to_torch(scale).requires_grad_(),
            to_torch(bias).requires_grad_()]
  out = gn_ops.gn_swish(*inputs, groups, 1e-6, use_kernel=True)
  got = torch.autograd.grad(
      out, inputs, nchw(np.asarray(dy, np.float32)).to(torch.bfloat16))
  assert got[0].dtype == torch.bfloat16
  dx_want = np.asarray(want[0], np.float32)
  np.testing.assert_allclose(nhwc(got[0].float()), dx_want, rtol=BF16_ULP,
                             atol=1e-5 * np.abs(dx_want).max())
  for g, w in zip(got[1:], want[1:]):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                               atol=1e-5)


# Which backward kernel takes each shape that chip_smoke.py checks (GN_CASES,
# IN32_GN_CASES, a tensor rank's window, the gathered 48-channel GroupNorm
# of three tensor ranks) and a few others: the ring where H x W is a
# multiple of a 16-byte vector and a run is at most 2,048 vectors.
GN_BWD_DESIGNS = [
    ((128, 128, 32, 32), torch.bfloat16, 32, 'ring'),
    ((128, 256, 32, 32), torch.bfloat16, 32, 'ring'),
    ((8, 128, 32, 32), torch.float32, 32, 'ring'),
    ((4, 48, 16, 16), torch.bfloat16, 16, 'ring'),
    ((3, 48, 5, 7), torch.float32, 16, 'regs'),
    ((128, 512, 32, 32), torch.bfloat16, 32, 'ring'),
    ((32, 64, 32, 32), torch.bfloat16, 16, 'ring'),
    ((16, 48, 32, 32), torch.bfloat16, 16, 'ring'),
    ((2, 256, 32, 32), torch.float32, 32, 'ring'),
    ((2, 512, 32, 32), torch.float32, 32, 'regs'),
    ((2, 1024, 32, 32), torch.bfloat16, 32, 'regs'),
    ((2, 64, 2, 2), torch.bfloat16, 32, 'regs'),
]


@pytest.mark.parametrize('shape, dtype, groups, design', GN_BWD_DESIGNS)
def test_gn_swish_bwd_design_by_shape(monkeypatch, shape, dtype, groups,
                                      design):
  """`bwd_design` names each shape's kernel, an unaligned x or dy takes
  'regs', and the wrapper calls that design's C entry point once with
  arguments its ctypes signature takes (the card stood in for by meta
  tensors, a recording library and a null stream)."""
  assert gn_ops.bwd_design(shape, dtype, groups) == design
  assert gn_ops.bwd_design(shape, dtype, groups, aligned=False) == 'regs'
  calls = []

  class Library:
    def __getattr__(self, name):
      return lambda *args: calls.append((name, args)) or 0
  monkeypatch.setattr(gn_ops._build, 'load_library', Library)
  monkeypatch.setattr(gn_ops, '_check_args', lambda *a: None)
  monkeypatch.setattr(gn_ops, '_stream', lambda t: None)
  monkeypatch.setattr(gn_ops, '_counters', lambda d, s, g: torch.empty(
      g, dtype=torch.int32, device='meta'))
  monkeypatch.setattr(gn_ops.gn_swish_bwd, 'launches', 0)
  x = torch.empty(shape, dtype=dtype, device='meta')
  w = torch.empty(shape[1], device='meta')
  stats = torch.empty((shape[0], groups, 2), device='meta')
  dx, dw, db = gn_ops.gn_swish_bwd(x, w, w, x, groups, 1e-6, stats)
  (name, args), = calls
  assert name == {'ring': 'mulan_gn_swish_bwd',
                  'regs': 'mulan_gn_swish_bwd_regs'}[design]
  argtypes = gn_ops._build._SIGNATURES[name]
  assert len(args) == len(argtypes)
  for arg, argtype in zip(args, argtypes):
    argtype.from_param(arg)
  b, c, h, w_ = shape
  assert args[10:15] == (b, c, h * w_, groups, int(dtype == torch.bfloat16))
  assert dx.shape == shape and dx.dtype == dtype
  assert dw.shape == db.shape == (c,) and dw.dtype == torch.float32
  assert gn_ops.gn_swish_bwd.launches == 1


def test_gn_swish_bwd_kernel_needs_the_forwards_statistics(monkeypatch):
  """On the card the backward takes the forward's statistics and reduces
  none itself: without them, or with them misshapen, the wrapper raises
  before it reaches the library."""
  monkeypatch.setattr(gn_ops._build, 'load_library', lambda: pytest.fail(
      'the library was loaded'))
  monkeypatch.setattr(gn_ops, '_check_args', lambda *a: None)
  x = torch.empty((2, 64, 4, 4), dtype=torch.bfloat16, device='meta')
  w = torch.empty(64, device='meta')
  for stats in (None, torch.empty((2, 16, 2), device='meta'),
                torch.empty((2, 32, 2), dtype=torch.bfloat16, device='meta')):
    with pytest.raises(ValueError, match="needs the forward's stats"):
      gn_ops.gn_swish_bwd(x, w, w, x, 32, 1e-6, stats)


def test_kernel_wrappers_raise_off_cpu_and_cuda():
  x = torch.empty((2, 32, 4, 4), device='meta')
  w = torch.empty(32, device='meta')
  with pytest.raises(ValueError, match='unsupported device'):
    gn_ops.gn_swish_fwd(x, w, w, 32)
  with pytest.raises(ValueError, match='unsupported device'):
    gn_ops.gn_swish_bwd(x, w, w, x, 32)
  with pytest.raises(ValueError, match='unsupported device'):
    drop_ops.dropout_mask_batch(1, 0, 3, (2, 4), 0.1, torch.float32, 'meta')


# -- the batched dropout masks (K7's module) ----------------------------------


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_mask_batch_slots_are_the_per_site_masks(dtype):
  """Slot i is bit for bit the mask of site first + i, through the plain
  version and the wrapper, whose CPU path it is."""
  shape, first = (3, 5, 7), 60
  masks = drop_ops.dropout_mask_batch_plain(9, first, 4, shape, 0.1, dtype)
  assert masks.shape == (4, *shape) and masks.dtype == dtype
  for i in range(4):
    assert torch.equal(masks[i], drop_ops.dropout_mask_plain(
        9, first + i, shape, 0.1, dtype)), i
  assert torch.equal(drop_ops.dropout_mask_batch(9, first, 4, shape, 0.1,
                                                 dtype), masks)
  for use_kernel in (False, True):
    assert torch.equal(drop_ops.dropout_masks(9, first, 4, shape, 0.1, dtype,
                                              'cpu', use_kernel), masks)


def test_mask_batch_statistics():
  """`tests/test_dropout.py:test_mask_batch_statistics`'s contract: values
  {0, scale}, the quantized rate per slot, distinct slots."""
  rate = 0.1
  masks = drop_ops.dropout_mask_batch_plain(42, 0, 4, (8, 128, 16), rate,
                                            torch.float32).numpy()
  scale = 1.0 / (1.0 - jax_dropout.effective_rate(rate))
  assert np.all((masks == 0.0) | np.isclose(masks, scale, rtol=1e-6))
  fracs = (masks == 0.0).reshape(4, -1).mean(axis=1)
  assert np.all(np.abs(fracs - rate) < 0.03), fracs
  for i in range(4):
    for j in range(i + 1, 4):
      assert not np.array_equal(masks[i], masks[j])


# -- blocks and the model with the fused GroupNorm+swish ----------------------


@pytest.mark.parametrize('in_ch,out_ch', [(32, 32), (64, 32), (48, 48)])
def test_fused_resnet_block_matches_flax(in_ch, out_ch):
  x = _rand((2, 4, 4, in_ch), 10)
  cond = _rand((2, 24), 11)
  dy = _rand((2, 4, 4, out_ch), 12)
  module = jax_layers.ResnetBlock(out_ch=out_ch, fused_gn=True)
  params_, flat = init_flax_module(module, jnp.asarray(x), jnp.asarray(cond))
  assert 'GroupNormF32_0/GroupNorm_0/scale' in flat
  want, vjp = jax.vjp(lambda xx: module.apply({'params': params_}, xx,
                                              jnp.asarray(cond)),
                      jnp.asarray(x))
  (want_dx,) = vjp(jnp.asarray(dy))
  port = load_torch_module(layers.ResnetBlock(in_ch, out_ch, 24,
                                              use_kernels=True,
                                              fused_gn=True), flat)
  tx = nchw(x).requires_grad_()
  got = port(tx, to_torch(cond))
  (dx,) = torch.autograd.grad(got, tx, nchw(dy))
  np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=RTOL,
                             atol=ATOL)
  np.testing.assert_allclose(nhwc(dx), np.asarray(want_dx), rtol=RTOL,
                             atol=ATOL)


def test_fused_tiny_elbo_matches_jax(monkeypatch):
  model, params_, port = mulan_pair(tiny_config(fused_gn_swish=True,
                                                use_kernels=True), batch=4)
  images = np.random.RandomState(0).randint(
      0, 256, size=(4, *port.config.image_shape)).astype(np.uint8)
  _elbo_pair(model, params_, port, images,
             np.array([0.05, 0.3, 0.55, 0.8], np.float32), monkeypatch)


def test_with_attention_tree_and_elbo_match_jax(monkeypatch):
  """A flax tree with the 66-style attention blocks (here 2 + 3 in the UNet
  and 1 in the encoder, plus the middles) maps leaf for leaf, and the ELBO
  agrees."""
  cfg = tiny_config(with_attention=True)
  model, params_, port = mulan_pair(cfg, batch=4)
  flat = flatten_dict(params_, sep='/')
  for name in ('score_model/down_attn_1/q/kernel',
               'score_model/up_attn_2/proj_out/kernel',
               'encoder_model/trunk/down_attn_0/k/bias'):
    assert name in flat, name
  assert set(params.from_flax(flat)) == set(port.state_dict())
  with torch.device('meta'):
    names = {k: tuple(v.shape) for k, v in MuLAN(cfg).state_dict().items()}
  fresh = params.init_params(cfg, torch.Generator().manual_seed(0))
  assert {k: tuple(v.shape) for k, v in fresh.items()} == names
  images = np.random.RandomState(1).randint(
      0, 256, size=(4, *cfg.image_shape)).astype(np.uint8)
  _elbo_pair(model, params_, port, images,
             np.array([0.1, 0.35, 0.6, 0.85], np.float32), monkeypatch)


# -- train-mode gradients under the flags -------------------------------------


@pytest.fixture(scope='module')
def tiny_params():
  """One flax init of tiny_synthetic, with and without attention blocks:
  {with_attention: (flax params, the port's MuLAN with them)}; the trees do
  not depend on the other flags."""
  cfg = configs.tiny_synthetic().model
  return {attn: mulan_pair(dataclasses.replace(cfg, with_attention=attn),
                           batch=2)[1:] for attn in (False, True)}


def _inject_batch_masks(monkeypatch):
  """`_inject_masks`, and the batched masks: JAX's `hw_mask_batch` by
  (n, B, H, W, C), the port's by that shape's NCHW transpose."""
  _inject_masks(monkeypatch)

  def jax_masks(seed, n_masks, shape, rate, dtype):
    del seed
    return jnp.asarray(_fake_mask((n_masks, *shape), rate), dtype)

  def port_masks(seed, first_site, n_masks, shape, rate, dtype, device=None):
    del seed, first_site
    b, c, h, w = shape
    return torch.from_numpy(_fake_mask((n_masks, b, h, w, c), rate)).permute(
        0, 1, 4, 2, 3).to(dtype=dtype, device=device)

  monkeypatch.setattr(jax_dropout, 'hw_mask_batch', jax_masks)
  monkeypatch.setattr(drop_ops, 'dropout_mask_batch', port_masks)
  monkeypatch.setattr(drop_ops, 'dropout_mask_batch_plain', port_masks)


def _grads_match_jax(monkeypatch, tiny_params, gamma_atol_frac, **model):
  """The train-mode loss and every gradient, port against JAX, at
  `test_torch_train`'s tolerance (the gamma network's leaves at
  `gamma_atol_frac` of the largest gradient)."""
  cfg = _train_config(**model)
  jax_model, jax_params, ex = _pair(cfg, tiny_params[cfg.model.with_attention])
  frozen_randomness(monkeypatch)
  _inject_batch_masks(monkeypatch)
  batch = _batch(cfg, 0)
  (bpd_want, _), grads_want = _jax_loss_and_grads(jax_model, jax_params, cfg,
                                                  batch, 0)
  bpd, _ = ex.loss_fn(ex.model, batch, train=True, noise=_port_noise(cfg))
  bpd.backward()
  np.testing.assert_allclose(bpd.item(), float(bpd_want), rtol=1e-4)
  want = params.from_flax({k: np.asarray(v) for k, v in
                           flatten_dict(grads_want, sep='/').items()})
  got = {k: p.grad for k, p in ex.model.named_parameters()}
  assert got.keys() == want.keys()
  scale = max(w.abs().max().item() for w in want.values())
  for name, w in want.items():
    frac = gamma_atol_frac if name.startswith('gamma.') else GRAD_ATOL_FRAC
    np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=GRAD_RTOL,
                               atol=frac * scale, err_msg=name)


def test_fused_batched_train_gradients_match_jax(monkeypatch, tiny_params):
  """fused_gn_swish and dropout_mask_batch, the same masks on both sides."""
  _grads_match_jax(monkeypatch, tiny_params, GRAD_ATOL_FRAC,
                   fused_gn_swish=True, dropout_mask_batch=True)


@pytest.mark.parametrize('remat', ['all', 'alt'])
def test_remat_train_gradients_match_jax(monkeypatch, tiny_params, remat):
  """Under the same remat mode on both sides."""
  _grads_match_jax(monkeypatch, tiny_params, GRAD_ATOL_FRAC, remat=remat)


def test_with_attention_train_gradients_match_jax(monkeypatch, tiny_params):
  """`bench.py --attention`: with_attention=True, remat='attn'."""
  _grads_match_jax(monkeypatch, tiny_params, GAMMA_ATOL_FRAC_ATTN,
                   with_attention=True, remat='attn')


def _port_step(cfg, state, images, t, noise, seed):
  """(loss, {name: grad}) of one train-mode ELBO of the port."""
  model = build_model('mulan_velocity', cfg, device='cpu', state=state)
  out = model.elbo(images, t, deterministic=False, dropout_seed=seed, **noise)
  loss = (out.loss_recon + out.loss_klz + out.loss_diff).mean()
  loss.backward()
  return loss.detach(), {k: p.grad for k, p in model.named_parameters()}


@pytest.fixture(scope='module')
def port_step_inputs():
  cfg = tiny_config(with_attention=True, sm_n_embd=16)
  state = params.init_params(cfg, torch.Generator().manual_seed(3),
                             perturb_zero_init=0.02)
  rs = np.random.RandomState(4)
  images = torch.from_numpy(rs.randint(0, 256, size=(3, *cfg.image_shape))
                            .astype(np.uint8))
  t = torch.tensor([0.2, 0.5, 0.9])
  noise = dict(eps0=to_torch(_rand((3, *cfg.image_shape), 5)),
               eps=to_torch(_rand((3, *cfg.image_shape), 6)),
               latent_noise=to_torch(np.random.RandomState(7).gamma(
                   1.0 / cfg.latent_k, size=(2, 3, cfg.latent_size))
                                   .astype(np.float32)))
  return cfg, state, images, t, noise


@pytest.mark.parametrize('fused_gn', [False, True])
def test_mask_batch_on_and_off_give_the_same_step(port_step_inputs,
                                                  fused_gn):
  """With one seed the batched masks are the per-site masks: the loss and
  every gradient are the same, bit for bit."""
  cfg, state, images, t, noise = port_step_inputs
  cfg = dataclasses.replace(cfg, fused_gn_swish=fused_gn, use_kernels=True)
  loss, grads = _port_step(cfg, state, images, t, noise, 11)
  loss_b, grads_b = _port_step(
      dataclasses.replace(cfg, dropout_mask_batch=True), state, images, t,
      noise, 11)
  assert torch.equal(loss, loss_b)
  for name, g in grads.items():
    assert torch.equal(g, grads_b[name]), name
  det = build_model('mulan_velocity', cfg, device='cpu', state=state).elbo(
      images, t, **noise)
  assert not torch.equal(det.loss_diff, build_model(
      'mulan_velocity', cfg, device='cpu', state=state).elbo(
          images, t, deterministic=False, dropout_seed=11,
          **noise).loss_diff)


@pytest.mark.parametrize('remat', ['all', 'attn', 'alt', True])
def test_remat_gives_the_step_without_it(port_step_inputs, remat):
  """The same loss; gradients up to the order in which the recomputed
  blocks' contributions are summed."""
  cfg, state, images, t, noise = port_step_inputs
  cfg = dataclasses.replace(cfg, fused_gn_swish=True)
  loss, grads = _port_step(cfg, state, images, t, noise, 12)
  loss_r, grads_r = _port_step(dataclasses.replace(cfg, remat=remat), state,
                               images, t, noise, 12)
  assert torch.equal(loss, loss_r)
  scale = max(g.abs().max().item() for g in grads.values())
  for name, g in grads.items():
    np.testing.assert_allclose(grads_r[name].numpy(), g.numpy(), rtol=1e-5,
                               atol=1e-6 * scale, err_msg=name)


def test_remat_checkpoints_the_blocks_jax_does():
  """Which blocks run under checkpointing, per mode (`unet.py:89-121`,
  `encoder.py:53-54`)."""
  def rematted(remat):
    model = MuLAN(tiny_config(with_attention=True, remat=remat))
    return {n for n, m in model.named_modules() if getattr(m, 'remat', False)}

  assert rematted('none') == rematted(False) == set()
  attn = rematted('attn')
  assert attn == {n for n in rematted('all') if '_attn_' in n}
  assert {'score_model.up_attn_2', 'encoder_model.trunk.mid_attn_1'} <= attn
  alt = rematted('alt') - attn
  # Sites 0, 2, 4, 6 of the 2 + 2 + 3 UNet blocks, in order.
  assert alt == {'score_model.down_block_0', 'score_model.mid_block_1',
                 'score_model.up_block_0', 'score_model.up_block_2'}
  assert rematted(True) == rematted('all')


# -- the config ---------------------------------------------------------------


@pytest.mark.parametrize('remat', [False, True, 'none', 'all', 'attn', 'alt',
                                   'some'])
def test_remat_properties_match_jax(remat):
  port = ModelConfig(remat=remat)
  want = JaxModelConfig(remat=remat)
  for prop in ('remat_blocks', 'remat_attn', 'remat_alt_blocks'):
    try:
      expected = getattr(want, prop)
    except ValueError as err:
      with pytest.raises(ValueError, match=str(err)):
        getattr(port, prop)
    else:
      assert getattr(port, prop) == expected, prop
  if remat == 'some':
    with pytest.raises(ValueError, match='unknown remat mode'):
      MuLAN(tiny_config(remat=remat))


def test_policy_field_defaults_match_jax():
  """The flags' defaults, and a remat default that means what JAX's
  (False) means: the port's is cifar10_conditioned's 'none'."""
  port, want = ModelConfig(), JaxModelConfig()
  for name in ('dropout_mask_batch', 'fused_gn_swish', 'with_attention'):
    assert getattr(port, name) == getattr(want, name), name
  for prop in ('remat_blocks', 'remat_attn', 'remat_alt_blocks'):
    assert getattr(port, prop) == getattr(want, prop) is False, prop
