"""The port's blocks (mulan_tpu_torch/models/layers.py) against their flax
counterparts, float32, with the same parameters and inputs.

The flax side runs NHWC, the port NCHW; inputs and outputs are permuted at
the boundary. Zero-initialized leaves are perturbed so that every branch of a
block reaches its output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mulan_tpu.models import layers as jax_layers
from mulan_tpu_torch.models import layers
from torch_port_helpers import (init_flax_module, load_torch_module, nchw,
                                nhwc, to_torch)

# Float32 on both sides; convolutions and reductions sum in other orders.
RTOL, ATOL = 1e-5, 1e-5


def _x(shape, seed=0):
  return np.random.RandomState(seed).standard_normal(shape).astype(
      np.float32)


@pytest.mark.parametrize('dim', [32, 128])
def test_timestep_embedding_matches_jax(dim):
  """The arguments reach 1000 rad, where one float32 ulp is 6e-5, so the
  sines agree to ~1e-4 absolute."""
  t = np.linspace(0.0, 1.0, 7).astype(np.float32)
  np.testing.assert_allclose(
      layers.timestep_embedding(to_torch(t), dim).numpy(),
      np.asarray(jax_layers.timestep_embedding(jnp.asarray(t), dim)),
      rtol=0, atol=1e-4)


def test_base2_fourier_features_match_jax():
  """The channel interleave: repeat per channel against tiled frequencies."""
  x = _x((2, 4, 4, 3))
  want = jax_layers.base2_fourier_features(jnp.asarray(x), start=6, stop=8)
  got = layers.base2_fourier_features(nchw(x))
  np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=RTOL,
                             atol=ATOL)


@pytest.mark.parametrize('channels', [32, 48])
def test_groupnorm_matches_flax(channels):
  """gcd(C, 32) groups (32 and 16 here) and eps 1e-6."""
  x = _x((2, 4, 4, channels)) * 3 + 1
  module = jax_layers.GroupNormF32()
  params, flat = init_flax_module(module, jnp.asarray(x))
  want = module.apply({'params': params}, jnp.asarray(x))
  port = load_torch_module(layers.GroupNormF32(channels), flat)
  np.testing.assert_allclose(nhwc(port(nchw(x))), np.asarray(want),
                             rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('in_ch,out_ch', [(32, 32), (64, 32)])
def test_resnet_block_matches_flax(in_ch, out_ch):
  """(64 -> 32) goes through the 1x1 nin_shortcut."""
  x = _x((2, 4, 4, in_ch))
  cond = _x((2, 24), seed=1)
  module = jax_layers.ResnetBlock(out_ch=out_ch)
  params, flat = init_flax_module(module, jnp.asarray(x), jnp.asarray(cond))
  want = module.apply({'params': params}, jnp.asarray(x), jnp.asarray(cond))
  port = load_torch_module(layers.ResnetBlock(in_ch, out_ch, 24), flat)
  got = port(nchw(x), to_torch(cond))
  np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=RTOL,
                             atol=ATOL)


@pytest.mark.parametrize('use_kernels', [False, True])
def test_attn_block_matches_flax(use_kernels):
  """use_pallas=True takes flax's einsum path on the CPU; use_kernels=True
  takes the kernel wrapper, which runs its plain version for CPU tensors."""
  x = _x((2, 6, 5, 32))  # T = 30 tokens
  module = jax_layers.AttnBlock(use_pallas=True)
  params, flat = init_flax_module(module, jnp.asarray(x))
  want = module.apply({'params': params}, jnp.asarray(x))
  port = load_torch_module(layers.AttnBlock(32, use_kernels), flat)
  np.testing.assert_allclose(nhwc(port(nchw(x))), np.asarray(want),
                             rtol=RTOL, atol=ATOL)


def test_attn_block_kernel_path_never_falls_back():
  """With use_kernels the block hands non-CPU tensors to the kernel
  wrapper, which raises where it has no kernel instead of running the plain
  version."""
  block = layers.AttnBlock(32, use_kernels=True).to('meta')
  with pytest.raises(ValueError, match='unsupported device'):
    block(torch.empty((1, 32, 4, 4), device='meta'))


@pytest.mark.parametrize('module', ['Conv2d', 'Linear', 'GroupNormF32'])
def test_cast_at_use_is_reused_until_the_parameter_changes(module):
  """Without autograd the bfloat16 cast of a float32 weight is made once and
  reused; an optimizer step or an EMA lerp on the weight makes the next call
  cast afresh, so the output always equals a fresh cast's. Under autograd
  the cast is in the graph and the float32 weight gets its gradient."""
  gen = torch.Generator().manual_seed(0)
  if module == 'Conv2d':
    layer, x = layers.Conv2d(4, 4, 3, padding=1), torch.randn(
        (2, 4, 5, 5), generator=gen)
  elif module == 'Linear':
    layer, x = layers.Linear(6, 4), torch.randn((3, 6), generator=gen)
  else:
    layer, x = layers.GroupNormF32(32), torch.randn((2, 32, 3, 3),
                                                     generator=gen)
  x = x.bfloat16()

  def fresh():
    casts = {n: p.detach().bfloat16() for n, p in layer.named_parameters()}
    return torch.func.functional_call(layer, casts, (x,))

  with torch.inference_mode():
    layer(x)
    cast = layers.cast_param(layer, 'weight', torch.bfloat16)
    assert layers.cast_param(layer, 'weight', torch.bfloat16) is cast
  optimizer = torch.optim.AdamW(layer.parameters(), lr=0.1)
  layer(x).float().square().sum().backward()
  assert layer.weight.grad.dtype == torch.float32
  assert layer.weight.grad.abs().sum() > 0
  optimizer.step()
  with torch.no_grad():
    assert torch.equal(layer(x), fresh())
    assert layers.cast_param(layer, 'weight', torch.bfloat16) is not cast
    torch._foreach_lerp_(list(layer.parameters()),
                         [torch.zeros_like(p) for p in layer.parameters()],
                         0.5)
    assert torch.equal(layer(x), fresh())


def _block_today(block, x, cond):
  """A ResnetBlock's forward as the unfused sites computed it before they
  could run K8: F.silu of each GroupNorm (no dropout)."""
  import torch.nn.functional as F
  h = block.conv1(F.silu(block.GroupNormF32_0(x)))
  h = F.silu(block.GroupNormF32_1(h + block.cond_proj(cond)[:, :, None,
                                                            None]))
  shortcut = x if block.nin_shortcut is None else block.nin_shortcut(x)
  return shortcut + block.conv2(h)


@pytest.mark.parametrize('use_kernels', [False, True])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('module', ['GroupNormF32', 'ResnetBlock'])
def test_gn_swish_sites_keep_their_numbers_on_the_cpu(module, dtype,
                                                      use_kernels):
  """On CPU tensors the GroupNorm -> swish sites (`GroupNormF32.gn_swish`,
  and so `ResnetBlock`) give F.silu(F.group_norm(...)), outputs and
  gradients bit for bit, with `use_kernels` or without: K8's kernels take
  only CUDA tensors."""
  import torch.nn.functional as F
  gen = torch.Generator().manual_seed(7)
  if module == 'GroupNormF32':
    layer = layers.GroupNormF32(48, use_kernels=use_kernels)
    x = torch.randn((2, 48, 5, 5), generator=gen)

    def today(layer, x):
      return F.silu(layer(x))
    inputs = (x,)
  else:
    layer = layers.ResnetBlock(32, 64, 24, use_kernels=use_kernels)
    x = torch.randn((2, 32, 6, 6), generator=gen)
    inputs = (x, torch.randn((2, 24), generator=gen))
    today = _block_today
  with torch.no_grad():
    for p in layer.parameters():  # every leaf reaches the output
      p.add_(0.1 * torch.randn(p.shape, generator=gen))
  run = layer if module == 'ResnetBlock' else layer.gn_swish
  outs, grads = [], []
  for fn in (run, lambda *a: today(layer, *a)):
    args = [t.to(dtype).requires_grad_() for t in inputs]
    layer.zero_grad()
    out = fn(*args)
    out.float().square().sum().backward()
    outs.append(out)
    grads.append([a.grad for a in args] + [p.grad.clone()
                                           for p in layer.parameters()])
  assert outs[0].dtype == dtype
  assert torch.equal(outs[0], outs[1])
  assert all(torch.equal(a, b) for a, b in zip(*grads))
