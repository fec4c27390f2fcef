"""Parameters for the port: transplanted from a flax tree, or made fresh.

Both functions return a float32 `state_dict` for the model's
`load_state_dict` (`MuLAN` or `VDM`); every parameter of a model is float32
(the UNets cast theirs to `config.dtype` at use). The VDM's learned schedule
(`gamma/l1`, `l2`, `l3`, `DenseMonotone`) keeps flax's (in, out) kernels
and their name, `kernel`; its scalar schedule has `gamma/w` and `gamma/b`.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch

from mulan_tpu_torch.models import make_model
from mulan_tpu_torch.models.config import ModelConfig

# Layers the JAX package zero-initializes (so a fresh block is the identity).
ZERO_INIT = ('cond_proj', 'conv2', 'proj_out', 'conv_out', 'dense_out_a')
# The VDM's `DenseMonotone` layers (`gamma/l1|l2|l3`): (in, out) kernels.
MONOTONE = ('l1', 'l2', 'l3')
# `flax.linen.initializers.normal()`'s stddev (`jax.nn.initializers.normal`,
# whose default is 1e-2), the init of `l2` and `l3`'s kernels
# (`mulan_tpu/models/schedules.py:95-106`).
FLAX_NORMAL_STDDEV = 1e-2


def _monotone(mods) -> bool:
  return mods[0] == 'gamma' and mods[-1] in MONOTONE


def _convert(path: str, value: np.ndarray):
  *mods, leaf = path.split('/')
  if _monotone(mods):  # DenseMonotone: the same (in, out) kernel
    pass
  elif mods[-1] == 'GroupNorm_0':  # GroupNormF32_k/GroupNorm_0/{scale,bias}
    mods = mods[:-1]
    leaf = {'scale': 'weight', 'bias': 'bias'}[leaf]
  elif leaf == 'kernel':
    leaf = 'weight'
    if value.ndim == 4:                      # conv HWIO -> OIHW
      value = value.transpose(3, 2, 0, 1)
    elif mods[-1] == 'nin_shortcut':         # Dense on channels -> 1x1 conv
      value = value.T[:, :, None, None]
    elif mods[-1] == 'proj_out':             # (heads, hd, C) -> (C, heads*hd)
      value = value.reshape(-1, value.shape[-1]).T
    elif value.ndim == 3:                    # q/k/v (C, heads, hd)
      value = value.reshape(value.shape[0], -1).T
    else:                                    # Dense (in, out) -> (out, in)
      value = value.T
  elif leaf == 'bias' and value.ndim == 2:   # q/k/v (heads, hd)
    value = value.reshape(-1)
  return '.'.join([*mods, leaf]), torch.tensor(
      np.ascontiguousarray(value), dtype=torch.float32)


def from_flax(flat: Mapping[str, np.ndarray]) -> dict:
  """Flattened flax params (`flatten_dict(params, sep='/')`, top keys
  score_model / encoder_model / gamma) -> the port's state_dict."""
  return dict(_convert(path, np.asarray(value))
              for path, value in flat.items())


def _export(name: str, value: np.ndarray):
  """The inverse of `_convert` (the port's attention has one head)."""
  *mods, leaf = name.split('.')
  if _monotone(mods):
    pass
  elif mods[-1].startswith('GroupNormF32'):
    mods.append('GroupNorm_0')
    leaf = {'weight': 'scale', 'bias': 'bias'}[leaf]
  elif leaf == 'weight':
    leaf = 'kernel'
    if mods[-1] == 'nin_shortcut':           # 1x1 conv -> Dense on channels
      value = value[:, :, 0, 0].T
    elif value.ndim == 4:                    # conv OIHW -> HWIO
      value = value.transpose(2, 3, 1, 0)
    elif mods[-1] == 'proj_out':             # (C, hd) -> (1, hd, C)
      value = value.T.reshape(1, *value.T.shape)
    elif mods[-1] in ('q', 'k', 'v'):        # (hd, C) -> (C, 1, hd)
      value = value.T.reshape(value.shape[1], 1, value.shape[0])
    else:                                    # (out, in) -> Dense (in, out)
      value = value.T
  elif leaf == 'bias' and mods[-1] in ('q', 'k', 'v'):
    value = value.reshape(1, -1)
  return '/'.join([*mods, leaf]), np.ascontiguousarray(value)


def to_flax(state: Mapping[str, torch.Tensor]) -> dict:
  """The port's state_dict -> flattened flax params (`/`-joined paths,
  float32 numpy), the inverse of `from_flax`."""
  return dict(_export(name, value.detach().cpu().float().numpy())
              for name, value in state.items())


def _scalar_gamma_init(config: ModelConfig, name: str, shape, generator):
  """The JAX initializers of the VDM's schedules
  (`mulan_tpu/models/schedules.py:58-59`, `:95-106`): the linear term at
  gamma_min + (gamma_max - gamma_min) t, the MLP's kernels normal(0, 1e-2),
  its biases 0."""
  span, gmin = config.gamma_max - config.gamma_min, config.gamma_min
  constant = {'gamma.w': span, 'gamma.l1.kernel': span, 'gamma.b': gmin,
              'gamma.l1.bias': gmin}
  if name in constant:
    return torch.full(shape, constant[name])
  if name.endswith('.kernel'):
    return FLAX_NORMAL_STDDEV * torch.randn(shape, generator=generator)
  return torch.zeros(shape)


def init_params(config: ModelConfig, generator: torch.Generator,
                perturb_zero_init: float = 0.0,
                vdm_type: str = 'mulan_velocity') -> dict:
  """A seeded fresh model of `vdm_type`: normal(0, 1/fan_in) weights (the
  variance of flax's lecun_normal), zero biases, unit GroupNorm scales, the
  layers in ZERO_INIT at zero, and the VDM's scalar schedule as JAX
  initializes it. With perturb_zero_init > 0, every all-zero tensor then
  gets normal(0, perturb_zero_init) noise, so that no block is the identity
  and a wrong kernel shows in the output.
  """
  with torch.device('meta'):
    shapes = {name: p.shape for name, p in
              make_model(vdm_type, config).named_parameters()}
  state = {}
  for name, shape in sorted(shapes.items()):
    module, leaf = name.rsplit('.', 1)
    if vdm_type == 'vdm' and module.split('.', 1)[0] == 'gamma':
      value = _scalar_gamma_init(config, name, shape, generator)
    elif leaf == 'bias' or module.rsplit('.', 1)[-1] in ZERO_INIT:
      value = torch.zeros(shape)
    elif 'GroupNormF32' in module:
      value = torch.ones(shape)
    else:
      fan_in = math.prod(shape[1:])
      value = torch.randn(shape, generator=generator) / math.sqrt(fan_in)
    if perturb_zero_init > 0 and not value.any():
      value = value + perturb_zero_init * torch.randn(shape,
                                                      generator=generator)
    state[name] = value
  return state
