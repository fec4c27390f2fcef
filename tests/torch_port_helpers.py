"""Helpers shared by the PyTorch-port parity tests (tests/test_torch_*.py).

Both packages get the same inputs: parameters come from one flax init,
flattened with `flatten_dict(sep='/')` and transplanted with
`mulan_tpu_torch.params.from_flax`; noise comes from numpy, seeded by shape
as in `parity_helpers.frozen_randomness`, so that the JAX side can draw it
through its patched `jax.random` while the port is handed the same arrays.
"""

import dataclasses

from flax.traverse_util import flatten_dict, unflatten_dict
import jax
import jax.numpy as jnp
import numpy as np
import torch

from mulan_tpu.models import build_model
from mulan_tpu.models.config import ModelConfig as JaxModelConfig
from mulan_tpu_torch.models import make_model
from mulan_tpu_torch.models.config import ModelConfig
from mulan_tpu_torch.models.mulan import MuLAN
from mulan_tpu_torch import params as params_lib
from mulan_tpu_torch.params import from_flax
from parity_helpers import shape_seed

# The tier-1 run uses several xdist workers on a shared host: keep torch
# from starting one thread per core in each.
torch.set_num_threads(2)

PERTURB_STD = 0.02


def jax_config(cfg: ModelConfig) -> JaxModelConfig:
  """The JAX ModelConfig with the port config's fields (use_pallas for
  use_kernels)."""
  fields = dataclasses.asdict(cfg)
  fields['use_pallas'] = fields.pop('use_kernels')
  return JaxModelConfig(**fields)


def perturb_zero_leaves(flat, seed: int = 0, std: float = PERTURB_STD):
  """Numpy copy of a flat param dict with every all-zero leaf (the
  zero-initialized layers and biases) replaced by seeded N(0, std) noise:
  with those at zero, attention and ResNet bodies would not reach the
  output."""
  rs = np.random.RandomState(seed)
  out = {}
  for key in sorted(flat):
    value = np.asarray(flat[key], np.float32)
    if not value.any():
      value = (std * rs.standard_normal(value.shape)).astype(np.float32)
    out[key] = value
  return out


def init_flax_module(module, *args, seed: int = 0, **kwargs):
  """(params pytree, flat numpy dict), zero leaves perturbed."""
  params = module.init(jax.random.PRNGKey(seed), *args, **kwargs)['params']
  flat = perturb_zero_leaves(flatten_dict(params, sep='/'), seed)
  return unflatten_dict({tuple(k.split('/')): jnp.asarray(v)
                         for k, v in flat.items()}), flat


def load_torch_module(module: torch.nn.Module, flat) -> torch.nn.Module:
  module.load_state_dict(from_flax(flat))
  return module.eval()


def mulan_pair(cfg: ModelConfig, batch: int = 2, seed: int = 0):
  """(flax MuLAN-velocity, its params, the port's MuLAN with the same
  parameters)."""
  model = build_model('mulan_velocity', jax_config(cfg))
  images = jnp.zeros((batch, *cfg.image_shape), jnp.uint8)
  # jit: an eager flax init dispatches thousands of small ops (4x slower).
  init = jax.jit(lambda rngs: model.init(
      rngs, images, jnp.zeros((batch,), jnp.int32), jnp.zeros((batch,)),
      step=-1.0)['params'])
  params = init({'params': jax.random.PRNGKey(seed),
                 'sample': jax.random.PRNGKey(seed + 1)})
  flat = perturb_zero_leaves(flatten_dict(params, sep='/'), seed)
  params = unflatten_dict({tuple(k.split('/')): jnp.asarray(v)
                           for k, v in flat.items()})
  return model, params, load_torch_module(MuLAN(cfg), flat)


def seeded_pair(cfg: ModelConfig, seed: int = 0,
                vdm_type: str = 'mulan_velocity'):
  """(the flax model of `vdm_type`, its params, the port's model with them)
  like `mulan_pair`, from the port's seeded `init_params` (zero-init leaves
  perturbed) handed to flax through `params.to_flax`: no flax init to
  compile."""
  state = params_lib.init_params(cfg, torch.Generator().manual_seed(seed),
                                 perturb_zero_init=PERTURB_STD,
                                 vdm_type=vdm_type)
  port = make_model(vdm_type, cfg)
  port.load_state_dict(state)
  jax_params = unflatten_dict({tuple(k.split('/')): jnp.asarray(v)
                               for k, v in params_lib.to_flax(state).items()})
  return build_model(vdm_type, jax_config(cfg)), jax_params, port.eval()


def shaped_normal(shape) -> np.ndarray:
  """What the patched jax.random.normal returns for this shape."""
  return np.random.RandomState(shape_seed(shape)).standard_normal(
      shape).astype(np.float32)


def shaped_gamma(a: float, shape) -> np.ndarray:
  """What the patched jax.random.gamma returns for this shape."""
  rs = np.random.RandomState(shape_seed(shape) ^ 0x5A5A5A)
  return rs.gamma(float(a), 1.0, size=shape).astype(np.float32)


def to_torch(a) -> torch.Tensor:
  return torch.from_numpy(np.array(a))


def nchw(a) -> torch.Tensor:
  """NHWC array -> NCHW torch tensor."""
  return to_torch(a).permute(0, 3, 1, 2).contiguous()


def nhwc(t: torch.Tensor) -> np.ndarray:
  """NCHW torch tensor -> NHWC numpy array."""
  return t.detach().permute(0, 2, 3, 1).numpy()
