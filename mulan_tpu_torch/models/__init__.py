"""The port's model zoo: MuLAN-velocity, and `build_model`, the counterpart
of `mulan_tpu.models.build_model`."""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from mulan_tpu_torch.models.config import ModelConfig
from mulan_tpu_torch.models.mulan import MuLAN


def resolve_device(device) -> torch.device:
  """The device as given; a CUDA device must exist (no silent fallback to
  the CPU, which the caller has to ask for)."""
  device = torch.device(device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(f'device {device} requested but CUDA is not '
                       "available; pass device='cpu' to run on the CPU")
  return device


def build_model(config: ModelConfig, *, device='cuda',
                state: Optional[Mapping[str, torch.Tensor]] = None) -> MuLAN:
  """MuLAN-velocity on `device` (the card unless the caller asks for the
  CPU), with the parameters of `state` (a state_dict, e.g. from
  `params.from_flax`) or, without one, `params.init_params` from seed 0."""
  from mulan_tpu_torch import params  # params imports this package
  device = resolve_device(device)
  if state is None:
    state = params.init_params(config, torch.Generator().manual_seed(0))
  model = MuLAN(config)
  model.load_state_dict(state)
  return model.to(device)


__all__ = ['MuLAN', 'ModelConfig', 'build_model', 'resolve_device']
