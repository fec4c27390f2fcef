"""The port's model zoo: the baseline VDM and MuLAN-velocity, and
`build_model`, the counterpart of `mulan_tpu.models.build_model`."""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from mulan_tpu_torch.models.config import ModelConfig
from mulan_tpu_torch.models.mulan import MuLAN
from mulan_tpu_torch.models.vdm import VDM

# `vdm_type` -> model class (`mulan_tpu/models/__init__.py:11-24`).
# 'mulan_epsilon' is not ported (ROADMAP.md Queue A, model variants).
MODELS = {'vdm': VDM, 'mulan_velocity': MuLAN}


def make_model(vdm_type: str, config: ModelConfig) -> torch.nn.Module:
  """The model of `vdm_type` for `config`, its parameters uninitialized
  (build under `torch.device('meta')` for names and shapes alone)."""
  if vdm_type == 'mulan_epsilon':
    raise NotImplementedError(
        "vdm_type='mulan_epsilon' is not ported yet; see ROADMAP.md Queue A, "
        'model variants')
  if vdm_type not in MODELS:
    raise ValueError(f'unknown vdm_type: {vdm_type!r}')
  return MODELS[vdm_type](config)


def resolve_device(device) -> torch.device:
  """The device as given; a CUDA device must exist (no silent fallback to
  the CPU, which the caller has to ask for)."""
  device = torch.device(device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(f'device {device} requested but CUDA is not '
                       "available; pass device='cpu' to run on the CPU")
  return device


def build_model(vdm_type: str, config: ModelConfig, *, device='cuda',
                state: Optional[Mapping[str, torch.Tensor]] = None
                ) -> torch.nn.Module:
  """The model of `vdm_type` ('vdm' or 'mulan_velocity') on `device` (the
  card unless the caller asks for the CPU), with the parameters of `state`
  (a state_dict, e.g. from `params.from_flax`) or, without one,
  `params.init_params` from seed 0."""
  from mulan_tpu_torch import params  # params imports this package
  device = resolve_device(device)
  model = make_model(vdm_type, config)
  if state is None:
    state = params.init_params(config, torch.Generator().manual_seed(0),
                               vdm_type=vdm_type)
  model.load_state_dict(state)
  return model.to(device)


__all__ = ['MODELS', 'MuLAN', 'ModelConfig', 'VDM', 'build_model',
           'make_model', 'resolve_device']
