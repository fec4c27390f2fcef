"""Train state with EMA parameters, counterpart of
`mulan_tpu/train/state.py:TrainState`.

The EMA starts as a deep copy of the parameters (in a copy of the model, so
that evaluation can run on it) and follows each update with
`ema += (1 - rate) (p - ema)`. Unlike JAX's immutable state, the parameters,
the optimizer's moments and the EMA are updated in place (the EMA through
`torch._foreach_lerp_`, whose formula for weights below 1/2 is exactly that
one), so a step holds no second copy of any of them.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict

import torch

from mulan_tpu_torch.train.optimizer import TwoGroupAdamW


@dataclasses.dataclass
class TrainState:
  step: int
  params: Dict[str, torch.nn.Parameter]
  ema_params: Dict[str, torch.Tensor]
  optimizer: TwoGroupAdamW
  ema_model: torch.nn.Module

  @classmethod
  def create(cls, model: torch.nn.Module,
             optimizer: TwoGroupAdamW) -> 'TrainState':
    ema_model = copy.deepcopy(model).requires_grad_(False).eval()
    return cls(step=0, params=dict(model.named_parameters()),
               ema_params=dict(ema_model.named_parameters()),
               optimizer=optimizer, ema_model=ema_model)

  @torch.no_grad()
  def apply_gradients(self, ema_rate: float) -> None:
    """The optimizer step from the parameters' gradients, then the EMA."""
    self.optimizer.step()
    torch._foreach_lerp_(list(self.ema_params.values()),
                         list(self.params.values()), 1.0 - ema_rate)
    self.step += 1
