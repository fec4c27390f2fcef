"""Train state with EMA parameters, counterpart of
`mulan_tpu/train/state.py` (`TrainState`, `merge_restored`).

The EMA starts as a deep copy of the parameters (in a copy of the model, so
that evaluation can run on it) and follows each update with
`ema += (1 - rate) (p - ema)`. Unlike JAX's immutable state, the parameters,
the optimizer's moments and the EMA are updated in place (the EMA through
`torch._foreach_lerp_`, whose formula for weights below 1/2 is exactly that
one), so a step holds no second copy of any of them.

Under FSDP the EMA model is sharded as the model is (`parallel/wrap.py`):
each rank lerps its shards of the EMA towards its shards of the
parameters. `state_dict()` gathers the whole tensors (a collective: every
rank calls it), so a checkpoint is the same file at every world size, and
`load_state_dict` lays whole tensors out as this state's are.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Optional

import torch

from mulan_tpu_torch.parallel.wrap import full, is_sharded, local, shard_like
from mulan_tpu_torch.train.optimizer import TwoGroupAdamW


@dataclasses.dataclass
class TrainState:
  step: int
  params: Dict[str, torch.nn.Parameter]
  ema_params: Dict[str, torch.Tensor]
  optimizer: TwoGroupAdamW
  ema_model: torch.nn.Module

  @classmethod
  def create(cls, model: torch.nn.Module, optimizer: TwoGroupAdamW,
             ema_model: Optional[torch.nn.Module] = None) -> 'TrainState':
    """The state at step 0; `ema_model` (a copy of the model, laid out as
    it is) defaults to a deep copy."""
    if ema_model is None:
      ema_model = copy.deepcopy(model).requires_grad_(False).eval()
    return cls(step=0, params=dict(model.named_parameters()),
               ema_params=dict(ema_model.named_parameters()),
               optimizer=optimizer, ema_model=ema_model)

  @torch.no_grad()
  def apply_gradients(self, ema_rate: float) -> None:
    """The optimizer step from the parameters' gradients, then the EMA."""
    self.optimizer.step()
    torch._foreach_lerp_([local(e) for e in self.ema_params.values()],
                         [local(p) for p in self.params.values()],
                         1.0 - ema_rate)
    self.step += 1

  def state_dict(self) -> Dict[str, Any]:
    """{step, params, ema_params, opt_state}: the tensors themselves (no
    copies; whole tensors gathered from sharded ones), the optimizer's
    state as `torch.optim` gives it."""
    adamw = self.optimizer.state_dict()
    adamw['state'] = {i: {k: full(v) for k, v in st.items()}
                      for i, st in adamw['state'].items()}
    return {'step': self.step,
            'params': {k: full(p.detach()) for k, p in self.params.items()},
            'ema_params': {k: full(p) for k, p in self.ema_params.items()},
            'opt_state': {'count': self.optimizer.count, 'adamw': adamw}}

  @torch.no_grad()
  def load_state_dict(self, state: Dict[str, Any]) -> None:
    """Copies a `state_dict()` (tensors on any device) into this state."""
    _check_keys('train state', state, ('step', 'params', 'ema_params',
                                       'opt_state'))
    _check_keys('opt_state', state['opt_state'], ('count', 'adamw'))
    for name in ('params', 'ema_params'):
      self.load_tensors(name, state[name])
    self.optimizer.load_state_dict(state['opt_state']['adamw'])
    adamw = self.optimizer.adamw
    for p in self.optimizer.params:  # whole moments to the params' shards
      if is_sharded(p) and p in adamw.state:
        adamw.state[p] = {k: v if k == 'step' else shard_like(v, p)
                          for k, v in adamw.state[p].items()}
    self.optimizer.count = int(state['opt_state']['count'])
    self.step = int(state['step'])

  @torch.no_grad()
  def load_tensors(self, name: str, tensors: Dict[str, torch.Tensor]) -> None:
    """Copies `tensors` into the 'params' or 'ema_params' in place; the
    names and shapes must be ours."""
    ours = getattr(self, name)
    _check_keys(name, tensors, ours)
    for key, value in ours.items():
      if tuple(tensors[key].shape) != tuple(value.shape):
        raise ValueError(f'{name}[{key!r}]: shape '
                         f'{tuple(tensors[key].shape)} in the checkpoint, '
                         f'{tuple(value.shape)} here')
    for key, value in ours.items():
      local(value).copy_(local(shard_like(tensors[key], value)))


def _check_keys(what: str, got, want) -> None:
  missing = sorted(set(want) - set(got))
  extra = sorted(set(got) - set(want))
  if missing or extra:
    raise ValueError(f'{what}: missing {missing[:8]}, unexpected '
                     f'{extra[:8]}')


def merge_restored(state_dict, restored):
  """Copies into `state_dict` only the keys present in `restored`,
  recursively (`mulan_tpu/train/state.py:merge_restored`): a checkpoint of
  another model warm-starts the leaves the two share."""
  if not isinstance(state_dict, dict):
    return restored
  out = dict(state_dict)
  for key, value in state_dict.items():
    if isinstance(restored, dict) and key in restored:
      out[key] = merge_restored(value, restored[key])
  return out
