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
parameters; under tensor parallelism each rank holds its slices of the
score UNet's (`parallel/tensor.py`, the optimizer's `tensor` group).
`state_dict()` gathers the whole tensors (a collective: every rank calls
it), so a checkpoint is the same file at every world size, `training.fsdp`
and `training.tp`, and `load_state_dict` lays whole tensors out as this
state's are.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Optional

import torch

from mulan_tpu_torch.parallel import tensor as tensor_lib
from mulan_tpu_torch.parallel.wrap import full, is_sharded, local, shard_like
from mulan_tpu_torch.train.optimizer import TwoGroupAdamW
from mulan_tpu_torch.utils import tracing


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
    """The optimizer step from the parameters' gradients, then the EMA,
    in the spans 'optimizer' and 'ema'."""
    with tracing.span('optimizer'):
      self.optimizer.step()
    with tracing.span('ema'):
      torch._foreach_lerp_([local(e) for e in self.ema_params.values()],
                           [local(p) for p in self.params.values()],
                           1.0 - ema_rate)
    self.step += 1

  def _whole(self, name: str, value: torch.Tensor) -> torch.Tensor:
    """The whole tensor of entry `name` (gathered over FSDP's shards and
    the tensor group's slices)."""
    return tensor_lib.gather_tensor(name, full(value),
                                    self.optimizer.tensor)

  def _mine(self, name: str, value: torch.Tensor, like: torch.Tensor):
    """The whole tensor `value` of entry `name` laid out as `like`."""
    return shard_like(tensor_lib.take_tensor(name, value,
                                             self.optimizer.tensor), like)

  def state_dict(self) -> Dict[str, Any]:
    """{step, params, ema_params, opt_state}: the tensors themselves (no
    copies; whole tensors gathered from sharded ones), the optimizer's
    state as `torch.optim` gives it."""
    adamw = self.optimizer.state_dict()
    names = self.optimizer.names
    adamw['state'] = {i: {k: v if k == 'step' else self._whole(names[i], v)
                          for k, v in st.items()}
                      for i, st in adamw['state'].items()}
    return {'step': self.step,
            'params': {k: self._whole(k, p.detach())
                       for k, p in self.params.items()},
            'ema_params': {k: self._whole(k, p)
                           for k, p in self.ema_params.items()},
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
    names = {id(p): n for n, p in self.params.items()}
    for p in self.optimizer.params:  # whole moments to the params' shards
      if p in adamw.state and (is_sharded(p) or tuple(
          adamw.state[p]['exp_avg'].shape) != tuple(p.shape)):
        adamw.state[p] = {k: v if k == 'step' else self._mine(
            names[id(p)], v, p) for k, v in adamw.state[p].items()}
    self.optimizer.count = int(state['opt_state']['count'])
    self.step = int(state['step'])

  @torch.no_grad()
  def load_tensors(self, name: str, tensors: Dict[str, torch.Tensor]) -> None:
    """Copies `tensors` (whole) into the 'params' or 'ema_params' in place;
    the names and shapes must be ours (this rank's slices of them under
    tensor parallelism)."""
    ours = getattr(self, name)
    _check_keys(name, tensors, ours)
    mine = tensor_lib.take_state(tensors, self.optimizer.tensor)
    for key, value in ours.items():
      if tuple(mine[key].shape) != tuple(value.shape):
        raise ValueError(f'{name}[{key!r}]: shape '
                         f'{tuple(tensors[key].shape)} in the checkpoint, '
                         f'{tuple(value.shape)} here')
    for key, value in ours.items():
      local(value).copy_(local(shard_like(mine[key], value)))


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
