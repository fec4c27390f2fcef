"""Two-group AdamW and its learning-rate schedule, counterpart of
`mulan_tpu/train/optimizer.py` (`make_lr_schedule`, `make_optimizer`).

What the optax chain does, written for PyTorch:
  * two groups split on the top-level module: `score_model` against
    {`encoder_model`, `gamma`}; the second group's learning rate is scaled by
    `lr_gamma_network_scale`;
  * weight decay on every tensor whose last name is not `bias`, so the
    GroupNorm scales (`weight` here) are decayed (`optimizer.py:45-48`);
  * the schedule is read at the count before the update, so with a linear
    warm-up from 0 the first update has learning rate 0;
  * optional clipping to a global norm in optax's form: g * max / |g| only
    when |g| >= max (`torch.nn.utils.clip_grad_norm_` adds 1e-6 to |g|);
    under FSDP |g| is taken over every rank's shards, and under tensor
    parallelism over every rank's slices, each element once.
optax's `-lr (adam + wd p)` equals `torch.optim.AdamW`'s decoupled
`p *= 1 - lr wd` followed by the Adam step, so AdamW runs each group.

JAX's two other implementations of the same update map to torch's own:
`optimizer.fused` (`make_fused_adamw`, one flat parameter vector with
per-element masks) to `torch.optim.AdamW(fused=True)` on each group, the
clipping kept; `optimizer.stacked` (`make_stacked_adamw`, leaves of one
shape stacked into one update) to its multi-tensor path (`foreach=True`),
which, like JAX's, refuses optimizer arguments other than `b1`, `b2`,
`eps` and `weight_decay`. Without either, torch picks its path (the
multi-tensor one for tensors on the card).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist

from mulan_tpu_torch.parallel import tensor as tensor_lib
from mulan_tpu_torch.parallel.wrap import is_sharded, local

TOP_LEVEL_GROUPS = ('encoder_model', 'score_model', 'gamma')
# The optimizer arguments the stacked variant implements
# (`optimizer.py:207-212`).
STACKED_ARGS = ('b1', 'b2', 'eps', 'weight_decay')


def make_lr_schedule(learning_rate: float, num_steps_lr_warmup: int,
                     num_steps_train: int, lr_decay: bool
                     ) -> Callable[[int], float]:
  """Linear warm-up from 0 over `num_steps_lr_warmup` counts (constant
  without one), then with `lr_decay` linear decay to 0 at
  `num_steps_train` (optax's `linear_schedule` and `join_schedules`)."""

  def linear(count, start, end, steps):
    frac = 1.0 - min(max(count, 0), steps) / steps
    return (start - end) * frac + end

  def schedule(count: int) -> float:
    if num_steps_lr_warmup > 0 and (count < num_steps_lr_warmup
                                    or not lr_decay):
      return linear(count, 0.0, learning_rate, num_steps_lr_warmup)
    if not lr_decay:
      return learning_rate
    return linear(count - max(num_steps_lr_warmup, 0), learning_rate, 0.0,
                  num_steps_train - max(num_steps_lr_warmup, 0))

  return schedule


def decayed(name: str) -> bool:
  return name.rsplit('.', 1)[-1] != 'bias'


def global_norm(grads, split=None, tensor=None) -> torch.Tensor:
  """|g| over all the gradients, each element counted once. A sharded
  (FSDP) gradient's local tensor is one rank's part of it: its squared
  norm is summed over the mesh dimensions it is sharded on. With a
  `tensor` group, the gradients flagged in `split` are a rank's slices of
  the tensor group's (`parallel/tensor.py`): their squared norm is summed
  over the group too, while the others are whole on every rank of it.
  Plain gradients are whole over the batch axes."""
  if tensor is not None:
    flags = list(split)
    whole = global_norm([g for g, f in zip(grads, flags) if not f])
    sliced = global_norm([g for g, f in zip(grads, flags) if f]).square()
    return torch.sqrt(whole.square() + tensor_lib._sum(sliced, tensor))
  if not grads:
    return torch.zeros(())
  sharded = [g for g in grads if is_sharded(g)]
  plain = [g for g in grads if not is_sharded(g)]
  if not sharded:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(plain)))
  mesh, placements = sharded[0].device_mesh, sharded[0].placements
  sq = torch.stack(torch._foreach_norm([local(g) for g in sharded])
                   ).square().sum()
  for dim, placement in enumerate(placements):
    if placement.is_shard():
      dist.all_reduce(sq, group=mesh.get_group(dim))
  if plain:
    sq = sq + torch.stack(torch._foreach_norm(plain)).square().sum()
  return torch.sqrt(sq)


def clip_by_global_norm_(grads, max_norm: float, split=None,
                         tensor=None) -> torch.Tensor:
  """Scales `grads` in place by max_norm / |g| when |g| >= max_norm;
  returns |g| (a tensor, so the host does not wait for the device);
  `split` and `tensor` as `global_norm`'s."""
  norm = global_norm(grads, split, tensor)
  torch._foreach_mul_([local(g) for g in grads],
                      torch.where(norm < max_norm, 1.0, max_norm / norm))
  return norm


class TwoGroupAdamW:
  """AdamW over named parameters in the two groups (each split once more
  into decayed and undecayed tensors).

  Under FSDP each of those groups is split once more into its sharded
  (DTensor) and its plain parameters (`REPLICATED_GROUPS`), since
  `torch.optim`'s multi-tensor kernels refuse to mix the two. `state_dict`
  and `load_state_dict` speak the unsplit layout, the one a single process
  has, so that a checkpoint moves between world sizes and `training.fsdp`.
  With a `tensor` group the parameters are a rank's slices: AdamW acts on
  them elementwise, the clipping norm counts each element once, and the
  state's names (`names`) let a checkpoint gather the moments whole.
  `implementation` is None (torch's choice), 'fused' or 'stacked' (the
  multi-tensor path); the state is the same either way.
  """

  def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
               lr_schedule: Callable[[int], float], *, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8,
               weight_decay: float = 1e-4, gamma_lr_scale: float = 1.0,
               clip_norm: Optional[float] = None, tensor=None,
               implementation: Optional[str] = None):
    buckets, unsplit = {}, {}
    self.params, self._param_names = [], []
    self.tensor = tensor
    for name, p in named_params:
      top = name.split('.', 1)[0]
      if top not in TOP_LEVEL_GROUPS:
        raise ValueError(f'unexpected param group: {top}')
      scale = 1.0 if top == 'score_model' else gamma_lr_scale
      buckets.setdefault((scale, decayed(name), is_sharded(p)), []).append(
          (name, p))
      unsplit.setdefault((scale, decayed(name)), []).append(name)
      self.params.append(p)
      self._param_names.append(name)
    keys = sorted(buckets)
    groups = [dict(params=[p for _, p in buckets[key]], lr_scale=key[0],
                   weight_decay=weight_decay if key[1] else 0.0)
              for key in keys]
    path = {None: {}, 'fused': {'fused': True},
            'stacked': {'foreach': True}}[implementation]
    self.adamw = torch.optim.AdamW(groups, lr=0.0, betas=(b1, b2), eps=eps,
                                   **path)
    # The parameters' names in the order torch numbers them, and the
    # unsplit groups' names in theirs.
    self._names = [name for key in keys for name, _ in buckets[key]]
    self._unsplit = [unsplit[key] for key in sorted(unsplit)]
    self._split = any(key[2] for key in keys)
    # Which parameters are a tensor rank's slices, in `params` order.
    self._tensor_split = [tensor is not None and
                          tensor_lib.split_segments(name) is not None
                          for name in self._param_names]
    self.lr_schedule = lr_schedule
    self.clip_norm = clip_norm
    self.count = 0

  def step(self) -> None:
    """One update from the parameters' `.grad`, at lr_schedule(count)."""
    if self.clip_norm is not None:
      clip_by_global_norm_([p.grad for p in self.params], self.clip_norm,
                           self._tensor_split, self.tensor)
    lr = self.lr_schedule(self.count)
    for group in self.adamw.param_groups:
      group['lr'] = lr * group['lr_scale']
    self.adamw.step()
    self.count += 1

  def zero_grad(self) -> None:
    self.adamw.zero_grad(set_to_none=True)

  @property
  def names(self):
    """The parameters' names in the order of `state_dict`'s indices."""
    return [name for group in self._unsplit for name in group]

  def state_dict(self) -> Dict[str, Any]:
    """The AdamW state as `torch.optim` gives it, in the unsplit layout."""
    sd = self.adamw.state_dict()
    if not self._split:
      return sd
    unsplit_of = {n: k for k, g in enumerate(self._unsplit) for n in g}
    index = {n: i for i, n in enumerate(n for g in self._unsplit for n in g)}
    hyper = {}
    for group in sd['param_groups']:
      hyper.setdefault(unsplit_of[self._names[group['params'][0]]],
                       {h: v for h, v in group.items() if h != 'params'})
    return {'state': {index[self._names[i]]: st
                      for i, st in sd['state'].items()},
            'param_groups': [dict(hyper[k], params=[index[n] for n in g])
                             for k, g in enumerate(self._unsplit)]}

  def load_state_dict(self, sd: Dict[str, Any]) -> None:
    """Loads a `state_dict()` (the unsplit layout) into this optimizer."""
    if not self._split:
      self.adamw.load_state_dict(sd)
      return
    if len(sd['param_groups']) != len(self._unsplit):
      raise ValueError(f'{len(sd["param_groups"])} optimizer groups saved, '
                       f'{len(self._unsplit)} here')
    unsplit_of = {n: k for k, g in enumerate(self._unsplit) for n in g}
    saved_names = [n for g in self._unsplit for n in g]
    index = {n: i for i, n in enumerate(self._names)}
    groups, start = [], 0
    for group in self.adamw.param_groups:
      count = len(group['params'])
      saved = sd['param_groups'][unsplit_of[self._names[start]]]
      groups.append(dict({h: v for h, v in saved.items() if h != 'params'},
                         params=list(range(start, start + count))))
      start += count
    self.adamw.load_state_dict({
        'state': {index[saved_names[i]]: st
                  for i, st in sd['state'].items()},
        'param_groups': groups})


def make_optimizer(named_params, optimizer_config, lr_schedule,
                   gamma_lr_scale: float = 1.0, tensor=None) -> TwoGroupAdamW:
  """The counterpart of `make_optimizer` for a `configs.OptimizerConfig`:
  `fused` before `stacked`, as JAX tests them; `tensor` as
  `TwoGroupAdamW`'s."""
  if optimizer_config.name != 'adamw':
    raise ValueError(f'unknown optimizer: {optimizer_config.name!r}')
  args = optimizer_config.args
  implementation = None
  if optimizer_config.fused:
    implementation = 'fused'
  elif optimizer_config.stacked:
    implementation = 'stacked'
    unknown = set(vars(args)) - set(STACKED_ARGS)
    if unknown:
      raise ValueError(
          f'stacked adamw does not implement optimizer args {sorted(unknown)};'
          ' use the default implementation for those')
  return TwoGroupAdamW(named_params, lr_schedule, b1=args.b1, b2=args.b2,
                       eps=args.eps, weight_decay=args.weight_decay,
                       gamma_lr_scale=gamma_lr_scale,
                       clip_norm=optimizer_config.gradient_clip_norm,
                       tensor=tensor, implementation=implementation)
