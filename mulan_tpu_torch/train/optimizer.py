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
    when |g| >= max (`torch.nn.utils.clip_grad_norm_` adds 1e-6 to |g|).
optax's `-lr (adam + wd p)` equals `torch.optim.AdamW`'s decoupled
`p *= 1 - lr wd` followed by the Adam step, so AdamW runs each group. The
`fused` and `stacked` variants are not ported (ROADMAP.md Queue A).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import torch

TOP_LEVEL_GROUPS = ('encoder_model', 'score_model', 'gamma')


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


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
  """Scales `grads` in place by max_norm / |g| when |g| >= max_norm;
  returns |g| (a tensor, so the host does not wait for the device)."""
  norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
  torch._foreach_mul_(grads, torch.where(norm < max_norm, 1.0,
                                         max_norm / norm))
  return norm


class TwoGroupAdamW:
  """AdamW over named parameters in the two groups (each split once more
  into decayed and undecayed tensors)."""

  def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
               lr_schedule: Callable[[int], float], *, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8,
               weight_decay: float = 1e-4, gamma_lr_scale: float = 1.0,
               clip_norm: Optional[float] = None):
    buckets = {}
    self.params = []
    for name, p in named_params:
      top = name.split('.', 1)[0]
      if top not in TOP_LEVEL_GROUPS:
        raise ValueError(f'unexpected param group: {top}')
      scale = 1.0 if top == 'score_model' else gamma_lr_scale
      buckets.setdefault((scale, decayed(name)), []).append(p)
      self.params.append(p)
    groups = [dict(params=ps, lr_scale=scale,
                   weight_decay=weight_decay if decay else 0.0)
              for (scale, decay), ps in sorted(buckets.items())]
    self.adamw = torch.optim.AdamW(groups, lr=0.0, betas=(b1, b2), eps=eps)
    self.lr_schedule = lr_schedule
    self.clip_norm = clip_norm
    self.count = 0

  def step(self) -> None:
    """One update from the parameters' `.grad`, at lr_schedule(count)."""
    if self.clip_norm is not None:
      clip_by_global_norm_([p.grad for p in self.params], self.clip_norm)
    lr = self.lr_schedule(self.count)
    for group in self.adamw.param_groups:
      group['lr'] = lr * group['lr_scale']
    self.adamw.step()
    self.count += 1

  def zero_grad(self) -> None:
    self.adamw.zero_grad(set_to_none=True)


def make_optimizer(named_params, optimizer_config, lr_schedule,
                   gamma_lr_scale: float = 1.0) -> TwoGroupAdamW:
  """The counterpart of `make_optimizer` for a `configs.OptimizerConfig`."""
  if optimizer_config.name != 'adamw':
    raise ValueError(f'unknown optimizer: {optimizer_config.name!r}')
  args = optimizer_config.args
  return TwoGroupAdamW(named_params, lr_schedule, b1=args.b1, b2=args.b2,
                       eps=args.eps, weight_decay=args.weight_decay,
                       gamma_lr_scale=gamma_lr_scale,
                       clip_norm=optimizer_config.gradient_clip_norm)
