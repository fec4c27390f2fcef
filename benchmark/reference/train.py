"""The reference's train steps and dense-VLB call, in plain PyTorch.

A train step: the ELBO in bits per dimension on one batch with dropout on,
its gradient, then AdamW (decoupled weight decay on every leaf whose name
does not end in `bias`, the learning rate read at the update count before
the step, a linear warm-up from 0) and the EMA. The batch is processed in
blocks of rows with the gradient summed, so that a float32 step at the
timed batch fits beside nothing else on the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List

import torch

from benchmark.reference import mulan as ref


@contextlib.contextmanager
def full_float32():
  """TF32 off for matmuls and convolutions, as long as the block runs;
  cuDNN picks its fastest float32 algorithm for each shape."""
  saved = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cudnn.benchmark = True
  try:
    yield
  finally:
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.benchmark) = saved


@dataclasses.dataclass(frozen=True)
class AdamW:
  learning_rate: float
  warmup: int
  b1: float
  b2: float
  eps: float
  weight_decay: float
  ema_rate: float

  def lr(self, count: int) -> float:
    if self.warmup > 0:
      return self.learning_rate * min(count, self.warmup) / self.warmup
    return self.learning_rate


@dataclasses.dataclass
class State:
  params: Dict[str, torch.Tensor]
  m: Dict[str, torch.Tensor]
  v: Dict[str, torch.Tensor]
  ema: Dict[str, torch.Tensor]
  count: int = 0

  @classmethod
  def start(cls, params):
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    return cls(params=params, m=zeros,
               v={k: torch.zeros_like(v) for k, v in params.items()},
               ema={k: v.clone() for k, v in params.items()})


def gradient(model: ref.Model, params, images, noise: ref.Noise,
             dropout_seed, num: ref.Numerics = ref.FLOAT32,
             rows_per_block: int = 32, rows=None, double_first=False):
  """(mean bpd over the batch, {name: gradient}). `rows` (a slice of the
  batch's rows), if given, is the only part of the batch the mean is
  taken over; `double_first` doubles the first row's bpd (a fault)."""
  b = images.shape[0]
  lo_all, hi_all = (0, b) if rows is None else (rows.start, rows.stop)
  count = hi_all - lo_all
  leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
  grads = {k: torch.zeros_like(v) for k, v in params.items()}
  total = torch.zeros((), dtype=torch.float64, device=images.device)
  for lo in range(lo_all, hi_all, rows_per_block):
    hi = min(lo + rows_per_block, hi_all)
    bpd = ref.elbo_bpd(leaves, model, images[lo:hi], noise.rows(lo, hi), num,
                       dropout_seed, first_row=lo)
    if double_first and lo == lo_all:
      bpd = torch.cat([2 * bpd[:1], bpd[1:]])
    part = bpd.sum() / count
    got = torch.autograd.grad(part, list(leaves.values()),
                              allow_unused=True)
    for (k, _), g in zip(leaves.items(), got):
      if g is not None:
        grads[k] += g
    total += part.detach().double()
  return float(total), grads


@torch.no_grad()
def apply(opt: AdamW, state: State, grads) -> None:
  lr = opt.lr(state.count)
  t = state.count + 1
  c1 = 1.0 - opt.b1 ** t
  c2 = 1.0 - opt.b2 ** t
  for k, p in state.params.items():
    g = grads[k]
    if not k.endswith('.bias'):
      p.mul_(1.0 - lr * opt.weight_decay)
    state.m[k].mul_(opt.b1).add_(g, alpha=1.0 - opt.b1)
    state.v[k].mul_(opt.b2).addcmul_(g, g, value=1.0 - opt.b2)
    denom = (state.v[k].sqrt() / math.sqrt(c2)).add_(opt.eps)
    p.addcdiv_(state.m[k], denom, value=-lr / c1)
    state.ema[k].add_(p - state.ema[k], alpha=1.0 - opt.ema_rate)
  state.count = t


@dataclasses.dataclass
class Trajectory:
  """The reference's readings of the first steps of a run: each step's
  loss, the first gradient's leaves, the first moment's leaves after
  `moment_after` steps, and the state after the last step."""
  losses: List[float]
  first_grad: Dict[str, torch.Tensor]
  moment: Dict[str, torch.Tensor]
  state: State


def follow(model: ref.Model, opt: AdamW, params, batches, seed: int,
           moment_after: int, num: ref.Numerics = ref.FLOAT32,
           fault: str = '', rows_per_block: int = 32) -> Trajectory:
  """The first len(batches) steps from `params` on `batches` (uint8 image
  tensors (B, H, W, C) on the device), each step's noise keyed by
  (seed, step). `fault` plants a fault for the comparison's readings:
  'half_batch' takes each step's mean over the first half of the rows;
  'answer' doubles the first example's bpd where it is produced."""
  state = State.start({k: v.clone() for k, v in params.items()})
  losses, first, moment = [], None, None
  for step, images in enumerate(batches):
    noise, dropout_seed = ref.train_step_noise(model, seed, step,
                                               images.shape[0],
                                               images.device)
    rows = slice(0, images.shape[0] // 2) if fault == 'half_batch' else None
    loss, grads = gradient(model, state.params, images, noise, dropout_seed,
                           num, rows_per_block, rows,
                           double_first=fault == 'answer')
    losses.append(loss)
    if first is None:
      first = grads
    apply(opt, state, grads)
    if step + 1 == moment_after:
      moment = {k: v.clone() for k, v in state.m.items()}
  return Trajectory(losses, first, moment, state)


@torch.no_grad()
def dense_call_per_image(model: ref.Model, params, images, key: int,
                         n_timesteps: int, images_per_chunk: int,
                         num: ref.Numerics = ref.FLOAT32,
                         rows_per_block: int = 512) -> torch.Tensor:
  """Dense bpd (B,) of one call over `images` (B, H, W, C) uint8 on the
  device: per image the mean over the grid of `n_timesteps` times, the
  generator seeded with `key` and drawn chunk by chunk, the encoder once an
  image."""
  dev = images.device
  gen = torch.Generator(dev).manual_seed(key)
  per_image = []
  for lo in range(0, images.shape[0], images_per_chunk):
    chunk = images[lo:lo + images_per_chunk]
    n = chunk.shape[0]
    noise = ref.dense_chunk_noise(model, gen, n, n_timesteps, dev)
    f = ref.encode(chunk, model.vocab_size).permute(0, 3, 1, 2)
    logits = ref.encoder_logits(params, model, f, num).repeat_interleave(
        n_timesteps, dim=0)
    rows = chunk.repeat_interleave(n_timesteps, dim=0)
    bpd = torch.cat([
        ref.elbo_bpd(params, model, rows[r:r + rows_per_block],
                     noise.rows(r, r + rows_per_block), num,
                     logits=logits[r:r + rows_per_block])
        for r in range(0, rows.shape[0], rows_per_block)])
    per_image.append(bpd.reshape(n, n_timesteps).mean(dim=1))
  return torch.cat(per_image)


def dense_call_bpd(per_image: torch.Tensor, images_per_chunk: int,
                   fault: str = '') -> float:
  """The call's mean of the per-image bpd. `fault`: 'half_batch' leaves
  out the second half of each chunk's images and averages over the rest;
  'answer' sets the first image's bpd to zero where it is produced."""
  if fault == 'half_batch':
    per_image = torch.cat([chunk[:max(1, len(chunk) // 2)] for chunk in
                           per_image.split(images_per_chunk)])
  elif fault == 'answer':
    per_image = torch.cat([torch.zeros_like(per_image[:1]), per_image[1:]])
  elif fault:
    raise ValueError(f'unknown fault {fault!r}')
  return float(per_image.double().mean())
