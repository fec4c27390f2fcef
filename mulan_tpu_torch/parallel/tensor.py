"""Tensor parallelism of the score UNet: its column-parallel layout, the
collectives between its layers, and the slices of its parameters;
counterpart of what GSPMD inserts behind `param_sharding` and
`constrain_activation_channels` (`mulan_tpu/parallel/mesh.py:78-146`).

A rank of a tensor group of `size` ranks holds, of every score-UNet
`Conv2d`, `Linear` and `GroupNormF32`, slice `rank` of the output features
(dim 0 of each of its parameters), the contiguous slice that JAX's
`param_sharding` puts on 'tensor'. The one exception to contiguity is the
first GroupNorm of an up block, which normalizes the concatenation [h,
skip] of two channel-sharded tensors: a rank holds [h_r, skip_r], slice
`rank` of each half (`segments` = 2), and its parameters follow that
layout. `conv_out` (3 channels) stays whole on every rank, as do the
encoder and the schedule network (`split_segments`). The parameters are
plain local tensors, not DTensors: under FSDP2 they are sharded once more
over the batch axes like any other tensor.

Between blocks the activations are channel-sharded, (B, C / size, H, W).
A layer that needs every channel gathers them first (`gather`), and what
the gather's backward must do depends on what the gathered tensor feeds:

  * a column-parallel layer (a conv or a dense layer whose output is
    sharded): each rank's backward gives only its output slice's part of
    the input gradient, so the true gradient is their sum, and the
    gather's backward is a reduce-scatter (`grad='sum'`: an all-reduce in
    float32, then the rank's slice);
  * compute that every rank repeats whole on the same input (the
    attention itself, `conv_out`): each rank already holds the whole
    gradient, and the gather's backward keeps its slice (`grad='slice'`).

A tensor that is whole on every rank and enters a column-parallel layer
(z into `conv_in`, the conditioning into `dense0`, the attention's output
into `proj_out`) passes `enter`: the identity forward, and in the backward
the sum of the ranks' partial gradients, so that what precedes it (the
encoder, the schedule network, the ODE's input gradient) sees the whole
gradient on every rank. Sums are taken in float32 and cast back.

Every helper is the identity with no group (one process, tp = 1), so the
one-process path runs what it ran before.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional

import torch
import torch.distributed as dist

from mulan_tpu_torch.parallel import mesh as mesh_lib


class TensorGroup(NamedTuple):
  """This rank's place in its tensor group: `rank` of `size`, and the
  process group (None only for in-process tests that never communicate)."""
  rank: int
  size: int
  group: Optional[dist.ProcessGroup] = None

  def __deepcopy__(self, memo):  # a model's copy (the EMA's) shares it
    return self

  def part(self, width: int) -> int:
    """The local share of `width` channels (which must divide)."""
    if width % self.size:
      raise ValueError(f'{width} channels do not split over a tensor group '
                       f'of {self.size}')
    return width // self.size

  def window(self, width: int):
    """(first channel, width): this rank's channels of `width`."""
    return self.rank * self.part(width), width


def tensor_group(mesh) -> Optional[TensorGroup]:
  """This rank's tensor group on `mesh` (None without a 'tensor' axis)."""
  if not mesh_lib.has_tensor(mesh):
    return None
  return TensorGroup(mesh.get_local_rank(mesh_lib.TENSOR_AXIS),
                     mesh.size(mesh.mesh_dim_names.index(
                         mesh_lib.TENSOR_AXIS)),
                     mesh.get_group(mesh_lib.TENSOR_AXIS))


def part(width: int, tensor: Optional[TensorGroup]) -> int:
  """The local share of `width` channels (`width` without a group)."""
  return width if tensor is None else tensor.part(width)


def split_segments(name: str) -> Optional[int]:
  """The segments of a state_dict entry's split over 'tensor' (along dim
  0), or None for an entry every rank holds whole: every score-UNet
  parameter but `conv_out`'s, in 2 segments for the up blocks' first
  GroupNorm ([h, skip])."""
  parts = name.split('.')
  if parts[0] != 'score_model' or parts[1] == 'conv_out':
    return None
  if parts[1].startswith('up_block_') and parts[2] == 'GroupNormF32_0':
    return 2
  return 1


# -- layouts --------------------------------------------------------------------


def _blocks(x: torch.Tensor, dim: int, segments: int, size: int):
  """x viewed with its (global) dim split into (segments, size, width),
  and the dim's index."""
  d = dim % x.dim()
  n = x.shape[d]
  if n % (segments * size):
    raise ValueError(f'{n} channels do not split into {segments} segments '
                     f'over {size} ranks')
  return x.reshape(*x.shape[:d], segments, size, n // (segments * size),
                   *x.shape[d + 1:]), d


def take(x: torch.Tensor, tensor: Optional[TensorGroup], dim: int = 1,
         segments: int = 1) -> torch.Tensor:
  """This rank's channels of a whole tensor along `dim` (differentiable:
  the backward puts the gradient at those channels, zeros elsewhere)."""
  if tensor is None:
    return x
  v, d = _blocks(x, dim, segments, tensor.size)
  local = v.select(d + 1, tensor.rank)
  return local.reshape(*x.shape[:d], -1, *x.shape[d + 1:])


def _assemble(parts: torch.Tensor, dim: int, segments: int) -> torch.Tensor:
  """The whole tensor from every rank's part, stacked on a leading axis."""
  size, local = parts.shape[0], parts.shape[1:]
  d = dim % len(local)
  v = parts.reshape(size, *local[:d], segments, local[d] // segments,
                    *local[d + 1:]).movedim(0, d + 1)
  return v.reshape(*local[:d], size * local[d], *local[d + 1:])


def _gather_parts(x: torch.Tensor, tensor: TensorGroup) -> torch.Tensor:
  """(size, *x.shape): every rank's x in rank order, on x's device."""
  comm = mesh_lib._comm_device(x.device, tensor.group)
  src = x.detach().to(comm).contiguous()
  out = torch.empty((tensor.size, *x.shape), dtype=x.dtype, device=comm)
  dist.all_gather(list(out.unbind(0)), src, group=tensor.group)
  return out.to(x.device)


def _sum(x: torch.Tensor, tensor: TensorGroup) -> torch.Tensor:
  """The sum of x over the group, in float32, in x's type."""
  comm = mesh_lib._comm_device(x.device, tensor.group)
  buf = x.detach().to(device=comm, dtype=torch.float32, copy=True)
  dist.all_reduce(buf, group=tensor.group)
  return buf.to(device=x.device, dtype=x.dtype)


def _sum_scatter(g: torch.Tensor, tensor: TensorGroup, dim: int,
                 segments: int) -> torch.Tensor:
  """This rank's channels of the sum of the ranks' whole `g` (an
  all-reduce and a slice, the one path of gloo and NCCL alike)."""
  return take(_sum(g, tensor), tensor, dim, segments).contiguous()


class _Gather(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, tensor, dim, segments, sum_grad):
    ctx.args = (tensor, dim, segments, sum_grad)
    return _assemble(_gather_parts(x, tensor), dim, segments)

  @staticmethod
  def backward(ctx, g):
    tensor, dim, segments, sum_grad = ctx.args
    if sum_grad:
      g = _sum_scatter(g, tensor, dim, segments)
    else:
      g = take(g, tensor, dim, segments).contiguous()
    return g, None, None, None, None


class _Enter(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, tensor):
    ctx.tensor = tensor
    return x.view_as(x)

  @staticmethod
  def backward(ctx, g):
    return _sum(g, ctx.tensor), None


def gather(x: torch.Tensor, tensor: Optional[TensorGroup], dim: int = 1,
           segments: int = 1, grad: str = 'sum') -> torch.Tensor:
  """Every rank's channels of x along `dim`, assembled in the global
  layout (`segments` as `take`'s) on every rank. `grad` says what the
  result feeds: 'sum' a column-parallel layer (the backward reduce-scatters
  the ranks' partial gradients), 'slice' compute every rank repeats whole
  (the backward keeps this rank's channels of the whole gradient)."""
  if tensor is None:
    return x
  if grad not in ('sum', 'slice'):
    raise ValueError(f"gather's grad is 'sum' or 'slice', not {grad!r}")
  return _Gather.apply(x, tensor, dim, segments, grad == 'sum')


def enter(x: torch.Tensor, tensor: Optional[TensorGroup]) -> torch.Tensor:
  """x, whole on every rank, entering a column-parallel layer: the
  identity, whose backward sums the ranks' partial gradients."""
  if tensor is None:
    return x
  return _Enter.apply(x, tensor)


# -- parameters -----------------------------------------------------------------


def take_tensor(name: str, value: torch.Tensor,
                tensor: Optional[TensorGroup]) -> torch.Tensor:
  """This rank's part of entry `name`'s whole tensor: its slice of a
  split entry, the tensor itself otherwise."""
  segments = split_segments(name)
  if tensor is None or segments is None:
    return value
  return take(value, tensor, 0, segments).contiguous()


def take_state(state: Mapping[str, torch.Tensor],
               tensor: Optional[TensorGroup]) -> Dict[str, torch.Tensor]:
  """A whole (one-process) state_dict -> this rank's."""
  return {name: take_tensor(name, value, tensor)
          for name, value in state.items()}


def gather_tensor(name: str, value: torch.Tensor,
                  tensor: Optional[TensorGroup]) -> torch.Tensor:
  """The whole tensor of this rank's entry `name` (a collective for a
  split entry: every rank of the group calls it)."""
  segments = split_segments(name)
  if tensor is None or segments is None:
    return value
  return _assemble(_gather_parts(value.detach(), tensor), 0, segments)


def gather_state(state: Mapping[str, torch.Tensor],
                 tensor: Optional[TensorGroup]) -> Dict[str, torch.Tensor]:
  """This rank's state_dict -> the whole one (a collective), the inverse
  of `take_state`."""
  return {name: gather_tensor(name, value, tensor)
          for name, value in state.items()}
