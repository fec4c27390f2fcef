"""The model under data parallelism or FSDP, counterpart of
`mulan_tpu/parallel/mesh.py:shard_state` and of the gradient reductions
that XLA inserts under `jit`.

  * A ('data',) mesh: `DistributedDataParallel`, every parameter
    replicated, gradients averaged over the ranks.
  * A mesh with 'fsdp': FSDP2 `fully_shard` (ZeRO-3) on every ResNet and
    attention block of the score UNet and of the encoder, then on the two
    networks themselves for what is left (their stems and heads), over the
    whole mesh: sharded over 'fsdp', replicated over 'data' (HSDP) when
    'data' > 1. `REPLICATED_GROUPS` (the schedule network) stays out of the
    sharding, plain tensors on every rank; `average_plain_grads` averages
    their gradients over every rank after the backward.

With a 'tensor' axis both act on the mesh's batch axes ('data', 'fsdp';
`mesh.batch_mesh`), over each rank's tensor slices (`parallel/tensor.py`):
the ranks of one tensor coordinate hold the same slices, average their
gradients and shard them among themselves. The leaves every rank of a
tensor group holds whole (the encoder, the schedule network, `conv_out`)
have equal gradients there in exact arithmetic; `average_whole_grads`
averages them over the group, so that its copies stay equal whatever
order a card's backward sums in.

Every module under a sharded unit is marked `cache_casts = False`: FSDP2
all-gathers its parameters into storage it reuses, with their version
counters preserved, so `layers.cast_param`'s no-grad cache, keyed on the
storage and the version, could hand back the casts of the weights before
an update.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import torch
from torch import nn

from mulan_tpu_torch.parallel import mesh as mesh_lib
from mulan_tpu_torch.parallel import tensor as tensor_lib


def is_sharded(t: torch.Tensor) -> bool:
  from torch.distributed.tensor import DTensor
  return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
  """A DTensor's local shard, or the tensor itself."""
  return t.to_local() if is_sharded(t) else t


def full(t: torch.Tensor) -> torch.Tensor:
  """The whole tensor of a DTensor (a collective: every rank calls it), or
  the tensor itself."""
  return t.full_tensor() if is_sharded(t) else t


def shard_like(value: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
  """The whole tensor `value` laid out as `like` (a DTensor: this rank's
  shard of it; a plain tensor: value on like's device)."""
  value = value.detach().to(device=like.device, dtype=like.dtype)
  if not is_sharded(like):
    return value
  from torch.distributed.tensor import distribute_tensor
  return distribute_tensor(value, like.device_mesh, like.placements)


def _blocks(module: nn.Module) -> Iterable[nn.Module]:
  from mulan_tpu_torch.models.layers import AttnBlock, ResnetBlock
  return [m for m in module.modules() if isinstance(m, (ResnetBlock,
                                                        AttnBlock))]


def shard_model(model: nn.Module, mesh) -> nn.Module:
  """`fully_shard`s the model's networks in place over `mesh` (see the
  module's docstring) and returns it."""
  from torch.distributed.fsdp import fully_shard
  mesh = mesh_lib.batch_mesh(mesh)
  for name, child in model.named_children():
    if name in mesh_lib.REPLICATED_GROUPS or not any(
        True for _ in child.parameters()):
      continue
    for block in _blocks(child):
      fully_shard(block, mesh=mesh)
    fully_shard(child, mesh=mesh)
    for m in child.modules():
      m.cache_casts = False
  return model


def data_parallel(model: nn.Module, mesh) -> nn.Module:
  """`model` under DistributedDataParallel over the mesh's batch group
  (the default group without a 'tensor' axis). Every parameter of every variant
  `mulan_tpu_torch` builds reaches its loss (tests/test_torch_multiprocess.py
  trains each under DDP), so DDP is not asked to look for unused ones."""
  from torch.nn.parallel import DistributedDataParallel
  dev = next(model.parameters()).device
  return DistributedDataParallel(
      model, device_ids=[dev.index] if dev.type == 'cuda' else None,
      process_group=mesh_lib.batch_group(mesh))


def _average(grads, total, count) -> None:
  """Replaces each of `grads` by total(its values) / count, the
  gradients flattened into one tensor for one collective."""
  flat = total(torch.cat([g.reshape(-1) for g in grads])) / count
  for g, part in zip(grads, flat.split([g.numel() for g in grads])):
    g.copy_(part.view_as(g))


def average_plain_grads(params: Iterable[torch.nn.Parameter],
                        mesh) -> None:
  """Averages over the mesh's batch axes the gradients of the parameters
  that FSDP does not manage (`REPLICATED_GROUPS`), in one collective."""
  grads = [p.grad for p in params
           if p.grad is not None and not is_sharded(p)]
  if not grads or not mesh_lib.is_distributed():
    return
  _average(grads, lambda x: mesh_lib.all_reduce_sum(
      x, mesh_lib.batch_group(mesh)), mesh_lib.batch_world(mesh))


def average_whole_grads(params: Mapping[str, torch.nn.Parameter],
                        tensor: tensor_lib.TensorGroup) -> None:
  """Averages over the tensor group the gradients (this rank's part, under
  FSDP) of the parameters every rank of it holds whole
  (`tensor_lib.split_segments`), in one collective, summed in float32."""
  grads = [local(p.grad) for name, p in params.items()
           if p.grad is not None and tensor_lib.split_segments(name) is None]
  if grads:
    _average(grads, lambda x: tensor_lib._sum(x, tensor), tensor.size)
