"""Process groups, device meshes and the rows each rank computes,
counterpart of `mulan_tpu/parallel/mesh.py`.

JAX runs one program over the global batch: `jit` over arrays sharded on
'data' (and 'fsdp'), the global array being the processes' local batches
concatenated in process order (`make_array_from_process_local_data`). Here
every rank is one process on one device, and a run on N ranks is correct
when it equals one process fed the global batch:

  * a rank's batch is rows [r b, (r + 1) b) of the global batch of N b
    rows (`Rows`), and every random draw of the global batch (times, noise,
    latent variates, dropout masks) is made at the global shape and cut to
    those rows, so that no rank draws another distribution or repeats
    rank 0's numbers;
  * the data axis averages gradients (DDP on a ('data',) mesh); an 'fsdp'
    axis also shards parameters, gradients, the optimizer's moments and the
    EMA over its ranks (FSDP2 `fully_shard`, ZeRO-3), with
    `REPLICATED_GROUPS` left out of the sharding;
  * results that JAX returns replicated (per-image bpd, samples, scalar
    means) are gathered in rank order (`all_gather_rows`) or all-reduced,
    so every rank returns the same global value;
  * a 'tensor' axis (`training.tp` > 1) splits the score UNet's channels
    over its ranks (`parallel/tensor.py`), which hold the same rows: the
    batch is sharded over the batch axes ('data', 'fsdp') only, as JAX
    replicates it over 'tensor'. The helpers of rows, data shards and
    gathers take the mesh: on one with a 'tensor' axis they count batch
    coordinates (`batch_rank`, `batch_world`), not ranks, and gather over
    the batch group, so every rank of a tensor group draws, holds and
    returns the same rows.

The backend is NCCL for CUDA devices and gloo for the CPU. Helpers given
no mesh run on the default (world) group; with no process group they are
the one-process identity.
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = 'data'
FSDP_AXIS = 'fsdp'
TENSOR_AXIS = 'tensor'

# Top-level parameter groups that stay replicated under 'fsdp'
# (`mulan_tpu/parallel/mesh.py:149-178`): the schedule network. Their
# gradients are averaged over every rank explicitly.
REPLICATED_GROUPS = ('gamma',)

_TORCHRUN_ENV = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
                 'MASTER_PORT')


def is_distributed() -> bool:
  return dist.is_available() and dist.is_initialized()


def rank() -> int:
  return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
  return dist.get_world_size() if is_distributed() else 1


def init_distributed(device='cuda') -> torch.device:
  """Joins the process group that torchrun's environment describes
  (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`), the
  counterpart of `jax.distributed.initialize()`; returns this rank's
  device, `cuda:<LOCAL_RANK>` (NCCL, the kernels built once a machine) or
  the CPU (gloo). A rank a card: LOCAL_RANK at or past the card count
  raises."""
  missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
  if missing:
    raise RuntimeError(f'--multiprocess needs torchrun\'s environment; '
                       f'{missing} not set (launch with torchrun '
                       '--nproc_per_node=N -m ...)')
  device = torch.device(device)
  local = int(os.environ['LOCAL_RANK'])
  if device.type == 'cuda':
    if not torch.cuda.is_available():
      raise RuntimeError("CUDA is not available; pass --device=cpu to run "
                         'the ranks on the CPU')
    if local >= torch.cuda.device_count():
      raise RuntimeError(f'LOCAL_RANK {local} but {torch.cuda.device_count()}'
                         ' CUDA devices: one rank a card')
    device = torch.device('cuda', local)
    torch.cuda.set_device(device)
    backend = 'nccl'
  elif device.type == 'cpu':
    backend = 'gloo'
  else:
    raise ValueError(f'unsupported device {device}')
  dist.init_process_group(backend, init_method='env://',
                          rank=int(os.environ['RANK']),
                          world_size=int(os.environ['WORLD_SIZE']))
  if device.type == 'cuda':
    # One build of the kernels' library a machine: local rank 0 compiles
    # it (or finds it built) before the other ranks load it.
    from mulan_tpu_torch.ops import _build
    if local == 0:
      _build.load_library()
    dist.barrier()
  return device


def create_mesh(world: Optional[int] = None, fsdp: int = 1, tp: int = 1,
                device_type: str = 'cuda'):
  """A `DeviceMesh` over the ranks: ('data',), ('data', 'fsdp'), ('data',
  'tensor') or ('data', 'fsdp', 'tensor'), as JAX's `create_mesh` lays out
  `devices.reshape([data, fsdp, tensor])`: 'tensor' groups consecutive
  ranks, 'fsdp' consecutive tensor groups. Asserts that the world divides
  into fsdp x tp groups, as JAX's does. With a 'tensor' axis the mesh
  carries its batch groups (`batch_group`), which every rank makes here,
  one a tensor coordinate."""
  from torch.distributed.device_mesh import init_device_mesh
  if world is None:
    world = world_size()
  assert world % (fsdp * tp) == 0, (world, fsdp, tp)
  shape, names = [world // (fsdp * tp)], [DATA_AXIS]
  if fsdp > 1:
    shape.append(fsdp)
    names.append(FSDP_AXIS)
  if tp > 1:
    shape.append(tp)
    names.append(TENSOR_AXIS)
  mesh = init_device_mesh(device_type, tuple(shape),
                          mesh_dim_names=tuple(names))
  _layout(mesh)
  return mesh


def has_fsdp(mesh) -> bool:
  return mesh is not None and FSDP_AXIS in (mesh.mesh_dim_names or ())


def has_tensor(mesh) -> bool:
  return mesh is not None and TENSOR_AXIS in (mesh.mesh_dim_names or ())


def batch_mesh(mesh):
  """The mesh's batch axes ('data' and 'fsdp'), the submesh DDP and FSDP2
  act on: the mesh itself without 'tensor'."""
  if not has_tensor(mesh):
    return mesh
  return mesh[tuple(n for n in mesh.mesh_dim_names if n != TENSOR_AXIS)]


class _Layout(NamedTuple):
  batch_group: object    # the ranks of this rank's tensor coordinate
  batch_rank: int
  batch_world: int


def _make_batch_layout(mesh) -> _Layout:
  """This rank's batch group on a mesh whose last axis is 'tensor': the
  ranks of its tensor coordinate (a process group a coordinate, every
  rank making all of them)."""
  if mesh.mesh_dim_names[-1] != TENSOR_AXIS:
    raise ValueError(f"'tensor' must be the mesh's last axis: {mesh}")
  ranks = mesh.mesh.reshape(-1, mesh.mesh.shape[-1])  # (batch, tensor)
  mine = None
  for t in range(ranks.shape[1]):
    members = ranks[:, t].tolist()
    group = dist.new_group(members)
    if rank() in members:
      mine = _Layout(group, members.index(rank()), len(members))
  return mine


def _layout(mesh) -> Optional[_Layout]:
  """The batch layout of a mesh with a 'tensor' axis, kept on the mesh
  (None otherwise: the batch helpers count ranks). Its first call on a
  mesh makes the process groups, so every rank makes it at once:
  `create_mesh` does."""
  if not has_tensor(mesh):
    return None
  if getattr(mesh, '_batch_layout', None) is None:
    mesh._batch_layout = _make_batch_layout(mesh)
  return mesh._batch_layout


def batch_rank(mesh=None) -> int:
  """This rank's coordinate on the mesh's batch axes: the rank itself
  without a tensor axis."""
  layout = _layout(mesh)
  return rank() if layout is None else layout.batch_rank


def batch_world(mesh=None) -> int:
  """The number of batch coordinates of the mesh: the world without a
  tensor axis."""
  layout = _layout(mesh)
  return world_size() if layout is None else layout.batch_world


def batch_group(mesh=None):
  """The process group of this rank's batch coordinates on the mesh (None:
  the default group)."""
  layout = _layout(mesh)
  return None if layout is None else layout.batch_group


def local_batch_size(global_batch: int,
                     process_count: Optional[int] = None) -> int:
  """The rows of a global batch each of `process_count` ranks (default:
  the world) holds; raises as JAX's does."""
  pc = process_count if process_count is not None else world_size()
  if global_batch % pc != 0:
    raise ValueError(f'global batch {global_batch} not divisible by '
                     f'process count {pc}')
  return global_batch // pc


class Rows(NamedTuple):
  """This rank's rows of a global array: rows [start, start + count) of
  each of `reps` consecutive blocks of `total` rows (the global array is
  the block tiled `reps` times, as the ODE likelihood tiles its batch)."""
  start: int
  count: int
  total: int
  reps: int = 1

  @property
  def global_rows(self) -> int:
    return self.reps * self.total

  def take(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """x's rows along `dim` (of size `global_rows`) that this rank holds."""
    if x.shape[dim] != self.global_rows:
      raise ValueError(f'{x.shape[dim]} rows along dim {dim}, the global '
                       f'array has {self.global_rows}')
    blocks = x.unflatten(dim, (self.reps, self.total))
    return blocks.narrow(dim + 1, self.start, self.count).flatten(dim, dim + 1)

  def interleaved(self, n: int) -> 'Rows':
    """The rows after every row is repeated n times in place
    (`repeat_interleave`)."""
    assert self.reps == 1, self
    return Rows(self.start * n, self.count * n, self.total * n)

  def tiled(self, n: int) -> 'Rows':
    """The rows after the whole array is tiled n times."""
    return self._replace(reps=self.reps * n)


def row_window(local: int, mesh=None) -> Rows:
  """This rank's rows [r local, (r + 1) local) of the global batch of
  world * local rows (r and world counting the mesh's batch
  coordinates)."""
  return Rows(batch_rank(mesh) * local, local, batch_world(mesh) * local)


def draw_rows(draw, shape: Sequence[int], rows: Optional[Rows],
              dim: int = 0) -> torch.Tensor:
  """`draw(shape)` with `shape[dim]` the local rows: without `rows` that
  draw itself; with them, the global array's draw cut to this rank's rows,
  so that every rank consumes the generator as one process would."""
  if rows is None:
    return draw(tuple(shape))
  shape = list(shape)
  if shape[dim] != rows.reps * rows.count:
    raise ValueError(f'{shape[dim]} local rows, the window holds '
                     f'{rows.reps * rows.count}')
  shape[dim] = rows.global_rows
  return rows.take(draw(tuple(shape)), dim)


def pad_and_mask(batch: Dict[str, np.ndarray], size: int,
                 n_valid: Optional[int] = None) -> Dict[str, np.ndarray]:
  """`batch` padded to `size` rows with JAX's wrap-around rows
  (`shard_host_padded`, `mulan_tpu/parallel/mesh.py:213-237`: the padding
  may exceed the valid rows), plus a boolean 'mask' of the valid ones."""
  if n_valid is None:
    n_valid = len(next(iter(batch.values())))
  assert n_valid > 0, 'empty per-host batch'
  assert size >= n_valid, (size, n_valid)
  idx = np.arange(size) % n_valid
  out = {k: np.asarray(v)[idx] for k, v in batch.items()}
  out['mask'] = np.arange(size) < n_valid
  return out


# -- collectives -----------------------------------------------------------------


def _comm_device(like: torch.device, group=None) -> torch.device:
  """Where a collective's tensors must live: the CUDA device for NCCL,
  the CPU for gloo (which this module always hands host tensors)."""
  if dist.get_backend(group) == 'nccl':
    return like if like.type == 'cuda' else torch.device(
        'cuda', torch.cuda.current_device())
  return torch.device('cpu')


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
  """The sum of x over the group's ranks (x itself with no process
  group), on x's device; x is not modified."""
  if not is_distributed():
    return x
  buf = x.detach().to(_comm_device(x.device, group), copy=True)
  dist.all_reduce(buf, group=group)
  return buf.to(x.device)


def mean_over_ranks(values: Dict[str, torch.Tensor],
                    mesh=None) -> Dict[str, torch.Tensor]:
  """{name: mean over the mesh's batch coordinates} of 0-d tensors, in one
  collective."""
  if not is_distributed() or not values:
    return values
  stacked = torch.stack([v.detach().float() for v in values.values()])
  total = all_reduce_sum(stacked, batch_group(mesh)) / batch_world(mesh)
  return dict(zip(values, total.unbind()))


def all_gather_rows(x: torch.Tensor, mask=None, mesh=None) -> torch.Tensor:
  """Every batch coordinate's x (the same number of rows on each) of the
  mesh concatenated in order, on every rank, without the rows whose `mask`
  is False."""
  dev = x.device
  if mask is not None:
    mask = torch.as_tensor(mask, dtype=torch.bool, device=dev)
  if is_distributed():
    group, n = batch_group(mesh), batch_world(mesh)
    comm = _comm_device(dev, group)
    parts = [torch.empty_like(x, device=comm) for _ in range(n)]
    dist.all_gather(parts, x.detach().to(comm).contiguous(), group=group)
    x = torch.cat(parts).to(dev)
    if mask is not None:
      masks = [torch.empty_like(mask, device=comm) for _ in range(n)]
      dist.all_gather(masks, mask.to(comm).contiguous(), group=group)
      mask = torch.cat(masks).to(dev)
  return x if mask is None else x[mask]


def max_over_ranks(values: Sequence[int]) -> List[int]:
  """The elementwise maximum of a list of ints of one length on every
  rank."""
  t = torch.tensor(list(values), dtype=torch.int64)
  if is_distributed() and len(values):
    t = t.to(_comm_device(torch.device('cpu')))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
  return t.cpu().tolist()


def even_chunks(chunks: List[Dict[str, np.ndarray]]
                ) -> List[Tuple[Dict[str, np.ndarray], int]]:
  """[(chunk padded to the largest size any rank has at its index, its
  valid rows)]: as many chunks on every rank, so that each collective of an
  evaluation loop pairs. A rank whose chunks end first joins the later
  ones with its first chunk, every row masked (valid 0)."""
  if not is_distributed():
    return [(dict(c), len(c['images'])) for c in chunks]
  (count,) = max_over_ranks([len(chunks)])
  if count and not chunks:
    raise ValueError('this rank has no eval rows, the others have some')
  sizes = max_over_ranks([len(c['images']) for c in chunks]
                         + [0] * (count - len(chunks)))
  out = []
  for i, size in enumerate(sizes):
    if i < len(chunks):
      n = len(chunks[i]['images'])
      out.append((pad_and_mask(chunks[i], size, n), n))
    else:
      filler = pad_and_mask(chunks[0], size)
      filler['mask'][:] = False
      out.append((filler, 0))
  return out


def from_rank0(x: torch.Tensor, mesh=None) -> torch.Tensor:
  """Rank 0's x on every rank on a mesh with a 'tensor' axis, whose tensor
  groups compute the same values apart (x itself otherwise): one value for
  a decision every rank must take alike."""
  if not has_tensor(mesh):
    return x
  buf = x.detach().to(_comm_device(x.device), copy=True)
  dist.broadcast(buf, src=0)
  return buf.to(x.device)


def barrier() -> None:
  if is_distributed():
    dist.barrier()


def broadcast_object(obj):
  """Rank 0's `obj` on every rank."""
  if not is_distributed():
    return obj
  box = [obj]
  dist.broadcast_object_list(box, src=0)
  return box[0]
