"""The port's data-parallel pieces in one process, against the JAX package
where it has them: the mesh and the local batch (`mulan_tpu/parallel/
mesh.py`, its 8-device CPU mesh), the wrap-around padding of
`shard_host_padded`, the per-host data shards and iterators
(`mulan_tpu/data/pipeline.py`, with `jax.process_index` and
`process_count` patched to a rank of 2), the dropout masks at a rank's
element offset (bit for bit the global mask's rows), and the row-windowed
draws (each rank's rows of the one-process draws). Multi-process runs are
`test_torch_multiprocess.py`.
"""

import ast
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mulan_tpu.configs import tiny_synthetic as jax_tiny_synthetic
from mulan_tpu.data import pipeline
from mulan_tpu.parallel import mesh as jax_mesh
from mulan_tpu_torch import configs, data
from mulan_tpu_torch.models import latents
from mulan_tpu_torch.models.config import tiny_config
from mulan_tpu_torch.models.mulan import MuLAN
from mulan_tpu_torch.models.vdm import sample_times
from mulan_tpu_torch.ops import dropout as drop_ops
from mulan_tpu_torch.parallel import mesh as mesh_lib
from mulan_tpu_torch.train import optimizer as port_optimizer
from mulan_tpu_torch.train.loop import Experiment
import torch_port_helpers  # noqa: F401  (caps torch's threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def fake_world():
  """A process group of 8 ranks in this process (torch's fake backend: no
  communication), for meshes of JAX's 8-device shape; torn down after."""
  from torch.testing._internal.distributed.fake_pg import FakeStore
  dist.init_process_group('fake', store=FakeStore(), rank=0, world_size=8)
  try:
    yield
  finally:
    dist.destroy_process_group()


@pytest.mark.parametrize('fsdp', [1, 2, 4])
def test_create_mesh_matches_jax(fake_world, fsdp):
  want = jax_mesh.create_mesh(fsdp=fsdp)
  got = mesh_lib.create_mesh(fsdp=fsdp, device_type='cpu')
  assert got.mesh_dim_names == want.axis_names
  assert tuple(got.shape) == tuple(want.shape[a] for a in want.axis_names)
  assert mesh_lib.has_fsdp(got) == (fsdp > 1)


def test_create_mesh_and_local_batch_refuse_as_jax():
  with pytest.raises(AssertionError):
    jax_mesh.create_mesh(fsdp=3)
  with pytest.raises(AssertionError):
    mesh_lib.create_mesh(8, fsdp=3, device_type='cpu')
  for global_batch, count in ((128, 2), (128, 4), (12, 3)):
    assert (mesh_lib.local_batch_size(global_batch, count)
            == jax_mesh.local_batch_size(global_batch, count))
  for call in (jax_mesh.local_batch_size, mesh_lib.local_batch_size):
    with pytest.raises(ValueError, match='not divisible by process count 3'):
      call(128, 3)
  # One process with no process group: the identity.
  assert mesh_lib.local_batch_size(128) == 128
  assert (mesh_lib.rank(), mesh_lib.world_size()) == (0, 1)


@pytest.mark.parametrize('n_valid', [3, 8, 10])
def test_pad_and_mask_matches_shard_host_padded(n_valid):
  """JAX pads to a multiple of its 8 local devices, wrapping around (the
  padding exceeds the valid rows below 4); the port to the size asked."""
  rs = np.random.RandomState(n_valid)
  batch = {'images': rs.randint(0, 256, (n_valid, 2, 2, 3)).astype(np.uint8),
           'labels': rs.randint(0, 10, (n_valid,)).astype(np.int32)}
  want = jax_mesh.shard_host_padded(jax_mesh.create_mesh(), dict(batch))
  size = n_valid + (-n_valid % jax.device_count())
  got = mesh_lib.pad_and_mask(batch, size)
  assert got.keys() == want.keys()
  for key in want:
    np.testing.assert_array_equal(got[key], np.asarray(want[key]), key)


def _jax_config():
  return jax_tiny_synthetic.get_config()


@pytest.mark.parametrize('rank', [0, 1])
def test_rank_shards_and_iterators_match_pipeline(monkeypatch, rank):
  """Rank r of 2: its shard of each split, its train batches (seed +
  rank), its eval batches (seed + 7919 + rank) and its one-time eval
  batches (batch // 2) equal JAX's per-host ones."""
  monkeypatch.setattr(jax, 'process_index', lambda: rank)
  monkeypatch.setattr(jax, 'process_count', lambda: 2)
  monkeypatch.setattr(mesh_lib, 'rank', lambda: rank)
  monkeypatch.setattr(mesh_lib, 'world_size', lambda: 2)
  monkeypatch.setattr(pipeline, '_prefetch', lambda gen, depth=2: gen)
  jcfg, cfg = _jax_config(), configs.tiny_synthetic()
  for split in ('train', 'eval'):
    want = pipeline._sources_from_config(jcfg, split)
    got = data.config_source(cfg, split)
    np.testing.assert_array_equal(got[0], want.images)
    np.testing.assert_array_equal(got[1], want.labels)
  want_train, want_eval = pipeline.create_dataset(jcfg, seed=11)
  got_train, got_eval = data.create_dataset(cfg, seed=11)
  for want_it, got_it, n in ((want_train, got_train, 5),
                             (want_eval, got_eval, 9)):
    for _ in range(n):
      w, g = next(want_it), next(got_it)
      for key in w:
        np.testing.assert_array_equal(g[key], w[key], err_msg=key)
  want = list(pipeline.create_one_time_eval_dataset(jcfg))
  got = list(data.create_one_time_eval_dataset(cfg))
  assert len(got) == len(want) == 32 // 4
  for w, g in zip(want, got):
    for key in w:
      np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.mark.parametrize('row_elems', [8 * 3 * 3, 5 * 3 * 3])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_masks_at_an_offset_are_the_global_rows(row_elems, dtype):
  """K6's and K7's plain versions at `first_index`: every rank's rows of a
  (6, ...) site, at offsets that are multiples of 8 (72 a row) and not
  (45 a row), bit for bit the global mask's."""
  shape = (6, row_elems // 9, 3, 3)
  full = drop_ops.dropout_mask_plain(1234, 5, shape, 0.3, dtype)
  full_batch = drop_ops.dropout_mask_batch_plain(77, 9, 3, shape, 0.3, dtype)
  for world in (2, 3, 6):
    b = shape[0] // world
    for r in range(world):
      first = r * b * row_elems
      part = drop_ops.dropout_mask_plain(1234, 5, (b, *shape[1:]), 0.3,
                                         dtype, first_index=first)
      assert torch.equal(part, full[r * b:(r + 1) * b]), (world, r)
      slots = drop_ops.dropout_mask_batch_plain(
          77, 9, 3, (b, *shape[1:]), 0.3, dtype, first_index=first)
      assert torch.equal(slots, full_batch[:, r * b:(r + 1) * b]), (world, r)
  # The model's path: a rank's first row, times the row's elements.
  x = torch.ones((2, *shape[1:]), dtype=dtype)
  assert torch.equal(drop_ops.dropout(x, 1234, 5, 0.3, False, first_row=2),
                     full[2:4])
  with pytest.raises(ValueError, match='first_index'):
    drop_ops.dropout_mask_plain(1, 2, (8,), 0.1, dtype, first_index=-8)


def _rank_draws(draw, world):
  """[draw(rows of rank r)] for every rank, each from a generator seeded
  alike."""
  return [draw(torch.Generator().manual_seed(3), mesh_lib.Rows(r * 2, 2,
                                                               2 * world))
          for r in range(world)]


@pytest.mark.parametrize('antithetic', [True, False])
def test_row_windowed_times_are_the_global_rows(antithetic):
  world = 4
  want = sample_times(8, antithetic=antithetic,
                      generator=torch.Generator().manual_seed(3))
  got = _rank_draws(lambda g, rows: sample_times(
      2, antithetic=antithetic, generator=g, rows=rows), world)
  assert torch.equal(torch.cat(got), want)


def test_row_windowed_noise_and_latent_variates_are_the_global_rows():
  """eps (the model's `_noise`), and the latent's Gamma (rows on axis 1),
  Gumbel and Gaussian variates."""
  world = 4
  model = MuLAN(tiny_config())
  shape = (2, 8, 8, 3)
  want = model._noise((8, *shape[1:]), torch.Generator().manual_seed(3))
  got = _rank_draws(lambda g, rows: model._noise(shape, g, rows), world)
  assert torch.equal(torch.cat(got), want)
  for overrides, dim in ((dict(), 1), (dict(topk_noise_type='gumbel'), 0),
                         (dict(latent_type='gaussian'), 0)):
    cfg = tiny_config(**overrides)
    want = latents.latent_variates(cfg, 8, generator=torch.Generator()
                                   .manual_seed(3), device='cpu')
    got = _rank_draws(lambda g, rows: latents.latent_variates(
        cfg, 2, generator=g, device='cpu', rows=rows), world)
    assert torch.equal(torch.cat(got, dim=dim), want), overrides


def test_rows_take_interleaved_and_tiled():
  x = torch.arange(2 * 6).reshape(2 * 6, 1)
  rows = mesh_lib.Rows(2, 2, 6)
  assert rows.take(x[:6]).flatten().tolist() == [2, 3]
  assert rows.tiled(2).take(x).flatten().tolist() == [2, 3, 8, 9]
  rep = torch.arange(6).repeat_interleave(3)
  assert rows.interleaved(3).take(rep).tolist() == [2, 2, 2, 3, 3, 3]
  with pytest.raises(ValueError, match='rows'):
    rows.take(x)


def test_even_chunks_is_the_identity_in_one_process():
  chunks = [{'images': np.zeros((3, 1))}, {'images': np.ones((2, 1))}]
  got = mesh_lib.even_chunks(chunks)
  assert [n for _, n in got] == [3, 2]
  assert all('mask' not in c for c, _ in got)
  assert mesh_lib.all_gather_rows(torch.arange(3), [True, False, True]
                                  ).tolist() == [0, 2]


def test_init_distributed_refuses_without_torchrun_or_a_card(monkeypatch):
  for key in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
              'MASTER_PORT'):
    monkeypatch.delenv(key, raising=False)
  with pytest.raises(RuntimeError, match='torchrun'):
    mesh_lib.init_distributed('cpu')
  monkeypatch.setenv('RANK', '1')
  monkeypatch.setenv('WORLD_SIZE', '2')
  monkeypatch.setenv('LOCAL_RANK', '1')
  monkeypatch.setenv('MASTER_ADDR', '127.0.0.1')
  monkeypatch.setenv('MASTER_PORT', '1')
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='CUDA is not available'):
    mesh_lib.init_distributed('cuda')
  # No silent remapping: LOCAL_RANK 1 on a machine of one card.
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
  monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
  with pytest.raises(RuntimeError, match='LOCAL_RANK 1 but 1 CUDA'):
    mesh_lib.init_distributed('cuda')
  assert not dist.is_initialized()


def test_experiment_refuses_tp_and_an_fsdp_mesh_of_one_process():
  # JAX's divisibility assert: one process holds no tensor or fsdp group
  # of 2 (tensor parallelism itself: test_torch_tensor_parallel.py).
  for training in ({'tp': 2}, {'fsdp': 2}, {'fsdp': 2, 'tp': 2}):
    with pytest.raises(AssertionError):
      Experiment(configs.replace(configs.tiny_synthetic(),
                                 training=training), device='cpu')


def test_global_norm_of_plain_gradients_is_unchanged():
  grads = [torch.randn(5, generator=torch.Generator().manual_seed(i))
           for i in range(3)]
  want = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
  assert torch.equal(port_optimizer.global_norm(grads), want)


def test_port_and_parallel_import_no_jax():
  """No module of the port, `parallel/` included, imports jax, flax or the
  JAX package (the subprocess check with them blocked is
  `test_torch_checkpoint.py::test_port_imports_without_jax_flax_msgpack_
  orbax`)."""
  root = os.path.join(REPO, 'mulan_tpu_torch')
  seen = set()
  for dirpath, _, files in os.walk(root):
    for name in files:
      if not name.endswith('.py'):
        continue
      path = os.path.join(dirpath, name)
      seen.add(os.path.relpath(path, REPO))
      for node in ast.walk(ast.parse(open(path).read())):
        mods = []
        if isinstance(node, ast.Import):
          mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
          mods = [node.module]
        for mod in mods:
          assert mod.split('.')[0] not in ('jax', 'flax', 'mulan_tpu'), (
              path, mod)
  assert {'mulan_tpu_torch/parallel/mesh.py',
          'mulan_tpu_torch/parallel/wrap.py'} <= seen
