"""Tensor parallelism of the port (`training.tp`, `parallel/tensor.py`)
against the JAX package: the 3-D mesh, which leaves a tensor rank slices
(JAX's `param_sharding` puts the same contiguous slices on 'tensor'), the
dropout masks of a rank's channel window (bit for bit the one-process
mask's slice), GroupNorm on a rank's groups, and `params.py`'s slices.

Then gloo pods on the CPU (`torch_multiprocess_worker.py --mode tp` at
world 2, tp = 2, and `--mode tp_hsdp` at world 4, fsdp = 2 x tp = 2),
rank 0 held against one process on the global batch at JAX's tolerances
for `test_tp_training_matches_dp` (bpd rtol 1e-5, parameters rtol 1e-4 /
atol 1e-6), and one step of the pod held against JAX's own step on the
same parameters, batch and noise without dropout.
"""

import concurrent.futures
import dataclasses
import threading
import types

from flax.traverse_util import flatten_dict
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mulan_tpu.models import build_model as build_jax_model
from mulan_tpu.parallel import mesh as jax_mesh
from mulan_tpu.train import loop as jax_loop
from mulan_tpu.train import optimizer as jax_optimizer
from mulan_tpu.train.state import TrainState as JaxTrainState
from mulan_tpu_torch import configs, params
from mulan_tpu_torch.models import build_model
from mulan_tpu_torch.models.layers import GroupNormF32
from mulan_tpu_torch.ops import dropout as drop_ops
from mulan_tpu_torch.parallel import mesh as mesh_lib
from mulan_tpu_torch.parallel import tensor as tensor_lib
from mulan_tpu_torch.parallel import wrap
from mulan_tpu_torch.parallel.tensor import TensorGroup
from parity_helpers import frozen_randomness
from test_torch_multiprocess import _assert_check, _launch, _TRANSPORT
from test_torch_train import B, _assert_grads_match, _batch, _port_noise
from torch_port_helpers import jax_config, mulan_pair

TP = 2


@pytest.fixture(scope='module')
def tiny_pair():
  """(flax model, flax params, the port's model with them) of
  tiny_synthetic."""
  return mulan_pair(configs.tiny_synthetic().model, batch=2)


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


@pytest.mark.parametrize('fsdp,tp', [(1, 2), (2, 2), (1, 4)])
def test_create_mesh_matches_jax(fake_world, fsdp, tp):
  """The axes, their sizes and every rank's coordinates are JAX's (its
  device i is rank i), and rank 0's batch coordinate and group."""
  want = jax_mesh.create_mesh(fsdp=fsdp, tp=tp)
  got = mesh_lib.create_mesh(fsdp=fsdp, tp=tp, device_type='cpu')
  assert got.mesh_dim_names == want.axis_names
  np.testing.assert_array_equal(
      got.mesh.numpy(), np.vectorize(lambda d: d.id)(want.devices))
  assert mesh_lib.has_tensor(got) and mesh_lib.has_fsdp(got) == (fsdp > 1)
  assert (mesh_lib.batch_rank(got), mesh_lib.batch_world(got)) == (0,
                                                                   8 // tp)
  assert mesh_lib.row_window(3, got) == mesh_lib.Rows(0, 3, 3 * 8 // tp)
  assert mesh_lib.local_batch_size(
      64, mesh_lib.batch_world(got)) == 64 * tp // 8
  # Without the mesh the helpers count the ranks of the default group.
  assert (mesh_lib.batch_rank(), mesh_lib.batch_world()) == (0, 8)
  group = tensor_lib.tensor_group(got)
  assert (group.rank, group.size) == (0, tp)
  assert tuple(mesh_lib.batch_mesh(got).mesh_dim_names) == tuple(
      a for a in want.axis_names if a != 'tensor')
  with pytest.raises(AssertionError):
    mesh_lib.create_mesh(8, fsdp=fsdp, tp=3, device_type='cpu')


def _jax_specs(jax_params, mesh):
  """{port name: (the leaf's sharding in JAX, path, leaf)}."""
  shardings = flatten_dict(jax_mesh.state_shardings(mesh, jax_params),
                           sep='/')
  return {params._convert(path, np.asarray(leaf))[0]:
          (shardings[path], path, leaf)
          for path, leaf in flatten_dict(jax_params, sep='/').items()}


def _on_tensor(sharding, leaf) -> bool:
  spec = sharding.spec
  return len(spec) == np.ndim(leaf) and spec[-1] == 'tensor'


def test_split_leaves_match_jax_param_sharding(tiny_pair):
  """Every score-UNet leaf JAX puts on 'tensor' is split here, and its
  slice on rank r is the shard JAX gives the device at tensor coordinate
  r (the up blocks' first GroupNorm: [h_r, skip_r] by design); conv_out,
  the encoder and the schedule network stay whole, and a model built with
  a tensor group holds exactly those slices."""
  _, jax_params, port = tiny_pair
  mesh = jax_mesh.create_mesh(tp=TP)
  specs = _jax_specs(jax_params, mesh)
  flat = {path: np.asarray(leaf) for _, path, leaf in specs.values()}
  whole = params.from_flax(flat)
  split_names = set()
  for name, (sharding, path, leaf) in specs.items():
    segments = tensor_lib.split_segments(name)
    if not name.startswith('score_model.'):
      assert segments is None, name  # JAX's encoder layout: memory only
      continue
    assert (segments is not None) == _on_tensor(sharding, leaf), name
    if segments is not None:
      split_names.add(name)
  assert 'score_model.conv_out.weight' not in split_names
  assert len(split_names) > 50
  for r in range(TP):
    group = TensorGroup(r, TP)
    mine = params.from_flax(flat, group)
    model = build_model('mulan_velocity', port.config, device='cpu',
                        state=whole, tensor=group)
    got = model.state_dict()
    for name, value in whole.items():
      assert torch.equal(got[name], mine[name]), name
      if name not in split_names:
        assert torch.equal(mine[name], value), name
        continue
      assert mine[name].shape[0] * TP == value.shape[0], name
      if tensor_lib.split_segments(name) == 2:
        h, skip = value.chunk(2)
        assert torch.equal(mine[name], torch.cat(
            [h.chunk(TP)[r], skip.chunk(TP)[r]])), name
        continue
      sharding, path, leaf = specs[name]
      arr = jax.device_put(jnp.asarray(leaf), sharding)
      device = mesh.devices[0, r]
      shard = next(s.data for s in arr.addressable_shards
                   if s.device == device)
      want = params._convert(path, np.asarray(shard))[1]
      assert torch.equal(mine[name], want), name


def test_params_round_trip_to_jax_tree(tiny_pair, monkeypatch):
  """`from_flax` with a tensor group gives each rank its slices, and
  `to_flax` gathers them back into JAX's tree, leaf for leaf."""
  _, jax_params, _ = tiny_pair
  flat = {k: np.asarray(v) for k, v in
          flatten_dict(jax_params, sep='/').items()}
  ranks = [params.from_flax(flat, TensorGroup(r, TP)) for r in range(TP)]
  by_ptr = {v.data_ptr(): k for k, v in ranks[0].items()}
  monkeypatch.setattr(tensor_lib, '_gather_parts', lambda x, t: torch.stack(
      [ranks[r][by_ptr[x.data_ptr()]] for r in range(TP)]))
  back = params.to_flax(ranks[0], TensorGroup(0, TP))
  assert back.keys() == flat.keys()
  for key, value in flat.items():
    np.testing.assert_array_equal(back[key], value, err_msg=key)


# (shape of the global mask (B, C, H, W), tp, first row): runs (C / tp) H W
# of 45, 30, 18, 64 and 9 elements, all but one off a multiple of 8.
MASK_CASES = [((4, 6, 3, 5), 2, 0), ((4, 6, 3, 5), 3, 0),
              ((6, 10, 3, 3), 5, 2), ((3, 16, 4, 4), 4, 1),
              ((5, 3, 3, 3), 3, 3)]


@pytest.mark.parametrize('shape,tp,first_row', MASK_CASES)
def test_windowed_masks_are_the_global_mask_slices(shape, tp, first_row):
  """K6's and K7's plain versions at a rank's channel window (and rows
  from `first_row` on) are bit for bit that window of the one-process
  mask, through `dropout` and `dropout_masks` too."""
  b, c = shape[0] - first_row, shape[1] // tp
  full = drop_ops.dropout_mask_plain(11, 4, shape, 0.3, torch.float32)
  batch = drop_ops.dropout_mask_batch_plain(11, 3, 3, shape, 0.3,
                                            torch.float32)
  x = torch.ones((b, c, *shape[2:]))
  for r in range(tp):
    window = (r * c, shape[1])
    want = full[first_row:, r * c:(r + 1) * c]
    kw = dict(zip(('first_index', 'row_stride'), drop_ops.channel_window(
        first_row, x.shape, window)))
    got = drop_ops.dropout_mask_plain(11, 4, x.shape, 0.3, torch.float32,
                                      **kw)
    assert torch.equal(got, want), r
    assert torch.equal(drop_ops.dropout(x, 11, 4, 0.3, False, first_row,
                                        window), want), r
    assert torch.equal(drop_ops.dropout_masks(
        11, 3, 3, x.shape, 0.3, torch.float32, 'cpu', False, first_row,
        window), batch[:, first_row:, r * c:(r + 1) * c]), r


@pytest.mark.parametrize('channels,tp,segments,gathered', [
    (64, 2, 1, False), (128, 2, 2, False), (128, 4, 2, False),
    (48, 3, 1, True), (96, 3, 2, True)])
@pytest.mark.parametrize('fused', [False, True])
def test_group_norm_on_a_ranks_groups(monkeypatch, channels, tp, segments,
                                      gathered, fused):
  """A rank's GroupNorm (its parameters' slices, in the up blocks' [h_r,
  skip_r] layout with 2 segments) gives the whole GroupNorm's channels and
  their gradients: on its own groups where they are whole, else from the
  gathered channels and parameters (tp = 3 at 48 and 96 channels), where
  the input's gradient is the sum of the ranks' partial ones and the
  parameters' their own slice."""
  gen = torch.Generator().manual_seed(channels + tp)
  x = torch.randn((2, channels, 3, 3), generator=gen) * 2 + 0.5
  cot = torch.randn(x.shape, generator=gen)
  state = {'weight': 1 + 0.1 * torch.randn(channels, generator=gen),
           'bias': 0.1 * torch.randn(channels, generator=gen)}
  whole = GroupNormF32(channels, fused)
  whole.load_state_dict(state)
  xw = x.clone().requires_grad_()
  want = whole(xw)
  (want * cot).sum().backward()
  groups = [TensorGroup(r, tp) for r in range(tp)]
  norms, parts = [], []
  for g in groups:
    norm = GroupNormF32(channels, fused, tensor=g, segments=segments)
    assert norm.gathered == gathered
    norm.load_state_dict({k: tensor_lib.take(v, g, 0, segments)
                          for k, v in state.items()})
    norms.append(norm)
    parts.append(tensor_lib.take(x, g, 1, segments).requires_grad_())
  # Every rank's tensor of a gather, by the local tensor handed to it.
  across = {}
  for ranks in (parts, [n.weight for n in norms], [n.bias for n in norms]):
    for t in ranks:
      across[t.data_ptr()] = torch.stack([r.detach() for r in ranks])
  monkeypatch.setattr(tensor_lib, '_gather_parts',
                      lambda local, t: across[local.data_ptr()])
  partial = []  # what each rank's backward sums over the group
  monkeypatch.setattr(tensor_lib, '_sum',
                      lambda g, t: partial.append(g.detach()) or g)
  for g, norm, part in zip(groups, norms, parts):
    got = norm(part)
    torch.testing.assert_close(got, tensor_lib.take(want, g, 1, segments),
                               rtol=1e-5, atol=1e-6)
    (got * tensor_lib.take(cot, g, 1, segments)).sum().backward()
    for name in ('weight', 'bias'):
      torch.testing.assert_close(
          getattr(norm, name).grad, tensor_lib.take(
              getattr(whole, name).grad, g, 0, segments),
          rtol=1e-4, atol=1e-5)
  assert len(partial) == (tp if gathered else 0)
  for g, part in zip(groups, parts):
    dx = (tensor_lib.take(sum(partial), g, 1, segments) if gathered
          else part.grad)
    torch.testing.assert_close(dx, tensor_lib.take(xw.grad, g, 1, segments),
                               rtol=1e-4, atol=1e-5)


def test_whole_leaves_gradients_are_averaged_over_the_tensor_group(
    monkeypatch):
  """`average_whole_grads` replaces the gradient of every leaf a tensor
  group holds whole (the encoder's, γ's, `conv_out`'s) by its mean over
  the group, in one collective, and leaves the split leaves' alone."""
  names = ['encoder_model.conv_in.weight', 'gamma.l1.kernel',
           'score_model.conv_out.bias', 'score_model.conv_in.weight',
           'score_model.down_block_0.conv1.weight']
  gen = torch.Generator().manual_seed(3)
  ps = {n: torch.nn.Parameter(torch.zeros(4, 3)) for n in names}
  for p in ps.values():
    p.grad = torch.randn(p.shape, generator=gen)
  before = {n: p.grad.clone() for n, p in ps.items()}
  other = {n: torch.randn(p.shape, generator=gen) for n, p in ps.items()}
  calls = []

  def fake_sum(flat, tensor):  # the other rank's gradients added
    calls.append(flat.numel())
    return flat + torch.cat([other[n].reshape(-1) for n in names
                             if tensor_lib.split_segments(n) is None])
  monkeypatch.setattr(tensor_lib, '_sum', fake_sum)
  wrap.average_whole_grads(ps, TensorGroup(0, 2))
  assert calls == [3 * 12]
  for n, p in ps.items():
    want = (before[n] if tensor_lib.split_segments(n) is not None
            else (before[n] + other[n]) / 2)
    torch.testing.assert_close(p.grad, want, rtol=0, atol=1e-7)


# -- the gloo pods ------------------------------------------------------------------


def _jax_case_config():
  """The pod's config for the step against JAX: tp = 2, no dropout (as
  `test_tp_training_matches_dp`), a constant lr and no clipping, batch B."""
  cfg = configs.tiny_synthetic()
  return configs.replace(
      cfg, model={'sm_pdrop': 0.0},
      training={'num_steps_lr_warmup': 0, 'batch_size_train': B, 'tp': TP},
      optimizer=dataclasses.replace(cfg.optimizer, learning_rate=2e-5))


def _run_pod(world, mode, mktemp, prepare=None):
  for attempt in range(2):
    workdir = mktemp(f'{mode}{attempt}')
    if prepare is not None:
      prepare(workdir)
    rcs, outs = _launch(world, mode, workdir)
    ok = all(rc == 0 and f'WORKER_OK rank={r}' in out
             for r, (rc, out) in enumerate(zip(rcs, outs)))
    if ok or not any(t in out for out in outs for t in _TRANSPORT):
      break
  return (rcs, outs), workdir


@pytest.fixture(scope='module')
def pods(tmp_path_factory, tiny_pair):
  """{'tp': ((rcs, outs), workdir), 'tp_hsdp': ...}: both pods at once."""
  _, _, port = tiny_pair
  cfg = _jax_case_config()

  def prepare(workdir):
    torch.save({'state': port.state_dict(), 'batch': _batch(cfg, 0),
                'noise': _port_noise(cfg),
                'model': {'sm_pdrop': 0.0},
                'training': {'num_steps_lr_warmup': 0,
                             'batch_size_train': B},
                'optimizer': cfg.optimizer}, workdir / 'jax_case.pt')
  lock = threading.Lock()

  def mktemp(name):
    with lock:
      return tmp_path_factory.mktemp(name)
  with concurrent.futures.ThreadPoolExecutor(2) as pool:
    tp = pool.submit(_run_pod, 2, 'tp', mktemp, prepare)
    hsdp = pool.submit(_run_pod, 4, 'tp_hsdp', mktemp)
    return {'tp': tp.result(), 'tp_hsdp': hsdp.result()}


@pytest.mark.parametrize('check', [
    'tp_layout',
    'tp_super_step_matches_one_process',
    'tp_matches_one_process',
    'tp_resume_bit_for_bit',
    'tp_checkpoint_restores_in_one_process',
    'tp_evals_match_one_process',
    'tp_variants_match_one_process',
    'tp_cli_flax_round_trip',
])
def test_tensor_parallel_two_ranks_equal_one_process(pods, check):
  """World 2 on a ('data', 'tensor') mesh of 1 x 2: every check of the pod,
  rank 0 against one process; both ranks print the same values."""
  _assert_check(pods['tp'][0], check)


def test_tensor_parallel_two_by_two_equals_one_process(pods):
  """World 4 on a ('data', 'fsdp', 'tensor') mesh of 1 x 2 x 2: two steps,
  the checkpoint into one process, the sparse VLB, the ancestral sampler
  and the likelihood (RK4, DoPri5) against one process."""
  for check in ('tp_hsdp_matches_one_process', 'tp_evals_match_one_process',
                'tp_checkpoint_restores_in_one_process'):
    _assert_check(pods['tp_hsdp'][0], check)


def test_tensor_parallel_step_matches_jax(pods, tiny_pair, monkeypatch):
  """The pod's step (tp = 2, no dropout) against JAX's loss, gradients and
  AdamW step (`loop.py:loss_fn`, `TrainState.apply_gradients`) on the same
  parameters, batch and noise: the bpd and every gathered gradient at the
  tolerances of the one-process port against JAX (`test_torch_train.py`),
  and the parameters within the step's move where Adam's sign of a
  near-zero gradient element can flip (as there)."""
  pod, workdir = pods['tp']
  _assert_check(pod, 'tp_jax_case_written')
  out = torch.load(workdir / 'jax_case_out.pt', weights_only=False)
  _, jax_params, _ = tiny_pair
  cfg = _jax_case_config()
  frozen_randomness(monkeypatch)
  fake = types.SimpleNamespace(
      model=build_jax_model('mulan_velocity', jax_config(cfg.model)),
      model_config=jax_config(cfg.model))
  batch = {k: jnp.asarray(v) for k, v in _batch(cfg, 0).items()}
  (bpd_want, _), grads = jax.jit(jax.value_and_grad(
      lambda p: jax_loop.Experiment.loss_fn(fake, p, batch, 0,
                                            jax.random.PRNGKey(0), True),
      has_aux=True))(jax_params)
  np.testing.assert_allclose(out['bpd'], float(bpd_want), rtol=1e-4)
  _assert_grads_match(out['grads'], grads)
  opt = cfg.optimizer
  tx = jax_optimizer.make_optimizer(
      {'name': 'adamw', 'args': dataclasses.asdict(opt.args)},
      jax_optimizer.make_lr_schedule(opt.learning_rate, 0,
                                     cfg.training.num_steps_train,
                                     opt.lr_decay))
  jstate = JaxTrainState.create(apply_fn=None, params=jax_params, tx=tx)
  jstate = jax.jit(lambda st, g: st.apply_gradients(
      grads=g, ema_rate=opt.ema_rate))(jstate, grads)
  want = params.from_flax({k: np.asarray(v) for k, v in
                           flatten_dict(jstate.params, sep='/').items()})
  excess = torch.cat([((out['params'][k] - w).abs() - 2e-3 * w.abs())
                      .flatten() for k, w in want.items()])
  assert excess.max() <= 2 * opt.learning_rate, excess.max()
  assert (excess > 0.2 * opt.learning_rate).double().mean() <= 1e-2
