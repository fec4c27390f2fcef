"""The port's checkpoints against the JAX package, float32 on the CPU: exact
resume, save and restore, partial warm-start, the standard-library msgpack
codec against flax's, and the parameter layouts of `ckpt-N.flax` files
against `mulan_tpu/compat.py`.

Parameters come from one flax init of the tiny config, transplanted with
`params.from_flax`.
"""

import dataclasses
import os
import subprocess
import sys

import flax.serialization
from flax.traverse_util import flatten_dict
import jax
import numpy as np
import pytest
import torch

from mulan_tpu import compat as jax_compat
from mulan_tpu.train.state import merge_restored as jax_merge_restored
from mulan_tpu_torch import compat, configs, main, eval_bpd
from mulan_tpu_torch.train import checkpoint as ckpt_lib
from mulan_tpu_torch.train.loop import Experiment, step_key
from mulan_tpu_torch.train.state import merge_restored
from mulan_tpu_torch.utils import msgpack
from torch_port_helpers import mulan_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 4


@pytest.fixture(scope='module')
def tiny():
  """(flax params, the port's state_dict with them) of tiny_synthetic."""
  _, jax_params, port = mulan_pair(configs.tiny_synthetic().model, batch=2)
  return jax_params, port.state_dict()


def _config(**training):
  """tiny_synthetic with a one-step warm-up and lr 2e-3, so that every
  step moves the parameters, the EMA and the moments (dropout 0.1)."""
  cfg = configs.tiny_synthetic()
  return configs.replace(
      cfg, training={'num_steps_lr_warmup': 1, **training},
      optimizer=dataclasses.replace(cfg.optimizer, learning_rate=2e-3))


def _batches(cfg, n):
  rs = np.random.RandomState(3)
  return [{'images': rs.randint(0, 256, size=(B, *cfg.model.image_shape))
                     .astype(np.uint8)} for _ in range(n)]


def _tensors(state):
  """Every tensor of a TrainState (params, EMA, AdamW moments and steps)
  and its counts, by name."""
  out = {f'params/{k}': v for k, v in state.params.items()}
  out.update({f'ema/{k}': v for k, v in state.ema_params.items()})
  adamw = state.optimizer.adamw.state_dict()['state']
  for i, slots in adamw.items():
    out.update({f'adamw/{i}/{k}': v for k, v in slots.items()})
  out['step'] = torch.tensor(state.step)
  out['count'] = torch.tensor(state.optimizer.count)
  return out


def _assert_same(got, want):
  assert got.keys() == want.keys()
  for name, w in want.items():
    assert torch.equal(got[name], w), name


def test_resume_is_bit_exact(tiny, tmp_path):
  """Four steps straight against two steps, a checkpoint, a fresh
  Experiment restored from it and two more, on the same batches: params,
  EMA, AdamW moments and counts bit for bit. A step's noise (diffusion
  noise and dropout seed) depends on (training.seed, step) alone."""
  cfg = _config()
  _, state = tiny
  batches = _batches(cfg, 4)
  straight = Experiment(cfg, device='cpu', state=state)
  bpds = [straight.train_step(b)['bpd'] for b in batches]

  first = Experiment(cfg, device='cpu', state=state)
  resumed_bpds = [first.train_step(b)['bpd'] for b in batches[:2]]
  ckpt_lib.CheckpointManager(tmp_path).save(2, first.state)
  second = Experiment(cfg, device='cpu', state=state)
  second.generator.manual_seed(12345)  # the generator's state is not kept
  ckpt_lib.CheckpointManager(tmp_path).restore(second.state)
  assert second.state.step == 2
  resumed_bpds += [second.train_step(b)['bpd'] for b in batches[2:]]

  assert all(torch.equal(a, b) for a, b in zip(bpds, resumed_bpds))
  want, got = _tensors(straight.state), _tensors(second.state)
  assert sum(k.startswith('adamw/') for k in want) == 3 * len(state)
  _assert_same(got, want)
  assert int(want['step']) == int(want['count']) == 4
  # The keys differ between steps and between streams.
  keys = {step_key(cfg.training.seed, s, i) for s in range(3)
          for i in range(4)}
  assert len(keys) == 12


def test_save_restore_round_trip_and_max_to_keep(tiny, tmp_path):
  cfg = _config()
  ex = Experiment(cfg, device='cpu', state=tiny[1])
  mngr = ckpt_lib.CheckpointManager(tmp_path / 'ckpts', max_to_keep=2)
  assert mngr.latest_step() is None
  with pytest.raises(FileNotFoundError):
    mngr.restore_dict()
  saved = {}
  for batch in _batches(cfg, 3):
    ex.train_step(batch)
    path = mngr.save(ex.state.step, ex.state)
    assert os.path.basename(path) == f'ckpt_{ex.state.step}.pt'
    saved[ex.state.step] = {k: v.clone() for k, v in
                            _tensors(ex.state).items()}
  assert mngr.steps() == [2, 3] and mngr.latest_step() == 3
  assert sorted(os.listdir(tmp_path / 'ckpts')) == ['ckpt_2.pt',
                                                    'ckpt_3.pt']
  restored = mngr.restore_dict(2)
  assert restored.keys() == {'step', 'params', 'ema_params', 'opt_state'}
  assert restored['step'] == 2
  for step in (2, 3):
    fresh = Experiment(cfg, device='cpu', state=tiny[1])
    mngr.restore(fresh.state, step)
    _assert_same(_tensors(fresh.state), saved[step])
  # A checkpoint of another model does not load.
  other = Experiment(configs.replace(cfg, model={'sm_n_layer': 1}),
                     device='cpu')
  with pytest.raises(ValueError, match='missing'):
    mngr.restore(other.state)


def test_restore_partial_into_matches_merge_restored(tiny, tmp_path):
  """merge_restored against JAX's on nested dicts; restore_partial_into
  copies only the leaves a checkpoint holds, from a directory (the latest
  wins) or one file, and warm-starts an Experiment through
  `ckpt_restore_dir`."""
  fresh = {'a': {'x': 1, 'y': {'z': 2}}, 'b': 3, 'c': [4]}
  restored = {'a': {'y': {'z': 20, 'w': 9}}, 'c': [40], 'd': 5}
  assert merge_restored(fresh, restored) == jax_merge_restored(fresh,
                                                               restored)
  assert merge_restored(fresh, restored) == {'a': {'x': 1, 'y': {'z': 20}},
                                             'b': 3, 'c': [40]}

  cfg = _config()
  ex = Experiment(cfg, device='cpu', state=tiny[1])
  gamma = {k: v + 1.0 for k, v in ex.state.params.items()
           if k.startswith('gamma.')}
  os.makedirs(tmp_path / 'dir')
  torch.save({'params': gamma, 'step': 7}, tmp_path / 'dir' / 'ckpt_7.pt')
  torch.save({'step': 3}, tmp_path / 'dir' / 'ckpt_3.pt')
  before = {k: v.clone() for k, v in _tensors(ex.state).items()}
  for path in (tmp_path / 'dir', tmp_path / 'dir' / 'ckpt_7.pt'):
    target = Experiment(cfg, device='cpu', state=tiny[1])
    ckpt_lib.restore_partial_into(target.state, str(path))
    after = _tensors(target.state)
    for name, value in before.items():
      key = name.split('/', 1)[-1]
      if name.startswith('params/') and key in gamma:
        assert torch.equal(after[name], gamma[key]), name
      elif name == 'step':
        assert int(after[name]) == 7
      else:
        assert torch.equal(after[name], value), name
  warm = Experiment(configs.replace(
      cfg, ckpt_restore_dir=str(tmp_path / 'dir' / 'ckpt_7.pt')),
                    device='cpu', state=tiny[1])
  assert warm.state.step == 7
  assert all(torch.equal(warm.state.params[k], v) for k, v in gamma.items())
  with pytest.raises(FileNotFoundError):
    ckpt_lib.restore_partial_into(ex.state, str(tmp_path / 'ckpt-7'))


# -- the msgpack codec --------------------------------------------------------

_INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
         2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
         -2 ** 31 - 1, -2 ** 63]


def _tree():
  """Every kind of value flax's `to_bytes` writes, at each width."""
  rs = np.random.RandomState(0)
  return {
      'ints': {str(i): v for i, v in enumerate(_INTS)},
      'floats': {'a': 1.5, 'b': -0.0, 'c': float('inf'), 'd': 1e300},
      'consts': {'t': True, 'f': False, 'n': None},
      'strs': {'s0': '', 's31': 'a' * 31, 's32': 'b' * 32, 's300': 'c' * 300,
               's70k': 'd' * 70000, 'u': 'ünï'},
      'bins': {'b10': b'x' * 10, 'b300': b'y' * 300, 'b70k': b'z' * 70000},
      'lists': {'l15': list(range(15)), 'l16': list(range(16)),
                'l70k': [1] * 70000},
      'map16': {str(i): i for i in range(16)},
      'map70k': {str(i): i for i in range(70000)},
      'scalars': {'f32': np.float32(3.5), 'i64': np.int64(-7),
                  'u8': np.uint8(200), 'b': np.bool_(True),
                  'c': complex(1.0, -2.0)},
      'arrays': {'f32': rs.standard_normal((3, 4)).astype(np.float32),
                 'f64': rs.standard_normal(5), 'i8': np.arange(-3, 3,
                                                              dtype=np.int8),
                 'u16': np.arange(7, dtype=np.uint16).reshape(7, 1),
                 'bool': rs.rand(2, 3) > 0.5, 'empty': np.zeros((0, 3)),
                 'scalar': np.array(2.5, np.float32),
                 'big': rs.standard_normal((70, 40)).astype(np.float32),
                 'strided': np.arange(24.0).reshape(4, 6)[:, ::2]},
  }


def _numpy(tree):
  """A tree's leaves as numpy arrays, its dicts in their order
  (`jax.tree.map` sorts the keys)."""
  if isinstance(tree, dict):
    return {k: _numpy(v) for k, v in tree.items()}
  return np.asarray(tree)


def _assert_trees_equal(got, want, path=''):
  assert type(got) is type(want), (path, type(got), type(want))
  if isinstance(want, dict):
    assert list(got) == list(want), path
    for key in want:
      _assert_trees_equal(got[key], want[key], f'{path}/{key}')
  elif isinstance(want, np.ndarray):
    assert got.dtype == want.dtype and got.shape == want.shape, path
    np.testing.assert_array_equal(got, want, err_msg=path)
  elif isinstance(want, float) and np.isnan(want):
    assert np.isnan(got), path
  else:
    assert got == want, path


@pytest.mark.parametrize('chunk', [None, 1000], ids=['whole', 'chunked'])
def test_msgpack_matches_flax(monkeypatch, chunk):
  """Encoding gives flax's bytes: `msgpack_serialize` (what `to_bytes`
  writes after `to_state_dict`, which turns lists into dicts), and
  `to_bytes` itself on a tree of dicts. Decoding gives `msgpack_restore`'s
  tree leaf for leaf. With the chunk size cut to 1000 bytes, the larger
  arrays become `__msgpack_chunked_array__` leaves."""
  if chunk is not None:
    monkeypatch.setattr(flax.serialization, 'MAX_CHUNK_SIZE', chunk)
    monkeypatch.setattr(msgpack, 'MAX_CHUNK_SIZE', chunk)
  tree = _tree()
  want = flax.serialization.msgpack_serialize(_tree(), in_place=True)
  assert msgpack.serialize(tree) == want
  del tree['lists']
  assert msgpack.serialize(tree) == flax.serialization.to_bytes(tree)
  if chunk is not None:
    assert b'__msgpack_chunked_array__' in want
  _assert_trees_equal(msgpack.restore(want),
                      flax.serialization.msgpack_restore(want))
  with pytest.raises(ValueError, match='ends inside'):
    msgpack.restore(want[:-1])


# -- parameter layouts --------------------------------------------------------


def test_convert_and_export_params_match_jax(tiny):
  """The reference layout of the tiny model's params: the port's export
  (from its state_dict) and JAX's `export_params` (from the flax tree) are
  leaf-identical and in the same order, `convert_params` maps it back as
  JAX's does, and a `ckpt-N.flax` the port exports is the bytes JAX's
  `to_bytes` writes."""
  jax_params, state = tiny
  want = jax_compat.export_params(jax_params)
  got = compat.to_reference_params(state)
  assert list(compat.flatten(got)) == list(flatten_dict(
      want, sep='/'))
  _assert_trees_equal(got, _numpy(want))
  back = compat.convert_params(got)
  _assert_trees_equal(back, _numpy(jax_compat.convert_params(want)))
  restored = compat.reference_state_dict(got, configs.tiny_synthetic().model)
  assert all(torch.equal(restored[k], v) for k, v in state.items())

  flat = compat.flatten(got)
  flat.pop('gamma/dense_1/bias')
  flat['score_model/conv_in/kernel'] = np.zeros((3, 3, 3, 5), np.float32)
  flat['score_model/extra/kernel'] = np.zeros(2, np.float32)
  with pytest.raises(ValueError) as err:
    compat.reference_state_dict(compat.unflatten(flat),
                                configs.tiny_synthetic().model)
  for part in ('missing from checkpoint', 'gamma.dense_1.bias',
               'unconsumed', 'score_model.extra', 'shape mismatches',
               'score_model.conv_in.weight'):
    assert part in str(err.value), part


def test_export_reference_checkpoint_is_flax_bytes(tiny, tmp_path):
  jax_params, state = tiny
  ex = Experiment(_config(), device='cpu', state=state)
  with torch.no_grad():
    for p in ex.state.ema_params.values():
      p.mul_(0.5)
  ex.state.step = 11
  ckpt_lib.CheckpointManager(tmp_path / 'ckpts').save(11, ex.state)
  path = compat.export_reference_checkpoint(str(tmp_path / 'ckpts'),
                                            str(tmp_path / 'out'))
  assert os.path.basename(path) == 'ckpt-11.flax'
  half = jax.tree.map(lambda p: np.asarray(p) * np.float32(0.5), jax_params)
  want = flax.serialization.to_bytes({
      'step': np.int64(11),
      'params': jax_compat.export_params(jax_params),
      'ema_params': jax_compat.export_params(half)})
  with open(path, 'rb') as f:
    assert f.read() == want
  assert compat.is_reference_checkpoint(str(tmp_path / 'out'))
  assert not compat.is_reference_checkpoint(str(tmp_path / 'ckpts'))

  # Imported back: params, EMA and step, and a fresh optimizer.
  step = compat.import_reference_checkpoint(
      _config(), path, str(tmp_path / 'imported'), device='cpu')
  assert step == 11
  back = ckpt_lib.CheckpointManager(
      tmp_path / 'imported' / 'checkpoints').restore_dict()
  assert back['step'] == 11 and not back['opt_state']['adamw']['state']
  for name in ('params', 'ema_params'):
    for k, v in getattr(ex.state, name).items():
      assert torch.equal(back[name][k], v), (name, k)


# -- entry points without CUDA ------------------------------------------------


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, tmp_path,
                                                   capsys):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  calls = [
      lambda: main.main(['--config=tiny_synthetic',
                         f'--workdir={tmp_path}']),
      lambda: eval_bpd.main(['--config=tiny_synthetic',
                             f'--checkpoint_directory={tmp_path}']),
      lambda: compat.import_reference_checkpoint(
          configs.tiny_synthetic(), str(tmp_path / 'ckpt-1.flax'),
          str(tmp_path)),
  ]
  for call in calls:
    with pytest.raises(RuntimeError, match="device='cpu'"):
      call()
  ckpt_lib.CheckpointManager(tmp_path / 'ckpts').save(
      0, Experiment(configs.tiny_synthetic(), device='cpu').state)
  capsys.readouterr()
  eval_bpd.main(['--config=tiny_synthetic', '--device=cpu',
                 '--bpd_eval_method=ode', '--solver=rk4', '--rk4_steps=1',
                 '--n_is=1', '--config.data.synthetic_examples=32',
                 f'--checkpoint_directory={tmp_path / "ckpts"}'])
  assert capsys.readouterr().out.startswith('Test BPD:')
  with pytest.raises(ValueError, match='--mode analyze needs --checkpoint'):
    main.main(['--config=tiny_synthetic', '--device=cpu', '--mode=analyze',
               f'--workdir={tmp_path}'])
  with pytest.raises(ValueError, match='unrecognized'):
    main.main(['--config=tiny_synthetic', '--device=cpu', '--seed=3',
               f'--workdir={tmp_path}'])


def test_port_imports_without_jax_flax_msgpack_orbax():
  """Every module of the port, the new CLIs included, imports with jax,
  flax, msgpack, orbax and the JAX package blocked."""
  code = (
      "import sys, pkgutil, importlib\n"
      "for m in ('jax', 'flax', 'msgpack', 'orbax', 'ml_collections',\n"
      "          'absl', 'mulan_tpu'):\n"
      "  sys.modules[m] = None\n"
      "import mulan_tpu_torch\n"
      "names = [m.name for m in pkgutil.walk_packages(\n"
      "    mulan_tpu_torch.__path__, 'mulan_tpu_torch.')]\n"
      "for name in names:\n"
      "  importlib.import_module(name)\n"
      "print(' '.join(names))\n")
  out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
  assert out.returncode == 0, out.stderr
  names = out.stdout.split()
  for name in ('compat', 'main', 'eval_bpd', 'train.checkpoint',
               'utils.msgpack', 'utils.workdir', 'ops.ode', 'evals.nll_ode'):
    assert f'mulan_tpu_torch.{name}' in names, name
