"""The port's train step against the JAX package, float32 on the CPU: the
configs, the data iterators, float32 master weights, the train-mode ELBO and
its gradients with dropout, the two-group AdamW with the EMA, and the
`Experiment` loop.

Parameters come from one flax init, transplanted with `params.from_flax`;
gradients map through the same function (its transposes are linear). The
JAX side draws its noise through the patched, shape-seeded `jax.random` of
`parity_helpers.frozen_randomness`, and its dropout masks through a patched
`mulan_tpu.ops.dropout._hw_mask`; the port is handed the same arrays.
"""

import dataclasses
import types

from flax.traverse_util import flatten_dict, unflatten_dict
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mulan_tpu.configs import cifar10_conditioned
from mulan_tpu.configs import imagenet32 as jax_imagenet32
from mulan_tpu.configs import tiny_synthetic as jax_tiny_synthetic
from mulan_tpu.configs import vdm_cifar10 as jax_vdm_cifar10
from mulan_tpu.data import pipeline
from mulan_tpu.models import build_model as build_jax_model
from mulan_tpu.models import model_config_from_dict
from mulan_tpu.ops import dropout as jax_dropout
from mulan_tpu.parallel import mesh as mesh_lib
from mulan_tpu.train import loop as jax_loop
from mulan_tpu.train import optimizer as jax_optimizer
from mulan_tpu.train.state import TrainState as JaxTrainState
from mulan_tpu_torch import configs, data, params
from mulan_tpu_torch.evals import harness, vlb
from mulan_tpu_torch.models import build_model, latents
from mulan_tpu_torch.models.config import flagship_config
from mulan_tpu_torch.models.mulan import MuLAN
from mulan_tpu_torch.ops import dropout as drop_ops
from mulan_tpu_torch.train import optimizer as port_optimizer
from mulan_tpu_torch.train.loop import Experiment
from mulan_tpu_torch.train.state import TrainState
from mulan_tpu_torch.utils.metrics import image_grid
from parity_helpers import frozen_randomness, shape_seed
from torch_port_helpers import (jax_config, mulan_pair, shaped_gamma,
                                shaped_normal, to_torch)

B = 4
# Gradients in the form of tests/test_grad_parity.py, with atol tied to the
# largest gradient of the model: float32 on both sides, summed in other
# orders through the whole model. The gamma network's gradients carry the
# largest differences (1e-3 of their leaf's max, with dropout and without;
# the network alone matches to 1e-6): d loss / d gamma_t reaches every pixel
# through the UNet's time embedding, sin and cos of arguments up to 1000 rad,
# where one float32 ulp is 6e-5.
GRAD_RTOL, GRAD_ATOL_FRAC = 2e-3, 2e-4


# -- configs and data ---------------------------------------------------------


# Fields JAX reads with config.get(name, default): {name: default}.
JAX_GET_DEFAULTS = {'nan_guard': False, 'fused': False, 'stacked': False}


def _assert_section(port, jax_section, defaults=JAX_GET_DEFAULTS):
  for field in dataclasses.fields(port):
    value = getattr(port, field.name)
    if dataclasses.is_dataclass(value):
      _assert_section(value, jax_section[field.name])
    elif field.name in jax_section:
      assert value == jax_section[field.name], field.name
    else:  # read with config.get(name, default) in JAX
      assert value == dict(defaults).get(field.name), field.name


@pytest.mark.parametrize('port_fn,jax_module', [
    (configs.cifar10_conditioned, cifar10_conditioned),
    (configs.tiny_synthetic, jax_tiny_synthetic),
    (configs.vdm_cifar10, jax_vdm_cifar10),
    (configs.imagenet32, jax_imagenet32)],
                         ids=['cifar10_conditioned', 'tiny_synthetic',
                              'vdm_cifar10', 'imagenet32'])
def test_configs_match_jax(port_fn, jax_module):
  port, want = port_fn(), jax_module.get_config()
  for section in ('data', 'training', 'optimizer'):
    _assert_section(getattr(port, section), want[section])
  model = model_config_from_dict(dict(want.model))
  for field in dataclasses.fields(port.model):
    jax_name = 'use_pallas' if field.name == 'use_kernels' else field.name
    assert getattr(port.model, field.name) == getattr(model, jax_name), (
        field.name)
  assert port.vdm_type == want.vdm_type
  assert port.ckpt_restore_dir == want.ckpt_restore_dir
  assert port.lr_gamma_network_scale == want.get('lr_gamma_network_scale',
                                                 1.0)


@pytest.mark.parametrize('substeps', [1, 3])
def test_train_iterator_matches_pipeline(substeps):
  """Across epoch boundaries (37 examples, 8 or 24 a super-batch)."""
  images, labels = data.synthetic(5, 37, (8, 8, 3))
  want = pipeline.train_iterator(pipeline.ArraySource(images, labels),
                                 batch_size=8, substeps=substeps, seed=4,
                                 prefetch=False)
  got = data.train_iterator(images, labels, batch_size=8,
                            substeps=substeps, seed=4)
  for _ in range(6):
    w, g = next(want), next(got)
    assert g.keys() == w.keys()
    for key in w:
      np.testing.assert_array_equal(g[key], w[key], err_msg=key)
      assert g[key].dtype == w[key].dtype, key


def test_eval_iterator_matches_pipeline():
  images, labels = data.synthetic(6, 37, (8, 8, 3))
  want = pipeline.eval_iterator(pipeline.ArraySource(images, labels),
                                batch_size=8, seed=5, prefetch=False)
  got = data.eval_iterator(images, labels, batch_size=8, seed=5)
  for _ in range(9):  # 4 batches a pass: crosses two reshuffles
    w, g = next(want), next(got)
    for key in w:
      np.testing.assert_array_equal(g[key], w[key], err_msg=key)


# -- float32 master weights, devices, determinism -----------------------------


def test_flagship_parameters_are_float32():
  with torch.device('meta'):
    model = MuLAN(flagship_config())
  dtypes = {name: p.dtype for name, p in model.named_parameters()}
  assert len(dtypes) > 700
  assert set(dtypes.values()) == {torch.float32}


def test_bf16_forward_unchanged_by_float32_parameters():
  """The flagship at depth 1 in bf16: float32 parameters cast at use give
  exactly what the same parameters rounded and stored in bf16 gave (the
  score UNet and the encoder trunk held bf16 before)."""
  cfg = flagship_config(sm_n_layer=1, forward_n_layer=1)
  state = params.init_params(cfg, torch.Generator().manual_seed(0),
                             perturb_zero_init=0.02)
  new = build_model('mulan_velocity', cfg, device='cpu', state=state)
  old = MuLAN(cfg)
  old.score_model.to(cfg.dtype)
  old.encoder_model.trunk.to(cfg.dtype)
  old.load_state_dict(state)
  rs = np.random.RandomState(0)
  images = torch.from_numpy(
      rs.randint(0, 256, size=(2, *cfg.image_shape)).astype(np.uint8))
  noise = dict(eps0=to_torch(shaped_normal((2, *cfg.image_shape))),
               latent_noise=to_torch(shaped_gamma(
                   1 / cfg.latent_k,
                   (latents.N_GAMMA_TERMS, 2, cfg.latent_size))))
  noise['eps'] = noise['eps0']
  t = torch.tensor([0.3, 0.8])
  with torch.no_grad():
    want = old.elbo(images, t, **noise)
    got = new.elbo(images, t, **noise)
  for name in ('loss_recon', 'loss_klz', 'loss_diff'):
    assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_build_model_needs_cuda_unless_cpu_is_asked(monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  cfg = configs.tiny_synthetic().model
  with pytest.raises(RuntimeError, match="device='cpu'"):
    build_model('mulan_velocity', cfg)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    Experiment(configs.tiny_synthetic())
  model = build_model('mulan_velocity', cfg, device='cpu')
  assert model.device.type == 'cpu'
  fresh = params.init_params(cfg, torch.Generator().manual_seed(0))
  assert all(torch.equal(model.state_dict()[k], v) for k, v in fresh.items())


def test_evaluation_is_deterministic_in_training_mode():
  """A model left in training mode (as nn.Module starts) never drops in
  eval_bpd_sparse or the sampler; the train-mode ELBO does."""
  cfg = configs.tiny_synthetic().model
  state = params.init_params(cfg, torch.Generator().manual_seed(0),
                             perturb_zero_init=0.02)
  model = build_model('mulan_velocity', cfg, device='cpu', state=state)
  assert model.training
  images, _ = data.synthetic_split('eval', cfg.image_shape, examples=64)

  def bpd():
    return vlb.eval_bpd_sparse(model, data.eval_batches(images, 8),
                               generator=torch.Generator().manual_seed(1),
                               max_batches=2)

  def samples():
    return harness.random_samples(
        model, 2, 3, generator=torch.Generator().manual_seed(2))[1]

  in_train = bpd(), samples()
  model.eval()
  assert bpd() == in_train[0]
  assert torch.equal(samples(), in_train[1])

  x = torch.from_numpy(images[:8])
  t = torch.linspace(0.1, 0.9, 8)
  noise = torch.Generator().manual_seed(3)
  with torch.no_grad():
    det = model.elbo(x, t, generator=torch.Generator().manual_seed(3))
    drop = model.elbo(x, t, generator=noise, deterministic=False,
                      dropout_seed=5)
  assert not torch.equal(det.loss_diff, drop.loss_diff)


# -- the train-mode loss and its gradients, dropout injected ------------------


def _fake_mask(shape, rate):
  """A shape-seeded numpy keep mask with values {0, 1 / (1 - p_eff)}."""
  rs = np.random.RandomState(shape_seed(shape) ^ 0x0D0D)
  p = jax_dropout.effective_rate(rate)
  return ((rs.uniform(size=shape) >= p) / (1.0 - p)).astype(np.float32)


def _inject_masks(monkeypatch):
  """The same masks on both sides: JAX's `_hw_mask` by NHWC shape, the
  port's mask functions by that shape transposed to NCHW."""

  def jax_mask(seed, shape, rate, dtype):
    del seed
    return jnp.asarray(_fake_mask(tuple(shape), rate), dtype)

  def port_mask(seed, site, shape, rate, dtype, device=None):
    del seed, site
    b, c, h, w = shape
    return torch.from_numpy(_fake_mask((b, h, w, c), rate)).permute(
        0, 3, 1, 2).to(dtype=dtype, device=device)

  monkeypatch.setattr(jax_dropout, '_hw_mask', jax_mask)
  monkeypatch.setattr(drop_ops, 'dropout_mask', port_mask)
  monkeypatch.setattr(drop_ops, 'dropout_mask_plain', port_mask)


def _train_config(**model):
  """tiny_synthetic with the kernel flag on (so JAX takes `hw_dropout`, and
  the port its mask functions), a one-step warm-up and lr 2e-3."""
  cfg = configs.tiny_synthetic()
  return configs.replace(
      cfg, model=dict(use_kernels=True, **model),
      training={'num_steps_lr_warmup': 1},
      optimizer=dataclasses.replace(cfg.optimizer, learning_rate=2e-3))


@pytest.fixture(scope='module')
def tiny_params():
  """One flax init of the tiny_synthetic model: (flax params, the port's
  MuLAN with them). The parameters do not depend on the flags varied
  below."""
  _, jax_params, port = mulan_pair(configs.tiny_synthetic().model, batch=2)
  return jax_params, port


def _pair(cfg, tiny_params):
  """(flax model for cfg, flax params, port Experiment on the CPU with
  them)."""
  jax_params, port = tiny_params
  model = build_jax_model('mulan_velocity', jax_config(cfg.model))
  return model, jax_params, Experiment(cfg, device='cpu',
                                       state=port.state_dict())


def _batch(cfg, seed):
  rs = np.random.RandomState(seed)
  return {'images': rs.randint(0, 256, size=(B, *cfg.model.image_shape))
                      .astype(np.uint8),
          'labels': np.zeros((B,), np.int32),
          'conditioning': np.zeros((B,), np.uint8)}


def _port_noise(cfg):
  """What the frozen jax.random draws inside the JAX ELBO."""
  m = cfg.model
  eps = to_torch(shaped_normal((B, *m.image_shape)))
  return dict(
      t=to_torch(jnp.mod(0.375 + jnp.arange(0.0, 1.0, step=1.0 / B), 1.0)),
      eps0=eps, eps=eps, dropout_seed=0,
      latent_noise=to_torch(shaped_gamma(1 / m.latent_k, (
          latents.N_GAMMA_TERMS, B, m.latent_size))))


def _jax_loss_and_grads(model, jax_params, cfg, batch, step):
  fake = types.SimpleNamespace(model=model,
                               model_config=jax_config(cfg.model))
  batch = {k: jnp.asarray(v) for k, v in batch.items()}
  return jax.value_and_grad(
      lambda p: jax_loop.Experiment.loss_fn(fake, p, batch, step,
                                            jax.random.PRNGKey(step), True),
      has_aux=True)(jax_params)


def _assert_grads_match(port_grads, jax_grads):
  want = params.from_flax({k: np.asarray(v) for k, v in
                           flatten_dict(jax_grads, sep='/').items()})
  assert port_grads.keys() == want.keys()
  scale = max(w.abs().max().item() for w in want.values())
  for name, w in want.items():
    np.testing.assert_allclose(port_grads[name].numpy(), w.numpy(),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL_FRAC * scale,
                               err_msg=name)
  norm = torch.sqrt(sum((g * g).sum() for g in port_grads.values()))
  assert norm > 1e-3


@pytest.mark.parametrize('pdrop', [0.1, 0.0])
def test_train_loss_and_gradients_match_jax(monkeypatch, tiny_params,
                                            pdrop):
  cfg = _train_config(sm_pdrop=pdrop)
  model, jax_params, ex = _pair(cfg, tiny_params)
  frozen_randomness(monkeypatch)
  _inject_masks(monkeypatch)
  batch = _batch(cfg, 0)
  (bpd_want, scalars_want), grads_want = _jax_loss_and_grads(
      model, jax_params, cfg, batch, 0)
  bpd, scalars = ex.loss_fn(ex.model, batch, train=True,
                            noise=_port_noise(cfg))
  bpd.backward()
  for key, value in scalars_want.items():
    np.testing.assert_allclose(scalars[key].item(), float(value), rtol=1e-4,
                               atol=1e-6, err_msg=key)
  _assert_grads_match({k: p.grad for k, p in ex.model.named_parameters()},
                      grads_want)
  if pdrop:  # the masks reached the loss
    ex.model.zero_grad()
    with torch.no_grad():
      det, _ = ex.loss_fn(ex.model, batch, train=False,
                          noise=_port_noise(cfg))
    assert abs(det.item() - bpd.item()) > 1e-4


# -- the optimizer and the EMA ------------------------------------------------


@pytest.mark.parametrize('clip', [None, 1.0], ids=['no_clip', 'clip'])
def test_optimizer_and_ema_match_jax(tiny_params, clip):
  """Six steps of the same gradients through JAX's `make_optimizer` +
  `TrainState.apply_gradients` and the port's: warm-up 3, lr 2e-3, the
  non-score group at half the rate."""
  jax_params, port = tiny_params
  lr, warmup, scale, ema_rate = 2e-3, 3, 0.5, 0.9
  tx = jax_optimizer.make_optimizer(
      {'name': 'adamw', 'args': {'b1': 0.9, 'b2': 0.99, 'eps': 1e-8,
                                 'weight_decay': 0.01},
       'gradient_clip_norm': clip},
      jax_optimizer.make_lr_schedule(lr, warmup, 100, False),
      gamma_lr_scale=scale)
  jstate = JaxTrainState.create(apply_fn=None, params=jax_params, tx=tx)
  apply = jax.jit(lambda st, g: st.apply_gradients(grads=g,
                                                   ema_rate=ema_rate))

  model = MuLAN(port.config)
  model.load_state_dict(port.state_dict())
  opt_cfg = configs.OptimizerConfig(learning_rate=lr,
                                    gradient_clip_norm=clip)
  state = TrainState.create(model, port_optimizer.make_optimizer(
      model.named_parameters(), opt_cfg,
      port_optimizer.make_lr_schedule(lr, warmup, 100, False), scale))
  start = {k: p.detach().clone() for k, p in state.params.items()}

  flat_shapes = {k: np.shape(v) for k, v in
                 flatten_dict(jax_params, sep='/').items()}
  rs = np.random.RandomState(7)
  for step in range(6):
    grads = {k: (0.1 * rs.standard_normal(s)).astype(np.float32)
             for k, s in sorted(flat_shapes.items())}
    jstate = apply(jstate, unflatten_dict(
        {tuple(k.split('/')): jnp.asarray(v) for k, v in grads.items()}))
    for name, g in params.from_flax(grads).items():
      state.params[name].grad = g
    state.apply_gradients(ema_rate)
    if step == 0:  # the warm-up is read before the update: lr 0
      assert all(torch.equal(start[k], p) for k, p in state.params.items())
  assert state.step == int(jstate.step) == 6

  for mine, theirs in ((state.params, jstate.params),
                       (state.ema_params, jstate.ema_params)):
    want = params.from_flax({k: np.asarray(v) for k, v in
                             flatten_dict(theirs, sep='/').items()})
    for name, w in want.items():
      np.testing.assert_allclose(mine[name].detach().numpy(), w.numpy(),
                                 rtol=1e-5, atol=1e-7, err_msg=name)
  # Decay covers every tensor but biases: the GroupNorm scales too.
  decay = {id(p): g['weight_decay'] for g in state.optimizer.adamw.param_groups
           for p in g['params']}
  for name, p in state.params.items():
    assert decay[id(p)] == (0.0 if name.endswith('.bias') else 0.01), name
  assert not all(torch.equal(start[k], p)
                 for k, p in state.ema_params.items())


def test_lr_schedule_matches_optax():
  for decay in (False, True):
    want = jax_optimizer.make_lr_schedule(3e-3, 4, 20, decay)
    got = port_optimizer.make_lr_schedule(3e-3, 4, 20, decay)
    for count in range(24):
      np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6,
                                 atol=1e-12, err_msg=(decay, count))


# -- the loop -----------------------------------------------------------------


def test_experiment_train_steps_match_jax(monkeypatch, tiny_params):
  """Three steps of the port's Experiment against a JAX loop of
  `Experiment.loss_fn` + `TrainState.apply_gradients`, on the same batches,
  frozen noise and injected dropout masks."""
  cfg = _train_config()
  model, jax_params, ex = _pair(cfg, tiny_params)
  frozen_randomness(monkeypatch)
  _inject_masks(monkeypatch)
  opt = cfg.optimizer
  tx = jax_optimizer.make_optimizer(
      {'name': 'adamw', 'args': dataclasses.asdict(opt.args)},
      jax_optimizer.make_lr_schedule(opt.learning_rate,
                                     cfg.training.num_steps_lr_warmup,
                                     cfg.training.num_steps_train,
                                     opt.lr_decay))
  jstate = JaxTrainState.create(apply_fn=None, params=jax_params, tx=tx)
  for step in range(3):
    batch = _batch(cfg, 10 + step)
    (bpd_want, _), grads = _jax_loss_and_grads(model, jstate.params, cfg,
                                               batch, step)
    jstate = jstate.apply_gradients(grads=grads, ema_rate=opt.ema_rate)
    scalars = ex.train_step(batch, noise=_port_noise(cfg))
    np.testing.assert_allclose(scalars['bpd'].item(), float(bpd_want),
                               rtol=1e-4, err_msg=f'step {step}')
  assert ex.state.step == 3
  # Adam divides each gradient element by its own running magnitude, so an
  # element whose gradient is near zero, or carries the 1e-3 differences
  # of the gamma network's gradients (GRAD_RTOL above), moves by up to lr a
  # step in a direction its last bits decide (0.1% of all elements do).
  # Every element stays within the largest move of the two updates with
  # lr > 0, and all but 1% of them within a tenth of it.
  move = 2 * opt.learning_rate
  for mine, theirs in ((ex.state.params, jstate.params),
                       (ex.state.ema_params, jstate.ema_params)):
    want = params.from_flax({k: np.asarray(v) for k, v in
                             flatten_dict(theirs, sep='/').items()})
    excess = torch.cat([
        ((mine[k].detach() - w).abs() - GRAD_RTOL * w.abs()).flatten()
        for k, w in want.items()])
    assert excess.max() <= move, excess.max()
    assert (excess > 0.1 * move).double().mean() <= 1e-2


def test_draw_samples_matches_jax_p_sample(monkeypatch, tiny_params):
  """Three steps of `Experiment.draw_samples` against JAX's `_p_sample`
  (`Experiment._compile_steps`, run on a stand-in Experiment), with
  sigma_prior 0.5. JAX draws its own noise: the prior from the second half
  of `split(rng)`, step i's from `fold_in(rng, i)` of the first; the port is
  handed the same arrays through `MuLAN._randn`. The argmax decode may move
  a pixel whose z_0 lies within float32 rounding of a bin edge to the
  neighbouring value, so the grids agree to one level and exactly on all
  but 1% of the values. The sampler draw_samples ran before (a random
  embedding per example) differs from JAX's in more than half of them."""
  cfg = configs.replace(configs.tiny_synthetic(), model={'sigma_prior': 0.5})
  n, steps = 4, 3
  jax_params, port = tiny_params
  jax_cfg = jax_tiny_synthetic.get_config()
  jax_cfg.model.sigma_prior = 0.5
  mesh = mesh_lib.create_mesh(devices=jax.devices()[:1])
  fake = types.SimpleNamespace(
      config=jax_cfg, mesh=mesh, model_config=jax_config(cfg.model),
      model=build_jax_model('mulan_velocity', jax_config(cfg.model)),
      state=JaxTrainState.create(apply_fn=None, params=jax_params,
                                 tx=optax.identity()),
      _replicated=mesh_lib.replicated_sharding(mesh),
      _train_rng=jax.random.PRNGKey(1), _eval_rng=jax.random.PRNGKey(2),
      _sample_rng=jax.random.PRNGKey(3))
  jax_loop.Experiment._compile_steps(fake)
  want = jax_loop.Experiment._draw_samples(fake, jax_params, n, steps)

  rng, prior_rng = jax.random.split(fake._sample_rng)
  shape = (n, *cfg.model.image_shape)
  noise = [jax.random.normal(prior_rng, shape)] + [
      jax.random.normal(jax.random.fold_in(rng, i), shape)
      for i in range(steps)]
  ex = Experiment(cfg, device='cpu', state=port.state_dict())
  monkeypatch.setattr(MuLAN, '_randn',
                      lambda self, shape, generator: to_torch(noise.pop(0)))
  got = ex.draw_samples(n, T=steps)
  assert not noise
  assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
  diff = np.abs(got.astype(int) - want.astype(int))
  assert diff.max() <= 1 and (diff > 0).mean() <= 1e-2, diff.sum()

  # What draw_samples drew before: a random hard top-k embedding per example
  # (`harness.random_samples`), here on the same prior and step noise.
  model, m = ex.state.ema_model, cfg.model
  emb = latents.logits_to_embeddings(torch.randn(
      (n, m.latent_size), generator=torch.Generator().manual_seed(0)),
                                     m.latent_k)
  with torch.no_grad():
    z = to_torch(jax.random.normal(prior_rng, shape))
    for i in range(steps):
      z = model.conditional_sample(i, steps, z, emb, eps=to_torch(
          jax.random.normal(jax.random.fold_in(rng, i), shape)))
    old = image_grid(model.generate_x(z).to(torch.uint8).numpy())
  assert (old != want).mean() > 0.5


def test_experiment_trains_and_evaluates_on_cpu(capsys):
  cfg = configs.replace(configs.tiny_synthetic(),
                        training={'num_steps_lr_warmup': 1,
                                  'steps_per_logging': 2})
  ex = Experiment(cfg, device='cpu')
  start = {k: p.detach().clone() for k, p in ex.state.params.items()}
  history = ex.train(4)  # two super-steps of 2
  assert len(history) == 4
  assert all(np.isfinite(s['bpd']) for s in history)
  assert any(not torch.equal(start[k], p) for k, p in ex.state.params.items())
  assert all(torch.isfinite(p).all() for p in ex.state.ema_params.values())
  scalars = ex.run_eval(1)
  assert np.isfinite(scalars['eval_bpd'])
  grid = ex.draw_samples(4, T=2)
  assert grid.shape == (16, 16, 3)
  out = capsys.readouterr().out
  assert 'Step, steps_per_sec, train_bpd' in out
  assert out.count('\n2, ') == 1 and out.count('\n4, ') == 1
