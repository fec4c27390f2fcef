"""The port's configs, data, parameter plumbing and evaluation entry points.

Configs and data are held against the JAX package's; the evaluation and
sampling entry points run end to end on the CPU at the tiny size (the
flagship size runs on the card, in chip_smoke.py).
"""

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_config
from mulan_tpu.configs import cifar10_conditioned, vdm_cifar10
from mulan_tpu.data import pipeline
from mulan_tpu.models import model_config_from_dict
from mulan_tpu.models.config import ModelConfig as JaxModelConfig
from mulan_tpu_torch import configs, data, params
from mulan_tpu_torch.evals import harness, vlb
from mulan_tpu_torch.models.config import (ModelConfig, flagship_config,
                                           tiny_config)
from mulan_tpu_torch.models.mulan import MuLAN
from torch_port_helpers import mulan_pair

REPO = pathlib.Path(__file__).resolve().parent.parent


def _assert_fields_match(port_cfg, jax_cfg):
  for field in dataclasses.fields(ModelConfig):
    jax_name = 'use_pallas' if field.name == 'use_kernels' else field.name
    assert getattr(port_cfg, field.name) == getattr(jax_cfg, jax_name), (
        field.name)


def test_flagship_config_matches_jax():
  _assert_fields_match(flagship_config(), model_config_from_dict(
      cifar10_conditioned.get_config().model))


def test_tiny_config_matches_graft_entry():
  _assert_fields_match(tiny_config(), model_config_from_dict(
      dict(_flagship_config(tiny=True).model)))


# JAX ModelConfig fields that the port renames: {JAX name: port name}.
RENAMED = {'use_pallas': 'use_kernels'}
# JAX ModelConfig fields that the port does not have, each with the value
# that the port's code implies (it runs only that behaviour).
NOT_PORTED = {
    'condition': 'input',  # the score UNet takes z_t itself as its input
    'epsilon': 0.0,  # no offset of the time grid
    'gamma_precision': 'highest',  # the gamma MLP runs in float32, TF32 off
    'importance_sampling': False,  # t is drawn uniform (antithetic)
    'model_time': False,  # the UNet is conditioned on gamma_t, not on t
    'monotone_layer': 'dense_monotone',  # the poly_fixedend network's layer
    'sigma_max': 20.0,  # sigma_*: the blur schedule's; 'no_blur' has none
    'sigma_min': 0.0,
    'sigma_type': 'no_blur',
    'trace_matching': False,  # the ELBO has no trace-matching term
}


def test_every_jax_config_field_is_ported_or_listed():
  """Walks the JAX ModelConfig's fields: each is a port field with the same
  flagship, VDM and tiny values, a rename, or a NOT_PORTED entry whose
  implied value every JAX config has. A JAX field added without a port
  fails."""
  port_fields = {f.name for f in dataclasses.fields(ModelConfig)}
  jax_fields = [f.name for f in dataclasses.fields(JaxModelConfig)]
  assert not port_fields & NOT_PORTED.keys()
  assert NOT_PORTED.keys() <= set(jax_fields)
  pairs = ((flagship_config(), model_config_from_dict(
      cifar10_conditioned.get_config().model)),
           (configs.vdm_cifar10().model, model_config_from_dict(
               vdm_cifar10.get_config().model)),
           (tiny_config(), model_config_from_dict(
               dict(_flagship_config(tiny=True).model))))
  for name in jax_fields:
    for port_cfg, jax_cfg in pairs:
      if name in NOT_PORTED:
        assert getattr(jax_cfg, name) == NOT_PORTED[name], name
      else:
        port_name = RENAMED.get(name, name)
        assert port_name in port_fields, f'{name} is neither ported nor listed'
        assert getattr(port_cfg, port_name) == getattr(jax_cfg, name), name


@pytest.mark.parametrize('split', ['train', 'eval'])
def test_synthetic_data_matches_pipeline(split):
  images, labels = data.synthetic_split(split, (8, 8, 3), seed=3,
                                        examples=64)
  want = pipeline.load_source('synthetic', split, image_shape=(8, 8, 3),
                              synthetic_seed=3, synthetic_examples=64)
  np.testing.assert_array_equal(images, want.images)
  np.testing.assert_array_equal(labels, want.labels)


def test_eval_batches_match_one_time_eval_iterator():
  images, labels = data.synthetic(5, 37, (8, 8, 3))
  want = pipeline.one_time_eval_iterator(
      pipeline.ArraySource(images, labels), batch_size=8)
  got = list(data.eval_batches(images, 8))
  assert len(got) == 4  # the remainder of 5 is dropped
  for g, w in zip(got, want, strict=True):
    np.testing.assert_array_equal(g, w['images'])


@pytest.mark.parametrize('cfg', [tiny_config(), flagship_config()],
                         ids=['tiny', 'flagship'])
def test_param_names_and_shapes_cover_the_model(cfg):
  """init_params and from_flax both give exactly the model's parameters."""
  with torch.device('meta'):
    want = {k: tuple(v.shape) for k, v in MuLAN(cfg).state_dict().items()}
  fresh = params.init_params(cfg, torch.Generator().manual_seed(0))
  assert {k: tuple(v.shape) for k, v in fresh.items()} == want
  if cfg == tiny_config():
    _, _, port = mulan_pair(cfg)  # load_state_dict(strict) inside
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == want


def test_init_params_zero_init_and_perturbation():
  cfg = tiny_config()
  plain = params.init_params(cfg, torch.Generator().manual_seed(0))
  assert not plain['score_model.mid_attn_1.proj_out.weight'].any()
  assert not plain['gamma.dense_out_a.weight'].any()
  assert (plain['score_model.GroupNormF32_0.weight'] == 1).all()
  perturbed = params.init_params(cfg, torch.Generator().manual_seed(0),
                                 perturb_zero_init=0.02)
  assert all(v.any() for v in perturbed.values())
  again = params.init_params(cfg, torch.Generator().manual_seed(0),
                             perturb_zero_init=0.02)
  assert all(torch.equal(perturbed[k], again[k]) for k in perturbed)


def _tiny_model(**overrides):
  cfg = tiny_config(**overrides)
  model = MuLAN(cfg).eval()
  model.load_state_dict(params.init_params(
      cfg, torch.Generator().manual_seed(0), perturb_zero_init=0.02))
  return model


@pytest.mark.parametrize('use_kernels', [False, True])
def test_eval_bpd_sparse_runs_on_cpu(use_kernels):
  """Finite and reproducible from the generator's seed; on the CPU the
  kernel flag gives the same number as the plain path."""
  model = _tiny_model(use_kernels=use_kernels)
  images, _ = data.synthetic_split('eval', model.config.image_shape,
                                   examples=128)

  def run():
    return vlb.eval_bpd_sparse(model, data.eval_batches(images, 8),
                               generator=torch.Generator().manual_seed(1),
                               max_batches=3)

  bpd = run()
  assert np.isfinite(bpd) and bpd > 0
  assert run() == bpd
  if use_kernels:
    plain = _tiny_model(use_kernels=False)
    assert vlb.eval_bpd_sparse(
        plain, data.eval_batches(images, 8),
        generator=torch.Generator().manual_seed(1), max_batches=3) == bpd


def test_random_samples_runs_on_cpu():
  model = _tiny_model()
  images, z_0 = harness.random_samples(
      model, batch_size=3, T=4, generator=torch.Generator().manual_seed(2))
  assert images.dtype == np.uint8
  assert images.shape == (3, *model.config.image_shape)
  assert z_0.shape == (3, *model.config.image_shape)
  assert torch.isfinite(z_0).all()


@pytest.mark.parametrize('field,value', [
    ('latent_type', 'gumbel'), ('unet_type', 'ldm'),
    ('velocity_from_epsilon', True), ('encoder', 'cnn')])
def test_unported_options_raise(field, value):
  with pytest.raises(NotImplementedError, match='ROADMAP'):
    MuLAN(tiny_config(**{field: value}))


def test_port_imports_without_jax():
  """Every module of the port imports with jax, flax, ml_collections and
  absl blocked, as on a machine that has only PyTorch."""
  code = (
      "import sys, pkgutil, importlib\n"
      "for m in ('jax', 'flax', 'ml_collections', 'absl'):\n"
      "  sys.modules[m] = None\n"
      "import mulan_tpu_torch\n"
      "names = [m.name for m in pkgutil.walk_packages(\n"
      "    mulan_tpu_torch.__path__, 'mulan_tpu_torch.')]\n"
      "for name in names:\n"
      "  importlib.import_module(name)\n"
      "print(len(names))\n")
  out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
  assert out.returncode == 0, out.stderr
  assert int(out.stdout.split()[-1]) >= 18
