"""The plain reference against the program at a tiny configuration on the
CPU: the parameters' names and shapes, the dropout masks, the noise of a
train step, the ELBO and its gradient. The test imports both; the
reference itself imports nothing of the program."""

import dataclasses
import math

import pytest
import torch

from benchmark.reference import mulan as ref
from benchmark.reference import philox
from mulan_tpu_torch.models import build_model
from mulan_tpu_torch.models.config import tiny_config
from mulan_tpu_torch.ops import dropout as dropout_ops
from mulan_tpu_torch.train.loop import TRAIN, step_key


def _pair(vdm_type, seed=5):
  cfg = tiny_config(image_size=8, sm_n_embd=32, sm_n_layer=2,
                    forward_n_layer=1, latent_size=10, latent_k=3)
  m = ref.Model.from_config(dataclasses.asdict(cfg), vdm_type)
  w = ref.make_weights(m, seed, 'cpu')
  return cfg, m, w, build_model(vdm_type, cfg, device='cpu', state=w)


@pytest.mark.parametrize('vdm_type', ['mulan_velocity', 'mulan_epsilon'])
def test_names_shapes_and_elbo(vdm_type):
  cfg, m, w, model = _pair(vdm_type)
  assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == (
      ref.param_shapes(m))
  images = torch.randint(0, 256, (6, 8, 8, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(1))
  noise = ref.draw_train_noise(m, torch.Generator().manual_seed(2), 6, 'cpu')
  out = model.elbo(images, noise.t, eps0=noise.eps0, eps=noise.eps,
                   latent_noise=noise.variates, deterministic=False,
                   dropout_seed=1234)
  program = (out.loss_recon + out.loss_klz + out.loss_diff) / (
      m.n_pixels * math.log(2))
  leaves = {k: v.clone().requires_grad_(True) for k, v in w.items()}
  want = ref.elbo_bpd(leaves, m, images, noise, dropout_seed=1234)
  torch.testing.assert_close(program, want.detach(), rtol=1e-5, atol=1e-5)
  names = [n for n, _ in model.named_parameters()]
  got = torch.autograd.grad(program.mean(), list(model.parameters()))
  exp = torch.autograd.grad(want.mean(), [leaves[n] for n in names])
  norms = torch.stack([e.norm() for e in exp])
  scale = torch.maximum(norms, norms.median())
  gaps = torch.stack([(g - e).norm() for g, e in zip(got, exp)]) / scale
  assert gaps.max() < 1e-3, names[int(gaps.argmax())]


def test_dropout_masks_are_the_programs():
  for seed, site, first in ((7, 0, 0), (2 ** 31 - 2, 70, 13), (99, 3, 4096)):
    shape = (3, 5, 4, 4)
    want = dropout_ops.dropout_mask_plain(seed, site, shape, 0.1,
                                          torch.float32, 'cpu', first)
    got = philox.keep_mask(seed, site, shape, 0.1, 'cpu', first)
    assert torch.equal(got, want)


def test_train_step_noise_is_the_programs(monkeypatch):
  """The program's train step draws, from its reseeded generator, what the
  reference draws for the same (seed, step)."""
  from mulan_tpu_torch import configs
  from mulan_tpu_torch.models import mulan as mulan_lib
  from mulan_tpu_torch.train.loop import Experiment
  cfg = configs.replace(configs.tiny_synthetic(),
                        model=dataclasses.asdict(tiny_config(
                            image_size=8, sm_n_embd=32, sm_n_layer=2,
                            forward_n_layer=1, latent_size=10, latent_k=3)),
                        training={'seed': 3_000_000_019, 'substeps': 1})
  m = ref.Model.from_config(dataclasses.asdict(cfg.model), cfg.vdm_type)
  ex = Experiment(cfg, device='cpu', state=ref.make_weights(m, 1, 'cpu'))
  seen = {}
  real = mulan_lib.MuLAN.elbo

  def spy(self, images, t, **kw):
    seen.update(t=t.clone(), dropout_seed=kw['dropout_seed'])
    gen = kw['generator']
    state = gen.get_state()
    seen['after_t'] = state
    return real(self, images, t, **kw)

  monkeypatch.setattr(mulan_lib.MuLAN, 'elbo', spy)
  ex.train_superstep(next(ex.train_iter))
  noise, dropout_seed = ref.train_step_noise(m, 3_000_000_019, 0, 8, 'cpu')
  assert dropout_seed == step_key(3_000_000_019, TRAIN, 0) % (2 ** 31 - 1)
  assert seen['dropout_seed'] == dropout_seed
  torch.testing.assert_close(seen['t'], noise.t, rtol=0, atol=0)
  gen = torch.Generator().set_state(seen['after_t'])
  variates = torch._standard_gamma(torch.full((10, 8, 10), 1 / 3),
                                   generator=gen)
  assert torch.equal(variates, noise.variates)
  assert torch.equal(torch.randn((8, 8, 8, 3), generator=gen), noise.eps0)
  assert torch.equal(torch.randn((8, 8, 8, 3), generator=gen), noise.eps)
