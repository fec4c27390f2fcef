"""The port's analysis module and `main --mode analyze` against
`mulan_tpu/analysis.py` and `mulan_tpu/main.py:_analyze`, and the blur
schedules and `inverse_sampling` against `mulan_tpu/models/schedules.py`.

The model probes (`get_logits`, `noise_schedule_per_embedding`) run the
tiny MuLAN of `seeded_pair` on both sides: JAX's through stand-in
experiments that hold its flax model, parameters and the eval batches the
port read. The clustering, projections and each figure's data (image
arrays, color limits, line and bar data, scatter offsets and colors) are
held against JAX's functions on the same inputs.
"""

import types

import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use('Agg')
import matplotlib.pyplot as plt  # noqa: E402

from mulan_tpu import analysis as jax_analysis  # noqa: E402
from mulan_tpu import main as jax_main  # noqa: E402
from mulan_tpu.evals import harness as jax_harness  # noqa: E402
from mulan_tpu.models import latents as jax_latents  # noqa: E402
from mulan_tpu.models import schedules as jax_schedules  # noqa: E402
from mulan_tpu_torch import analysis, configs, main  # noqa: E402
from mulan_tpu_torch.models import latents  # noqa: E402
from mulan_tpu_torch.models import schedules  # noqa: E402
from mulan_tpu_torch.train import checkpoint as ckpt_lib  # noqa: E402
from mulan_tpu_torch.train.loop import Experiment  # noqa: E402
from torch_port_helpers import jax_config, seeded_pair  # noqa: E402

RTOL = 1e-5
PNGS = ('cluster_gallery', 'schedule_curves', 'schedule_heatmap',
        'schedule_histograms', 'embedding_pca')


def _close(got, want, rtol=RTOL):
  """|got - want| within rtol of want's largest magnitude."""
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  assert got.shape == want.shape
  assert np.abs(got - want).max() <= rtol * np.abs(want).max()


@pytest.fixture(scope='module')
def pair():
  """(port Experiment of tiny_synthetic on the CPU, a JAX stand-in
  experiment with the same parameters as its EMA)."""
  cfg = configs.tiny_synthetic()
  model, params, port = seeded_pair(cfg.model)
  ex = Experiment(cfg, device='cpu', state=port.state_dict())
  fake = types.SimpleNamespace(model=model,
                               state=types.SimpleNamespace(ema_params=params))
  return ex, fake


# -- model probes ---------------------------------------------------------------


def test_get_logits_and_schedules_match_jax(pair):
  """Two eval batches' logits through the EMA encoder, and gamma(z, t) on
  128 t for three of their hard embeddings, at 1e-5 relative."""
  ex, fake = pair
  logits, images = analysis.get_logits(ex, num_batches=2)
  batch = ex.config.training.batch_size_eval
  assert images.dtype == np.uint8 and len(images) == 2 * batch
  fake.eval_iter = iter([{'images': images[:batch]},
                         {'images': images[batch:]}])
  want_logits, want_images = jax_analysis.get_logits(fake, num_batches=2)
  np.testing.assert_array_equal(images, want_images)
  _close(logits.numpy(), want_logits)

  k = ex.config.model.latent_k
  embeddings = latents.logits_to_embeddings(logits, k)[:3]
  want_embeddings = jax_latents.logits_to_embeddings(want_logits, k)[:3]
  np.testing.assert_array_equal(embeddings.numpy(), want_embeddings)
  grids = analysis.noise_schedule_per_embedding(ex, embeddings)
  want_grids = jax_analysis.noise_schedule_per_embedding(fake,
                                                         want_embeddings)
  assert len(grids) == len(want_grids) == 3
  for got, want in zip(grids, want_grids):
    assert got.shape == (128, ex.config.model.n_pixels)
    _close(got.numpy(), want)
    assert (np.diff(got.numpy(), axis=0) >= -1e-5).all()  # as JAX tests


@pytest.mark.parametrize('shift', [0, 4])
def test_get_embedding_matches_jax(shift):
  got = analysis.get_embedding(batch_size=3, latent_size=10, k=3,
                               shift=shift)
  np.testing.assert_array_equal(
      got.numpy(), jax_analysis.get_embedding(3, 10, 3, shift))


def _hard_embeddings(n=24, size=20, k=5, seed=0):
  """n hard top-k rows, a third of them near-copies of the first few."""
  rng = np.random.default_rng(seed)
  emb = np.zeros((n, size), np.float32)
  for i in range(n):
    emb[i, rng.choice(size, k, replace=False)] = 1
  for i in range(0, n, 3):
    emb[i + 1] = emb[i]
    if i + 2 < n and i % 2:
      emb[i + 2] = np.roll(emb[i], 1)
  return emb


@pytest.mark.parametrize('kwargs', [dict(), dict(min_cosine=0.7),
                                    dict(min_cosine=0.5, min_size=3,
                                         max_size=3)],
                         ids=['default', 'loose', 'truncated'])
def test_cluster_embeddings_matches_jax(kwargs):
  emb = _hard_embeddings()
  got = analysis.cluster_embeddings(emb, **kwargs)
  want = jax_analysis.cluster_embeddings(emb, **kwargs)
  assert got.n_clusters == want.n_clusters > 0
  np.testing.assert_array_equal(got.assignment, want.assignment)
  np.testing.assert_array_equal(got.leaders, want.leaders)
  np.testing.assert_array_equal(got.similarity, want.similarity)
  for c in range(got.n_clusters):
    assert got.members(c) == want.members(c)


def test_projections_match_jax():
  rng = np.random.default_rng(1)
  data = rng.normal(size=(20, 10))
  np.testing.assert_array_equal(analysis.pca_transformation(data, 3),
                                jax_analysis.pca_transformation(data, 3))
  image = rng.normal(size=(8, 8, 3))
  np.testing.assert_array_equal(analysis.dct2(image),
                                jax_analysis.dct2(image))
  np.testing.assert_array_equal(analysis.dct2(image[..., 0]),
                                jax_analysis.dct2(image[..., 0]))


# -- the figures ------------------------------------------------------------------


def figure_data(fig):
  """What a figure draws, axes by axes: image arrays and color limits,
  line data, bar heights and positions, scatter offsets and colors,
  titles and legend texts."""
  out = []
  for ax in fig.axes:
    legend = ax.get_legend()
    out.append(dict(
        images=[(np.asarray(im.get_array()), im.get_clim())
                for im in ax.images],
        lines=[np.asarray(line.get_xydata()) for line in ax.lines],
        bars=[(p.get_x(), p.get_height()) for p in ax.patches],
        scatter=[(np.asarray(c.get_offsets()), np.asarray(c.get_facecolor()))
                 for c in ax.collections],
        title=ax.get_title(),
        legend=[t.get_text() for t in legend.get_texts()] if legend else []))
  plt.close(fig)
  return out


def _assert_same_drawing(got, want):
  assert len(got) == len(want)
  for g, w in zip(got, want):
    for key in ('images', 'lines', 'bars', 'scatter'):
      assert len(g[key]) == len(w[key]), key
    assert g['title'] == w['title'] and g['legend'] == w['legend']
    for (gi, gc), (wi, wc) in zip(g['images'], w['images']):
      np.testing.assert_array_equal(gi, wi)
      assert gc == wc
    for gl, wl in zip(g['lines'], w['lines']):
      np.testing.assert_array_equal(gl, wl)
    assert g['bars'] == w['bars']
    for (go, gf), (wo, wf) in zip(g['scatter'], w['scatter']):
      np.testing.assert_array_equal(go, wo)
      np.testing.assert_array_equal(gf, wf)


def _figure_inputs():
  rng = np.random.default_rng(2)
  grid = np.cumsum(rng.random((16, 8 * 8 * 3)), axis=0).astype(np.float32)
  emb = _hard_embeddings()
  clusters = (analysis.cluster_embeddings(emb),
              jax_analysis.cluster_embeddings(emb))
  images = rng.integers(0, 256, (len(emb), 8, 8, 3), np.uint8)
  points = rng.normal(size=(len(emb), 2))
  return grid, clusters, images, points


FIGURES = {
    'cluster_gallery': lambda mod, grid, clusters, images, points: (
        mod.cluster_gallery(images, clusters[mod is jax_analysis])),
    'schedule_curves': lambda mod, grid, clusters, images, points: (
        mod.schedule_curves([grid, 2 * grid], labels=['a', 'b'])),
    'schedule_curves_max': lambda mod, grid, clusters, images, points: (
        mod.schedule_curves([grid], reduce=np.max)),
    'schedule_heatmap': lambda mod, grid, clusters, images, points: (
        mod.schedule_heatmap(grid, (8, 8, 3))),
    'schedule_heatmap_gray': lambda mod, grid, clusters, images, points: (
        mod.schedule_heatmap(grid[:, :64], (8, 8), times=(0, 1.0))),
    'schedule_histograms': lambda mod, grid, clusters, images, points: (
        mod.schedule_histograms(grid, bins=16)),
    'embedding_scatter': lambda mod, grid, clusters, images, points: (
        mod.embedding_scatter(points)),
    'embedding_scatter_clusters': lambda mod, grid, clusters, images,
    points: mod.embedding_scatter(points, colors=clusters[0].assignment),
}


@pytest.mark.parametrize('name', list(FIGURES))
def test_figure_draws_what_jax_draws(name):
  inputs = _figure_inputs()
  got = figure_data(FIGURES[name](analysis, *inputs))
  want = figure_data(FIGURES[name](jax_analysis, *inputs))
  assert any(a['images'] or a['lines'] or a['bars'] or a['scatter']
             for a in got), name
  _assert_same_drawing(got, want)


def test_animate_redraws_each_frame():
  frames = [np.zeros((4, 4)), np.ones((4, 4))]
  drawn = []
  anim = analysis.animate(lambda ax, i: drawn.append(ax.imshow(frames[i])),
                          len(frames))
  for i in range(len(frames)):
    anim._func(i)
  assert [np.asarray(im.get_array()).max() for im in drawn] == [0.0, 1.0]
  plt.close(anim._fig)


# -- main --mode analyze ----------------------------------------------------------


VDM_ARGS = ['--config=vdm_cifar10', '--config.model.image_size=8',
            '--config.model.sm_n_embd=16', '--config.model.sm_n_layer=2',
            '--config.model.compute_dtype=float32',
            '--config.model.use_kernels=False',
            '--config.data.dataset=synthetic',
            '--config.data.synthetic_examples=64',
            '--config.training.batch_size_eval=8']


def test_analyze_writes_the_five_pngs(tmp_path, capsys):
  """`--mode analyze --device=cpu` on a tiny checkpoint after 2 steps
  writes JAX's five figures under JAX's names."""
  ckpts = tmp_path / 'ckpts'
  ex = Experiment(configs.tiny_synthetic(), device='cpu')
  ex.train(2)
  ckpt_lib.CheckpointManager(ckpts).save(2, ex.state)
  main.main(['--mode=analyze', '--config=tiny_synthetic', '--device=cpu',
             f'--checkpoint={ckpts}', f'--workdir={tmp_path / "out"}',
             '--analyze_batches=2', '--analyze_min_cosine=0.6'])
  assert sorted(p.name for p in (tmp_path / 'out').iterdir()) == sorted(
      f'{name}_ckpt2.png' for name in PNGS)
  for name in PNGS:
    with open(tmp_path / 'out' / f'{name}_ckpt2.png', 'rb') as f:
      assert f.read(8) == b'\x89PNG\r\n\x1a\n', name
  assert '16 images -> ' in capsys.readouterr().out


def _jax_analyze_error(monkeypatch, checkpoint, vdm_type) -> str:
  """The ValueError of JAX's `_analyze` with a stand-in EvalExperiment
  whose model has no `gamma_of`."""
  monkeypatch.setattr(jax_harness, 'EvalExperiment', lambda config, path: (
      types.SimpleNamespace(model=object(), model_config=None)))
  flags = types.SimpleNamespace(
      checkpoint=checkpoint, config=types.SimpleNamespace(vdm_type=vdm_type))
  with pytest.raises(ValueError) as raised:
    jax_main._analyze(flags)
  return str(raised.value)


def test_analyze_raises_jax_errors(tmp_path, monkeypatch):
  """Without `--checkpoint`, and on a VDM checkpoint (a scalar schedule,
  no `gamma_of`), the port raises JAX's ValueError."""
  with pytest.raises(ValueError) as raised:
    main.main(['--mode=analyze', '--config=tiny_synthetic', '--device=cpu',
               f'--workdir={tmp_path}'])
  assert str(raised.value) == _jax_analyze_error(monkeypatch, '',
                                                 'mulan_velocity')
  ckpts = tmp_path / 'vdm'
  ckpt_lib.CheckpointManager(ckpts).save(0, Experiment(
      configs.from_command_line('vdm_cifar10', VDM_ARGS[1:]),
      device='cpu').state)
  with pytest.raises(ValueError) as raised:
    main.main(['--mode=analyze', *VDM_ARGS, '--device=cpu',
               f'--checkpoint={ckpts}', f'--workdir={tmp_path}'])
  assert str(raised.value) == _jax_analyze_error(monkeypatch, str(ckpts),
                                                 'vdm')
  assert 'vdm_type=' in str(raised.value)


# -- the blur schedules and inverse_sampling ---------------------------------------


@pytest.mark.parametrize('name', sorted(schedules.BLUR_SCHEDULES))
def test_blur_schedules_match_jax(name):
  """sigma(t) and dsigma/dt (JAX's by `jax.jvp`) at 1e-6, at JAX's
  default ends (the port's `SIGMA_MIN`/`SIGMA_MAX`) and a learned
  schedule's w = -0.7, b = 0.3."""
  cfg = configs.tiny_synthetic().model
  port = schedules.BLUR_SCHEDULES[name](cfg)
  jax_cfg = jax_config(cfg)
  assert (jax_cfg.sigma_min, jax_cfg.sigma_max) == (schedules.SIGMA_MIN,
                                                    schedules.SIGMA_MAX)
  module = jax_schedules.BLUR_SCHEDULES[name](jax_cfg)
  t = np.linspace(0, 1, 11).astype(np.float32)
  params = {}
  if name == 'learnable_scalar':
    with torch.no_grad():
      port.w.fill_(-0.7)
      port.b.fill_(0.3)
    params = {'w': jnp.array([-0.7]), 'b': jnp.array([0.3])}
  variables = {'params': params}
  want = module.apply(variables, jnp.asarray(t))
  want_g, want_dg = module.apply(variables, jnp.asarray(t),
                                 method=module.gamma_and_dgamma)
  got = port(torch.from_numpy(t))
  got_g, got_dg = port.gamma_and_dgamma(torch.from_numpy(t))
  for g, w in ((got, want), (got_g, want_g), (got_dg, want_dg)):
    _close(g.detach().numpy(), w, 1e-6)


def test_inverse_sampling_matches_jax():
  """`NoiseSchedulePolynomialFixedend.inverse_sampling` on the tiny
  schedule's parameters (`seeded_pair`): new_t exactly, the curve's length
  at 1e-6."""
  cfg = configs.tiny_synthetic().model
  model, params, port = seeded_pair(cfg)
  rng = np.random.default_rng(3)
  emb = (rng.random((4, cfg.latent_size)) > 0.6).astype(np.float32)
  targets = np.asarray([0.0, 0.3, 0.5, 1.0], np.float32)
  want_t, want_len = model.apply(
      {'params': params}, jnp.asarray(emb), jnp.asarray(targets),
      method=lambda m, e, t: m.gamma.inverse_sampling(e, t))
  with torch.no_grad():
    got_t, got_len = port.gamma.inverse_sampling(torch.from_numpy(emb),
                                                 torch.from_numpy(targets))
  np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
  _close(got_len.numpy(), want_len, 1e-6)
  assert got_t[0] == 0 and got_t[-1] == 1
