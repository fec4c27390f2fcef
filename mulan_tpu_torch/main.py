"""Train / eval / sample / analyze CLI of the port, counterpart of
`mulan_tpu/main.py`:

    python -m mulan_tpu_torch.main --mode train --config=tiny_synthetic \
        --workdir=<dir> [--config.training.seed=3] [--device=cpu]
    python -m mulan_tpu_torch.main --mode eval --config=... \
        --workdir=<dir> --checkpoint=<workdir>/<...>/checkpoints
    python -m mulan_tpu_torch.main --mode sample --config=... \
        --workdir=<dir> --checkpoint=<checkpoints dir or ckpt-N.flax> \
        [--sampler={ancestral,ode}]
    python -m mulan_tpu_torch.main --mode analyze --config=... \
        --workdir=<dir> --checkpoint=<checkpoints dir or ckpt-N.flax> \
        [--analyze_batches=8] [--analyze_min_cosine=0.9]

`--config` takes a port config name or the path of a JAX config file
(mapped by its basename); `--config.<section>.<field>=<value>` overrides a
field. `train` runs `Experiment.train_and_evaluate` in
`<workdir>/<config>/<job id or time stamp>[-<overrides>]` and resumes from
its checkpoints; `eval` evaluates a checkpoint's EMA weights; `sample` draws
a grid of samples from a checkpoint, ancestral or by the probability-flow
ODE (`evals/nll_ode.py:make_ode_sample_fn`), and writes it as a PNG;
`analyze` writes the analysis figures of a MuLAN checkpoint (`analysis.py`:
the latent clusters' gallery, the schedule's curves, heat map and
histograms, and a PCA scatter of the embeddings) as
`<workdir>/<figure>_ckpt<step>.png`; it needs matplotlib and sklearn.
`--nan_guard` sets `training.nan_guard`. Runs on the card unless
`--device=cpu` is given.

`--multiprocess` joins the process group that torchrun's environment
describes, one rank a card (`cuda:<LOCAL_RANK>`) or CPU ranks over gloo
with `--device=cpu`:

    torchrun --nproc_per_node=N -m mulan_tpu_torch.main --multiprocess \
        --mode train --config=... --workdir=<dir>

The ranks run one data-parallel program (`training.fsdp` > 1 shards the
train state, `train/loop.py`); rank 0 alone logs and writes files.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from mulan_tpu_torch import configs
from mulan_tpu_torch.models import resolve_device
from mulan_tpu_torch.parallel import mesh as mesh_lib


def parser() -> argparse.ArgumentParser:
  p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  p.add_argument('--config', required=True,
                 help='a port config name or a JAX config file')
  p.add_argument('--workdir', required=True, help='work unit directory')
  p.add_argument('--checkpoint', default='',
                 help='--mode eval / sample / analyze: the checkpoint to '
                 'read')
  p.add_argument('--mode', default='train',
                 choices=('train', 'eval', 'sample', 'analyze'))
  p.add_argument('--analyze_batches', type=int, default=8,
                 help='--mode analyze: eval batches probed for logits')
  p.add_argument('--analyze_min_cosine', type=float, default=0.9,
                 help='--mode analyze: latent-cluster cosine threshold '
                 '(k=15 latents: 0.9 requires ~14 of 15 shared)')
  p.add_argument('--sample_batch', type=int, default=16,
                 help='--mode sample: samples to draw (a square)')
  p.add_argument('--sample_T', type=int, default=1000,
                 help='--mode sample: ancestral steps')
  p.add_argument('--sampler', default='ancestral',
                 choices=('ancestral', 'ode'))
  p.add_argument('--device', default='cuda')
  p.add_argument('--multiprocess', action='store_true',
                 help="join torchrun's process group (one rank a card)")
  p.add_argument('--nan_guard', action='store_true',
                 help='check every scalar for NaN/inf after each train '
                 'step and fail naming the first bad one')
  return p


def config_from_args(args, overrides) -> configs.Config:
  """The config named by `--config` with the `--config.*` overrides
  applied, and `training.nan_guard` set by `--nan_guard`."""
  config = configs.from_command_line(args.config, overrides)
  if args.nan_guard:
    config = configs.replace(config, training={'nan_guard': True})
  return config


def main(argv=None) -> None:
  argv = sys.argv[1:] if argv is None else list(argv)
  args, overrides = parser().parse_known_args(argv)
  config = config_from_args(args, overrides)
  device = (mesh_lib.init_distributed(args.device) if args.multiprocess
            else resolve_device(args.device))
  if args.mode == 'sample':
    _sample(args, config, device)
    return
  if args.mode == 'analyze':
    _analyze(args, config, device)
    return

  from mulan_tpu_torch.train.loop import Experiment
  from mulan_tpu_torch.utils.workdir import get_workdir
  experiment = Experiment(config, device=device)
  if args.mode == 'train':
    # Rank 0's time stamp names every rank's workdir.
    workdir = os.path.join(args.workdir, mesh_lib.broadcast_object(
        get_workdir(['main', *argv])))
    if mesh_lib.rank() == 0:
      print(f'Training at workdir: {workdir}', flush=True)
    experiment.train_and_evaluate(workdir)
  else:
    if not args.checkpoint:
      raise ValueError('--mode eval needs --checkpoint=<checkpoints dir>')
    experiment.evaluate(args.workdir, args.checkpoint)


def _sample(args, config, device) -> None:
  """Writes a grid of samples of a checkpoint's EMA weights."""
  from mulan_tpu_torch.evals import nll_ode
  from mulan_tpu_torch.evals.harness import EvalExperiment
  from mulan_tpu_torch.train.loop import SAMPLE
  from mulan_tpu_torch.utils.metrics import image_grid, write_png
  if not args.checkpoint:
    raise ValueError('--mode sample needs --checkpoint=<checkpoints dir or '
                     'ckpt-N.flax>')
  g = int(args.sample_batch ** 0.5)
  if g * g != args.sample_batch:
    raise ValueError(f'--sample_batch must be a perfect square, got '
                     f'{args.sample_batch}')
  ex = EvalExperiment(config, args.checkpoint, device=device)
  if args.sampler == 'ancestral':
    samples = ex.random_samples(batch_size=args.sample_batch,
                                T=args.sample_T)
  else:
    model = ex.state.ema_model
    ex.reseed(SAMPLE, 0)
    rows = ex.rows(args.sample_batch)
    z_0, nfe = nll_ode.make_ode_sample_fn(model, mesh=ex.mesh)(
        args.sample_batch if rows is None else rows.count, ex.generator,
        rows=rows)
    images = model.generate_x(z_0, ex.generator, rows=rows)
    samples = mesh_lib.all_gather_rows(images.to(torch.uint8),
                                       mesh=ex.mesh).cpu().numpy()
    if mesh_lib.rank() == 0:
      print(f'ode sampler nfe: {nfe}')
  if mesh_lib.rank() != 0:
    return
  os.makedirs(args.workdir, exist_ok=True)
  path = os.path.join(args.workdir,
                      f'samples_ckpt{ex.checkpoint_step}_{args.sampler}.png')
  write_png(path, image_grid(samples))
  print(f'Wrote {len(samples)} samples: {path}')


def _analyze(args, config, device) -> None:
  """Writes the analysis figures of a checkpoint's EMA weights
  (`mulan_tpu/main.py:_analyze`): the logits of `--analyze_batches` eval
  batches, their hard latents clustered at `--analyze_min_cosine`, the
  schedule of up to 6 cluster leaders (or the first 4 examples when
  nothing clusters), and the five figures of `analysis.py`."""
  import matplotlib
  matplotlib.use('Agg')
  import matplotlib.pyplot as plt
  import numpy as np

  from mulan_tpu_torch import analysis
  from mulan_tpu_torch.evals.harness import EvalExperiment
  from mulan_tpu_torch.models import latents
  if not args.checkpoint:
    raise ValueError('--mode analyze needs --checkpoint=<checkpoints dir>')
  ex = EvalExperiment(config, args.checkpoint, device=device)
  cfg = config.model
  if not hasattr(ex.state.ema_model, 'gamma_of'):
    raise ValueError('--mode analyze probes the learned per-pixel schedule; '
                     f'vdm_type={config.vdm_type!r} has a scalar '
                     'schedule (use TensorBoard scalars instead).')
  logits, images = analysis.get_logits(ex, num_batches=args.analyze_batches)
  embeddings = latents.logits_to_embeddings(logits, cfg.latent_k)
  emb_np = embeddings.cpu().numpy()
  clusters = analysis.cluster_embeddings(emb_np,
                                         min_cosine=args.analyze_min_cosine)
  if mesh_lib.rank() == 0:
    print(f'{len(emb_np)} images -> {clusters.n_clusters} latent clusters '
          f'(min_cosine={args.analyze_min_cosine:.2f})', flush=True)
  if clusters.n_clusters:
    probe_idx = np.asarray(clusters.leaders[:6])
    labels = [f'cluster {i}' for i in range(len(probe_idx))]
  else:
    probe_idx = np.arange(min(4, len(emb_np)))
    labels = [f'example {i}' for i in probe_idx]
  grids = [g.cpu().numpy() for g in analysis.noise_schedule_per_embedding(
      ex, embeddings[torch.as_tensor(probe_idx, device=embeddings.device)])]
  figs = {
      'cluster_gallery': analysis.cluster_gallery(images, clusters),
      'schedule_curves': analysis.schedule_curves(grids, labels=labels),
      'schedule_heatmap': analysis.schedule_heatmap(grids[0],
                                                    cfg.image_shape),
      'schedule_histograms': analysis.schedule_histograms(grids[0]),
      'embedding_pca': analysis.embedding_scatter(
          analysis.pca_transformation(emb_np, 2),
          # assignment -1 (unclustered) is drawn grey, not as cluster 0
          colors=clusters.assignment if clusters.n_clusters else None),
  }
  for name, fig in figs.items():
    if mesh_lib.rank() == 0:
      os.makedirs(args.workdir, exist_ok=True)
      path = os.path.join(args.workdir,
                          f'{name}_ckpt{ex.checkpoint_step}.png')
      fig.savefig(path, dpi=150, bbox_inches='tight')
      print(f'Wrote {path}')
    plt.close(fig)


if __name__ == '__main__':
  main()
