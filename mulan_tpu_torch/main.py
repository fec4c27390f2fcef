"""Train / eval / sample CLI of the port, counterpart of
`mulan_tpu/main.py`:

    python -m mulan_tpu_torch.main --mode train --config=tiny_synthetic \
        --workdir=<dir> [--config.training.seed=3] [--device=cpu]
    python -m mulan_tpu_torch.main --mode eval --config=... \
        --workdir=<dir> --checkpoint=<workdir>/<...>/checkpoints
    python -m mulan_tpu_torch.main --mode sample --config=... \
        --workdir=<dir> --checkpoint=<checkpoints dir or ckpt-N.flax> \
        [--sampler={ancestral,ode}]

`--config` takes a port config name or the path of a JAX config file
(mapped by its basename); `--config.<section>.<field>=<value>` overrides a
field. `train` runs `Experiment.train_and_evaluate` in
`<workdir>/<config>/<job id or time stamp>[-<overrides>]` and resumes from
its checkpoints; `eval` evaluates a checkpoint's EMA weights; `sample` draws
a grid of samples from a checkpoint, ancestral or by the probability-flow
ODE (`evals/nll_ode.py:make_ode_sample_fn`), and writes it as a PNG. Runs
on the card unless `--device=cpu` is given.

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
                 help='--mode eval / sample: the checkpoint to read')
  p.add_argument('--mode', default='train',
                 choices=('train', 'eval', 'sample', 'analyze'))
  p.add_argument('--sample_batch', type=int, default=16,
                 help='--mode sample: samples to draw (a square)')
  p.add_argument('--sample_T', type=int, default=1000,
                 help='--mode sample: ancestral steps')
  p.add_argument('--sampler', default='ancestral',
                 choices=('ancestral', 'ode'))
  p.add_argument('--device', default='cuda')
  p.add_argument('--multiprocess', action='store_true',
                 help="join torchrun's process group (one rank a card)")
  return p


def main(argv=None) -> None:
  argv = sys.argv[1:] if argv is None else list(argv)
  args, overrides = parser().parse_known_args(argv)
  config = configs.from_command_line(args.config, overrides)
  if args.mode == 'analyze':
    raise NotImplementedError('--mode analyze is not ported yet; see '
                              'ROADMAP.md Queue A, item 4')
  device = (mesh_lib.init_distributed(args.device) if args.multiprocess
            else resolve_device(args.device))
  if args.mode == 'sample':
    _sample(args, config, device)
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


if __name__ == '__main__':
  main()
