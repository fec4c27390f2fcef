"""Bits-per-dimension evaluation CLI of the port, counterpart of
`mulan_tpu/eval_bpd.py`:

    python -m mulan_tpu_torch.eval_bpd --config=cifar10_conditioned \
        --checkpoint_directory=<checkpoints dir or ckpt-N.flax> \
        [--checkpoint=N] --bpd_eval_method={dense,sparse} \
        [--n_timesteps=128] [--images_per_chunk=0] [--device=cpu] \
        [--config.data.dataset=npz:<dir>]

Evaluates the checkpoint's EMA weights over one pass of the config's eval
split and prints `Test BPD:<bpd> ckpt:<step>`. `dense` is the stratified
t-grid of `evals/vlb.py:eval_bpd_dense`, `sparse` one ELBO per image. The
probability-flow ODE estimator (`ode`) is not ported yet. Runs on the card
unless `--device=cpu` is given.
"""

from __future__ import annotations

import argparse
import sys

import torch

from mulan_tpu_torch import configs
from mulan_tpu_torch.models import resolve_device


def parser() -> argparse.ArgumentParser:
  p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  p.add_argument('--config', required=True,
                 help='a port config name or a JAX config file')
  p.add_argument('--checkpoint_directory', required=True,
                 help='a port checkpoints directory or a ckpt-N[.flax]')
  p.add_argument('--checkpoint', type=int, default=None,
                 help='checkpoint step (default: the latest)')
  p.add_argument('--bpd_eval_method', default='dense',
                 choices=('dense', 'sparse', 'ode'))
  p.add_argument('--n_timesteps', type=int, default=128,
                 help='dense: the t-grid size')
  p.add_argument('--images_per_chunk', type=int, default=0,
                 help='dense: images a chunk (0: 512 (image, t) rows)')
  p.add_argument('--device', default='cuda')
  return p


def main(argv=None) -> float:
  argv = sys.argv[1:] if argv is None else list(argv)
  args, overrides = parser().parse_known_args(argv)
  config = configs.from_command_line(args.config, overrides)
  device = resolve_device(args.device)
  if args.bpd_eval_method == 'ode':
    raise NotImplementedError('--bpd_eval_method=ode is not ported yet; see '
                              'ROADMAP.md Queue A, item 4 (ODE NLL)')
  from mulan_tpu_torch import data
  from mulan_tpu_torch.evals import vlb
  from mulan_tpu_torch.evals.harness import EvalExperiment
  ex = EvalExperiment(config, args.checkpoint_directory, args.checkpoint,
                      device=device)
  batches = (b['images'] for b in data.create_one_time_eval_dataset(config))
  generator = torch.Generator(device).manual_seed(0)
  model = ex.state.ema_model
  if args.bpd_eval_method == 'sparse':
    bpd = vlb.eval_bpd_sparse(model, batches, generator=generator)
  else:
    bpd = vlb.eval_bpd_dense(model, batches, n_timesteps=args.n_timesteps,
                             images_per_chunk=args.images_per_chunk or None,
                             generator=generator)
  print(f'Test BPD:{bpd} ckpt:{ex.checkpoint_step}')
  return bpd


if __name__ == '__main__':
  main()
