"""Bits-per-dimension evaluation CLI of the port, counterpart of
`mulan_tpu/eval_bpd.py`:

    python -m mulan_tpu_torch.eval_bpd --config=cifar10_conditioned \
        --checkpoint_directory=<checkpoints dir or ckpt-N.flax> \
        [--checkpoint=N] --bpd_eval_method={ode,dense,sparse} \
        [--n_is=20] [--solver={dopri5,rk4}] [--rk4_steps=128] \
        [--rtol=1e-5] [--atol=1e-5] [--n_timesteps=128] [--device=cpu] \
        [--config.data.dataset=npz:<dir>]

Evaluates the checkpoint's EMA weights over one pass of the config's eval
split and prints `Test BPD:<bpd> ckpt:<step>`. `ode` (the default) is the
importance-weighted exact NLL through the probability-flow ODE of
`evals/nll_ode.py:eval_bpd_ode`, `dense` the stratified t-grid of
`evals/vlb.py:eval_bpd_dense`, `sparse` one ELBO per image. Runs on the
card unless `--device=cpu` is given. `--multiprocess` runs it on the ranks
of torchrun's process group (`torchrun --nproc_per_node=N -m
mulan_tpu_torch.eval_bpd --multiprocess ...`): each rank evaluates its
shard of the split, every rank computes the same global bpd, and rank 0
prints it.
"""

from __future__ import annotations

import argparse
import sys

import torch

from mulan_tpu_torch import configs
from mulan_tpu_torch.models import resolve_device
from mulan_tpu_torch.parallel import mesh as mesh_lib


def parser() -> argparse.ArgumentParser:
  p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  p.add_argument('--config', required=True,
                 help='a port config name or a JAX config file')
  p.add_argument('--checkpoint_directory', required=True,
                 help='a port checkpoints directory or a ckpt-N[.flax]')
  p.add_argument('--checkpoint', type=int, default=None,
                 help='checkpoint step (default: the latest)')
  p.add_argument('--bpd_eval_method', default='ode',
                 choices=('ode', 'dense', 'sparse'))
  p.add_argument('--n_timesteps', type=int, default=128,
                 help='dense: the t-grid size')
  p.add_argument('--images_per_chunk', type=int, default=0,
                 help='dense: images a chunk (0: 512 (image, t) rows)')
  ode = p.add_argument_group('ode')
  ode.add_argument('--n_is', type=int, default=20,
                   help='importance samples an image')
  ode.add_argument('--num_iters', type=int, default=1,
                   help='passes over the eval split')
  ode.add_argument('--deterministic_noise', action='store_true',
                   help='rk4: keep the Hutchinson probe fixed within a solve')
  ode.add_argument('--redraw_noise', default='auto',
                   choices=('auto', 'true', 'false'),
                   help='redraw the probe at every RHS time (auto: rk4 '
                   'unless --deterministic_noise; dopri5 never)')
  ode.add_argument('--hutchinson_type', default='Rademacher',
                   choices=('Rademacher', 'Gaussian'))
  ode.add_argument('--dequantization', default='tn',
                   choices=('tn', 'uniform'))
  ode.add_argument('--rtol', type=float, default=1e-5)
  ode.add_argument('--atol', type=float, default=1e-5)
  ode.add_argument('--first_step', type=float, default=0.01)
  ode.add_argument('--max_steps', type=int, default=5000,
                   help='DoPri5 steps a solve before it fails')
  ode.add_argument('--on_solver_failure', default='raise',
                   choices=('raise', 'warn'))
  ode.add_argument('--solver', default='dopri5', choices=('dopri5', 'rk4'))
  ode.add_argument('--rk4_steps', type=int, default=128,
                   help='rk4: fixed steps (4 RHS evaluations each)')
  ode.add_argument('--is_batch', type=int, default=0,
                   help='importance samples a solve (0: ~128 rows)')
  p.add_argument('--device', default='cuda')
  p.add_argument('--multiprocess', action='store_true',
                 help="join torchrun's process group (one rank a card)")
  return p


def main(argv=None) -> float:
  argv = sys.argv[1:] if argv is None else list(argv)
  args, overrides = parser().parse_known_args(argv)
  config = configs.from_command_line(args.config, overrides)
  device = (mesh_lib.init_distributed(args.device) if args.multiprocess
            else resolve_device(args.device))
  from mulan_tpu_torch import data
  from mulan_tpu_torch.evals import nll_ode, vlb
  from mulan_tpu_torch.evals.harness import EvalExperiment
  ex = EvalExperiment(config, args.checkpoint_directory, args.checkpoint,
                      device=device)
  batches = data.create_one_time_eval_dataset(config, mesh=ex.mesh)
  generator = torch.Generator(device).manual_seed(0)
  model = ex.state.ema_model
  if args.bpd_eval_method == 'ode':
    bpd = nll_ode.eval_bpd_ode(
        ex, config, hutchinson_type=args.hutchinson_type,
        dequantization=args.dequantization,
        deterministic_noise=args.deterministic_noise,
        num_iters=args.num_iters, num_is=args.n_is, rtol=args.rtol,
        atol=args.atol, first_step=args.first_step, max_steps=args.max_steps,
        on_solver_failure=args.on_solver_failure, solver=args.solver,
        rk4_steps=args.rk4_steps, is_batch=args.is_batch,
        redraw_noise={'auto': None, 'true': True,
                      'false': False}[args.redraw_noise])
  elif args.bpd_eval_method == 'sparse':
    bpd = vlb.eval_bpd_sparse(model, batches, generator=generator,
                              mesh=ex.mesh)
  else:
    bpd = vlb.eval_bpd_dense(model, batches, n_timesteps=args.n_timesteps,
                             images_per_chunk=args.images_per_chunk or None,
                             generator=generator, mesh=ex.mesh)
  if mesh_lib.rank() == 0:
    print(f'Test BPD:{bpd} ckpt:{ex.checkpoint_step}')
  return bpd


if __name__ == '__main__':
  main()
