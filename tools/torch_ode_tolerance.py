"""DoPri5's cost against its tolerance on the ODE likelihood of the flagship
MuLAN-velocity (full width and depth, seeded weights with the zero-init
leaves perturbed as `chip_smoke.py` seeds them, 128 synthetic images, one
dequantization draw and one Rademacher probe), with the score UNet in
bfloat16 and in float32, on one GPU.

    python3 tools/torch_ode_tolerance.py [--tols 1e-2,3e-3,1e-3]
        [--dtypes bfloat16,float32] [--max_steps 200]

For every (dtype, tolerance) pair, rtol = atol = tolerance, it prints one
JSON line: RHS evaluations, accepted and rejected steps, whether the solve
finished within `--max_steps` attempts, its seconds (host clock around a
synchronized solve) and milliseconds per evaluation, and the bpd of the one
importance sample. The last line is the card's name and power limit. Run
from the repository root; needs CUDA and `nvcc` (float32 runs the plain
versions, bfloat16 the kernels).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

sys.path.insert(0, '.')


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  parser.add_argument('--tols', default='1e-2,3e-3,1e-3')
  parser.add_argument('--dtypes', default='bfloat16,float32')
  parser.add_argument('--max_steps', type=int, default=200)
  args = parser.parse_args()
  import torch

  import chip_smoke
  from mulan_tpu_torch import data, params
  from mulan_tpu_torch.evals import nll_ode
  from mulan_tpu_torch.models import build_model
  from mulan_tpu_torch.models.config import flagship_config
  if not torch.cuda.is_available():
    raise SystemExit('torch_ode_tolerance: needs a CUDA device')
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device('cuda', 0)
  card = subprocess.run(
      ['nvidia-smi', '-i', '0', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True,
      check=True).stdout.strip()
  cfg = flagship_config()
  state = params.init_params(cfg, torch.Generator().manual_seed(0),
                             perturb_zero_init=0.02)
  images, _ = data.synthetic_split('eval', cfg.image_shape, seed=0)
  batch = torch.as_tensor(images[:chip_smoke.ODE_ROWS], device=dev)
  u, probe = chip_smoke.ode_noise(
      cfg, torch.Generator(device=dev).manual_seed(0), dev)
  for dtype in args.dtypes.split(','):
    model = build_model('mulan_velocity', dataclasses.replace(
        cfg, compute_dtype=dtype, use_kernels=dtype == 'bfloat16'),
                        device=dev, state=state).requires_grad_(False)
    for tol in map(float, args.tols.split(',')):
      likelihood = nll_ode.make_ode_likelihood_fn(
          model, rtol=tol, atol=tol, max_steps=args.max_steps)
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      log_p, _, aux, stats = likelihood(batch, u=u, probe=probe)
      torch.cuda.synchronize()
      secs = time.perf_counter() - t0
      print(json.dumps(dict(
          dtype=dtype, tol=tol, max_steps=args.max_steps, **stats,
          seconds=secs, ms_per_rhs=1e3 * secs / stats['nfe'],
          bpd=chip_smoke.ode_bpd(cfg, log_p, aux))), flush=True)
    del model
    torch.cuda.empty_cache()
  print(card)


if __name__ == '__main__':
  main()
