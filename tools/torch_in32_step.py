"""A train step of one checkout on one GPU: `imagenet32` (default) or the
flagship `cifar10_conditioned` at batch 128 under `remat='none'` (the
configs of `chip_smoke.py` phases 14 and 7), seeded weights, synthetic
images, `Experiment.train_step` timed call by call on the host clock with
the card synchronized around each call.

    python3 tools/torch_in32_step.py [--tree DIR] [--steps N]
        [--config imagenet32|cifar10_conditioned] [--fused] [--profile]

`--tree` names the checkout whose `mulan_tpu_torch` is measured (default:
this one). To compare two commits on one card, unpack the other into a
git-ignored directory (`runs/`) and alternate the two in one call: other,
this, this, other. Two warm-up steps come first. `--fused` turns on
`fused_gn_swish` and `dropout_mask_batch` (K8, its backward and K7 in the
step; `chip_smoke.py` phase 8). `--profile` then traces two more steps
with torch.profiler: kernels a step, by name and in all, their ms a step
and the device's busy share (kernel time over the traced span, as
`chip_smoke.py --profile` reckons it). The last line is one JSON object
with the card's name, power limit and SM clock, each step's ms, their
median and the trace. Needs CUDA and `nvcc`; uses only torch.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time


def trace(step, n: int = 2) -> dict:
  """Kernels a step (by name, the first 100 characters, and in all), their
  ms a step and the device's busy share over n calls of step() after one
  more, from torch.profiler's CUDA kernel and copy events."""
  import torch
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity
  step()
  torch.cuda.synchronize()
  with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for _ in range(n):
      step()
    torch.cuda.synchronize()
    span_us = 1e6 * (time.perf_counter() - t0)
  counts, total_us = {}, 0.0
  for evt in prof.events():
    if evt.device_type != DeviceType.CUDA or evt.is_user_annotation:
      continue
    counts[evt.name[:100]] = counts.get(evt.name[:100], 0) + 1 / n
    total_us += evt.time_range.elapsed_us()
  return {'kernels_per_step': sum(counts.values()),
          'kernel_ms_per_step': total_us / n / 1e3,
          'busy_share': total_us / span_us,
          'span_ms_per_step': span_us / n / 1e3,
          'kernels_by_name': dict(sorted(counts.items()))}


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  parser.add_argument('--tree', default=str(
      pathlib.Path(__file__).resolve().parents[1]))
  parser.add_argument('--steps', type=int, default=10)
  parser.add_argument('--config', default='imagenet32',
                      choices=('imagenet32', 'cifar10_conditioned'))
  parser.add_argument('--fused', action='store_true')
  parser.add_argument('--profile', action='store_true')
  args = parser.parse_args()
  sys.path.insert(0, str(pathlib.Path(args.tree).resolve()))
  import torch

  from mulan_tpu_torch import configs, data, params
  from mulan_tpu_torch.train.loop import Experiment
  if not torch.cuda.is_available():
    raise SystemExit('torch_in32_step: needs a CUDA device')
  dev = torch.device('cuda', 0)
  model = {'remat': 'none'}
  if args.fused:
    model.update(fused_gn_swish=True, dropout_mask_batch=True)
  cfg = configs.replace(getattr(configs, args.config)(),
                        data={'dataset': 'synthetic'},
                        training={'batch_size_train': 128}, model=model)
  state = params.init_params(cfg.model, torch.Generator().manual_seed(0),
                             perturb_zero_init=0.02, vdm_type=cfg.vdm_type)
  ex = Experiment(cfg, device=dev, state=state)
  images, _ = data.synthetic_split('eval', cfg.model.image_shape, seed=0)
  batch = {'images': torch.as_tensor(images[:128], device=dev)}
  for _ in range(2):
    ex.train_step(batch)
  ms = []
  for _ in range(args.steps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ex.train_step(batch)
    torch.cuda.synchronize()
    ms.append(1e3 * (time.perf_counter() - t0))
  traced = trace(lambda: ex.train_step(batch)) if args.profile else None
  card = subprocess.run(
      ['nvidia-smi', '-i', '0', '--query-gpu=name,power.limit,clocks.sm',
       '--format=csv,noheader'], capture_output=True, text=True,
      check=True).stdout.strip()
  print(json.dumps({'tree': args.tree, 'card': card, 'config': args.config,
                    'fused': args.fused, 'ms': ms,
                    'median_ms': statistics.median(ms), 'profile': traced}),
        flush=True)


if __name__ == '__main__':
  main()
