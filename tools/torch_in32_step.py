"""The ImageNet32 train step of one checkout on one GPU: `imagenet32` at
batch 128 under `remat='none'` (the config of `chip_smoke.py` phase 14),
seeded weights, synthetic images, `Experiment.train_step` timed call by
call on the host clock with the card synchronized around each call.

    python3 tools/torch_in32_step.py [--tree DIR] [--steps N]

`--tree` names the checkout whose `mulan_tpu_torch` is measured (default:
this one). To compare two commits on one card, unpack the other into a
git-ignored directory (`runs/`) and alternate the two in one call: other,
this, this, other. Two warm-up steps come first. The last line is one JSON
object with the card's name, power limit and SM clock, each step's ms and
their median. Needs CUDA and `nvcc`; uses only torch.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  parser.add_argument('--tree', default=str(
      pathlib.Path(__file__).resolve().parents[1]))
  parser.add_argument('--steps', type=int, default=10)
  args = parser.parse_args()
  sys.path.insert(0, str(pathlib.Path(args.tree).resolve()))
  import torch

  from mulan_tpu_torch import configs, data, params
  from mulan_tpu_torch.train.loop import Experiment
  if not torch.cuda.is_available():
    raise SystemExit('torch_in32_step: needs a CUDA device')
  dev = torch.device('cuda', 0)
  cfg = configs.replace(configs.imagenet32(), data={'dataset': 'synthetic'},
                        training={'batch_size_train': 128},
                        model={'remat': 'none'})
  state = params.init_params(cfg.model, torch.Generator().manual_seed(0),
                             perturb_zero_init=0.02,
                             vdm_type='mulan_epsilon')
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
  card = subprocess.run(
      ['nvidia-smi', '-i', '0', '--query-gpu=name,power.limit,clocks.sm',
       '--format=csv,noheader'], capture_output=True, text=True,
      check=True).stdout.strip()
  print(json.dumps({'tree': args.tree, 'card': card, 'ms': ms,
                    'median_ms': statistics.median(ms)}), flush=True)


if __name__ == '__main__':
  main()
