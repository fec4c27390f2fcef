"""A copy of the benchmark's definitions cut to a size the CPU runs in
seconds, for the tests: the flagship's configuration at 8x8 images, 32
channels and 2 layers in float32 with the kernels off, and cells of a few
rows."""

from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TINY_MODEL = {'image_size': 8, 'sm_n_embd': 32, 'sm_n_layer': 2,
              'forward_n_layer': 1, 'latent_size': 10, 'latent_k': 3,
              'compute_dtype': 'float32', 'use_kernels': False}
TINY_TRAFFIC = {
    'train-b128-s1': {'batch': 8, 'check_calls': 3},
    'train-b128-s8': {'batch': 4, 'substeps': 2, 'check_calls': 1},
    'dense-b128-t128-c4': {'batch': 8, 'n_timesteps': 4,
                           'images_per_chunk': 2, 'warmup_images': 4},
}


def _edit(path, fn):
  with open(path) as f:
    data = json.load(f)
  fn(data)
  with open(path, 'w') as f:
    json.dump(data, f, indent=2)


def make_root(tmp: str) -> str:
  """`tmp` holding BENCHMARK.json and benchmark/{configs,traffic,
  workloads,entries,metrics} cut to the tiny size; returns it."""
  shutil.copy(os.path.join(REPO, 'BENCHMARK.json'), tmp)
  for part in ('configs', 'traffic', 'workloads', 'entries', 'metrics'):
    shutil.copytree(os.path.join(REPO, 'benchmark', part),
                    os.path.join(tmp, 'benchmark', part))
  for name in ('cifar10_conditioned', 'imagenet32'):
    def cut(c):
      c['model'].update(TINY_MODEL)
      c['train_examples'], c['eval_examples'] = 64, 32
      c['training']['batch_size_train'] = 8
    _edit(os.path.join(tmp, 'benchmark', 'configs', f'{name}.json'), cut)
  for name, update in TINY_TRAFFIC.items():
    _edit(os.path.join(tmp, 'benchmark', 'traffic', f'{name}.json'),
          lambda t, u=update: t.update(u))
  return tmp
