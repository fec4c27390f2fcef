"""Synthetic image source and evaluation batches (numpy only).

Counterpart of `mulan_tpu/data/pipeline.py`'s `_synthetic` source and
`one_time_eval_iterator`, which that module cannot serve where JAX is absent.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def synthetic(seed: int, n: int, image_shape):
  """(images uint8 (n, H, W, C), labels int (n,)): 4x4 blocks of random
  values upsampled to the image size, plus Gaussian noise."""
  rng = np.random.default_rng(seed)
  h, w, c = image_shape
  base = rng.integers(0, 256, size=(n, 4, 4, c)).astype(np.float32)
  images = np.repeat(np.repeat(base, h // 4, axis=1), w // 4, axis=2)
  images += rng.normal(0, 8, size=(n, h, w, c))
  labels = rng.integers(0, 10, size=(n,))
  return np.clip(images, 0, 255).astype(np.uint8), labels


def synthetic_split(split: str, image_shape, *, seed: int = 0,
                    examples: int = 4096):
  """The JAX package's synthetic split: eval uses seed + 1 and a quarter of
  the examples."""
  if split == 'train':
    return synthetic(seed, examples, image_shape)
  return synthetic(seed + 1, examples // 4, image_shape)


def eval_batches(images: np.ndarray, batch_size: int) -> Iterator[np.ndarray]:
  """One unshuffled pass; the trailing remainder is dropped."""
  for lo in range(0, len(images) - batch_size + 1, batch_size):
    yield images[lo:lo + batch_size]
