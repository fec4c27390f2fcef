"""Synthetic image source, training and evaluation batches (numpy only).

Counterpart of `mulan_tpu/data/pipeline.py`'s `_synthetic` source,
`train_iterator`, `eval_iterator` and `one_time_eval_iterator`, which that
module cannot serve where JAX is absent: the same seed gives the same
permutation stream and the same batches. Images stay uint8 NHWC; there is no
augmentation (the flagship dataset has none) and no prefetch thread.
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


def source(dataset: str, split: str, image_shape, *, seed: int = 0,
           examples: int = 4096):
  """(images, labels) of a split; only the synthetic source is ported (the
  TFDS and on-disk sources need their data, ROADMAP.md Queue A)."""
  if dataset != 'synthetic':
    raise NotImplementedError(
        f'dataset {dataset!r} is not ported yet (only synthetic); see '
        'ROADMAP.md Queue A')
  return synthetic_split(split, image_shape, seed=seed, examples=examples)


def train_iterator(images: np.ndarray, labels: np.ndarray, *,
                   batch_size: int, substeps: int,
                   seed: int) -> Iterator[dict]:
  """Infinite shuffled super-batches of `substeps` x `batch_size` examples:
  images (substeps, batch, H, W, C), labels and zero conditioning."""
  rng = np.random.default_rng(seed)
  chunk = batch_size * substeps
  order = np.array([], dtype=np.int64)
  labels = np.asarray(labels, np.int32)
  while True:
    while len(order) < chunk:
      order = np.concatenate([order, rng.permutation(len(images))])
    idx, order = order[:chunk], order[chunk:]
    yield {
        'images': images[idx].reshape(substeps, batch_size,
                                      *images.shape[1:]),
        'labels': labels[idx].reshape(substeps, batch_size),
        'conditioning': np.zeros((substeps, batch_size), np.uint8),
    }


def eval_iterator(images: np.ndarray, labels: np.ndarray, *,
                  batch_size: int, seed: int) -> Iterator[dict]:
  """Infinite shuffled evaluation batches, a new permutation every pass."""
  rng = np.random.default_rng(seed)
  labels = np.asarray(labels, np.int32)
  while True:
    order = rng.permutation(len(images))
    for lo in range(0, len(images) - batch_size + 1, batch_size):
      idx = order[lo:lo + batch_size]
      yield {'images': images[idx], 'labels': labels[idx],
             'conditioning': np.zeros(batch_size, np.uint8)}
