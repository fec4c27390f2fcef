"""The port's augmented training batches against the JAX pipeline's, bit
for bit: `train_iterator(..., augment=True)` with and without the channel
permutation, `create_dataset` on `npz:` directories whose names ask for
augmentation (`pipeline.py:470-471`), and the prefetching iterator against
the plain one. The flips, rotations and channel permutations are drawn on
the permutation's generator, in JAX's order, so any other order gives
other batches on the same seed."""

import os

import numpy as np
import pytest

from mulan_tpu.configs import tiny_synthetic as jax_tiny_synthetic
from mulan_tpu.data import pipeline
from mulan_tpu_torch import configs, data
import torch_port_helpers  # noqa: F401  (the stdout-only writer)


def _images(seed: int, n: int = 37):
  """Synthetic 8x8 images with per-pixel noise, so that every flip,
  rotation and channel permutation shows."""
  images, labels = data.synthetic(seed, n, (8, 8, 3))
  noise = np.random.default_rng(seed).integers(0, 64, images.shape)
  return (images // 2 + noise).astype(np.uint8), labels


def _assert_batches_equal(got, want, what):
  assert got.keys() == want.keys(), what
  for key in want:
    np.testing.assert_array_equal(got[key], want[key],
                                  err_msg=f'{what}: {key}')
    assert got[key].dtype == want[key].dtype, (what, key)


@pytest.mark.parametrize('channel_flip', [False, True],
                         ids=['flip_rot', 'flip_rot_channel'])
@pytest.mark.parametrize('seed', [3, 8])
def test_augmented_train_iterator_matches_pipeline(seed, channel_flip):
  """Six batches of 8 (crossing the 37 examples' epoch boundary), the
  second case with 2 substeps a super-batch."""
  images, labels = _images(seed)
  substeps = 1 if seed == 3 else 2
  want = pipeline.train_iterator(
      pipeline.ArraySource(images, labels), batch_size=8, substeps=substeps,
      seed=seed, augment=True, channel_flip=channel_flip, prefetch=False)
  got = data.train_iterator(images, labels, batch_size=8, substeps=substeps,
                            seed=seed, augment=True,
                            channel_flip=channel_flip, prefetch=False)
  plain = data.train_iterator(images, labels, batch_size=8,
                              substeps=substeps, seed=seed, prefetch=False)
  changed = 0
  for i in range(6):
    w, g = next(want), next(got)
    _assert_batches_equal(g, w, f'batch {i}')
    unaugmented = next(plain)
    if i == 0:  # the permutation is drawn first: the same examples
      np.testing.assert_array_equal(g['labels'], unaugmented['labels'])
    changed += int((g['images'] != unaugmented['images']).any(
        axis=(-1, -2, -3)).sum())
    assert set(np.unique(g['conditioning'])) <= {0, 1}
  assert changed > 0


@pytest.mark.parametrize('name', ['plain', 'x_aug', 'x_aug_with_channel'])
def test_create_dataset_matches_pipeline_on_npz_names(tmp_path, name):
  """`npz:<dir>/<name>`: augmented when the name holds `_aug` (with the
  channel permutation when it ends in `with_channel`), unaugmented with
  zero conditioning otherwise; the first 4 train super-batches (2 substeps
  each, the config's) and 2 eval batches as JAX's `create_dataset` yields
  them."""
  root = tmp_path / name
  os.makedirs(root)
  for split, seed in (('train', 5), ('eval', 6)):
    images, labels = _images(seed, 40)
    np.savez(root / f'{split}.npz', images=images, labels=labels)
  dataset = f'npz:{root}'
  assert ('_aug' in dataset) == (name != 'plain')
  jcfg = jax_tiny_synthetic.get_config()
  jcfg.data.dataset = dataset
  cfg = configs.replace(configs.tiny_synthetic(), data={'dataset': dataset})
  want_train, want_eval = pipeline.create_dataset(jcfg, seed=11)
  got_train, got_eval = data.create_dataset(cfg, seed=11)
  for i in range(4):
    g, w = next(got_train), next(want_train)
    _assert_batches_equal(g, w, f'train batch {i}')
    if name == 'plain':
      assert not g['conditioning'].any()
  assert name == 'plain' or g['conditioning'].any()
  for i in range(2):
    _assert_batches_equal(next(got_eval), next(want_eval), f'eval batch {i}')


def test_prefetching_iterator_yields_the_plain_iterators_batches():
  images, labels = _images(4)
  kwargs = dict(batch_size=8, substeps=1, seed=4, augment=True,
                channel_flip=True)
  ahead = data.train_iterator(images, labels, prefetch=True, **kwargs)
  plain = data.train_iterator(images, labels, prefetch=False, **kwargs)
  for i in range(10):
    _assert_batches_equal(next(ahead), next(plain), f'batch {i}')
