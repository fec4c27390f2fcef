"""Image sources, training and evaluation batches (numpy only).

Counterpart of `mulan_tpu/data/pipeline.py`'s synthetic, `npz:<dir>` and
`npy:<dir>` sources, `augment_batch`, `train_iterator`, `eval_iterator`,
`one_time_eval_iterator`, `create_dataset` and
`create_one_time_eval_dataset`, which that module cannot serve where JAX is
absent: the same seed gives the same permutation stream, the same
augmentation and the same batches. Images stay uint8 NHWC. A dataset whose
name holds `_aug` is augmented (random left/right flips and 90-degree
rotations, and with a name ending in `with_channel` a random channel
permutation), with the aug bit in the batch's `conditioning`; the train
batches are made ahead on a thread, as JAX's are. There is no TFDS source
(it needs `tensorflow_datasets` and a download).

Under `torch.distributed` every rank reads its own contiguous shard of
each split (`host_shard`, `pipeline.py:60-65`) in per-rank batches of the
global batch size over the world (`pipeline.py:455-490`), so that the
global batch is the ranks' batches concatenated in rank order. Under
tensor parallelism the ranks of a tensor group read the same shard and
batches: given the mesh, rank and world count its batch coordinates
(`mesh.batch_rank`).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from mulan_tpu_torch.parallel import mesh as mesh_lib


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


def _load_npz(path: str, split: str):
  """`<path>/<split>.npz` with `images` (uint8 NHWC) and optional
  `labels`."""
  data = np.load(os.path.join(path, f'{split}.npz'))
  images = np.asarray(data['images'], np.uint8)
  labels = data['labels'] if 'labels' in data else np.zeros(len(images))
  return images, np.asarray(labels, np.int32)


def _load_npy_memmap(path: str, split: str):
  """`<path>/<split>_images.npy` (uint8 NHWC), memory-mapped so batches are
  read off disk on demand, and optional `<path>/<split>_labels.npy`."""
  images = np.load(os.path.join(path, f'{split}_images.npy'), mmap_mode='r')
  if images.dtype != np.uint8 or images.ndim != 4:
    raise ValueError(f'{path}: images must be uint8 NHWC, got '
                     f'{images.dtype} {images.shape}')
  labels_path = os.path.join(path, f'{split}_labels.npy')
  labels = (np.load(labels_path) if os.path.exists(labels_path)
            else np.zeros(len(images)))
  return images, np.asarray(labels, np.int32)


def source(dataset: str, split: str, image_shape, *, seed: int = 0,
           examples: int = 4096):
  """(images, labels) of a split of `synthetic`, `npz:<dir>` or
  `npy:<dir>` (`pipeline.py:load_source`); the TFDS datasets are not
  ported."""
  if dataset == 'synthetic':
    return synthetic_split(split, image_shape, seed=seed, examples=examples)
  if dataset.startswith('npz:'):
    return _load_npz(dataset[len('npz:'):], split)
  if dataset.startswith('npy:'):
    return _load_npy_memmap(dataset[len('npy:'):], split)
  raise NotImplementedError(
      f'dataset {dataset!r} is not ported (the port reads synthetic, '
      'npz:<dir> and npy:<dir>; TFDS needs its package and a download)')


def host_shard(images: np.ndarray, labels: np.ndarray, rank: int,
               world: int):
  """Rank `rank`'s equal contiguous slice of a split of n examples, n //
  world of them (`pipeline.py:ArraySource.host_shard`)."""
  n = len(images) // world
  lo = rank * n
  return images[lo:lo + n], np.asarray(labels)[lo:lo + n]


def config_source(config, split: str, mesh=None):
  """(images, labels) of this rank's shard of a split of `config.data` for
  `config.model` (the whole split in one process), sharded over the
  mesh's batch coordinates."""
  return host_shard(*source(config.data.dataset, split,
                            config.model.image_shape,
                            seed=config.data.synthetic_seed,
                            examples=config.data.synthetic_examples),
                    mesh_lib.batch_rank(mesh), mesh_lib.batch_world(mesh))


def create_dataset(config, seed: int, mesh=None):
  """(train_iter, eval_iter) of this rank's batches
  (`pipeline.py:create_dataset`): `batch_size_train` and `batch_size_eval`
  over the world, a train iterator seeded `seed + rank` and an eval
  iterator seeded `seed + 7919 + rank` (world and rank counting batch
  coordinates of `mesh`: a tensor group shares its batches). The train
  iterator yields super-batches of `training.substeps` batches, so that a
  rank holds its rows of every substep's global batch, as JAX shards the
  super-batch's axis 1 (`loop.py:220-222`). The train batches are
  augmented when the dataset's name holds `_aug`, with a channel
  permutation when it ends in `with_channel` (`pipeline.py:470-471`),
  one draw over a super-batch's `substeps` x batch images."""
  training, dataset = config.training, config.data.dataset
  r, n = mesh_lib.batch_rank(mesh), mesh_lib.batch_world(mesh)
  train_iter = train_iterator(
      *config_source(config, 'train', mesh),
      batch_size=mesh_lib.local_batch_size(training.batch_size_train, n),
      substeps=training.substeps, seed=seed + r,
      augment='_aug' in dataset,
      channel_flip=dataset.endswith('with_channel'))
  eval_iter = eval_iterator(
      *config_source(config, 'eval', mesh),
      batch_size=mesh_lib.local_batch_size(training.batch_size_eval, n),
      seed=seed + 7919 + r)
  return train_iter, eval_iter


def augment_batch(rng: np.random.Generator, images: np.ndarray,
                  channel_flip: bool = False
                  ) -> Tuple[np.ndarray, np.ndarray]:
  """(images, aug bit uint8 (n,)): random left/right flips, then random
  rotations by 90, 180 or 270 degrees, then with `channel_flip` a random
  channel permutation; the bit is set where any was applied
  (`pipeline.py:augment_batch`). Draws from `rng` in JAX's order: the
  flips, the rotations' choice and their k, the channels' choice, then one
  permutation per chosen image in index order."""
  n = len(images)
  out = images.copy()
  flip = rng.random(n) > 0.5
  out[flip] = out[flip, :, ::-1]
  do_rot = rng.random(n) > 0.5
  ks = rng.integers(1, 4, size=n)
  for k in (1, 2, 3):
    sel = do_rot & (ks == k)
    if sel.any():
      out[sel] = np.rot90(out[sel], k=k, axes=(1, 2))
  aug = flip | do_rot
  if channel_flip:
    do_ch = rng.random(n) > 0.5
    for i in np.where(do_ch)[0]:
      out[i] = out[i][:, :, rng.permutation(out.shape[-1])]
    aug = aug | do_ch
  return out, aug.astype(np.uint8)


def _prefetch(items: Iterator, depth: int = 2) -> Iterator:
  """`items`, made ahead on a daemon thread, at most `depth` waiting
  (`pipeline.py:_prefetch`)."""
  q: queue.Queue = queue.Queue(maxsize=depth)
  done = object()

  def worker():
    for item in items:
      q.put(item)
    q.put(done)

  threading.Thread(target=worker, daemon=True).start()
  while True:
    item = q.get()
    if item is done:
      return
    yield item


def train_iterator(images: np.ndarray, labels: np.ndarray, *,
                   batch_size: int, substeps: int, seed: int,
                   augment: bool = False, channel_flip: bool = False,
                   prefetch: bool = True) -> Iterator[dict]:
  """Infinite shuffled super-batches of `substeps` x `batch_size` examples:
  images (substeps, batch, H, W, C), labels and conditioning: the aug bit
  with `augment` (`augment_batch`, on the permutation's generator), else
  zeros. With `prefetch` the batches are made ahead on a thread."""
  rng = np.random.default_rng(seed)
  chunk = batch_size * substeps
  labels = np.asarray(labels, np.int32)

  def batches():
    order = np.array([], dtype=np.int64)
    while True:
      while len(order) < chunk:
        order = np.concatenate([order, rng.permutation(len(images))])
      idx, order = order[:chunk], order[chunk:]
      batch = images[idx]
      cond = np.zeros(chunk, np.uint8)
      if augment:
        batch, cond = augment_batch(rng, batch, channel_flip=channel_flip)
      yield {
          'images': batch.reshape(substeps, batch_size, *images.shape[1:]),
          'labels': labels[idx].reshape(substeps, batch_size),
          'conditioning': cond.reshape(substeps, batch_size),
      }

  return _prefetch(batches()) if prefetch else batches()


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


def one_time_eval_iterator(images: np.ndarray, labels: np.ndarray, *,
                           batch_size: int) -> Iterator[dict]:
  """One unshuffled pass over a split in batches of `batch_size`; the
  trailing remainder is dropped (`pipeline.py:one_time_eval_iterator`)."""
  labels = np.asarray(labels, np.int32)
  for lo in range(0, len(images) - batch_size + 1, batch_size):
    yield {'images': images[lo:lo + batch_size],
           'labels': labels[lo:lo + batch_size],
           'conditioning': np.zeros(batch_size, np.uint8)}


def create_one_time_eval_dataset(config, batch_size: Optional[int] = None,
                                 mesh=None) -> Iterator[dict]:
  """`one_time_eval_iterator` over this rank's shard of the config's eval
  split, in batches of `batch_size` (default `training.batch_size_eval`)
  over the world."""
  if batch_size is None:
    batch_size = config.training.batch_size_eval
  return one_time_eval_iterator(
      *config_source(config, 'eval', mesh),
      batch_size=batch_size // mesh_lib.batch_world(mesh))
