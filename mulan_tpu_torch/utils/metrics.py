"""Image grids, a PNG writer and the metric writers, counterpart of
`mulan_tpu/utils/metrics.py`: the stdout scalar writer (`ScalarWriter`),
a TensorBoard writer (`SummaryWriter`, on
`torch.utils.tensorboard.SummaryWriter`), `MultiWriter`, which fans a call
out to several, and `create_writer`, which gives rank 0 both (stdout alone
where TensorBoard does not import) and every other rank a silent stdout
writer. TensorBoard is imported only when rank 0's writer is made: the
import loads TensorFlow where it is installed, which takes seconds.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Any, Mapping

import numpy as np


def image_grid(images) -> np.ndarray:
  """(B, H, W, C) -> (G*H, G*W, C) with G = floor(sqrt(B)); every row lays
  its samples out right to left, as the reference's grid does."""
  images = np.asarray(images)
  g = int(np.floor(np.sqrt(images.shape[0])))
  images = images[:g * g]
  _, h, w, c = images.shape
  grid = images.reshape(g, g, h, w, c)[:, ::-1].transpose(0, 2, 1, 3, 4)
  return grid.reshape(g * h, g * w, c)


def write_png(path: str, image) -> None:
  """Writes a uint8 (H, W, 3) image as an 8-bit RGB PNG (zlib and struct;
  no imaging library needed)."""
  image = np.ascontiguousarray(image, np.uint8)
  if image.ndim != 3 or image.shape[-1] != 3:
    raise ValueError(f'need (H, W, 3), got {image.shape}')
  h, w, _ = image.shape
  raw = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, -1)],
                       axis=1)  # filter type 0 before each row

  def chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack('>I', len(data)) + kind + data
            + struct.pack('>I', zlib.crc32(kind + data) & 0xffffffff))

  with open(path, 'wb') as f:
    f.write(b'\x89PNG\r\n\x1a\n'
            + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0, 0))
            + chunk(b'IDAT', zlib.compress(raw.tobytes()))
            + chunk(b'IEND', b''))


class ScalarWriter:
  """CSV-style scalar lines on stdout: a `Step, key, ...` header whenever
  the key set changes, then `step, value, ...` with 4 decimals. A writer
  made with `enabled=False` (every rank but 0 of a multi-process run,
  `utils/metrics.py:68-80`) prints nothing."""

  def __init__(self, enabled: bool = True):
    self._last_keys = None
    self.enabled = enabled

  def _print(self, line: str) -> None:
    if self.enabled:
      print(line, flush=True)

  def write_scalars(self, step: int, scalars: Mapping[str, Any]) -> None:
    keys = sorted(scalars)
    if keys != self._last_keys:
      self._print(', '.join(['Step'] + keys))
      self._last_keys = keys
    vals = [float(np.asarray(scalars[k])) for k in keys]
    self._print(f'{step}, ' + ', '.join(f'{v:.4f}' for v in vals))

  def write_images(self, step: int, images: Mapping[str, Any]) -> None:
    self._print(f'[{step}] images: '
                f'{ {k: np.asarray(v).shape for k, v in images.items()} }')

  def write_hparams(self, config) -> None:
    self._print(f'Hyperparameters:\n{flatten_hparams(config)}')

  def flush(self) -> None:
    pass

  def close(self) -> None:
    pass


def flatten_hparams(config, prefix: str = '') -> dict:
  """{'section.field': value} of a nested dataclass (a `configs.Config`);
  values that TensorBoard's hparams do not take (None, tuples, ...) become
  their str."""
  flat = {}
  for field in dataclasses.fields(config):
    name, value = prefix + field.name, getattr(config, field.name)
    if dataclasses.is_dataclass(value):
      flat.update(flatten_hparams(value, name + '.'))
    elif isinstance(value, (bool, int, float, str)):
      flat[name] = value
    else:
      flat[name] = str(value)
  return flat


class SummaryWriter:
  """TensorBoard event files in `logdir`: scalars under their keys, images
  (a batch (N, H, W, C) uint8 per key, as the training loop writes
  `{'samples': grid[None]}`) under the key, and hparams in the hparams
  plugin's format, flattened to 'section.field' (torch's writer stores a
  bool as the number 0 or 1)."""

  def __init__(self, logdir: str):
    from torch.utils.tensorboard import SummaryWriter as TorchWriter
    self._writer = TorchWriter(logdir)

  def write_scalars(self, step: int, scalars: Mapping[str, Any]) -> None:
    for key, value in scalars.items():
      self._writer.add_scalar(key, float(np.asarray(value)), step)

  def write_images(self, step: int, images: Mapping[str, Any]) -> None:
    for key, batch in images.items():
      self._writer.add_images(key, np.asarray(batch), step,
                              dataformats='NHWC')

  def write_hparams(self, config) -> None:
    from torch.utils.tensorboard.summary import hparams as hparams_summary
    for summary in hparams_summary(flatten_hparams(config), {}):
      self._writer.file_writer.add_summary(summary)

  def flush(self) -> None:
    self._writer.flush()

  def close(self) -> None:
    self._writer.close()


class MultiWriter:
  """Each call goes to every writer in turn."""

  def __init__(self, writers):
    self.writers = list(writers)

  def __getattr__(self, name):
    def call(*args, **kwargs):
      for writer in self.writers:
        getattr(writer, name)(*args, **kwargs)
    return call


def summary_writer(logdir: str):
  """TensorBoard's writer in `logdir`, or None where it does not import."""
  try:
    return SummaryWriter(logdir)
  except ImportError:
    return None


def create_writer(logdir: str, rank: int):
  """Rank 0: stdout and, where TensorBoard imports, its event files in
  `logdir`; every other rank: a silent stdout writer
  (`utils/metrics.py:create_writer`)."""
  if rank > 0:
    return ScalarWriter(enabled=False)
  writers = [ScalarWriter()]
  tensorboard = summary_writer(logdir)
  if tensorboard is None:
    print('TensorBoard SummaryWriter unavailable; stdout only', flush=True)
  else:
    writers.append(tensorboard)
  return MultiWriter(writers)
