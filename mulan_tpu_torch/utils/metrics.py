"""Image grids, a PNG writer and the stdout scalar writer (numpy and the
standard library only), counterpart of `mulan_tpu/utils/metrics.py`'s
`image_grid` and `ScalarLoggingWriter`. The TensorBoard writer is not
ported."""

from __future__ import annotations

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
