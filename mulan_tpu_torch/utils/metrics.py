"""Image grids and the stdout scalar writer (numpy only), counterpart of
`mulan_tpu/utils/metrics.py`'s `image_grid` and `ScalarLoggingWriter`. The
TensorBoard writer is not ported."""

from __future__ import annotations

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


class ScalarWriter:
  """CSV-style scalar lines on stdout: a `Step, key, ...` header whenever
  the key set changes, then `step, value, ...` with 4 decimals."""

  def __init__(self):
    self._last_keys = None

  @staticmethod
  def _print(line: str) -> None:
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
