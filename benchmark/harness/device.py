"""The card a run uses: whether it is there, its name and power limit, and
its memory peak."""

from __future__ import annotations

import subprocess
from typing import Optional

import torch


def missing_chips(chips: int) -> Optional[str]:
  """Why the run cannot go on (no CUDA, too few cards), or None."""
  if not torch.cuda.is_available():
    return 'torch.cuda.is_available() is false'
  count = torch.cuda.device_count()
  if count < chips:
    return f'the cell asks for {chips} cards, {count} are visible'
  return None


def power_limit_w() -> Optional[float]:
  """The card's power limit in watts as nvidia-smi reads it, or None."""
  try:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=power.limit',
         '--format=csv,noheader,nounits', '-i', '0'],
        capture_output=True, text=True, timeout=30, check=True).stdout
    return float(out.strip().splitlines()[0])
  except (OSError, subprocess.SubprocessError, ValueError, IndexError):
    return None


def describe(device: torch.device, chips: int, peak_bytes: int) -> dict:
  """The result's `device` object."""
  if device.type != 'cuda':
    return {'platform': device.type, 'kind': device.type, 'count': chips,
            'memory_peak_bytes': peak_bytes}
  return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(device),
          'count': chips, 'memory_peak_bytes': peak_bytes,
          'power_limit_w': power_limit_w()}


def synchronize(device: torch.device) -> None:
  if device.type == 'cuda':
    torch.cuda.synchronize(device)


def reset_peak(device: torch.device) -> None:
  if device.type == 'cuda':
    torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device: torch.device) -> int:
  if device.type == 'cuda':
    return torch.cuda.max_memory_allocated(device)
  return 0


def free_memory(device: torch.device) -> None:
  if device.type == 'cuda':
    torch.cuda.empty_cache()


class Marks:
  """Points in the device's stream: CUDA events read after a
  synchronisation on the card, the host clock elsewhere."""

  def __init__(self, device: torch.device):
    self.cuda = device.type == 'cuda'
    self.marks = []

  def mark(self) -> None:
    if self.cuda:
      event = torch.cuda.Event(enable_timing=True)
      event.record()
      self.marks.append(event)
    else:
      import time
      self.marks.append(time.perf_counter())

  def intervals_ms(self):
    """The milliseconds between consecutive marks (call after a
    synchronisation)."""
    pairs = zip(self.marks[:-1], self.marks[1:])
    if self.cuda:
      return [a.elapsed_time(b) for a, b in pairs]
    return [1e3 * (b - a) for a, b in pairs]
