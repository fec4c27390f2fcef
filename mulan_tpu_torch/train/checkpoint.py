"""Checkpoints of the train state, counterpart of
`mulan_tpu/train/checkpoint.py` (`CheckpointManager`,
`restore_partial_into`).

A checkpoint is one file, `<directory>/ckpt_<step>.pt`, holding
`TrainState.state_dict()` through `torch.save`. It is written to a
temporary file first and then renamed over the final name, so a run killed
while saving leaves the previous checkpoints and no torn file. The same
three restore paths as JAX's:
  1. auto-resume: `restore` into a same-shaped `TrainState`;
  2. partial warm-start: `restore_partial_into` copies only the keys the
     checkpoint holds (`merge_restored`);
  3. evaluation: `restore_dict` reads the saved dict (tensors on the CPU).

Under `torch.distributed` every rank calls `save` (the state's whole
tensors are gathered from every rank's shards), rank 0 alone writes the
file a single process writes, and a barrier follows; every rank restores
from it, at any world size and `training.fsdp`.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import torch

from mulan_tpu_torch.parallel import mesh as mesh_lib
from mulan_tpu_torch.train.state import TrainState, merge_restored

_NAME = re.compile(r'^ckpt_(\d+)\.pt$')


def step_of(path: str) -> Optional[int]:
  """The step of a `ckpt_<step>.pt` path, or None."""
  m = _NAME.match(os.path.basename(path))
  return int(m.group(1)) if m else None


class CheckpointManager:
  """Saves and restores `ckpt_<step>.pt` files in `directory`, keeping the
  newest `max_to_keep`."""

  def __init__(self, directory: str, max_to_keep: int = 100):
    self.directory = os.path.abspath(directory)
    self.max_to_keep = max_to_keep

  def steps(self) -> List[int]:
    if not os.path.isdir(self.directory):
      return []
    return sorted(s for s in map(step_of, os.listdir(self.directory))
                  if s is not None)

  def latest_step(self) -> Optional[int]:
    steps = self.steps()
    return steps[-1] if steps else None

  def path(self, step: int) -> str:
    return os.path.join(self.directory, f'ckpt_{step}.pt')

  def save(self, step: int, state: TrainState) -> str:
    """Writes the state as step `step`, then deletes the oldest checkpoints
    beyond `max_to_keep`. Returns the path written. Every rank calls it."""
    path = self.path(step)
    state_dict = state.state_dict()
    if mesh_lib.rank() == 0:
      os.makedirs(self.directory, exist_ok=True)
      tmp = path + '.tmp'
      torch.save(state_dict, tmp)
      os.replace(tmp, path)
      for old in self.steps()[:-self.max_to_keep]:
        os.remove(self.path(old))
    mesh_lib.barrier()
    return path

  def _step(self, step: Optional[int]) -> int:
    if step is None:
      step = self.latest_step()
    if step is None:
      raise FileNotFoundError(f'no checkpoint found in {self.directory}')
    return step

  def restore_dict(self, step: Optional[int] = None) -> Dict:
    """The saved dict of `step` (default: the latest), tensors on the CPU."""
    return load(self.path(self._step(step)))

  def restore(self, state: TrainState,
              step: Optional[int] = None) -> TrainState:
    """Copies checkpoint `step` (default: the latest) into `state`, which
    must have the same structure; returns it."""
    state.load_state_dict(self.restore_dict(step))
    return state


def load(path: str) -> Dict:
  """A checkpoint file's dict, tensors on the CPU."""
  return torch.load(path, weights_only=True, map_location='cpu')


def restore_partial_into(state: TrainState, restore_path: str) -> TrainState:
  """Warm-start from `restore_path`, a directory of checkpoints (the latest
  wins) or one `ckpt_<step>.pt`: only the keys the checkpoint holds are
  copied into `state` (`merge_restored`); returns it."""
  if os.path.isdir(restore_path):
    restored = CheckpointManager(restore_path).restore_dict()
  elif step_of(restore_path) is not None:
    restored = load(restore_path)
  else:
    raise FileNotFoundError(f'{restore_path} is neither a directory of '
                            'checkpoints nor a ckpt_<step>.pt file')
  state.load_state_dict(merge_restored(state.state_dict(), restored))
  return state
