"""Diffusion-time sampling, counterpart of `mulan_tpu/models/vdm.py:sample_times`.
The scalar-gamma VDM model itself is not ported yet (ROADMAP.md Queue A)."""

from __future__ import annotations

from typing import Optional

import torch


def sample_times(n: int, *, generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
  """Antithetic (low-discrepancy) times: t_i = (u + i / n) mod 1 for one
  uniform u. The i.i.d. uniform option of the JAX package is not ported
  (every shipped config is antithetic)."""
  u = torch.rand((), generator=generator, device=device)
  return torch.remainder(
      u + torch.arange(n, dtype=torch.float32, device=device) / n, 1.0)
