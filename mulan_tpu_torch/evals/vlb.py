"""Sparse variational-lower-bound BPD, counterpart of
`mulan_tpu/evals/vlb.py:eval_bpd_sparse`: one Monte-Carlo ELBO per test
image, antithetic t across each batch. The dense estimator is not ported yet
(ROADMAP.md Queue A)."""

from __future__ import annotations

import math
from typing import Iterable, Optional

import torch

from mulan_tpu_torch.models.mulan import MuLAN
from mulan_tpu_torch.models.outputs import ELBOOutput


def bpd_terms(outputs: ELBOOutput, n_pixels: int) -> torch.Tensor:
  """Per-example bits per dimension of the summed ELBO terms."""
  nats = outputs.loss_recon + outputs.loss_klz + outputs.loss_diff
  return nats / (n_pixels * math.log(2.0))


@torch.inference_mode()
def eval_bpd_sparse(model: MuLAN, batches: Iterable,
                    generator: Optional[torch.Generator] = None,
                    max_batches: Optional[int] = None) -> float:
  """Mean bpd over uint8 NHWC image batches.

  Per-batch means stay on the device and are read once at the end, so the
  host never waits on the device inside the loop.
  """
  n_pixels = model.config.n_pixels
  bpds = []
  for i, images in enumerate(batches):
    if max_batches is not None and i >= max_batches:
      break
    bpds.append(bpd_terms(model(images, generator=generator),
                          n_pixels).mean())
  if not bpds:
    raise ValueError('eval_bpd_sparse saw zero batches')
  return float(torch.stack(bpds).mean())
