"""Variational-lower-bound BPD, counterpart of `mulan_tpu/evals/vlb.py`.

  * `eval_bpd_sparse`: one Monte-Carlo ELBO per test image, antithetic t
    across each batch.
  * `eval_bpd_dense`: each image on the stratified grid
    t_j = (u_i + j / n_timesteps) mod 1 with one offset u_i per image. For
    MuLAN the encoder runs once per image and its logits are repeated over
    the grid (`MuLAN.elbo(encoder_logits=...)`); each (image, t) row still
    draws its own top-k and diffusion noise. The VDM has no latent and takes
    the plain path (`mulan_tpu/evals/vlb.py:111-117`). The rows go through
    the model in chunks of `images_per_chunk` images, 512 rows by default.

`model` is a `MuLAN` or a `VDM`.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional

import torch

from torch import nn

from mulan_tpu_torch.models.mulan import MuLAN
from mulan_tpu_torch.models.outputs import ELBOOutput


def bpd_terms(outputs: ELBOOutput, n_pixels: int) -> torch.Tensor:
  """Per-example bits per dimension of the summed ELBO terms."""
  nats = outputs.loss_recon + outputs.loss_klz + outputs.loss_diff
  return nats / (n_pixels * math.log(2.0))


@torch.inference_mode()
def eval_bpd_sparse(model: nn.Module, batches: Iterable,
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


# (image, t) rows per dense chunk by default (`vlb.py:106` on one device).
DENSE_ROWS_PER_CHUNK = 512


def dense_chunk_bpd(model: nn.Module, images, n_timesteps: int, *,
                    generator: Optional[torch.Generator] = None, u=None,
                    **noise) -> torch.Tensor:
  """Per-image bpd (B,) averaged over the grid t_j = (u_i + j / n) mod 1,
  on the device. `u` (B,) and the ELBO's `noise` (eps0, eps, and MuLAN's
  topk_noise, for the B * n rows, image-major) are drawn from `generator`
  when not given."""
  images = torch.as_tensor(images, device=model.device)
  b = images.shape[0]
  if u is None:
    u = torch.rand((b,), generator=generator, device=model.device)
  steps = torch.arange(n_timesteps, device=model.device) / n_timesteps
  t = torch.remainder(torch.as_tensor(u, device=model.device)[:, None]
                      + steps, 1.0).reshape(-1)
  if isinstance(model, MuLAN):  # one encoder pass an image
    noise['encoder_logits'] = model.apply_encoder(images).repeat_interleave(
        n_timesteps, dim=0)
  out = model.elbo(images.repeat_interleave(n_timesteps, dim=0), t,
                   generator=generator, **noise)
  return bpd_terms(out, model.config.n_pixels).reshape(
      b, n_timesteps).mean(dim=1)


@torch.inference_mode()
def eval_bpd_dense(model: nn.Module, batches: Iterable, n_timesteps: int = 128,
                   images_per_chunk: Optional[int] = None,
                   generator: Optional[torch.Generator] = None,
                   max_batches: Optional[int] = None) -> float:
  """Mean dense bpd over uint8 NHWC image batches (`vlb.py:71-182`).

  Each batch is cut into chunks of `images_per_chunk` images (default
  `DENSE_ROWS_PER_CHUNK // n_timesteps`, at least 1). Per-image results
  stay on the device and are read once at the end.
  """
  if images_per_chunk is None:
    images_per_chunk = max(1, DENSE_ROWS_PER_CHUNK // n_timesteps)
  bpds = []
  for i, images in enumerate(batches):
    if max_batches is not None and i >= max_batches:
      break
    for lo in range(0, len(images), images_per_chunk):
      bpds.append(dense_chunk_bpd(model, images[lo:lo + images_per_chunk],
                                  n_timesteps, generator=generator))
  if not bpds:
    raise ValueError('eval_bpd_dense saw zero batches')
  return float(torch.cat(bpds).mean())
