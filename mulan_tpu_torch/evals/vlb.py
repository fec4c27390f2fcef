"""Variational-lower-bound BPD, counterpart of `mulan_tpu/evals/vlb.py`.

  * `eval_bpd_sparse`: one Monte-Carlo ELBO per test image, antithetic t
    across each batch.
  * `eval_bpd_dense`: each image on the stratified grid
    t_j = (u_i + j / n_timesteps) mod 1 with one offset u_i per image, its
    labels and conditioning repeated over the grid. For a MuLAN with a
    logits encoder (top-k or Gumbel latent, `reparam_type` 'true') the
    encoder runs once per image and its logits are repeated over the grid
    (`MuLAN.elbo(encoder_logits=...)`); each (image, t) row still draws its
    own latent and diffusion noise. The VDM, the Gaussian latent and the
    models without an encoder take the plain path
    (`mulan_tpu/evals/vlb.py:111-118`). The rows go through the model in
    chunks of `images_per_chunk` images, 512 rows by default.

`model` is a `MuLAN` or a `VDM`. A batch is a dict of `images` (uint8
NHWC) and, when the model reads them, `labels` and `conditioning` (B,), as
the data iterators yield it, or the images alone. The ELBO's step is 0, as
in JAX.

Under `torch.distributed` each rank passes its shard of the eval split
(`data.create_one_time_eval_dataset`). The global batch (or dense chunk)
is the ranks' concatenated in rank order, as JAX assembles it, and each
rank draws its rows of the global batch's noise. Every rank runs as many
batches, padded to one size (`parallel.mesh.even_chunks`, the wrap-around
padding and mask of `shard_host_padded`), and the per-image bpd is
gathered, so every rank returns the same global mean
(`mulan_tpu/evals/vlb.py:120-180`).
"""

from __future__ import annotations

import itertools
import math
from typing import Iterable, Optional

import torch

from torch import nn

from mulan_tpu_torch.models.mulan import MuLAN
from mulan_tpu_torch.models.outputs import ELBOOutput
from mulan_tpu_torch.parallel import mesh as mesh_lib
from mulan_tpu_torch.utils import tracing


def bpd_terms(outputs: ELBOOutput, n_pixels: int) -> torch.Tensor:
  """Per-example bits per dimension of the summed ELBO terms."""
  nats = outputs.loss_recon + outputs.loss_klz + outputs.loss_diff
  return nats / (n_pixels * math.log(2.0))


def _as_dict(batch):
  """The images, and the labels and conditioning it has, of a batch dict or
  of images alone."""
  if not isinstance(batch, dict):
    return {'images': batch}
  return {k: batch[k] for k in ('images', 'labels', 'conditioning')
          if batch.get(k) is not None}


def _rows(chunk, mesh) -> Optional[mesh_lib.Rows]:
  """This rank's rows of a global chunk (None in one process)."""
  if not mesh_lib.is_distributed():
    return None
  return mesh_lib.row_window(len(chunk['images']), mesh)


def _shares_encoder(model: nn.Module) -> bool:
  """Whether the dense VLB may run the encoder once per image: a MuLAN
  whose encoder gives logits (`vlb.py:116-118`)."""
  cfg = model.config
  return (isinstance(model, MuLAN) and cfg.reparam_type == 'true'
          and cfg.latent_type in ('topk', 'gumbel'))


@torch.inference_mode()
def eval_bpd_sparse(model: nn.Module, batches: Iterable,
                    generator: Optional[torch.Generator] = None,
                    max_batches: Optional[int] = None, mesh=None) -> float:
  """Mean bpd over batches (see the module's docstring), the ranks
  splitting them over the batch coordinates of `mesh`.

  Per-image results stay on the device and are read once at the end, so
  the host never waits on the device inside the loop (in one process).
  """
  n_pixels = model.config.n_pixels
  bpds = []
  chunks = [_as_dict(b) for b in itertools.islice(batches, max_batches)]
  for chunk, _ in mesh_lib.even_chunks(chunks):
    bpd = bpd_terms(model(chunk['images'], labels=chunk.get('labels'),
                          conditioning=chunk.get('conditioning'),
                          generator=generator, rows=_rows(chunk, mesh)),
                    n_pixels)
    bpds.append(mesh_lib.all_gather_rows(bpd, chunk.get('mask'), mesh))
  if not bpds:
    raise ValueError('eval_bpd_sparse saw zero batches')
  return float(torch.cat(bpds).mean())


# (image, t) rows per dense chunk by default (`vlb.py:106` on one device).
DENSE_ROWS_PER_CHUNK = 512


def dense_chunk_bpd(model: nn.Module, images, n_timesteps: int, *,
                    labels=None, conditioning=None,
                    generator: Optional[torch.Generator] = None, u=None,
                    rows: Optional[mesh_lib.Rows] = None,
                    **noise) -> torch.Tensor:
  """Per-image bpd (B,) averaged over the grid t_j = (u_i + j / n) mod 1,
  on the device, the images' `labels` and `conditioning` (B,) repeated
  over it. `u` (B,) and the ELBO's `noise` (eps0, eps, and MuLAN's
  latent_noise, for the B * n rows, image-major) are drawn from `generator`
  when not given, as `rows` of the global chunk's draws when given."""
  dev = model.device
  images = torch.as_tensor(images, device=dev)
  b = images.shape[0]
  if u is None:
    u = mesh_lib.draw_rows(lambda s: torch.rand(s, generator=generator,
                                                device=dev), (b,), rows)
  steps = torch.arange(n_timesteps, device=dev) / n_timesteps
  t = torch.remainder(torch.as_tensor(u, device=dev)[:, None]
                      + steps, 1.0).reshape(-1)

  def repeat(a):
    return (None if a is None else
            torch.as_tensor(a, device=dev).repeat_interleave(n_timesteps,
                                                             dim=0))
  if _shares_encoder(model):  # one encoder pass an image
    with tracing.span('encoder'):
      noise['encoder_logits'] = repeat(model.apply_encoder(images))
  out = model.elbo(repeat(images), t, labels=repeat(labels),
                   conditioning=repeat(conditioning), generator=generator,
                   rows=None if rows is None else rows.interleaved(
                       n_timesteps), **noise)
  return bpd_terms(out, model.config.n_pixels).reshape(
      b, n_timesteps).mean(dim=1)


@torch.inference_mode()
def eval_bpd_dense(model: nn.Module, batches: Iterable, n_timesteps: int = 128,
                   images_per_chunk: Optional[int] = None,
                   generator: Optional[torch.Generator] = None,
                   max_batches: Optional[int] = None, mesh=None) -> float:
  """Mean dense bpd over batches (`vlb.py:71-182`; see the module's
  docstring), the ranks splitting them over the batch coordinates of
  `mesh`.

  Each batch is cut into chunks of `images_per_chunk` images (default
  `DENSE_ROWS_PER_CHUNK // n_timesteps`, at least 1; on each rank, as
  JAX's count is per host). Per-image results stay on the device and are
  read once at the end (in one process). Each chunk runs in a unit
  'chunk' of the recorder (`utils/tracing.py`).
  """
  if images_per_chunk is None:
    images_per_chunk = max(1, DENSE_ROWS_PER_CHUNK // n_timesteps)
  chunks = []
  for batch in itertools.islice(batches, max_batches):
    batch = _as_dict(batch)
    for lo in range(0, len(batch['images']), images_per_chunk):
      chunks.append({k: v[lo:lo + images_per_chunk]
                     for k, v in batch.items()})
  bpds = []
  for chunk, _ in mesh_lib.even_chunks(chunks):
    with tracing.unit('chunk'):
      bpds.append(mesh_lib.all_gather_rows(dense_chunk_bpd(
          model, chunk['images'], n_timesteps, labels=chunk.get('labels'),
          conditioning=chunk.get('conditioning'), generator=generator,
          rows=_rows(chunk, mesh)), chunk.get('mask'), mesh))
  if not bpds:
    raise ValueError('eval_bpd_dense saw zero batches')
  return float(torch.cat(bpds).mean())
