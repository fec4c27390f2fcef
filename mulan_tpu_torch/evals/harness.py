"""Checkpoint evaluation and ancestral sampling, counterpart of
`mulan_tpu/evals/harness.py` (`EvalExperiment`, its `random_samples`).
The samplers take a `MuLAN` or a `VDM`; the VDM ignores the embedding.
With `rows` (a data-parallel rank's `parallel.mesh.Rows`) a sampler draws
its rows of the global batch's noise; `EvalExperiment` on a mesh gathers
every rank's samples."""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch

from torch import nn

from mulan_tpu_torch import compat
from mulan_tpu_torch.models import latents
from mulan_tpu_torch.parallel import mesh as mesh_lib
from mulan_tpu_torch.train import checkpoint as ckpt_lib
from mulan_tpu_torch.train.loop import SAMPLE, Experiment, mean_scalars


def _randn(model, shape, generator, rows):
  return mesh_lib.draw_rows(lambda s: torch.randn(
      s, generator=generator, device=model.device), shape, rows)


def _ancestral(model: nn.Module, emb, T: int, generator, rows=None):
  """T ancestral steps from a standard normal prior conditioned on `emb`
  (B, latent_size) and on zero conditioning (`harness.py:55`, `:86`), then
  the decode: (uint8 NHWC numpy images, the final float32 NHWC latent on
  the model's device)."""
  z = _randn(model, (emb.shape[0], *model.config.image_shape), generator,
             rows)
  for i in range(T):
    z = model.conditional_sample(i, T, z, emb, generator=generator,
                                 rows=rows)
  return model.generate_x(z, generator, rows=rows).to(
      torch.uint8).cpu().numpy(), z


@torch.inference_mode()
def random_samples(model: nn.Module, batch_size: int = 16, T: int = 1000,
                   generator: Optional[torch.Generator] = None,
                   rows: Optional[mesh_lib.Rows] = None):
  """T ancestral steps from the prior, each example conditioned on a random
  hard top-k embedding, then the decode (the argmax, or a categorical draw
  with `sample_softmax`). With `rows`, `batch_size` is the local rows of
  the global batch's draws.

  Returns (images, z_0): uint8 NHWC numpy images and the final float32 NHWC
  latent on the model's device.
  """
  cfg = model.config
  emb = latents.logits_to_embeddings(
      _randn(model, (batch_size, cfg.latent_size), generator, rows),
      cfg.latent_k)
  return _ancestral(model, emb, T, generator, rows)


@torch.inference_mode()
def conditional_samples(model: nn.Module, embedding, batch_size: int = 16,
                        T: int = 1000,
                        generator: Optional[torch.Generator] = None,
                        rows: Optional[mesh_lib.Rows] = None):
  """T ancestral steps from the prior, every example conditioned on one
  latent `embedding` (latent_size,); uint8 NHWC numpy images (`rows` as
  `random_samples`')."""
  emb = torch.as_tensor(embedding, dtype=torch.float32, device=model.device)
  if emb.dim() != 1:
    raise ValueError(f'embedding must be 1-D, got {tuple(emb.shape)}')
  return _ancestral(model, emb[None].expand(batch_size, -1), T,
                    generator, rows)[0]


def _checkpoint_ema(config, path: str, number: Optional[int]):
  """(EMA state_dict, step) of a port checkpoint directory or a reference
  `ckpt-N[.flax]` (file or directory)."""
  if compat.is_reference_checkpoint(path):
    if number is not None:
      path = compat.resolve_flax_path(f'{path}/ckpt-{number}')
    ref = compat.load_reference_state(path)
    return (compat.reference_state_dict(
        ref.get('ema_params', ref['params']), config.model, config.vdm_type),
            compat.reference_step(ref, path))
  restored = ckpt_lib.CheckpointManager(path).restore_dict(number)
  return restored['ema_params'], int(restored['step'])


class EvalExperiment(Experiment):
  """An `Experiment` bound to a checkpoint's EMA weights: a port checkpoint
  directory (`checkpoint_num`, default the latest) or a reference
  `ckpt-N.flax`. The live and the EMA slots both hold those weights, as in
  JAX; `checkpoint_step` is the checkpoint's step. `mesh` as
  `Experiment`'s: on one, the samplers' `batch_size` is the global batch,
  each rank draws its rows and every rank returns all the samples."""

  def __init__(self, config, checkpoint_dir: str,
               checkpoint_num: Optional[int] = None, device='cuda',
               mesh=None):
    ema, self.checkpoint_step = _checkpoint_ema(config, checkpoint_dir,
                                                checkpoint_num)
    super().__init__(config, device=device, state=ema, mesh=mesh)

  def _sampled(self, sampler, batch_size: int, generator):
    if generator is None:
      self.reseed(SAMPLE, 0)
      generator = self.generator
    rows = self.rows(batch_size)
    local = batch_size if rows is None else rows.count
    images = sampler(local, generator, rows)
    if rows is None:
      return images
    return mesh_lib.all_gather_rows(torch.from_numpy(images),
                                    mesh=self.mesh).numpy()

  def conditional_samples(self, embedding, batch_size: int = 16,
                          T: int = 1000, generator=None):
    """Samples conditioned on one fixed latent embedding
    (`harness.py:43-70`), from the fixed sample key by default."""
    return self._sampled(lambda b, gen, rows: conditional_samples(
        self.state.ema_model, embedding, b, T, gen, rows), batch_size,
                         generator)

  def random_samples(self, batch_size: int = 16, T: int = 1000,
                     generator=None):
    """Samples with a random hard top-k embedding per example
    (`harness.py:72-100`), from the fixed sample key by default."""
    return self._sampled(lambda b, gen, rows: random_samples(
        self.state.ema_model, b, T, gen, rows)[0], batch_size, generator)

  def test(self, loader: Iterable) -> Dict[str, float]:
    """Mean eval scalars over a finite loader of batches, batch i keyed by
    i; read from the device once at the end (`harness.py:104-121`)."""
    return mean_scalars([self.eval_step(batch, i)
                         for i, batch in enumerate(loader)])
