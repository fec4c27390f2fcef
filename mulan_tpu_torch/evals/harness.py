"""Checkpoint evaluation and ancestral sampling, counterpart of
`mulan_tpu/evals/harness.py` (`EvalExperiment`, its `random_samples`).
The samplers take a `MuLAN` or a `VDM`; the VDM ignores the embedding."""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch

from torch import nn

from mulan_tpu_torch import compat
from mulan_tpu_torch.models import latents
from mulan_tpu_torch.train import checkpoint as ckpt_lib
from mulan_tpu_torch.train.loop import SAMPLE, Experiment, mean_scalars


def _ancestral(model: nn.Module, emb, T: int, generator):
  """T ancestral steps from a standard normal prior conditioned on `emb`
  (B, latent_size), then the argmax decode: (uint8 NHWC numpy images, the
  final float32 NHWC latent on the model's device)."""
  z = torch.randn((emb.shape[0], *model.config.image_shape),
                  generator=generator, device=model.device)
  for i in range(T):
    z = model.conditional_sample(i, T, z, emb, generator=generator)
  return model.generate_x(z).to(torch.uint8).cpu().numpy(), z


@torch.inference_mode()
def random_samples(model: nn.Module, batch_size: int = 16, T: int = 1000,
                   generator: Optional[torch.Generator] = None):
  """T ancestral steps from the prior, each example conditioned on a random
  hard top-k embedding, then the argmax decode.

  Returns (images, z_0): uint8 NHWC numpy images and the final float32 NHWC
  latent on the model's device.
  """
  cfg = model.config
  emb = latents.logits_to_embeddings(
      torch.randn((batch_size, cfg.latent_size), generator=generator,
                  device=model.device), cfg.latent_k)
  return _ancestral(model, emb, T, generator)


@torch.inference_mode()
def conditional_samples(model: nn.Module, embedding, batch_size: int = 16,
                        T: int = 1000,
                        generator: Optional[torch.Generator] = None):
  """T ancestral steps from the prior, every example conditioned on one
  latent `embedding` (latent_size,); uint8 NHWC numpy images."""
  emb = torch.as_tensor(embedding, dtype=torch.float32, device=model.device)
  if emb.dim() != 1:
    raise ValueError(f'embedding must be 1-D, got {tuple(emb.shape)}')
  return _ancestral(model, emb[None].expand(batch_size, -1), T,
                    generator)[0]


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
  JAX; `checkpoint_step` is the checkpoint's step."""

  def __init__(self, config, checkpoint_dir: str,
               checkpoint_num: Optional[int] = None, device='cuda'):
    ema, self.checkpoint_step = _checkpoint_ema(config, checkpoint_dir,
                                                checkpoint_num)
    super().__init__(config, device=device, state=ema)

  def conditional_samples(self, embedding, batch_size: int = 16,
                          T: int = 1000, generator=None):
    """Samples conditioned on one fixed latent embedding
    (`harness.py:43-70`), from the fixed sample key by default."""
    if generator is None:
      self.reseed(SAMPLE, 0)
      generator = self.generator
    return conditional_samples(self.state.ema_model, embedding, batch_size,
                               T, generator)

  def random_samples(self, batch_size: int = 16, T: int = 1000,
                     generator=None):
    """Samples with a random hard top-k embedding per example
    (`harness.py:72-100`), from the fixed sample key by default."""
    if generator is None:
      self.reseed(SAMPLE, 0)
      generator = self.generator
    return random_samples(self.state.ema_model, batch_size, T,
                          generator)[0]

  def test(self, loader: Iterable) -> Dict[str, float]:
    """Mean eval scalars over a finite loader of batches, batch i keyed by
    i; read from the device once at the end (`harness.py:104-121`)."""
    return mean_scalars([self.eval_step(batch, i)
                         for i, batch in enumerate(loader)])
