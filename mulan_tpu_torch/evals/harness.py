"""Ancestral sampling, counterpart of
`mulan_tpu/evals/harness.py:EvalExperiment.random_samples`."""

from __future__ import annotations

from typing import Optional

import torch

from mulan_tpu_torch.models import latents
from mulan_tpu_torch.models.mulan import MuLAN


@torch.inference_mode()
def random_samples(model: MuLAN, batch_size: int = 16, T: int = 1000,
                   generator: Optional[torch.Generator] = None):
  """T ancestral steps from the prior, each example conditioned on a random
  hard top-k embedding, then the argmax decode.

  Returns (images, z_0): uint8 NHWC numpy images and the final float32 NHWC
  latent on the model's device.
  """
  cfg = model.config
  device = model.device
  emb = latents.logits_to_embeddings(
      torch.randn((batch_size, cfg.latent_size), generator=generator,
                  device=device), cfg.latent_k)
  z = torch.randn((batch_size, *cfg.image_shape), generator=generator,
                  device=device)
  for i in range(T):
    z = model.conditional_sample(i, T, z, emb, generator=generator)
  images = model.generate_x(z)
  return images.to(torch.uint8).cpu().numpy(), z
