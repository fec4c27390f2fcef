"""Model configuration for the PyTorch port (standard library only).

Counterpart of `mulan_tpu/models/config.py`, which needs flax and jax, and of
the `ml_collections` files under `mulan_tpu/configs/`; neither can be imported
where only PyTorch is installed. The fields are the ones the ported slices
read, with the JAX package's names and defaults.
`use_kernels` is the counterpart of `use_pallas`: it routes attention, the
decoder log-likelihood, the dropout masks and every GroupNorm+swish site
(fused or not) through the hand-written CUDA kernels in `ops/`. The other
execution-policy fields, `remat`, `dropout_mask_batch` and
`fused_gn_swish`, take the JAX package's values
(`mulan_tpu/models/config.py:93-140`), as does `gamma_precision`
(`schedules.py`, `layers.gamma_matmul`). The JAX fields that the port does
not have, each with the value the port implies, are listed in
`tests/test_torch_port.py` (`NOT_PORTED`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
  # data / decoder
  vocab_size: int = 256
  sample_softmax: bool = False
  image_size: int = 32
  image_channels: int = 3

  # time sampling & ELBO
  antithetic_time_sampling: bool = True
  sm_n_timesteps: int = 0  # 0 => continuous time

  # noise schedule
  gamma_type: str = 'poly_fixedend'
  gamma_min: float = -13.3
  gamma_max: float = 5.0

  # score model
  unet_type: str = 'vdm'
  sm_n_embd: int = 128
  sm_n_layer: int = 32
  sm_pdrop: float = 0.1
  with_fourier_features: bool = True
  with_attention: bool = False

  # auxiliary latent encoder q(z_x | x)
  encoder: str = 'unet'
  forward_n_layer: int = 4
  latent_size: int = 50
  latent_k: int = 15
  latent_type: str = 'topk'
  topk_noise_type: str = 'gamma'
  reparam_type: str = 'true'
  z_conditioning: bool = True

  # velocity parameterization
  velocity_from_epsilon: bool = False

  # sampling: the prior's standard deviation at t = 1
  sigma_prior: float = 1.0

  # execution policy
  compute_dtype: str = 'float32'  # 'float32' | 'bfloat16' (UNet compute only)
  use_kernels: bool = False
  # Activation checkpointing: 'none' (or False) | 'all' (or True: every
  # block) | 'attn' (attention blocks only) | 'alt' (attention blocks and
  # every other ResNet block of the score UNet).
  remat: Any = 'none'
  # All of the score UNet's dropout masks from one launch per training
  # forward (K7), kept for the backward, instead of one mask per block in the
  # forward and its regeneration in the backward (K6).
  dropout_mask_batch: bool = False
  # swish(groupnorm(x)) in one pass (K8) at both GN-swish sites of every
  # ResNet block of the score UNet.
  fused_gn_swish: bool = False
  # The learned gamma networks' matmuls: 'highest' (float32), 'high' (three
  # bf16 passes, float32 accumulation) or 'default' (one bf16 pass).
  gamma_precision: str = 'highest'

  @property
  def remat_blocks(self) -> bool:
    if self.remat in (False, 'none', 'attn', 'alt'):
      return False
    if self.remat in (True, 'all'):
      return True
    raise ValueError(f'unknown remat mode: {self.remat!r}')

  @property
  def remat_attn(self) -> bool:
    if self.remat in (False, 'none'):
      return False
    if self.remat in (True, 'all', 'attn', 'alt'):
      return True
    raise ValueError(f'unknown remat mode: {self.remat!r}')

  @property
  def remat_alt_blocks(self) -> bool:
    """Checkpoint every other ResNet block (only the 'alt' mode)."""
    if self.remat in (False, 'none', 'attn', True, 'all'):
      return False
    if self.remat == 'alt':
      return True
    raise ValueError(f'unknown remat mode: {self.remat!r}')

  @property
  def n_pixels(self) -> int:
    return self.image_size * self.image_size * self.image_channels

  @property
  def image_shape(self):
    return (self.image_size, self.image_size, self.image_channels)

  @property
  def dtype(self) -> torch.dtype:
    return {'float32': torch.float32, 'bfloat16': torch.bfloat16}[
        self.compute_dtype]


def flagship_config(**overrides) -> ModelConfig:
  """MuLAN-velocity on CIFAR-10 (`mulan_tpu/configs/cifar10_conditioned.py`):
  bf16 UNet compute, 128 channels, 32 layers, dropout 0.1, top-15-of-50
  latents, `poly_fixedend` schedule, kernels on."""
  cfg = ModelConfig(
      vocab_size=256, image_size=32, image_channels=3, sample_softmax=False,
      antithetic_time_sampling=True, sm_n_timesteps=0,
      gamma_type='poly_fixedend', gamma_min=-13.3, gamma_max=5.0,
      unet_type='vdm', sm_n_embd=128, sm_n_layer=32, sm_pdrop=0.1,
      with_fourier_features=True, with_attention=False, encoder='unet',
      forward_n_layer=4, latent_size=50, latent_k=15, latent_type='topk',
      topk_noise_type='gamma', reparam_type='true', z_conditioning=True,
      velocity_from_epsilon=False, sigma_prior=1.0,
      compute_dtype='bfloat16', use_kernels=True)
  return dataclasses.replace(cfg, **overrides)


def tiny_config(**overrides) -> ModelConfig:
  """The flagship cut to 8x8 images, 32 channels and 2 layers in fp32
  (`__graft_entry__._flagship_config(tiny=True)`)."""
  cfg = flagship_config(
      image_size=8, sm_n_embd=32, sm_n_layer=2, forward_n_layer=1,
      latent_size=10, latent_k=3, compute_dtype='float32', use_kernels=False)
  return dataclasses.replace(cfg, **overrides)
