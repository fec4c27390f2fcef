"""Latent machinery, counterpart of `mulan_tpu/models/latents.py`: the
straight-through top-k (Gamma or Gumbel noise), the straight-through Gumbel
argmax and the reparameterized Gaussian, with the canonical embeddings the
unconditional sampler uses.

Random draws are explicit tensor arguments; `latent_variates` draws them
from a `torch.Generator` when the caller has none, so that tests can feed
both packages the same numbers.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from mulan_tpu_torch.parallel.mesh import Rows, draw_rows

N_GAMMA_TERMS = 10
GAMMA_TAU = 10.0


def gumbel_kl(logits: torch.Tensor, latent_size: int) -> torch.Tensor:
  """KL(softmax(logits) || Uniform(latent_size)); shape (B,)."""
  log_q = torch.log_softmax(logits, dim=-1)
  return torch.sum(log_q.exp() * (log_q - math.log(1.0 / latent_size)),
                   dim=-1)


def gamma_variates(k: int, shape, *, generator: Optional[torch.Generator],
                   device, rows: Optional[Rows] = None) -> torch.Tensor:
  """Gamma(1/k) draws of shape (N_GAMMA_TERMS, *shape); with `rows`,
  shape[0] is the local rows of the global batch's draw.

  `torch.distributions.Gamma` takes no generator; its sampler does.
  """
  def draw(full):
    alpha = torch.full(full, 1.0 / k, device=device)
    return torch._standard_gamma(alpha, generator=generator)
  return draw_rows(draw, (N_GAMMA_TERMS, *shape), rows, dim=1)


def gumbel_variates(shape, *, generator: Optional[torch.Generator],
                    device, rows: Optional[Rows] = None) -> torch.Tensor:
  """Standard Gumbel draws -log(-log u), u uniform on [tiny, 1), as
  `jax.random.gumbel` makes them; `rows` as `gamma_variates`'."""
  u = draw_rows(lambda full: torch.rand(full, generator=generator,
                                        device=device), shape, rows)
  return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


def latent_variates(config, batch: int, *,
                    generator: Optional[torch.Generator],
                    device, rows: Optional[Rows] = None) -> torch.Tensor:
  """The draw `embedding_and_kl` takes for `config.latent_type`: Gamma(1/k)
  variates (N_GAMMA_TERMS, B, latent_size) for the top-k with Gamma noise,
  standard Gumbels (B, latent_size) for the top-k with Gumbel noise and for
  the Gumbel latent, standard normals (B, latent_size) for the Gaussian.
  With `rows`, B is the local rows of the global batch's draw."""
  shape = (batch, config.latent_size)
  if config.latent_type == 'topk' and config.topk_noise_type == 'gamma':
    return gamma_variates(config.latent_k, shape, generator=generator,
                          device=device, rows=rows)
  if config.latent_type == 'gaussian':
    return draw_rows(lambda full: torch.randn(full, generator=generator,
                                              device=device), shape, rows)
  return gumbel_variates(shape, generator=generator, device=device,
                         rows=rows)


def gamma_noise(k: int, variates: torch.Tensor) -> torch.Tensor:
  """Smoothed top-k perturbation from (n_terms, *shape) Gamma(1/k) variates:
  GAMMA_TAU / k * (sum_i variates_i * i / k - log n_terms)."""
  n_terms = variates.shape[0]
  beta = k / torch.arange(1.0, n_terms + 1.0, device=variates.device)
  beta = beta.reshape((n_terms,) + (1,) * (variates.dim() - 1))
  s = torch.sum(variates / beta, dim=0) - math.log(float(n_terms))
  return GAMMA_TAU * (s / k)


def topk_embedding(logits: torch.Tensor, k: int, noise: torch.Tensor):
  """Straight-through smoothed top-k; returns (embedding, kl) with kl on the
  logits before the noise.

  The noisy logits are mean-centred and L2-normalized for the soft part; the
  hard part keeps every entry >= the k-th largest, ties included.
  """
  kl = gumbel_kl(logits, logits.shape[-1])
  logits = logits + noise
  logits = logits - logits.mean(dim=-1, keepdim=True)
  soft = logits / torch.linalg.vector_norm(logits, dim=-1, keepdim=True)
  hard = logits_to_embeddings(logits, k)
  return (hard - soft).detach() + soft, kl


def gumbel_embedding(logits: torch.Tensor, step,
                     gumbels: torch.Tensor) -> torch.Tensor:
  """Straight-through Gumbel argmax: the one-hot argmax of (logits +
  gumbels) / tau in the forward, the softmax's gradient in the backward;
  tau = max(0.5, exp(-1e-5 step)) anneals from 1 to 0.5."""
  noisy = (logits + gumbels) / max(0.5, math.exp(-1e-5 * float(step)))
  soft = torch.softmax(noisy, dim=-1)
  hard = F.one_hot(noisy.argmax(dim=-1), logits.shape[-1]).float()
  return (hard - soft).detach() + soft


def gaussian_embedding(mu: torch.Tensor, var: torch.Tensor,
                       eps: torch.Tensor):
  """Reparameterized Gaussian latent mu + sqrt(var) eps, and its KL to
  N(0, I), (B,)."""
  embedding = mu + torch.sqrt(var) * eps
  kl = 0.5 * torch.sum(mu ** 2 + var - torch.log(var) - 1.0, dim=-1)
  return embedding, kl


def embedding_and_kl(config, heads, noise: torch.Tensor, step=0):
  """(embedding, kl) of the encoder's output for `config.latent_type`
  (`mulan_tpu/models/mulan.py:_embedding_and_kl`): `heads` are the logits,
  or (mu, var) for the Gaussian latent; `noise` is `latent_variates`'
  draw."""
  if config.latent_type == 'topk':
    if config.topk_noise_type == 'gamma':
      noise = gamma_noise(config.latent_k, noise)
    elif config.topk_noise_type != 'gumbel':
      raise ValueError(
          f'unknown topk_noise_type: {config.topk_noise_type!r}')
    return topk_embedding(heads, config.latent_k, noise)
  if config.latent_type == 'gumbel':
    return (gumbel_embedding(heads, step, noise),
            gumbel_kl(heads, config.latent_size))
  if config.latent_type == 'gaussian':
    return gaussian_embedding(*heads, noise)
  raise ValueError(f'unknown latent_type: {config.latent_type!r}')


def deterministic_embedding(batch_size: int, latent_size: int, latent_k: int,
                            latent_type: str = 'topk',
                            device=None) -> torch.Tensor:
  """Canonical embedding for unconditional sampling: the first `latent_k`
  latents on (top-k), latent 1 on (Gumbel), zeros (Gaussian)."""
  emb = torch.zeros((batch_size, latent_size), device=device)
  if latent_type == 'topk':
    emb[:, :latent_k] = 1.0
  elif latent_type == 'gumbel':
    emb[:, 1] = 1.0
  elif latent_type != 'gaussian':
    raise ValueError(f'unknown latent_type: {latent_type!r}')
  return emb


def logits_to_embeddings(logits: torch.Tensor, k: int) -> torch.Tensor:
  """Hard top-k of logits -> {0, 1} embedding (ties kept)."""
  kth = torch.topk(logits, k, dim=-1).values[..., -1:]
  return (logits >= kth).float()
