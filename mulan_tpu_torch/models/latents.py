"""Top-k latent machinery, counterpart of `mulan_tpu/models/latents.py`.

Random draws take an explicit `torch.Generator`, or the variates themselves,
so that tests can feed both packages the same numbers.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

N_GAMMA_TERMS = 10
GAMMA_TAU = 10.0


def gumbel_kl(logits: torch.Tensor, latent_size: int) -> torch.Tensor:
  """KL(softmax(logits) || Uniform(latent_size)); shape (B,)."""
  log_q = torch.log_softmax(logits, dim=-1)
  return torch.sum(log_q.exp() * (log_q - math.log(1.0 / latent_size)),
                   dim=-1)


def gamma_variates(k: int, shape, *, generator: Optional[torch.Generator],
                   device) -> torch.Tensor:
  """Gamma(1/k) draws of shape (N_GAMMA_TERMS, *shape).

  `torch.distributions.Gamma` takes no generator; its sampler does.
  """
  alpha = torch.full((N_GAMMA_TERMS, *shape), 1.0 / k, device=device)
  return torch._standard_gamma(alpha, generator=generator)


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


def deterministic_embedding(batch_size: int, latent_size: int, latent_k: int,
                            device=None) -> torch.Tensor:
  """Canonical top-k embedding for unconditional sampling: k ones first."""
  emb = torch.zeros((batch_size, latent_size), device=device)
  emb[:, :latent_k] = 1.0
  return emb


def logits_to_embeddings(logits: torch.Tensor, k: int) -> torch.Tensor:
  """Hard top-k of logits -> {0, 1} embedding (ties kept)."""
  kth = torch.topk(logits, k, dim=-1).values[..., -1:]
  return (logits >= kth).float()
