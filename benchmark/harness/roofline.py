"""The least time the card could take over each hand-written kernel's
work, from its call's shapes: the larger of its operations over the peak
for its inputs' type and its bytes over the memory bandwidth (each input
byte read once, each output byte written once). Ready for per-kernel
`<kernel>_roofline` metrics once the program marks where each kernel's
work runs; no metric reads it yet.

Shapes: attention (batch, heads, tokens, head_dim); the decoder's pixels
(batch x H x W x C, float32); the masks' and GroupNorm's elements.
"""

from __future__ import annotations

PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}  # H100 SXM, dense
HBM_BYTES_PER_S = 3.35e12
ELEMENT_BYTES = {'bfloat16': 2, 'float32': 4}


def bound_s(flops: float, bytes_moved: float, dtype: str) -> float:
  return max(flops / PEAK_FLOPS[dtype], bytes_moved / HBM_BYTES_PER_S)


def attention_fwd_flops(b, h, t, d):
  """K1: S = Q K^T and O = P V."""
  return 4 * b * h * t * t * d


def attention_bwd_dkv_flops(b, h, t, d):
  """K2: S again, dV = P^T dO, dP = dO V^T, dK = dS^T Q."""
  return 8 * b * h * t * t * d


def attention_bwd_dq_flops(b, h, t, d):
  """K3: S again, dP = dO V^T, dQ = dS K."""
  return 6 * b * h * t * t * d


def decoder_bytes(pixels):
  """K4 reads x, z and g0; K5 reads x and z and writes dz (float32)."""
  return 3 * 4 * pixels


def mask_bytes(elements, dtype='bfloat16', masks=1):
  """K6 (one site) and K7 (`masks` sites) write the keep masks."""
  return masks * elements * ELEMENT_BYTES[dtype]


def gn_swish_bytes(elements, dtype='bfloat16'):
  """K8 reads x and writes y."""
  return 2 * elements * ELEMENT_BYTES[dtype]


def gn_swish_bwd_bytes(elements, dtype='bfloat16'):
  """K8's backward reads x and dy and writes dx."""
  return 3 * elements * ELEMENT_BYTES[dtype]
