"""PyTorch + CUDA port of mulan_tpu (MuLAN on an NVIDIA H100).

Imports torch, numpy and the standard library only. The JAX package
`mulan_tpu` is the reference it is tested against. This slice ports
MuLAN-velocity's evaluation (sparse VLB) and ancestral sampling, with the
flash-attention and decoder log-likelihood forwards as CUDA kernels
(`ops/`, sources in `csrc/`).
"""
