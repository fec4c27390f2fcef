"""PyTorch + CUDA port of mulan_tpu (MuLAN on an NVIDIA H100).

Imports torch, numpy and the standard library only. The JAX package
`mulan_tpu` is the reference it is tested against. Ported: MuLAN-velocity's
evaluation (sparse VLB), ancestral sampling and train step (`train/`), with
the flash-attention forward and backward, the decoder log-likelihood forward
and backward and the dropout mask as CUDA kernels (`ops/`, sources in
`csrc/`).
"""
