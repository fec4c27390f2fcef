"""PyTorch + CUDA port of mulan_tpu (MuLAN on an NVIDIA H100).

Imports torch, numpy and the standard library only. The JAX package
`mulan_tpu` is the reference it is tested against. Ported, for
MuLAN-velocity and the baseline VDM with its scalar schedules: evaluation
(sparse and dense VLB, the exact NLL through the probability-flow ODE,
`EvalExperiment`), ancestral and ODE sampling,
train step and training loop with checkpoints (`train/`), the reference's
`ckpt-N.flax` files (`compat.py`) and the command lines (`main.py`,
`eval_bpd.py`), with the flash-attention forward and backward, the decoder
log-likelihood forward and backward, the dropout masks and the fused
GroupNorm+swish as CUDA kernels (`ops/`, sources in `csrc/`).
"""
