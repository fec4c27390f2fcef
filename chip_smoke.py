"""Drive the PyTorch port's paths once on one GPU: evaluation, sampling
and the train step, with the execution-policy flags off and on.

    python3 chip_smoke.py [--profile]

Run from the repository root on a machine with an NVIDIA H100 (sm_90a), the
CUDA toolkit (`nvcc`) and PyTorch built for CUDA; JAX is not needed. The
script builds the CUDA kernels from `mulan_tpu_torch/csrc/`, checks each
against its plain PyTorch version at the shapes the main paths give it, then
drives the flagship MuLAN-velocity model (full width and depth, random
weights from a seed) through the sparse-VLB evaluation, the ancestral
sampler and a dozen steps of `Experiment.train` at batch 128 with dropout,
and checks from the kernels' launch counts that each path went through its
kernels; one train step with the kernels is held against one with the plain
versions, and planted faults in K2 and K3 must fail the same gates. Then
the same three paths run with `fused_gn_swish` and `dropout_mask_batch` on
(K8 at every GN-swish site of the score UNet, forward and backward, K7 for
its masks), one fused train step is held against its plain twin (and planted
faults in K8's forward and backward must fail its gates), a few train steps
run with
`with_attention` and `remat='attn'`, and one train step under each `remat`
mode is held against the step without it. Last, the checkpoint paths:
K1 and K4 at the dense VLB's shapes against their plain versions;
`Experiment.train_and_evaluate` in a temporary workdir (4 steps, an
evaluation and a sample grid after step 1 and every 2 steps, a checkpoint
every 2), whose last checkpoint restored into a fresh Experiment must hold
its state bit for bit and whose step-2 checkpoint must give step 3's bpd
again; the checkpoint exported as a `ckpt-N.flax` and read by
`EvalExperiment`, whose EMA must be the run's bit for bit; and the dense VLB
through it, one chunk held against the plain versions. Then the
probability-flow ODE: DoPri5 and RK4 on the card against the CPU on closed
forms; an RK4 likelihood of 128 images through the kernels, the plain
versions and a float32 twin, and the score UNet's attention block alone at
one RHS evaluation (planted faults in K2 and K3 must fail its gate);
`eval_bpd --bpd_eval_method=ode` and `main --mode sample --sampler=ode` on
the exported checkpoint; two adaptive DoPri5 solves; one RHS evaluation with
`fused_gn_swish` against its plain twin; and `score_jvp`, which must refuse
the kernels. Last, the baseline VDM (`vdm_cifar10`: the flagship's score
UNet at full width and depth with the learned scalar schedule): a few steps
of `Experiment.train` at batch 128, whose learned g0 puts the decoder
backward (K5) on the path; one step held against its plain twin, and K5
alone at that step's inputs (planted K5 faults must fail its gate); K5
timed there, at g0 per example and at gamma_max, beside the earlier
online-softmax K5 built from `ops/ablations/k5_bwd.json`; the sparse VLB,
the ancestral sampler, and `eval_bpd --config=vdm_cifar10
--bpd_eval_method=ode` on its exported `ckpt-N.flax`. Last, MuLAN-epsilon at
ImageNet32's width (`imagenet32`: a 256-channel score UNet with one head, so
the attention kernels run at head_dim 256, all three on their 'sm90' route):
K1, K2 and K3 alone at its shapes against their plain versions and beside
SDPA and their 'simt' entry points; the sparse VLB at batch 512 (one batch
kernels against plain); the ancestral sampler; a few steps of
`Experiment.train` at batch 128 and one step held against its plain twin
(planted K1, K2 and K3 faults must fail its gates); `eval_bpd
--config=imagenet32 --bpd_eval_method=ode` on its exported `ckpt-N.flax`;
and K8 with its backward alone at the 256-wide UNet's channel counts. Every
K1-K3 launch there, as every one before it, must take the 'sm90' route.
Last, four MuLAN variants at the flagship's width and depth (`VARIANTS`):
V1, the per-pixel-gamma 'ldm' UNet with the learned monotone schedule and
the Gumbel latent, through a few train steps (its learned g0 puts K5 on
the step), one step against its plain twin, the sparse VLB, the sampler
and an RK4 likelihood; the Gaussian latent, the CNN encoder and the label
embedding through two train steps and one ELBO batch against plain each.
Last (phase 16), data parallelism and FSDP: the flagship's train step at
batch 128 through the unwrapped `Experiment` and, in a process group of
one rank over NCCL, under DDP and under FSDP2 (a ('data', 'fsdp') mesh of
one rank), each held against the unwrapped steps; an evaluation after an
optimizer step under FSDP2 against the plain model loaded with its
gathered EMA (and the bf16 casts counted), and 10 sampler steps under it.
Then two ranks, spawned by the script, share the card over gloo (NCCL
refuses two ranks on one device): two train steps at 64 rows each under DDP
and under `training.fsdp` = 2 against one process on the global batch, each
rank's K6 and K7 masks at its `first_index` against the rows of the global
masks, and K1-K3 on 'sm90' at 64 rows. Last (phase 17), tensor
parallelism: two flagship steps at 32 rows unwrapped and on a ('data',
'tensor') mesh of size 1 over NCCL, bit for bit; then two ranks spawned by
the script share the card over gloo with `training.tp` = 2, each holding
the same 32 rows and half of every score-UNet channel dimension: their
steps against one process (the bpd, the first step's gradient norm within
0.1%, the gathered attention and GroupNorm leaves), the collectives'
calls, bytes and host seconds a step, one sparse-VLB batch, each rank's
K6 and K7 masks at its channel window against plain and against the
global mask's window, K1-K3 on 'sm90'; three ranks running a GroupNorm
whose groups straddle them (K8 and its backward on the gathered
channels) against the plain whole one; K6, K7 and K8 (forward and
backward) timed at a rank's window. Last (phase 18), the remaining
surface: a seeded split written as `npz:<tmp>/cifar10_aug_with_channel`
through 4 flagship steps of `train_and_evaluate`, the config built as
`main` builds it with `--config.training.profile=True --nan_guard`: each
train batch holds per-image permutations of its source images' pixels,
the aug bit's share is near 0.875 and reaches `loss_fn` as the
conditioning, each step launches what `expected_launches` says, and the
profile hook's trace of step 1 holds exactly that step's kernel events
by name; a NaN state is refused naming 'bpd' at step 1, and the steps are
timed with and without the guard; rank 0's writer is made; the encoder's
logits of two eval batches (`analysis.get_logits`, K1 counted) against
the plain model within a bound from bf16 attention rounding, and the γ
grids of `noise_schedule_per_embedding` bit for bit and non-decreasing in
t. Every phase logs its wall time. Every check raises on failure.

With `--profile` it also profiles one ELBO, one dense-VLB chunk, one train
step (unfused, fused, with `with_attention`, the VDM's, ImageNet32's and
V1's below, and in phase 16 unwrapped, under DDP and under FSDP2)
and one ODE RHS evaluation by kernel category with `torch.profiler` and
prints the tables as `[profile]` lines.

Output, one line per phase; the line before the last is the card's name and
power limit, the one before that a JSON summary of the kernels, and the last
line is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

SEED = 0
EVAL_BATCH = 128
EVAL_BATCHES = 4
SAMPLE_BATCH = 16
SAMPLE_STEPS = 50
TRAIN_STEPS = 12
FUSED_TRAIN_STEPS = 6
ATTN_TRAIN_STEPS = 3
FLAGSHIP_ATTN = (EVAL_BATCH, 1, 1024, 128)
SAMPLER_ATTN = (SAMPLE_BATCH, 1, 1024, 128)
# Checkpoint evaluation. The dense VLB's t-grid and the images it sweeps:
# chunks of 512 (image, t) rows, so K1 at (512, 1, 1024, 128) in the score
# UNet and at (4, 1, 1024, 128) in the encoder (once per image), K4 at 512
# rows. The workdir run: steps, and the in-training sampler's batch
# (min(64, batch_size_eval)).
DENSE_T = 128
DENSE_IMAGES = 8
DENSE_ROWS = 512
DENSE_ATTN = (DENSE_ROWS, 1, 1024, 128)
DENSE_ENCODER_ATTN = (DENSE_ROWS // DENSE_T, 1, 1024, 128)
WORKDIR_STEPS = 4
WORKDIR_SAMPLER_ATTN = (64, 1, 1024, 128)
# Kernels every one of whose launches on the paths must take the 'sm90'
# route (TMA-fed, warp-specialised wgmma kernels): the route each counted
# run asserts, per kernel.
SM90_KERNELS = ('flash_attention', 'flash_attention_bwd_dkv',
                'flash_attention_bwd_dq')

# Phase 16 (data parallelism and FSDP): PAR_STEPS train steps at batch
# EVAL_BATCH through the unwrapped Experiment, DDP and FSDP2 at world size 1
# over NCCL (the first step alone, the others timed), PAR_SAMPLE_STEPS
# sampler steps under FSDP2; then PAR_RANKS ranks that share the card over
# gloo take PAR_GLOO_STEPS steps under DDP and under training.fsdp =
# PAR_RANKS, at EVAL_BATCH // PAR_RANKS rows each, within
# PAR_WORKER_TIMEOUT_S seconds.
PAR_STEPS = 4
PAR_SAMPLE_STEPS = 10
PAR_RANKS = 2
PAR_GLOO_STEPS = 2
PAR_WORKER_TIMEOUT_S = 420
# The dropout site and seed of the rank-mask gates.
PAR_MASK_SEED, PAR_MASK_SITE = 1234, 5
# Phase 17 (tensor parallelism): TP_STEPS flagship train steps at TP_ROWS
# rows unwrapped, on a tensor mesh of size 1 over NCCL, and on PAR_RANKS
# ranks that share the card over gloo with training.tp = PAR_RANKS, every
# rank holding the same rows; the first step's gradient norm within
# TP_GRAD_NORM_RTOL of one process's.
TP_ROWS = 32
TP_STEPS = 2
TP_GRAD_NORM_RTOL = 1e-3
# Then TP_GN_RANKS ranks over gloo run one fused GroupNormF32 of
# TP_GN_CHANNELS channels (16 groups of 3) with the kernels, at TP_ROWS rows
# and the flagship's 32 x 32: a rank's 16 channels cut groups, so each
# gathers the channels and runs K8 and its backward on the whole tensor.
# The output against the plain whole GN-swish's slice at GN_TOL; the
# input's gradient (the ranks' bf16 partial gradients summed) by its
# cosine at GN_ALONE_COS_MIN; the parameters' at GN_BWD_SUM_RTOL.
TP_GN_RANKS, TP_GN_CHANNELS = 3, 48
# Phase 18 (the remaining surface): a seeded synthetic split of
# SURFACE_EXAMPLES train and SURFACE_EXAMPLES // 4 eval images written to
# `npz:<tmp>/cifar10_aug_with_channel`, so that the train batches are
# augmented with the channel permutation; the flagship config as `main`
# builds it with `--config.training.profile=True --nan_guard`, through
# SURFACE_STEPS steps of `train_and_evaluate` (evaluations after step 1 and
# at the last, the sampler cut to SAMPLE_STEPS). The aug bit's share is
# 1 - 0.5^3 in expectation; over SURFACE_STEPS x 128 images its standard
# deviation is 0.0146, so AUG_SHARE_TOL is ~5 of them. The guard's cost is
# timed over SURFACE_GUARD_STEPS steps, each way in turns.
SURFACE_EXAMPLES = 1024
SURFACE_STEPS = 4
SURFACE_EVAL_BATCHES = 2
AUG_SHARE = 1 - 0.5 ** 3
AUG_SHARE_TOL = 0.07
SURFACE_GUARD_STEPS = 3
SURFACE_GUARD_TURNS = 2
# `analysis.get_logits` over SURFACE_LOGIT_BATCHES eval batches, K1 in the
# encoder. Its logits with the kernels against the plain model's: K1 and
# the plain attention each round the attention's probabilities and output
# to bf16 where the float32 attention does not. Let delta be the largest
# change of a logit when the plain model's encoder attention alone runs in
# float32 (the rounding's whole effect on the logits). Both bf16 attentions
# lie within about delta of the float32 one, so within 2 delta of each
# other; LOGITS_BOUND_FACTOR = 4 leaves a factor of 2 for K1's other
# rounding points (it rounds its unnormalized probabilities and divides by
# the row sum at the end).
SURFACE_LOGIT_BATCHES = 2
LOGITS_BOUND_FACTOR = 4.0
# Each gamma grid of `noise_schedule_per_embedding` (128 t) is
# non-decreasing in t up to float32 rounding: gamma = gmin + (gmax - gmin)
# P(t) / P(1) is evaluated as a sum of five powers of t, whose rounding
# (a few ulps of 18.3 at 1.2e-7 each) can undo a step of the same size
# where P'(t) nearly vanishes. The bound is JAX's own test's
# (`tests/test_analysis.py:32`).
GAMMA_STEP_TOL = 1e-5
# Phase 19 (the super-step): the flagship config as `main` builds it with
# `--config.training.substeps=SUPER_SUBSTEPS` (JAX's is JAX_SUBSTEPS,
# `mulan_tpu/configs/cifar10_conditioned.py:82`) through SUPER_STEPS steps
# of `train_and_evaluate` with `--nan_guard` and the profile, logging every
# super-step and evaluating (SUPER_EVAL_BATCHES batches) and saving at the
# last; the sampler cut to SAMPLE_STEPS (JAX's JAX_SAMPLE_T). A logged
# train scalar is the float32 mean of its super-step's values, within
# SUPER_MEAN_RTOL of their float64 mean. The state after the run against
# SUPER_STEPS single `train_step` calls on the same batches: bit for bit,
# or where the card's kernels do not repeat bit for bit, the bpds within
# TRAIN_BPD_TOL and every leaf of the params, the EMA and the AdamW moments
# at a cosine of SUPER_LEAF_COS_MIN. The steps of a super-step and as
# single calls are timed SUPER_TIMING_TURNS times each, in turns.
SUPER_SUBSTEPS = 4
SUPER_STEPS = 8
SUPER_EVAL_BATCHES = 2
SUPER_MEAN_RTOL = 1e-6
SUPER_LEAF_COS_MIN = 0.9999
SUPER_TIMING_TURNS = 2
SUPER_PLANTED_SUBSTEP = 2
JAX_SUBSTEPS = 1000
JAX_SAMPLE_T = 1000
# The CUDA kernel names (demangled, before the template arguments) of each
# counted wrapper, for counting a torch.profiler trace's kernel events.
# K6 and K7 share `dropout_mask`; K4 and K5 launch a reduction after their
# kernel, which the trace also holds (`sum_partials`, `sum_rows`); K8's
# backward is one launch of either design.
TRACE_KERNEL_NAMES = {
    'flash_attention': ('flash_fwd_sm90', 'flash_fwd_sm90_d256',
                        'flash_fwd_simt'),
    'flash_attention_bwd_dkv': ('flash_bwd_dkv_sm90',
                                'flash_bwd_dkv_sm90_d256', 'flash_bwd_dkv'),
    'flash_attention_bwd_dq': ('flash_bwd_dq_sm90', 'flash_bwd_dq_sm90_d256',
                               'flash_bwd_dq'),
    'decoder_logprob': ('decoder_logprob_partial',),
    'decoder_logprob_bwd': ('decoder_logprob_bwd',),
    'dropout_mask': ('dropout_mask',),
    'gn_swish': ('gn_swish',),
    'gn_swish_bwd': ('gn_swish_bwd', 'gn_swish_bwd_regs'),
}


# Peak rates of one H100 SXM (NVIDIA's data sheet, dense, at the 700 W
# limit): a kernel's bound is the larger of its operations over the
# rate for its inputs' type and its bytes over the memory rate.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12
# The special-function units of compute capability 9.0 return 16 results of
# exp2, log2, rcp, sin or cos a clock per SM (CUDA C++ Programming Guide,
# arithmetic instruction throughput); the rate is that times the SM count
# times the card's maximum SM clock, read at run time.
SFU_PER_CLOCK_PER_SM = 16
# Its 32-bit integer multiply units return 64 results a clock per SM (the
# same table); a mulhi counts as one multiply.
IMUL_PER_CLOCK_PER_SM = 64
# K6/K7: Philox4x32-10 takes 10 rounds of a mulhi and a mul on two lanes,
# 40 32-bit multiplies a counter of 8 mask values.
PHILOX_MULS = 40

# K1 tolerances. bf16: the plain version rounds the normalized softmax
# weights to bf16 before the product with v, the tensor-core kernel the
# unnormalized ones and the CUDA-core kernel none (relative error 2^-9 per
# weight); both round the output to bf16. f32: only the order of the sums
# differs.
ATTN_TOL_BF16 = 2e-2
ATTN_TOL_F32 = 1e-5
# bf16 K1 also as a fraction of max |o| of the plain version, as K2/K3 are
# held (ATTN_BWD_TOL): at T = 1024 a typical |o| is ~0.04, so the absolute
# limit alone would pass an error of half of it. Both round o to bf16, one
# ulp of max |o| being 2^-8 to 2^-7 of it.
ATTN_REL_TOL_BF16 = 2e-2
# K1's row log-sum-exp, relative to max(1, |lse|): float32 both ways; the
# tensor-core kernel keeps the running max in log2 units.
LSE_RTOL = 1e-5
# K2/K3 against the plain backward on the same (q, k, v, o, lse, dO), as a
# fraction of each gradient's max-abs. Both compute in float32 from the same
# inputs, so only the order of the T-long sums differs (f32: 1e-5); in bf16
# both round their outputs to bf16 (2^-9 relative), hence 2e-2.
ATTN_BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
# K4: f32 both ways; the kernel sums its logsumexp over the window of bins
# that a float32 exp does not flush to 0 (one ex2.approx each, ~2^-22
# relative), the plain version over all of them in chunks of 64, and the
# pixel sums differ in order.
DECODER_RTOL = 1e-5
# K5: f32 both ways, the same closed form, max |kernel - plain| over the
# gradient's max-abs. The kernel runs the moments one vocab value at a time,
# the plain version in chunks of 64, so E_p[e] differs by f32 rounding
# (~1e-7 of |e| < 1); dz = e^-g0 (e_x - E_p[e]) cancels and multiplies that
# by e^-g0, up to e^13.3 = 6e5 at gamma_min: ~0.04 absolute against a
# max |dz| of ~2e3, 2e-5 relative (measured 1.7e-5 at the flagship shape).
DECODER_BWD_RTOL = 1e-4
# |bpd(kernels) - bpd(plain)| on one batch with the same noise: the two runs
# differ only in the attention weights' bf16 rounding (two blocks) and in the
# decoder's summation order, each far below 1e-3 of a bpd near 10.
BPD_TOL = 1e-2
# One train step, kernels against plain, same batch, noise and dropout masks
# (K6 and the plain Philox give the same bits): the losses within 1e-2 bpd,
# the gradient norms within 1e-2, and a cosine per leaf of the attention
# blocks, which K1-K3 alone touch directly. In the step, the UNet block's
# leaves must reach 0.999: the paths differ only in the attention's bf16
# rounding, and the blocks downstream round on from there (>= 0.9998 on an
# H100). The encoder block's gradient arrives through the top-k latent and
# the gamma network, where that rounding moves its leaves' cosines to
# 0.994-0.997, so each block is also held alone at the step's own input and
# output cotangent, where the paths differ only by the kernels: every leaf
# (and the input) to 0.9999 (>= 0.99998 on an H100).
# Key biases are left out (their gradient is 0). A step with K2's dK
# planted as zero, and one with K3's dQ zeroed on half of every query tile,
# must fail these gates.
TRAIN_BPD_TOL = 1e-2
ATTN_LEAF_COS_MIN = 0.999
ATTN_ALONE_COS_MIN = 0.9999
GRAD_NORM_RTOL = 1e-2
# K8 against gn_swish_plain, elementwise |kernel - plain| <= atol + rtol
# |plain|. Both compute in float32 from the same inputs and cast once; the
# statistics are summed in another order and the kernel computes swish as
# y / (1 + e^-y), the plain version as y * sigmoid(y), a few float32 ulps
# apart. In bf16 that moves an output by at most one bf16 ulp (2^-7 of its
# value) where the two float32 results straddle a rounding boundary; near
# swish's zero, the float32 rounding of y (~1e-7 absolute) is the atol.
GN_TOL = {torch.bfloat16: (2.0 ** -7, 1e-5), torch.float32: (1e-5, 1e-5)}
# The (mean, rstd) K8 writes for its backward against `group_stats` on the
# same x: both in float32, summed in other orders (4,096-16,384 terms at the
# flagship's widths, the variance as E[x^2] - mean^2 of x ~ N(0.5, 4)), a
# few float32 ulps of E[x^2]; |mean| is held against 1e-5 max |x| and rstd
# relatively at 1e-5.
GN_STATS_RTOL = 1e-5
# K8's backward against gn_swish_bwd_plain on the same (x, dy). dx
# elementwise, |kernel - plain| <= rtol |plain| + atol_frac max |plain|: both
# compute in float32 and cast once (bf16: one ulp, 2^-7 of the value, where
# the two straddle a rounding boundary; float32: the sigmoid's ex2.approx
# and rcp.approx, a few ulps), and dx = r (w g - mean(w g) - xhat mean(w g
# xhat)) subtracts two group means summed in other orders, ~1e-7 of the
# largest |dx|, hence atol_frac. dweight and dbias (float32) are sums over
# B x H x W = 131,072 terms of mixed sign, in other orders: max |kernel -
# plain| over their max-abs, as DECODER_BWD_RTOL.
GN_BWD_DX_TOL = {torch.bfloat16: (2.0 ** -7, 1e-5),
                 torch.float32: (1e-5, 1e-5)}
GN_BWD_SUM_RTOL = 1e-4
# |bpd(fused) - bpd(unfused)| on one batch with the same noise, both through
# the kernels: the fused GroupNorm+swish applies its affine and swish in
# float32 and rounds once to bf16, the unfused one rounds the GroupNorm's
# output and the swish's separately, at 134 sites; each a bf16 rounding
# (2^-9 relative) of activations, far below 1e-2 of a bpd near 10.
FUSED_BPD_TOL = 1e-2
# One fused train step, kernels against plain (K8 against gn_swish_plain;
# K7 and the plain Philox give the same bits): bpd and gradient norms as at
# TRAIN_BPD_TOL, and a cosine per leaf of the score UNet's ResNet blocks'
# GroupNormF32_0/1 weights and biases, which K8's output reaches first. The
# unfused step's UNet parts agree at 0.99985-0.99999 kernels against plain
# on an H100 (PERF.md); one leaf holds less of the norm than a part and
# also sees the attention kernels' bf16 rounding, so the in-step gate is
# the attention leaves' 0.999. Two fused blocks (128 and 256 input channels) are also
# held alone at the step's input and output cotangent, where only K8
# differs: every leaf and the input to 0.9999. K8 launched with half the
# groups, and K8's backward with dx missing its xhat mean(w g xhat) term,
# must each fail these gates.
GN_LEAF_COS_MIN = 0.999
GN_ALONE_COS_MIN = 0.9999
# remat against 'none', one train step each with the kernels, same batch,
# noise and dropout seed: the forward is the same computation, so the loss
# must be the same bit for bit. The backward may sum the recomputed blocks'
# contributions in another order, and cuDNN's weight gradients may differ
# from run to run (printed: 'none' against itself), so the gradients are
# held to a whole cosine of REMAT_COS_MIN and norms within GRAD_NORM_RTOL;
# on an H100 every mode gave 'none''s gradients bit for bit (cosine 1.0).
REMAT_COS_MIN = 0.9999
# The baseline VDM (phase 13): train steps at batch 128 and the batches of
# its sparse-VLB evaluation. One step kernels against plain gates the
# schedule's leaves by their cosines as the attention block's; its linear
# term's kernel and bias are one number each, so their cosine is their sign.
# Their relative differences are printed beside the plain step's from its
# float32 twin: each sums the step's loss terms with opposite signs, where
# bf16 rounding anywhere in the UNet moves the small remainder (kernels
# against plain 12.6% and 1.5% on one batch on an H100, with no K5 in the
# kernel's term at t = 0; plain against float32 4.4% and 0.5%). K5 alone at
# the VDM step's inputs against its plain version: the cosine of dz and, for
# the one g0, 1 - the relative difference of dg0. Both compute the same
# per-pixel terms in float32 (the kernel's exp2.approx 2^-22 relative) and
# sum dg0 in other orders; its terms are mostly of one sign (pixels whose
# noise crossed a bin edge), so the sum keeps their relative error. A
# planted dg0 = 0 gives 0, a flipped dz -1.
VDM_TRAIN_STEPS = 6
VDM_EVAL_BATCHES = 2
DECODER_BWD_ALONE_MIN = 0.9999
# MuLAN-epsilon at ImageNet32's width (phase 14): 256 channels and one head,
# so every attention block runs at head_dim 256, where `attention_route`
# sends K1, K2 and K3 to their 'sm90' kernels for D <= 256 in bf16. The
# evaluation runs the config's batch of 512; training runs 128 a step on one
# card (512 is the global batch of a data-parallel run). K1 alone at the
# evaluation's, the train step's, the sampler's and a dense-VLB encoder
# chunk's shapes, K2 and K3 at the train step's, each against its plain
# version with the tolerances above.
IN32_EVAL_BATCH = 512
IN32_EVAL_BATCHES = 2
IN32_TRAIN_BATCH = 128
IN32_TRAIN_STEPS = 4
IN32_EVAL_ATTN = (IN32_EVAL_BATCH, 1, 1024, 256)
IN32_TRAIN_ATTN = (IN32_TRAIN_BATCH, 1, 1024, 256)
IN32_SAMPLER_ATTN = (SAMPLE_BATCH, 1, 1024, 256)
IN32_ENCODER_ATTN = (4, 1, 1024, 256)
# The calls a timing of phase 14's K1-K3 takes the median of (their 'simt'
# entry points, timed beside them, run 9-35 ms a call).
IN32_TIMED_CALLS = 6
# The train step's remat mode: the config's.
IN32_REMAT = 'none'
# The MuLAN variants (phase 15) at the flagship's width and depth: V1 (the
# per-pixel-gamma 'ldm' UNet, the 'learnable_nnet' schedule, the Gumbel
# latent, `sample_softmax`, i.i.d. times) takes VARIANT_TRAIN_STEPS train
# steps at batch 128, one batch of the sparse VLB, VARIANT_SAMPLE_STEPS
# ancestral steps at batch SAMPLE_BATCH and an RK4 likelihood of
# VARIANT_ODE_ROWS images (ODE_RK4_STEPS steps); V2-V4 take
# VARIANT_SMALL_STEPS train steps and one ELBO batch each, kernels against
# plain within BPD_TOL.
VARIANTS = {
    'v1': dict(unet_type='ldm', gamma_type='learnable_nnet',
               latent_type='gumbel', sample_softmax=True,
               antithetic_time_sampling=False),
    'v2': dict(latent_type='gaussian', gamma_type='linear',
               z_conditioning=False),
    'v3': dict(encoder='cnn', topk_noise_type='gumbel'),
    'v4': dict(reparam_type='none'),
}
VARIANT_TRAIN_STEPS = 4
VARIANT_SMALL_STEPS = 2
VARIANT_SAMPLE_STEPS = 10
VARIANT_ODE_ROWS = 64
# The probability-flow ODE (phase 12): a likelihood solve takes ODE_ROWS
# images at once; RK4 with ODE_RK4_STEPS steps is 16 RHS evaluations, each
# the score UNet's forward and its input gradient (K1, K2 and K3 once). The
# solvers on the card against the CPU: the same steps, and y within
# ODE_SOLVER_RTOL of its largest magnitude (the same float32 operations;
# the error norm's mean and the closed forms' sin round differently). The
# adaptive solve's tolerances and its step budget (two solves within ~90
# s): at 1e-2 a 128-row solve takes 9 steps (55 RHS evaluations, 7 s on an
# H100); tighter tolerances cost far more (tools/torch_ode_tolerance.py).
# The ODE sampler's loosened tolerances (79 evaluations at batch 16).
ODE_ROWS = EVAL_BATCH
ODE_RK4_STEPS = 4
ODE_SOLVER_RTOL = 1e-6
ODE_DOPRI5_TOL = 1e-2
ODE_DOPRI5_MAX_STEPS = 50
ODE_SAMPLE_TOL = 1e-2
# The RK4 solve, kernels against plain, and a float32 plain twin beside
# them. log p is the prior's log density at x(1) (the drift's integral)
# plus delta log p (the divergence's): their bpd parts are held apart. The
# drift's part: within BPD_TOL. The divergence's part is ill-conditioned on
# seeded weights: the Hutchinson estimate integrates per-image divergences
# of up to ~1e5 nats, which each bf16 path rounds differently, so two
# correct bf16 solves part by far more than their drifts do (on an H100,
# 700 W: the divergence parts of kernels and plain 0.072 bpd apart, the
# drift parts 0.005; plain against float32 0.049 in all). The whole bpd is
# held within BPD_TOL plus ODE_BPD_NOISE times the plain bf16 solve's own
# distance from the float32 one.
ODE_BPD_NOISE = 2.0
# One fused RHS evaluation (K8 and K8's backward at 134 sites) against its
# plain twin: cosines of the drift and of the divergence, 0.99921 and
# 0.99998 on an H100 (700 W).
ODE_FUSED_COS_MIN = 0.998


def log(phase: str, **fields) -> None:
  print(f'[{phase}] ' + ' '.join(f'{k}={v}' for k, v in fields.items()),
        flush=True)


class PhaseClock:
  """Logs each phase's wall time, from the end of the one before (the
  script's start for phase 1)."""

  def __init__(self):
    self.last = time.perf_counter()
    self.seconds = {}

  def done(self, phase: int, name: str) -> None:
    torch.cuda.synchronize()
    now = time.perf_counter()
    self.seconds[phase] = now - self.last
    log('phase_time', number=phase, name=name, seconds=self.seconds[phase])
    self.last = now


def cuda_ms(fn, n: int = 20) -> float:
  """Median of n CUDA-event timings of fn(), after one warm-up call."""
  fn()
  times = []
  for _ in range(n):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
  return statistics.median(times)


def back_to_back_ms(fn, reps: int = 10, n: int = 10) -> float:
  """The device's time per call of fn(): CUDA events around `reps` calls
  in a row, per call, median of n."""
  def run():
    for _ in range(reps):
      fn()
  return cuda_ms(run, n) / reps


def host_ms(fn, calls: int = 50) -> float:
  """The host's time per call of fn(), over `calls` calls enqueued with no
  synchronize between them."""
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(calls):
    fn()
  secs = time.perf_counter() - t0
  torch.cuda.synchronize()
  return 1e3 * secs / calls


def sm_ops_per_s(per_clock_per_sm: int) -> float:
  """The card's rate for a unit that returns `per_clock_per_sm` results a
  clock on each SM, at the card's maximum SM clock."""
  mhz = subprocess.run(
      ['nvidia-smi', '-i', '0', '--query-gpu=clocks.max.sm',
       '--format=csv,noheader,nounits'], capture_output=True, text=True,
      check=True).stdout.strip()
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  return per_clock_per_sm * sms * float(mhz) * 1e6


def bound(flops: float, nbytes: float, dtype=torch.float32, *,
          exps: float = 0.0, sfu_rate: float = 1.0, imuls: float = 0.0,
          imul_rate: float = 1.0):
  """The least time for the work on this card (bound_ms, bound_by), and
  its two terms; `exps` special-function operations run at `sfu_rate` and
  `imuls` 32-bit integer multiplies at `imul_rate` beside the `flops`."""
  t_ops = 1e3 * max(flops / PEAK_FLOPS[dtype], exps / sfu_rate,
                    imuls / imul_rate)
  t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
  return dict(bound_ms=max(t_ops, t_bytes),
              bound_by='operations' if t_ops >= t_bytes else 'bytes',
              bound_ops_ms=t_ops, bound_bytes_ms=t_bytes)


def nbytes(*tensors) -> int:
  return sum(t.numel() * t.element_size() for t in tensors)


def rel_err(got, want) -> float:
  """max |got - want| over max |want|."""
  want = want.float()
  return ((got.float() - want).abs().max()
          / want.abs().max().clamp_min(1e-30)).item()


def k1_key_tile(head_dim: int) -> int:
  """Keys a K/V tile of K1's 'sm90' kernel at this head_dim (kFwdKeys,
  kFwd256Keys in csrc/flash_attention.cu)."""
  return 128 if head_dim <= 128 else 80


def attention_case(dev, gen, shape, dtype, tol, timed_case, n: int = 20,
                   simt_n: int = 0):
  """K1 at one shape against its plain version (the output, absolutely
  and in bf16 also relative to max |o|, and the row log-sum-exp written
  under autograd, which must leave the output unchanged). In bf16, where T
  spans more than one key tile, a control reads what the gate would see
  of a kernel that dropped its last key tile (the plain version without
  those keys) and must fail the relative gate. With `timed_case`, timed
  one launch (median of n) and back to back (10 calls, median of n / 2)
  beside the plain version, SDPA and its bound. With `simt_n` (bf16 on the 'sm90' route), the 'simt' C entry
  point is also checked on the same inputs and timed the same ways over
  simt_n calls (`simt_ms`, `simt_back_to_back_ms`): the route's earlier
  times. Logs and returns the result."""
  from mulan_tpu_torch.ops.flash_attention import (attention_route,
                                                   flash_attention_fwd,
                                                   flash_attention_plain)
  q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
             for _ in range(3))
  scale = shape[-1] ** -0.5
  out = flash_attention_fwd(q, k, v, scale)
  out_lse, lse = flash_attention_fwd(q, k, v, scale, return_lse=True)
  torch.cuda.synchronize()
  ref, ref_lse = flash_attention_plain(q, k, v, scale, return_lse=True)
  assert out.shape == ref.shape and out.dtype == ref.dtype
  assert torch.equal(out, out_lse), 'the lse write changed the output'
  lse_err = ((lse - ref_lse).abs() / ref_lse.abs().clamp_min(1.0)).max()
  result = dict(max_abs_err=(out.float() - ref.float()).abs().max().item(),
                max_abs_ref=ref.float().abs().max().item(),
                rel_err=rel_err(out, ref), lse_rel_err=lse_err.item(),
                route=attention_route(dtype, shape[-1]))
  tile = k1_key_tile(shape[-1])
  kept = (shape[2] - 1) // tile * tile
  if dtype == torch.bfloat16 and kept:
    result['dropped_tile_rel_err'] = rel_err(flash_attention_plain(
        q, k[:, :, :kept], v[:, :, :kept], scale), ref)
  if simt_n:
    simt = simt_fwd_call(q, k, v, scale)
    result['simt_max_abs_err'] = (simt().float() - ref.float()).abs().max(
    ).item()
    assert result['simt_max_abs_err'] <= tol, ('simt', shape, result)
  del ref, ref_lse

  def run():
    return flash_attention_fwd(q, k, v, scale)

  def sdpa():
    return F.scaled_dot_product_attention(q, k, v, scale=scale)
  if timed_case:
    result['ms'] = cuda_ms(run, n)
    result['back_to_back_ms'] = back_to_back_ms(run, n=max(1, n // 2))
    result['ms_with_lse'] = cuda_ms(lambda: flash_attention_fwd(
        q, k, v, scale, return_lse=True), n)
    result['plain_ms'] = cuda_ms(
        lambda: flash_attention_plain(q, k, v, scale), n)
    result['library_ms'] = cuda_ms(sdpa, n)
    result['library_back_to_back_ms'] = back_to_back_ms(
        sdpa, n=max(1, n // 2))
    if simt_n:
      result['simt_ms'] = cuda_ms(simt, simt_n)
      result['simt_back_to_back_ms'] = back_to_back_ms(
          simt, n=max(1, simt_n // 2))
    b, h, t, d = shape
    result.update(bound(4.0 * b * h * t * t * d, nbytes(q, k, v, out),
                        dtype))
  log('flash_attention', shape=list(shape), dtype=str(dtype), tol=tol,
      rel_tol=ATTN_REL_TOL_BF16 if dtype == torch.bfloat16 else None,
      lse_rtol=LSE_RTOL, **result)
  assert result['max_abs_err'] <= tol, (shape, dtype, result)
  assert result['lse_rel_err'] <= LSE_RTOL, (shape, dtype, result)
  if dtype == torch.bfloat16:
    assert result['rel_err'] <= ATTN_REL_TOL_BF16, (shape, dtype, result)
    assert result.get('dropped_tile_rel_err', 1.0) > ATTN_REL_TOL_BF16, (
        'the gate does not see a dropped key tile', shape, result)
  return result


def check_attention(dev, gen):
  """K1. The flagship shape and the sampler's (bf16, sm90 route) and the
  tiny config's float32 with a ragged T (simt route) are checked and timed;
  the others cover the sm90 route at a head_dim that is not a multiple of 16
  and at D = 64 with a T ragged across a 128-row tile, on two heads, and
  its kernel for 128 < D <= 256 at a T ragged across an 80-key tile, and, on
  inputs from a generator of their own (a draw from `gen` here would move
  every later phase's), at D = 200 and 136, ragged in D (TMA fills the last
  64-column box, or the last two, with zeros). Returns the flagship's and
  the sampler's results."""
  cases = ((FLAGSHIP_ATTN, torch.bfloat16, ATTN_TOL_BF16, True),
           (SAMPLER_ATTN, torch.bfloat16, ATTN_TOL_BF16, True),
           ((3, 1, 60, 32), torch.float32, ATTN_TOL_F32, True),
           ((2, 2, 100, 40), torch.bfloat16, ATTN_TOL_BF16, False),
           ((2, 2, 200, 64), torch.bfloat16, ATTN_TOL_BF16, False),
           ((2, 1, 130, 256), torch.bfloat16, ATTN_TOL_BF16, False))
  results = [attention_case(dev, gen, *case) for case in cases]
  own = torch.Generator(device=dev).manual_seed(SEED + 1)
  for d in (200, 136):
    attention_case(dev, own, (2, 2, 100, d), torch.bfloat16, ATTN_TOL_BF16,
                   False)
  return results[0], results[1]


def attention_bwd_case(dev, gen, shape, dtype, timed_case, n: int = 20,
                       simt_n: int = 0):
  """K2 and K3 at one shape against the plain backward on the same inputs;
  with `timed_case`, K2, K3 and the pair K2 + K3 timed one launch (median
  of n) and back to back (10 calls, median of n / 2), the host's time a K3
  call, beside the plain backward and the backward of
  `F.scaled_dot_product_attention` (fwd + bwd minus fwd; one launch and
  back to back). With `simt_n` (bf16 on the 'sm90' route), the 'simt' C
  entry points are also checked on the same inputs and timed the same ways
  over simt_n calls (`simt_ms`, `simt_back_to_back_ms`): the route's
  earlier times. Logs the result and returns (K2's, K3's) timings, None
  untimed."""
  from mulan_tpu_torch.ops.flash_attention import (attention_route,
                                                   flash_attention_bwd_dkv,
                                                   flash_attention_bwd_dq,
                                                   flash_attention_bwd_plain,
                                                   flash_attention_fwd)
  q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                 for _ in range(4))
  scale = shape[-1] ** -0.5
  o, lse = flash_attention_fwd(q, k, v, scale, return_lse=True)
  di = (o.float() * do.float()).sum(-1)
  dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, di, scale)
  dq_k = flash_attention_bwd_dq(q, k, v, do, lse, di, scale)
  torch.cuda.synchronize()
  ref = flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
  errs = {name: rel_err(got, want) for name, got, want in
          (('dq', dq_k, ref[0]), ('dk', dk, ref[1]), ('dv', dv, ref[2]))}
  tol = ATTN_BWD_TOL[dtype]
  route = attention_route(dtype, shape[-1])
  log('flash_attention_bwd', shape=list(shape), dtype=str(dtype),
      route=route, tol=tol,
      max_abs_ref=max(r.float().abs().max().item() for r in ref),
      **{f'{n}_rel_err': e for n, e in errs.items()})
  assert max(errs.values()) <= tol, (shape, dtype, errs)
  if not timed_case:
    return None, None
  b, h, t, d = shape
  product = 2.0 * b * h * t * t * d
  plain_ms = cuda_ms(lambda: flash_attention_bwd_plain(
      q, k, v, o, lse, do, scale), n=5)
  qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

  def sdpa_fwd():
    return F.scaled_dot_product_attention(qg, kg, vg, scale=scale)

  def sdpa_fwd_bwd():
    return torch.autograd.grad(sdpa_fwd(), (qg, kg, vg), do)

  def run_dkv():
    return flash_attention_bwd_dkv(q, k, v, do, lse, di, scale)

  def run_dq():
    return flash_attention_bwd_dq(q, k, v, do, lse, di, scale)

  def run_pair():
    run_dkv()
    run_dq()

  def one(fn):
    return cuda_ms(fn, n)

  def b2b(fn):
    return back_to_back_ms(fn, n=max(1, n // 2))
  sdpa_bwd = one(sdpa_fwd_bwd) - one(sdpa_fwd)
  sdpa_bwd_b2b = b2b(sdpa_fwd_bwd) - b2b(sdpa_fwd)
  dkv = dict(max_abs_err=max((dk.float() - ref[1].float()).abs().max(),
                             (dv.float() - ref[2].float()).abs().max())
             .item(),
             ms=one(run_dkv), back_to_back_ms=b2b(run_dkv),
             plain_ms=plain_ms, library_ms=sdpa_bwd,
             library_back_to_back_ms=sdpa_bwd_b2b, route=route,
             **bound(4 * product, nbytes(q, k, v, do, lse, di, dk, dv),
                     dtype))
  dq = dict(max_abs_err=(dq_k.float() - ref[0].float()).abs().max().item(),
            ms=one(run_dq), back_to_back_ms=b2b(run_dq),
            host_ms=host_ms(run_dq, calls=5 * n // 2), plain_ms=plain_ms,
            library_ms=None, route=route,
            **bound(3 * product, nbytes(q, k, v, do, lse, di, dq_k), dtype))
  pair = dict(ms=one(run_pair), back_to_back_ms=b2b(run_pair))
  dq['with_dkv'] = pair
  if simt_n:
    simt_calls = simt_bwd_calls(q, k, v, do, lse, di, scale)

    def simt_times(fn):
      return dict(simt_ms=cuda_ms(fn, simt_n),
                  simt_back_to_back_ms=back_to_back_ms(
                      fn, n=max(1, simt_n // 2)))
    for name, r, want in (('dkv', dkv, ref[1:]), ('dq', dq, ref[:1])):
      got = simt_calls[name]()
      err = max(rel_err(g, w) for g, w in zip(got, want))
      assert err <= tol, ('simt', name, err)
      r.update(simt_rel_err=err, **simt_times(simt_calls[name]))
    pair.update(simt_times(simt_calls['pair']))
    log('flash_attention_bwd_simt', shape=list(shape),
        dkv_simt_rel_err=dkv['simt_rel_err'],
        dq_simt_rel_err=dq['simt_rel_err'], tol=tol,
        dkv_simt_ms=dkv['simt_ms'],
        dkv_simt_back_to_back_ms=dkv['simt_back_to_back_ms'],
        dq_simt_ms=dq['simt_ms'],
        dq_simt_back_to_back_ms=dq['simt_back_to_back_ms'],
        dkv_dq_simt_ms=pair['simt_ms'],
        dkv_dq_simt_back_to_back_ms=pair['simt_back_to_back_ms'])
  log('flash_attention_bwd_timing', shape=list(shape), route=route,
      dkv_ms=dkv['ms'], dkv_back_to_back_ms=dkv['back_to_back_ms'],
      dkv_bound_ms=dkv['bound_ms'], dq_ms=dq['ms'],
      dq_back_to_back_ms=dq['back_to_back_ms'], dq_host_ms=dq['host_ms'],
      dq_bound_ms=dq['bound_ms'], dkv_dq_ms=pair['ms'],
      dkv_dq_back_to_back_ms=pair['back_to_back_ms'], plain_ms=plain_ms,
      sdpa_bwd_ms=sdpa_bwd, sdpa_bwd_back_to_back_ms=sdpa_bwd_b2b)
  return dkv, dq


def check_attention_bwd(dev, gen):
  """K2 and K3 against the plain backward on the same inputs, on the same
  shapes as `check_attention` ((2, 1, 130, 256), ragged in T, on K2's and
  K3's 'sm90' route at D <= 256), and at (2, 2, 100, 200), ragged in D (TMA
  fills the last 64-column box past D with zeros), whose inputs come from a
  generator of its own: a draw from `gen` here would move every later
  phase's. The flagship shape is timed (`attention_bwd_case`). Returns its
  (K2, K3) results."""
  cases = ((FLAGSHIP_ATTN, torch.bfloat16), (SAMPLER_ATTN, torch.bfloat16),
           ((3, 1, 60, 32), torch.float32), ((2, 2, 100, 40), torch.bfloat16),
           ((2, 2, 200, 64), torch.bfloat16),
           ((2, 1, 130, 256), torch.bfloat16))
  timed_results = [attention_bwd_case(dev, gen, shape, dtype, i == 0)
                   for i, (shape, dtype) in enumerate(cases)]
  attention_bwd_case(dev, torch.Generator(device=dev).manual_seed(SEED + 1),
                     (2, 2, 100, 200), torch.bfloat16, False)
  return timed_results[0]


def simt_fwd_call(q, k, v, scale):
  """A call of K1's 'simt' C entry point at these bf16 inputs, returning o.
  The call holds its input tensors (the C function takes raw pointers)."""
  from mulan_tpu_torch.ops import _build
  lib = _build.load_library()
  b, h, t, d = q.shape
  stream = torch.cuda.current_stream(q.device).cuda_stream

  def call():
    o = torch.empty_like(q)
    _build.check(lib.mulan_flash_attention_fwd_simt(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None, b * h,
        t, d, scale, 1, stream), 'fwd_simt')
    return o
  return call


def simt_bwd_calls(q, k, v, do, lse, di, scale):
  """{'dkv', 'dq', 'pair': a call of the 'simt' C entry points of K2, K3 or
  both at these bf16 inputs, returning (dk, dv), (dq,) or None}. The calls
  hold their input tensors (the C functions take raw pointers)."""
  from mulan_tpu_torch.ops import _build
  lib = _build.load_library()
  b, h, t, d = q.shape
  stream = torch.cuda.current_stream(q.device).cuda_stream
  inputs = (q, k, v, do, lse, di)

  def ins():
    return tuple(x.data_ptr() for x in inputs)

  def dkv():
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _build.check(lib.mulan_flash_attention_bwd_dkv_simt(
        *ins(), dk.data_ptr(), dv.data_ptr(), b * h, t, d, scale, 1, stream),
                 'dkv_simt')
    return dk, dv

  def dq():
    out = torch.empty_like(q)
    _build.check(lib.mulan_flash_attention_bwd_dq_simt(
        *ins(), out.data_ptr(), b * h, t, d, scale, 1, stream), 'dq_simt')
    return (out,)

  def pair():
    dkv()
    dq()
  return dict(dkv=dkv, dq=dq, pair=pair)


def check_decoder(dev, gen, cfg, sfu_rate, batch=EVAL_BATCH):
  """K4 against its plain version at `batch` images, per-pixel g0 and
  g0 = gamma_min, each timed beside the bound of the work its window needs
  (`bound_ms`) and that of the full-vocab online logsumexp
  (`bound_full_vocab_ms`). Returns both cases' results."""
  from mulan_tpu_torch.ops.decoder_logprob import (decoder_logprob_fwd,
                                                   decoder_logprob_plain,
                                                   encode, logsumexp_window)
  shape = (batch, *cfg.image_shape)
  x = torch.randint(0, 256, shape, generator=gen, device=dev).float()
  per_pixel = cfg.gamma_min + (cfg.gamma_max - cfg.gamma_min) * torch.rand(
      shape, generator=gen, device=dev)
  results = []
  for name, g0 in (('per_pixel', per_pixel),
                   ('gamma_min', torch.full(shape, cfg.gamma_min,
                                            device=dev))):
    z = encode(x, 256) + torch.exp(0.5 * g0) * torch.randn(
        shape, generator=gen, device=dev)
    out = decoder_logprob_fwd(x, z, g0)
    torch.cuda.synchronize()
    ref = decoder_logprob_plain(x, z, g0)
    assert out.shape == ref.shape == (batch,)
    rel = ((out - ref).abs() / ref.abs().clamp_min(1.0)).max().item()
    first, last = logsumexp_window(z, g0, cfg.vocab_size)
    bins = (last - first + 1).sum().item()
    pixels = x.numel()
    steps = pixels * cfg.vocab_size
    # The work the function needs: x, z and g0 read once, and a bin of the
    # window (`logsumexp_window`, this run's data) ~5 float32 operations and
    # one exp; a pixel ~30 operations and three exp or log. Beside it, the
    # work of the full-vocab online logsumexp the TPU kernel runs: ~9
    # operations and two exp a (pixel, vocab value) step.
    full = bound(9.0 * steps, nbytes(x, z, g0, out), exps=2.0 * steps,
                 sfu_rate=sfu_rate)
    result = dict(max_abs_err=(out - ref).abs().max().item(),
                  ms=cuda_ms(lambda: decoder_logprob_fwd(x, z, g0)),
                  back_to_back_ms=back_to_back_ms(
                      lambda: decoder_logprob_fwd(x, z, g0)),
                  plain_ms=cuda_ms(lambda: decoder_logprob_plain(x, z, g0)),
                  library_ms=None, window_bins_per_pixel=bins / pixels,
                  bound_full_vocab_ms=full['bound_ms'],
                  **bound(5.0 * bins + 30.0 * pixels, nbytes(x, z, g0, out),
                          exps=bins + 3.0 * pixels, sfu_rate=sfu_rate))
    log('decoder_logprob', g0=name, shape=list(shape), max_rel_err=rel,
        rtol=DECODER_RTOL, **result)
    assert rel <= DECODER_RTOL, f'decoder_logprob {name}: {rel}'
    results.append(result)
  return results


def check_decoder_bwd(dev, gen, cfg):
  """K5 through the autograd wrapper, against the plain closed form, with
  per-pixel, per-example and scalar g0 drawn over [gamma_min, gamma_max]
  (the last two reduced in the kernel to g0's shape). Its times are taken
  at the VDM step's inputs (`time_decoder_bwd`)."""
  from mulan_tpu_torch.ops.decoder_logprob import (decoder_logprob,
                                                   decoder_logprob_bwd_plain,
                                                   encode)
  shape = (EVAL_BATCH, *cfg.image_shape)
  x = torch.randint(0, 256, shape, generator=gen, device=dev).float()
  ct = torch.randn((EVAL_BATCH,), generator=gen, device=dev)
  span = cfg.gamma_max - cfg.gamma_min
  for name, g_shape in (('per_pixel', shape),
                        ('per_example', (EVAL_BATCH, 1, 1, 1)),
                        ('scalar', ())):
    g0 = (cfg.gamma_min + span * torch.rand(g_shape, generator=gen,
                                            device=dev)).requires_grad_()
    z = (encode(x, 256) + torch.exp(0.5 * g0.detach()) * torch.randn(
        shape, generator=gen, device=dev)).requires_grad_()
    dz, dg0 = torch.autograd.grad(decoder_logprob(x, z, g0), (z, g0), ct)
    torch.cuda.synchronize()
    ref_dz, ref_dg = decoder_logprob_bwd_plain(x, z.detach(), g0.detach(),
                                               ct)
    assert dg0.shape == ref_dg.shape == g_shape, (name, dg0.shape)
    errs = dict(dz_rel_err=rel_err(dz, ref_dz),
                dg0_rel_err=rel_err(dg0, ref_dg))
    log('decoder_logprob_bwd', g0=name, shape=list(shape),
        rtol=DECODER_BWD_RTOL, **errs)
    assert max(errs.values()) <= DECODER_BWD_RTOL, (name, errs)


def build_online_decoder_bwd(tmp_root: str):
  """The earlier K5 (the 256-step online softmax a pixel, a per-pixel dg0
  that its wrapper summed back in PyTorch), built from the ablation spec's
  `online_full_vocab` variant of `csrc/decoder_logprob.cu` by
  `ops/ablate.py`: (the library, ptxas's notes)."""
  from mulan_tpu_torch.ops import ablate
  spec = json.loads((pathlib.Path(ablate.__file__).parent / 'ablations'
                     / 'k5_bwd.json').read_text())
  name = 'online_full_vocab'
  _, path, notes = ablate.build(name, spec['variants'][name], spec['file'],
                                spec['show'], tmp_root)
  assert path, f'the online K5 variant did not build: {notes}'
  return ablate.load(path, spec['entries']), notes


def decoder_bwd_c_call(lib, x, z, g0, ct, per_pixel: bool = False):
  """(a launch of `lib`'s `mulan_decoder_logprob_bwd` on these inputs, its
  (dz, dg0)), prepared as the wrapper prepares them; with `per_pixel`, g0
  expanded to z's shape, as the online K5's wrapper handed a broadcast
  g0."""
  from mulan_tpu_torch.ops import decoder_logprob as dec
  b, n = z.shape[0], z[0].numel()
  x2, z2 = dec._flat(z, x, z)
  g0 = torch.as_tensor(g0, dtype=torch.float32, device=z.device)
  mode = dec.PER_PIXEL if per_pixel else dec.g0_mode(g0, z)
  g2 = (dec._flat(z, g0)[0] if mode == dec.PER_PIXEL
        else g0.reshape(-1).contiguous())
  ct2 = ct.float().reshape(b).contiguous()
  n_blocks = -(-n // dec._BWD_PIXELS_PER_BLOCK)
  dz = torch.empty_like(z2)
  dg0 = torch.empty_like(z2 if mode == dec.PER_PIXEL else g2)
  partial = torch.empty((b, n_blocks), device=z.device)
  tensors = (x2, z2, g2, ct2, dz, dg0, partial)  # alive while launch is
  stream = torch.cuda.current_stream().cuda_stream

  def launch():
    status = lib.mulan_decoder_logprob_bwd(
        *(t.data_ptr() for t in tensors), b, n, n_blocks, mode, 256, stream)
    assert status == 0, status
  return launch, (dz, dg0)


def time_decoder_bwd(cases, cfg, sfu_rate, online_lib):
  """K5 at each case's (x, z, g0, ct) against its plain version (dz and dg0
  within DECODER_BWD_RTOL of their max-abs), timed one launch and back to
  back through the wrapper and the C call, beside the online K5 at the same
  inputs (its C call, g0 per pixel) and the bound of the work this run's
  windows need (`logsumexp_window`). Returns {case: result}."""
  from mulan_tpu_torch.ops import _build
  from mulan_tpu_torch.ops import decoder_logprob as dec
  lib = _build.load_library()
  results = {}
  for name, (x, z, g0, ct) in cases.items():
    dz, dg0 = dec.decoder_logprob_bwd(x, z, g0, ct)
    torch.cuda.synchronize()
    ref_dz, ref_dg = dec.decoder_logprob_bwd_plain(x, z, g0, ct)
    errs = dict(dz_rel_err=rel_err(dz, ref_dz),
                dg0_rel_err=rel_err(dg0, ref_dg))
    new_call, (new_dz, new_dg) = decoder_bwd_c_call(lib, x, z, g0, ct)
    old_call, (old_dz, old_dg) = decoder_bwd_c_call(online_lib, x, z, g0, ct,
                                                    per_pixel=True)
    new_call()
    old_call()
    torch.cuda.synchronize()
    errs.update(c_call_dz_rel_err=rel_err(new_dz.reshape(z.shape), ref_dz),
                c_call_dg0_rel_err=rel_err(new_dg.reshape(ref_dg.shape),
                                           ref_dg),
                online_kernel_dz_rel_err=rel_err(old_dz.reshape(z.shape),
                                              ref_dz),
                online_kernel_dg0_rel_err=rel_err(
                    old_dg.reshape(z.shape).sum_to_size(ref_dg.shape),
                    ref_dg))
    first, last = dec.logsumexp_window(z.float(), torch.broadcast_to(
        torch.as_tensor(g0, device=z.device), z.shape), cfg.vocab_size)
    bins = (last - first + 1).sum().item()
    pixels = z.numel()
    steps = pixels * cfg.vocab_size
    io = nbytes(x.float(), z, dz, torch.as_tensor(g0), ct, dg0)
    # The work the function needs: x and z read and dz written once, and a
    # bin of the window ~8 float32 operations and one exp; a pixel ~30
    # operations and three exp, division or log. Beside it, the online
    # softmax over every bin: ~14 operations and two exp a (pixel, bin).
    full = bound(14.0 * steps, io, exps=2.0 * steps, sfu_rate=sfu_rate)
    results[name] = dict(
        max_abs_err=max((dz - ref_dz).abs().max(),
                        (dg0 - ref_dg).abs().max()).item(),
        ms=cuda_ms(lambda: dec.decoder_logprob_bwd(x, z, g0, ct)),
        back_to_back_ms=back_to_back_ms(
            lambda: dec.decoder_logprob_bwd(x, z, g0, ct)),
        c_call_ms=cuda_ms(new_call),
        c_call_back_to_back_ms=back_to_back_ms(new_call),
        online_kernel_ms=cuda_ms(old_call),
        online_kernel_back_to_back_ms=back_to_back_ms(old_call),
        plain_ms=cuda_ms(lambda: dec.decoder_logprob_bwd_plain(x, z, g0,
                                                               ct), n=5),
        library_ms=None, window_bins_per_pixel=bins / pixels,
        bound_full_vocab_ms=full['bound_ms'],
        **bound(8.0 * bins + 30.0 * pixels, io, exps=bins + 3.0 * pixels,
                sfu_rate=sfu_rate))
    log('decoder_logprob_bwd_timed', case=name, shape=list(z.shape),
        g0_shape=list(torch.as_tensor(g0).shape), rtol=DECODER_BWD_RTOL,
        **errs, **results[name])
    assert max(errs.values()) <= DECODER_BWD_RTOL, (name, errs)
  return results


def agreement(got, want) -> float:
  """The cosine of two gradients, or 1 - |got - want| / |want| for one
  number (whose cosine is its sign)."""
  got, want = got.flatten().double(), want.flatten().double()
  if want.numel() == 1:
    return 1.0 - (abs(got - want) / abs(want).clamp_min(1e-30)).item()
  return cosine(got, want)


def decoder_bwd_alone(x, z, g0, ct):
  """{dz, dg0: agreement of K5 (the module's current wrapper, so a planted
  fault bites) with its plain version} at one call's inputs."""
  from mulan_tpu_torch.ops import decoder_logprob as dec
  got = dec.decoder_logprob_bwd(x, z, g0, ct)
  want = dec.decoder_logprob_bwd_plain(x, z, g0, ct)
  return {k: agreement(g, w) for k, g, w in zip(('dz', 'dg0'), got, want)}


@contextlib.contextmanager
def planted_decoder_bwd_fault(kind: str):
  """A wrong K5 the alone gate must reject: dg0 replaced by zeros
  ('dg0_zero') or dz with its sign flipped ('dz_sign')."""
  from mulan_tpu_torch.ops import decoder_logprob as dec
  real = dec.decoder_logprob_bwd

  def faulty(*args, **kwargs):
    dz, dg0 = real(*args, **kwargs)
    if kind == 'dg0_zero':
      return dz, torch.zeros_like(dg0)
    return -dz, dg0
  faulty.launches = 0  # the real wrapper counts on the module's name
  dec.decoder_logprob_bwd = faulty
  try:
    yield
  finally:
    dec.decoder_logprob_bwd = real


@contextlib.contextmanager
def recording_decoder_bwd(calls: list):
  """Appends the (x, z, g0, ct) of every K5 call to `calls`."""
  from mulan_tpu_torch.ops import decoder_logprob as dec
  real = dec.decoder_logprob_bwd

  def recorded(x, z, g0, ct, *args, **kwargs):
    calls.append(tuple(t.detach() for t in (x, z, g0, ct)))
    return real(x, z, g0, ct, *args, **kwargs)
  recorded.launches = 0
  dec.decoder_logprob_bwd = recorded
  try:
    yield
  finally:
    dec.decoder_logprob_bwd = real


# K6/K7 at a bf16 size of 15 M values, whose last chunk of 8 holds 5: a
# grid of 7,325 blocks with a ragged tail.
LONG_MASK = (3, 5, 1000003)


def check_dropout(dev, cfg, imul_rate):
  """K6: bit-identical to the plain Philox at one flagship site (bf16), at
  LONG_MASK and at a float32 shape with a ragged tail; keep share and mean
  reported. The flagship site is timed: one launch, back to back and the
  host's time a call of the wrapper."""
  from mulan_tpu_torch.ops.dropout import (dropout_mask, dropout_mask_plain,
                                           effective_rate)
  rate = cfg.sm_pdrop
  site_shape = (EVAL_BATCH, cfg.sm_n_embd, cfg.image_size, cfg.image_size)
  result = None
  for shape, dtype in ((site_shape, torch.bfloat16),
                       (LONG_MASK, torch.bfloat16),
                       ((7, 11, 13), torch.float32)):
    mask = dropout_mask(1234, 5, shape, rate, dtype, dev)
    torch.cuda.synchronize()
    ref = dropout_mask_plain(1234, 5, shape, rate, dtype, dev)
    identical = torch.equal(mask, ref)
    keep = (mask != 0).float().mean().item()
    log('dropout_mask', shape=list(shape), dtype=str(dtype),
        bit_identical=identical, keep_share=keep,
        expected_keep=1 - effective_rate(rate),
        mean=mask.float().mean().item())
    assert identical, (shape, dtype)
    if result is None:
      def run():
        return dropout_mask(1234, 5, shape, rate, dtype, dev)
      counters = (mask.numel() + 7) // 8
      result = dict(
          max_abs_err=(mask.float() - ref.float()).abs().max().item(),
          ms=cuda_ms(run), back_to_back_ms=back_to_back_ms(run),
          host_ms=host_ms(run),
          plain_ms=cuda_ms(lambda: dropout_mask_plain(
              1234, 5, shape, rate, dtype, dev)),
          library_ms=cuda_ms(lambda: torch.empty(
              shape, dtype=dtype, device=dev).bernoulli_(1 - rate)),
          **bound(0.0, nbytes(mask), imuls=PHILOX_MULS * counters,
                  imul_rate=imul_rate))
      log('dropout_mask_timing', shape=list(shape), **result)
  return result


# (shape, dtype, groups, timed): the flagship's two channel counts,
# float32, 16 groups, and an H x W that is no multiple of 8 (the kernel's
# scalar path). Phase 14 checks the 256-wide UNet's C = 256 and 512 (its up
# blocks; 8 vectors a thread) at the end of the run, so that the draws of
# the phases before it stay as they were.
GN_CASES = (((EVAL_BATCH, 128, 32, 32), torch.bfloat16, 32, True),
            ((EVAL_BATCH, 256, 32, 32), torch.bfloat16, 32, True),
            ((8, 128, 32, 32), torch.float32, 32, False),
            ((4, 48, 16, 16), torch.bfloat16, 16, False),
            ((3, 48, 5, 7), torch.float32, 16, False))
IN32_GN_CASES = (((EVAL_BATCH, 256, 32, 32), torch.bfloat16, 32, True),
                 ((EVAL_BATCH, 512, 32, 32), torch.bfloat16, 32, True))


def check_gn_swish(dev, gen, sfu_rate, cases=GN_CASES):
  """K8 against `gn_swish_plain` on `cases`. The timed ones are timed (one
  launch and back to back) beside the plain version and the unfused path's
  two calls, F.silu(F.group_norm(...)) (no single PyTorch call computes
  the function). The statistics it writes for the backward must leave the
  output as it was and agree with `group_stats` (GN_STATS_RTOL). Returns the
  timed results."""
  from mulan_tpu_torch.ops.groupnorm_swish import (gn_swish_fwd,
                                                   gn_swish_plain)
  results = []
  for shape, dtype, groups, timed_case in cases:
    c = shape[1]
    x = (2 * torch.randn(shape, generator=gen, device=dev) + 0.5).to(dtype)
    w = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
    b = 0.1 * torch.randn(c, generator=gen, device=dev)
    out = gn_swish_fwd(x, w, b, groups)
    out_st, stats = gn_swish_fwd(x, w, b, groups, 1e-6, True)
    torch.cuda.synchronize()
    ref = gn_swish_plain(x, w, b, groups)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    # Writing the statistics leaves the output as it was.
    assert torch.equal(out, out_st), (shape, dtype)
    stats_err = stats_errors(stats, x, groups)
    rtol, atol = GN_TOL[dtype]
    diff = (out.float() - ref.float()).abs()
    excess = (diff - rtol * ref.float().abs()).max().item()
    result = dict(max_abs_err=diff.max().item(), max_excess_over_rtol=excess,
                  **stats_err)
    if timed_case:
      wl, bl = w.to(dtype), b.to(dtype)
      result.update(
          ms=cuda_ms(lambda: gn_swish_fwd(x, w, b, groups)),
          plain_ms=cuda_ms(lambda: gn_swish_plain(x, w, b, groups)),
          library_ms=None,
          unfused_pair_ms=cuda_ms(lambda: F.silu(F.group_norm(
              x, groups, wl, bl, 1e-6))),
          back_to_back_ms=back_to_back_ms(
              lambda: gn_swish_fwd(x, w, b, groups)),
          # ~6 float32 operations, an exp2 and a reciprocal an element.
          **bound(6.0 * x.numel(), nbytes(x, w, b, out),
                  exps=2.0 * x.numel(), sfu_rate=sfu_rate))
    log('gn_swish', shape=list(shape), dtype=str(dtype), groups=groups,
        rtol=rtol, atol=atol, **result)
    assert excess <= atol, (shape, dtype, result)
    assert max(stats_err.values()) <= GN_STATS_RTOL, (shape, dtype, result)
    if timed_case:
      results.append(result)
  return results


def stats_errors(stats, x, groups: int) -> dict:
  """K8's (B, G, 2) statistics against `group_stats` of x, as GN_STATS_RTOL
  holds them: the means' error over max |x|, rstd's relative error."""
  from mulan_tpu_torch.ops.groupnorm_swish import group_stats
  want = group_stats(x, groups, 1e-6)
  return dict(
      mean_err_over_max_x=((stats[..., 0] - want[..., 0]).abs().max()
                           / x.float().abs().max()).item(),
      rstd_rel_err=((stats[..., 1] - want[..., 1]).abs()
                    / want[..., 1]).max().item())


def check_gn_swish_bwd(dev, gen, sfu_rate, cases=GN_CASES):
  """K8's backward against `gn_swish_bwd_plain` on `cases`, with the
  statistics K8's forward writes (as under autograd; held against
  `group_stats`): dx elementwise and dweight, dbias by their max-abs (see
  GN_BWD_DX_TOL), through the wrapper (the design `bwd_design` picks) and,
  where that is the ring, through the registers design's C entry point
  too. Each design runs twice and must give the same bits (dweight and
  dbias are summed over the batch in a fixed order). The timed cases are
  timed (one launch, back to back, the host's time a call, the C call
  alone, and the registers design's C call where the ring is picked)
  beside the plain version and the backward of the unfused pair
  F.silu(F.group_norm(...)) in bf16 (forward and backward minus forward;
  no single PyTorch call computes the function). Returns their results."""
  from mulan_tpu_torch.ops import _build
  from mulan_tpu_torch.ops.groupnorm_swish import (_counters, bwd_design,
                                                   gn_swish_bwd,
                                                   gn_swish_bwd_plain,
                                                   gn_swish_fwd)
  lib = _build.load_library()
  stream = torch.cuda.current_stream(dev).cuda_stream
  results = []
  for shape, dtype, groups, timed_case in cases:
    c = shape[1]
    x = (2 * torch.randn(shape, generator=gen, device=dev) + 0.5).to(dtype)
    dy = torch.randn(shape, generator=gen, device=dev).to(dtype)
    w = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
    b = 0.1 * torch.randn(c, generator=gen, device=dev)
    _, stats = gn_swish_fwd(x, w, b, groups, 1e-6, True)
    stats_err = stats_errors(stats, x, groups)
    assert max(stats_err.values()) <= GN_STATS_RTOL, (shape, dtype, stats_err)
    design = bwd_design(shape, dtype, groups)
    ref = gn_swish_bwd_plain(x, w, b, dy, groups)
    rtol, atol_frac = GN_BWD_DX_TOL[dtype]
    want = ref[0].float()

    def c_call(entry):
      """A launch of the C entry point `entry` with the wrapper's arguments
      on these inputs, and the (dx, dweight, dbias) it writes."""
      outs = (torch.empty_like(x), torch.empty((2, *shape[:2]), device=dev),
              torch.empty_like(w), torch.empty_like(b))
      args = (x.data_ptr(), dy.data_ptr(), w.data_ptr(), b.data_ptr(),
              stats.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
              _counters(dev, stream, groups).data_ptr(), outs[2].data_ptr(),
              outs[3].data_ptr(), shape[0], c, shape[2] * shape[3], groups,
              int(dtype == torch.bfloat16), stream)

      def launch(outs=outs):
        assert entry(*args) == 0
      return launch, (outs[0], outs[2], outs[3])
    regs_call, regs_outs = c_call(lib.mulan_gn_swish_bwd_regs)

    def regs_twice():
      regs_call()
      first = tuple(t.clone() for t in regs_outs)
      regs_call()
      return first, regs_outs
    result = dict(design=design, **stats_err)
    for d in ('ring', 'regs') if design == 'ring' else (design,):
      if d == design:
        got = gn_swish_bwd(x, w, b, dy, groups, 1e-6, stats)
        again = gn_swish_bwd(x, w, b, dy, groups, 1e-6, stats)
      else:
        got, again = regs_twice()
      torch.cuda.synchronize()
      dx, dw, db = got
      assert dx.dtype == ref[0].dtype == dtype and dx.shape == x.shape
      assert dw.dtype == db.dtype == torch.float32 and dw.shape == (c,)
      assert all(torch.equal(u, v) for u, v in zip(got, again)), (
          shape, d, 'two runs differ')
      diff = (dx.float() - want).abs()
      dx_excess = ((diff - rtol * want.abs()).max()
                   / want.abs().max()).item()
      errs = dict(dx_excess_over_rtol_frac=dx_excess,
                  dweight_rel_err=rel_err(dw, ref[1]),
                  dbias_rel_err=rel_err(db, ref[2]))
      max_abs = max(diff.max(), (dw - ref[1]).abs().max(),
                    (db - ref[2]).abs().max()).item()
      log('gn_swish_bwd', shape=list(shape), dtype=str(dtype), groups=groups,
          design=d, rtol=rtol, atol_frac=atol_frac,
          sum_rtol=GN_BWD_SUM_RTOL, max_abs_err=max_abs, **errs)
      assert dx_excess <= atol_frac, (shape, dtype, d, errs)
      assert max(errs['dweight_rel_err'], errs['dbias_rel_err']) <= (
          GN_BWD_SUM_RTOL), (shape, dtype, d, errs)
      if d == design:
        first = got
        result.update(max_abs_err=max_abs, **errs)
      elif timed_case:
        result['regs_c_call_back_to_back_ms'] = back_to_back_ms(regs_call)
    if timed_case:
      xg = x.detach().requires_grad_()
      wl, bl = (t.to(dtype).requires_grad_() for t in (w, b))

      def pair_fwd():
        return F.silu(F.group_norm(xg, groups, wl, bl, 1e-6))

      def pair_fwd_bwd():
        return torch.autograd.grad(pair_fwd(), (xg, wl, bl), dy)

      def run():
        return gn_swish_bwd(x, w, b, dy, groups, 1e-6, stats)
      design_call, design_outs = c_call(
          {'ring': lib.mulan_gn_swish_bwd,
           'regs': lib.mulan_gn_swish_bwd_regs}[design])
      result.update(
          ms=cuda_ms(run), back_to_back_ms=back_to_back_ms(run),
          host_ms=host_ms(run), c_call_ms=cuda_ms(design_call),
          c_call_back_to_back_ms=back_to_back_ms(design_call),
          plain_ms=cuda_ms(lambda: gn_swish_bwd_plain(x, w, b, dy, groups)),
          library_ms=None,
          unfused_pair_bwd_ms=cuda_ms(pair_fwd_bwd) - cuda_ms(pair_fwd),
          # x and dy read and dx written once; ~20 float32 operations, an
          # exp2 and a reciprocal an element.
          **bound(20.0 * x.numel(), nbytes(x, dy, w, b, dx, dw, db),
                  exps=2.0 * x.numel(), sfu_rate=sfu_rate))
      assert torch.equal(design_outs[0], first[0]), (
          shape, 'the C call differs')
      log('gn_swish_bwd_timing', shape=list(shape), dtype=str(dtype),
          groups=groups, **result)
      results.append(result)
  return results


def check_mask_batch(dev, cfg, imul_rate):
  """K7: every slot of one launch of the score UNet's masks at the flagship
  shape (67 x (128, 128, 32, 32) bf16) bit-identical to K6 at (seed, site);
  3 bf16 slots of LONG_MASK, whose n % 8 != 0 values leave the slots after
  the first not 16-byte aligned, slot by slot against K6 and against the
  plain version; a float32 batch of such slots against the plain version.
  The flagship launch is timed: one launch, back to back and the host's
  time a call of the wrapper."""
  from mulan_tpu_torch.ops.dropout import (dropout_mask, dropout_mask_batch,
                                           dropout_mask_batch_plain)
  rate = cfg.sm_pdrop
  n_sites = 2 * cfg.sm_n_layer + 3
  shape = (EVAL_BATCH, cfg.sm_n_embd, cfg.image_size, cfg.image_size)
  masks = dropout_mask_batch(1234, 0, n_sites, shape, rate, torch.bfloat16,
                             dev)
  torch.cuda.synchronize()
  max_err, identical = 0.0, True
  for i in range(n_sites):
    one = dropout_mask(1234, i, shape, rate, torch.bfloat16, dev)
    identical &= torch.equal(masks[i], one)
    max_err = max(max_err, (masks[i].float() - one.float()).abs().max().item())
  long = dropout_mask_batch(77, 9, 3, LONG_MASK, rate, torch.bfloat16, dev)
  long_ok = torch.equal(long, dropout_mask_batch_plain(
      77, 9, 3, LONG_MASK, rate, torch.bfloat16, dev)) and all(
          torch.equal(long[i], dropout_mask(77, 9 + i, LONG_MASK, rate,
                                            torch.bfloat16, dev))
          for i in range(3))
  del long
  ragged = dropout_mask_batch(99, 5, 3, (7, 11, 13), rate, torch.float32, dev)
  ragged_ok = torch.equal(ragged, dropout_mask_batch_plain(
      99, 5, 3, (7, 11, 13), rate, torch.float32, dev))
  distinct = not torch.equal(masks[0], masks[1])

  def run():
    return dropout_mask_batch(1234, 0, n_sites, shape, rate, torch.bfloat16,
                              dev)
  counters = n_sites * ((masks[0].numel() + 7) // 8)
  result = dict(
      max_abs_err=max_err, ms=cuda_ms(run), back_to_back_ms=back_to_back_ms(
          run, n=5), host_ms=host_ms(run, calls=20),
      plain_ms=cuda_ms(lambda: dropout_mask_batch_plain(
          1234, 0, n_sites, shape, rate, torch.bfloat16, dev), n=3),
      library_ms=cuda_ms(lambda: torch.empty(
          (n_sites, *shape), dtype=torch.bfloat16,
          device=dev).bernoulli_(1 - rate)),
      **bound(0.0, nbytes(masks), imuls=PHILOX_MULS * counters,
              imul_rate=imul_rate))
  log('dropout_mask_batch', slots=n_sites, shape=list(shape),
      bytes=nbytes(masks), every_slot_equals_k6=identical,
      long_bf16_slots_equal_k6_and_plain=long_ok,
      ragged_f32_equals_plain=ragged_ok, slots_distinct=distinct,
      keep_share=(masks != 0).float().mean().item(), **result)
  assert identical and long_ok and ragged_ok and distinct
  return result


def expected_launches(cfg, path: str, vdm: bool = False) -> dict:
  """Kernel launches per call of `path` for model config cfg, MuLAN's or
  (`vdm`) the baseline VDM's: an ELBO ('eval'), a sampler step ('sample'),
  a train step ('train'), the latent encoder ('encoder', once per ODE
  solve), one RHS evaluation of the ODE likelihood ('ode_rhs': the score
  UNet's forward and its input gradient) or of the ODE sampler
  ('ode_sample_rhs': the forward alone).

  Attention blocks: the middle one of the UNet and of the encoder (the VDM
  has none), plus, with `with_attention`, one after each of the UNet's
  2 n_layer + 1 down and up blocks and each of the encoder's down blocks.
  K8 runs twice in each of the UNet's 2 n_layer + 3 ResNet blocks with
  `fused_gn_swish`. In a train step K8's backward runs once per K8 site,
  and a checkpointed block (remat) runs its forward again in the backward:
  K1 once more per attention block, K8 twice and K6 once more per ResNet
  block. K6 makes a block's mask in the forward and again in the backward;
  with `dropout_mask_batch`, one K7 launch makes the UNet's masks instead
  and the encoder keeps K6. K5 runs once a step where g0 is learned (the
  VDM's schedule and MuLAN's `learnable_nnet`) and never where it is
  pinned or fixed (`poly_fixedend`, `linear`). The encoder UNet (its
  trunk) is there for MuLAN's logits or Gaussian latent with
  `reparam_type` 'true'; the CNN encoder has neither attention nor
  dropout.
  """
  n_unet = 2 * cfg.sm_n_layer + 3
  trunk = not vdm and cfg.reparam_type == 'true' and (
      cfg.encoder == 'unet' or cfg.latent_type == 'gaussian')
  n_enc = cfg.forward_n_layer + 2 if trunk else 0
  unet_attn = 1 + (2 * cfg.sm_n_layer + 1 if cfg.with_attention else 0)
  enc_attn = 1 + (cfg.forward_n_layer if cfg.with_attention
                  else 0) if trunk else 0
  learned_g0 = vdm or cfg.gamma_type == 'learnable_nnet'
  counts = dict.fromkeys(kernel_counters(), 0)
  k8 = 2 * n_unet if cfg.fused_gn_swish else 0
  if path == 'eval':
    counts.update(flash_attention=unet_attn + enc_attn, decoder_logprob=1,
                  gn_swish=k8)
    return counts
  if path in ('sample', 'ode_sample_rhs'):
    counts.update(flash_attention=unet_attn, gn_swish=k8)
    return counts
  if path == 'encoder':
    counts.update(flash_attention=enc_attn)
    return counts
  unet_remat = (n_unet if cfg.remat_blocks else
                (n_unet + 1) // 2 if cfg.remat_alt_blocks else 0)
  if path == 'ode_rhs':
    counts.update(
        flash_attention=unet_attn * (2 if cfg.remat_attn else 1),
        flash_attention_bwd_dkv=unet_attn, flash_attention_bwd_dq=unet_attn,
        gn_swish=k8 + (2 * unet_remat if cfg.fused_gn_swish else 0),
        gn_swish_bwd=k8)
    return counts
  assert path == 'train', path
  n_attn = unet_attn + enc_attn
  enc_remat = n_enc if cfg.remat_blocks else 0
  drop = cfg.sm_pdrop > 0
  batched = drop and cfg.dropout_mask_batch
  counts.update(
      flash_attention=n_attn * (2 if cfg.remat_attn else 1),
      flash_attention_bwd_dkv=n_attn, flash_attention_bwd_dq=n_attn,
      decoder_logprob=1, decoder_logprob_bwd=int(learned_g0),
      dropout_mask=drop * ((0 if batched else 2 * n_unet + unet_remat)
                           + 2 * n_enc + enc_remat),
      dropout_mask_batch=int(batched),
      gn_swish=k8 + (2 * unet_remat if cfg.fused_gn_swish else 0),
      gn_swish_bwd=k8)
  return counts


def times(counts: dict, n: int) -> dict:
  return {k: n * v for k, v in counts.items()}


def timed(fn):
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  out = fn()
  torch.cuda.synchronize()
  return out, time.perf_counter() - t0


def kernel_counters():
  """{JSON name: the wrapper whose `launches` counts that kernel}."""
  from mulan_tpu_torch.ops import decoder_logprob as dec
  from mulan_tpu_torch.ops import dropout
  from mulan_tpu_torch.ops import flash_attention as attn
  from mulan_tpu_torch.ops import groupnorm_swish as gn
  return {'flash_attention': attn.flash_attention,
          'flash_attention_bwd_dkv': attn.flash_attention_bwd_dkv,
          'flash_attention_bwd_dq': attn.flash_attention_bwd_dq,
          'decoder_logprob': dec.decoder_logprob,
          'decoder_logprob_bwd': dec.decoder_logprob_bwd,
          'dropout_mask': dropout.dropout_mask,
          'dropout_mask_batch': dropout.dropout_mask_batch,
          'gn_swish': gn.gn_swish_fwd,
          'gn_swish_bwd': gn.gn_swish_bwd}


def counted(fn, route_totals):
  """(fn(), {kernel: launches during fn}), every count set to 0 first.
  Asserts that every launch of each of the SM90_KERNELS took the 'sm90'
  route (at the flagship's head_dim 128 and at ImageNet32's 256 alike),
  and adds the launches by route to route_totals ({kernel: {route: n}})."""
  counters = kernel_counters()
  for f in counters.values():
    f.launches = 0
    if hasattr(f, 'launches_by_route'):
      f.launches_by_route = dict.fromkeys(f.launches_by_route, 0)
  out = fn()
  torch.cuda.synchronize()
  counts = {name: f.launches for name, f in counters.items()}
  for name, f in counters.items():
    by_route = getattr(f, 'launches_by_route', None)
    if by_route is None:
      continue
    assert sum(by_route.values()) == counts[name], (name, by_route)
    if name in SM90_KERNELS:
      assert by_route['sm90'] == counts[name], (name, by_route)
    total = route_totals.setdefault(name, dict.fromkeys(by_route, 0))
    for r, n in by_route.items():
      total[r] += n
  return out, counts


# Kernel-name substrings -> category, first match wins.
_CATEGORIES = (
    ('K1 flash attention', ('flash_fwd',)),
    ('K2 flash attention dK dV', ('flash_bwd_dkv',)),
    ('K3 flash attention dQ', ('flash_bwd_dq',)),
    ('K4/K5 decoder', ('decoder_logprob',)),
    ('K6/K7 dropout masks', ('dropout_mask',)),
    ('K8 GroupNorm+swish backward', ('gn_swish_bwd',)),
    ('K8 GroupNorm+swish', ('gn_swish',)),
    ('layout transposes', ('nchwToNhwc', 'nhwcToNchw', 'transpose')),
    ('convolutions and GEMMs', ('conv', 'xmma', 'gemm', 'cutlass', 'sm90',
                                'dgrad', 'wgrad', 'implicit', 'nvjet')),
    ('GroupNorm', ('group_norm', 'GroupNorm', 'RowwiseMoments',
                   'ComputeFused', 'compute_stats', 'GammaBeta',
                   'ComputeInternalGradients', 'ComputeBackwardFused')),
    ('optimizer and EMA', ('multi_tensor', 'foreach', 'lerp')),
    ('collectives and FSDP2 copies', ('nccl', 'chunk_cat',
                                      'split_with_sizes')),
    ('concat', ('CatArray',)),
    ('reductions', ('reduce',)),
    ('elementwise', ('elementwise', 'vectorized', 'unrolled')),
)


def profile(fn, n: int = 2):
  """Kernel time of fn() by category over n calls after a warm-up, with the
  device busy share of the span (torch.profiler's CUDA kernel events)."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity
  fn()
  torch.cuda.synchronize()
  with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for _ in range(n):
      fn()
    torch.cuda.synchronize()
    span_us = 1e6 * (time.perf_counter() - t0)
  by_cat, other, count = {}, {}, 0
  for evt in prof.events():
    # Ranges such as the optimizer's `Optimizer.step` annotation also lie on
    # the device's timeline; only kernels and copies count.
    if evt.device_type != DeviceType.CUDA or evt.is_user_annotation:
      continue
    count += 1
    cat = next((c for c, keys in _CATEGORIES
                if any(k in evt.name for k in keys)), 'other')
    us = evt.time_range.elapsed_us()
    by_cat[cat] = by_cat.get(cat, 0.0) + us
    if cat == 'other':
      other[evt.name[:80]] = other.get(evt.name[:80], 0.0) + us
  total = sum(by_cat.values())
  return {'kernels_per_call': count / n,
          'kernel_ms_per_call': total / n / 1e3,
          'busy_share': total / span_us,
          'share': {c: t / total for c, t in
                    sorted(by_cat.items(), key=lambda kv: -kv[1])},
          'other_top': {k: t / total for k, t in
                        sorted(other.items(), key=lambda kv: -kv[1])[:6]}}


@contextlib.contextmanager
def planted_fault(kernel: str):
  """A wrong attention kernel the train-step gates must reject: K1's output
  zeroed on one consumer warpgroup's 64 rows of every 128-row query tile,
  its lse left right ('fwd'); K2's dK replaced by zeros ('dk'); or K3's dQ
  zeroed on one consumer warpgroup's 64 rows of every 128-query tile
  ('dq')."""
  from mulan_tpu_torch.ops import flash_attention as attn
  name = {'fwd': 'flash_attention_fwd', 'dk': 'flash_attention_bwd_dkv',
          'dq': 'flash_attention_bwd_dq'}[kernel]
  real = getattr(attn, name)

  def zero_rows(x):
    rows = torch.arange(x.shape[2], device=x.device) % 128 >= 64
    return x.masked_fill(rows[:, None], 0)

  def faulty(*args, **kwargs):
    out = real(*args, **kwargs)
    if kernel == 'dk':
      dk, dv = out
      return torch.zeros_like(dk), dv
    if kernel == 'fwd' and isinstance(out, tuple):
      o, lse = out
      return zero_rows(o), lse
    return zero_rows(out)
  # K2's and K3's wrappers count on their module names, so their launches
  # go back to the real wrappers' counts, and a counted run sees their
  # routes; K1's counts on `flash_attention`, which stays.
  faulty.launches = 0
  faulty.launches_by_route = dict.fromkeys(attn.ROUTES, 0)
  setattr(attn, name, faulty)
  try:
    yield
  finally:
    setattr(attn, name, real)
    if kernel != 'fwd':
      real.launches += faulty.launches
      for route, n in faulty.launches_by_route.items():
        real.launches_by_route[route] += n


@contextlib.contextmanager
def planted_gn_fault(kind: str):
  """A wrong GroupNorm+swish the fused train-step gates must reject: K8
  launched with half the groups ('half_groups'), or K8's backward with dx
  missing its rstd xhat mean_grp(w g xhat) term ('missing_term')."""
  from mulan_tpu_torch.ops import groupnorm_swish as gn
  name = {'half_groups': 'gn_swish_fwd', 'missing_term': 'gn_swish_bwd'}[kind]
  real = getattr(gn, name)

  def half_groups(x, weight, bias, num_groups, eps=1e-6, stats=False):
    # The statistics of the right groups, as the backward would reduce them.
    out = real(x, weight, bias, num_groups // 2, eps)
    return (out, gn.group_stats(x, num_groups, eps)) if stats else out

  def missing_term(x, weight, bias, dy, num_groups, eps=1e-6, stats=None):
    dx, dweight, dbias = real(x, weight, bias, dy, num_groups, eps, stats)
    xhat, rstd = gn._normalized(x, num_groups, eps)
    w = gn._per_channel(weight, x)
    y = xhat * w + gn._per_channel(bias, x)
    s = torch.sigmoid(y)
    wgx = (w * dy.float() * s * (1 + y * (1 - s)) * xhat).reshape(
        x.shape[0], num_groups, -1)
    term = rstd * xhat.reshape(wgx.shape) * wgx.mean(dim=-1, keepdim=True)
    return (dx.float() + term.reshape(x.shape)).to(x.dtype), dweight, dbias
  fault = half_groups if kind == 'half_groups' else missing_term
  fault.launches = 0  # the real wrapper counts on the module's name
  setattr(gn, name, fault)
  try:
    yield
  finally:
    setattr(gn, name, real)


@contextlib.contextmanager
def no_plain_gn_bwd_on_cuda():
  """Makes a plain float32 GroupNorm+swish backward on a CUDA tensor raise:
  on the kernels' path every such backward is K8's backward kernel."""
  from mulan_tpu_torch.ops import groupnorm_swish as gn
  real = gn.gn_swish_bwd_plain

  def guarded(x, *args, **kwargs):
    assert not x.is_cuda, 'a plain GroupNorm+swish backward ran on the card'
    return real(x, *args, **kwargs)
  gn.gn_swish_bwd_plain = guarded
  try:
    yield
  finally:
    gn.gn_swish_bwd_plain = real


def cosine(a, b) -> float:
  return (torch.dot(a, b) / (a.norm() * b.norm())).item()


def leaf_cosines(got, want, names=None):
  """{leaf: cosine} over `names` (default: all), leaving out the key
  biases: a key bias shifts every logit of a row by the same q.b, which the
  softmax ignores, so its gradient is 0 up to rounding."""
  return {n: cosine(got[n], want[n]) for n in (names or got)
          if n.split('.')[-2:] != ['k', 'bias']}


def block_grads(block, inputs, dy, use_kernels):
  """{leaf: gradient} of one block (the leaves that require grad), and its
  input's, for its recorded positional inputs (x, then a ResNet block's
  cond, dropout_seed and dropout_mask) and output cotangent dy, with the
  kernels on or off."""
  flags = {m: m.use_kernels for m in block.modules()
           if hasattr(m, 'use_kernels')}
  for m in flags:
    m.use_kernels = use_kernels
  block.zero_grad(set_to_none=True)
  x = inputs[0].clone().requires_grad_()
  torch.autograd.backward(block(x, *inputs[1:]), dy)
  grads = {n: p.grad.flatten().double() for n, p in block.named_parameters()
           if p.grad is not None}
  grads['input'] = x.grad.flatten().double()
  block.zero_grad(set_to_none=True)
  for m, flag in flags.items():
    m.use_kernels = flag
  return grads


def grad_part(name: str) -> str:
  """The part of MuLAN a parameter belongs to."""
  top, block = name.split('.')[:2]
  if top == 'score_model':
    part = next((p for p in ('down_block', 'mid', 'up_block')
                 if block.startswith(p)), 'in_out')
    return f'unet.{part}'
  return top


def step_grads(ex, m, batch, noise):
  """(bpd, {leaf: gradient}) of one train-mode loss of model m."""
  m.zero_grad(set_to_none=True)
  bpd, _ = ex.loss_fn(m, batch, train=True, noise=noise)
  bpd.backward()
  grads = {n: p.grad.flatten().double() for n, p in m.named_parameters()}
  m.zero_grad(set_to_none=True)
  return bpd.item(), grads


def capture_io(blocks: dict):
  """Forward hooks that record each block's positional inputs (detached)
  and its output's cotangent into the returned dict; and the hooks."""
  captured = {}

  def capture(name):
    def hook(module, inputs, output):
      inputs = tuple(a.detach() if torch.is_tensor(a) else a for a in inputs)
      output.register_hook(lambda g: captured.__setitem__(
          name, (inputs, g.detach())))
    return hook
  return captured, [b.register_forward_hook(capture(n))
                    for n, b in blocks.items()]


def compare_train_step(ex, model, build_plain, batch, noise, tag='train',
                       with_f32=True, planted=('dk', 'dq')):
  """One train step's loss and gradients through `model` (the kernels) and
  its plain twin on the same batch, noise and dropout masks, with the gates
  described at ATTN_LEAF_COS_MIN; the same gates must reject the step with
  each fault of `planted` (`planted_fault`'s kinds). With
  `with_f32`, the cosines to a float32 twin's gradient, per part of the
  model, are reported. Logs as `<tag>_...`."""

  blocks = {'unet': model.score_model.mid_attn_1,
            'encoder': model.encoder_model.trunk.mid_attn_1}
  captured, hooks = capture_io(blocks)
  bpds, grads = {}, {}
  bpds['kernels'], grads['kernels'] = step_grads(ex, model, batch, noise)
  for h in hooks:
    h.remove()
  twins = (('plain', {}), ('f32', {'compute_dtype': 'float32'}))
  for name, overrides in twins[:2 if with_f32 else 1]:
    other = build_plain(**overrides)
    bpds[name], grads[name] = step_grads(ex, other, batch, noise)
    del other

  unet_attn = [n for n in grads['kernels']
               if n.startswith('score_model.mid_attn_1.')]

  def alone(use_kernels):
    return {b: block_grads(blocks[b], *captured[b], use_kernels)
            for b in blocks}
  alone_plain = alone(False)

  def gates(step_grads, alone_grads):
    """(leaf cosines of the step's UNet attention block, of each block
    alone): kernels (or a fault) against plain."""
    return (leaf_cosines(step_grads, grads['plain'], unet_attn),
            {b: leaf_cosines(alone_grads[b], alone_plain[b])
             for b in blocks})

  def passes(step_cos, alone_cos):
    return (all(c >= ATTN_LEAF_COS_MIN for c in step_cos.values())
            and all(c >= ATTN_ALONE_COS_MIN for cos in alone_cos.values()
                    for c in cos.values()))

  step_cos, alone_cos = gates(grads['kernels'], alone(True))
  faults, fault_delta = {}, {}
  for kernel in planted:
    with planted_fault(kernel):
      bpd, fault_grads = step_grads(ex, model, batch, noise)
      faults[kernel] = gates(fault_grads, alone(True))
    fault_delta[kernel] = abs(bpd - bpds['plain'])
  whole = {k: torch.cat(list(g.values())) for k, g in grads.items()}
  norm_rel = abs(whole['kernels'].norm().item()
                 / whole['plain'].norm().item() - 1)
  to_f32 = {}
  if with_f32:
    to_f32['whole_cos_to_f32'] = {k: cosine(whole[k], whole['f32'])
                                  for k in ('kernels', 'plain')}
  log(f'{tag}_kernels_vs_plain', bpd=bpds,
      abs_delta=abs(bpds['kernels'] - bpds['plain']), tol=TRAIN_BPD_TOL,
      grad_norm_rel_diff=norm_rel, norm_rtol=GRAD_NORM_RTOL,
      unet_attn_leaf_cos_min=min(step_cos.values()),
      tol_leaf=ATTN_LEAF_COS_MIN,
      alone_leaf_cos_min={b: min(c.values()) for b, c in alone_cos.items()},
      tol_alone=ATTN_ALONE_COS_MIN,
      planted_faults_rejected={k: not passes(*c) for k, c in faults.items()},
      fault_unet_attn_leaf_cos_min={k: min(c[0].values())
                                    for k, c in faults.items()},
      fault_alone_leaf_cos_min={k: {b: min(cos.values())
                                    for b, cos in c[1].items()}
                                for k, c in faults.items()},
      fault_abs_delta=fault_delta,
      whole_cos=cosine(whole['kernels'], whole['plain']), **to_f32)
  log(f'{tag}_attn_leaf_cosines', **{n.split('mid_attn_1.')[1]: round(c, 6)
                                     for n, c in step_cos.items()})

  # Where the bf16 gradients part from the float32 one (or, without it,
  # from each other), per part of MuLAN.
  ref = 'f32' if with_f32 else 'plain'
  pairs = ((('kernels', 'f32'), ('plain', 'f32'), ('kernels', 'plain'))
           if with_f32 else (('kernels', 'plain'),))
  parts = {}
  for n in grads[ref]:
    parts.setdefault(grad_part(n), []).append(n)
  total = whole[ref].square().sum().item()
  log(f'{tag}_grad_parts', **{part: dict(
      **{f'share_of_{ref}_norm2': round(sum(
          grads[ref][n].square().sum().item() for n in ns) / total, 6)},
      **{f'cos_{a}_{b}': round(cosine(
          *(torch.cat([grads[k][n] for n in ns]) for k in (a, b))), 6)
         for a, b in pairs})
                              for part, ns in parts.items()})

  assert abs(bpds['kernels'] - bpds['plain']) <= TRAIN_BPD_TOL
  assert norm_rel <= GRAD_NORM_RTOL, norm_rel
  assert passes(step_cos, alone_cos), (step_cos, alone_cos)
  for kernel, cos in faults.items():
    assert not passes(*cos), (f'a planted {kernel} fault passed', cos)


def compare_fused_step(ex, model, build_plain, batch, noise):
  """One fused train step (`fused_gn_swish` and `dropout_mask_batch`)
  through `model` (the kernels) and its plain twin on the same batch, noise
  and masks, with the gates described at GN_LEAF_COS_MIN; the same gates
  must reject the step with each planted K8 fault (`planted_gn_fault`)."""
  blocks = {n: model.score_model.get_submodule(n)
            for n in ('mid_block_1', 'up_block_0')}
  captured, hooks = capture_io(blocks)
  bpd_k, grads_k = step_grads(ex, model, batch, noise)
  for h in hooks:
    h.remove()
  plain = build_plain()
  bpd_p, grads_p = step_grads(ex, plain, batch, noise)
  del plain
  gn_leaves = [n for n in grads_k if n.startswith('score_model.')
               and '_block_' in n and '.GroupNormF32_' in n]
  assert len(gn_leaves) == 4 * (2 * ex.config.model.sm_n_layer + 3)

  def alone(use_kernels):
    return {b: block_grads(blocks[b], *captured[b], use_kernels)
            for b in blocks}
  alone_plain = alone(False)

  def gates(step, alone_grads):
    return (leaf_cosines(step, grads_p, gn_leaves),
            {b: leaf_cosines(alone_grads[b], alone_plain[b]) for b in blocks})

  def passes(step_cos, alone_cos):
    return (all(c >= GN_LEAF_COS_MIN for c in step_cos.values())
            and all(c >= GN_ALONE_COS_MIN for cos in alone_cos.values()
                    for c in cos.values()))

  step_cos, alone_cos = gates(grads_k, alone(True))
  faults = {}
  for kind in ('half_groups', 'missing_term'):
    with planted_gn_fault(kind):
      fault_bpd, fault_grads = step_grads(ex, model, batch, noise)
      fault_step, fault_alone = gates(fault_grads, alone(True))
    faults[kind] = dict(
        bpd=fault_bpd, gn_leaf_cos_min=min(fault_step.values()),
        alone_leaf_cos_min={b: min(c.values())
                            for b, c in fault_alone.items()},
        fails_step_gate=not passes(fault_step, {}),
        fails_alone_gate=not passes({}, fault_alone),
        rejected=not passes(fault_step, fault_alone))
  whole_k, whole_p = (torch.cat(list(g.values())) for g in (grads_k, grads_p))
  norm_rel = abs(whole_k.norm().item() / whole_p.norm().item() - 1)
  worst = min(step_cos, key=step_cos.get)
  log('fused_train_kernels_vs_plain', bpd_kernels=bpd_k, bpd_plain=bpd_p,
      abs_delta=abs(bpd_k - bpd_p), tol=TRAIN_BPD_TOL,
      grad_norm_rel_diff=norm_rel, norm_rtol=GRAD_NORM_RTOL,
      gn_leaves=len(gn_leaves), gn_leaf_cos_min=step_cos[worst],
      gn_leaf_cos_min_at=worst,
      gn_leaf_cos_median=statistics.median(step_cos.values()),
      tol_leaf=GN_LEAF_COS_MIN,
      alone_leaf_cos_min={b: min(c.values()) for b, c in alone_cos.items()},
      tol_alone=GN_ALONE_COS_MIN, whole_cos=cosine(whole_k, whole_p),
      planted_faults=faults)
  assert abs(bpd_k - bpd_p) <= TRAIN_BPD_TOL
  assert norm_rel <= GRAD_NORM_RTOL, norm_rel
  assert passes(step_cos, alone_cos), (step_cos, alone_cos)
  for kind, fault in faults.items():
    assert fault['rejected'], (f'a planted {kind} K8 fault passed', fault)


def compare_remat(ex, cfg, state, batch, noise, dev, route_totals):
  """One train step with the kernels under each remat mode, on the same
  batch, noise and dropout seed, against 'none' (and 'none' against a
  second run of itself, the run-to-run spread); launches per mode from
  `expected_launches` (by route into route_totals, as `counted`), and the
  step's peak memory above what was held before it."""
  from mulan_tpu_torch.models import build_model
  runs, counts = {}, {}
  for name, mode in (('none', 'none'), ('all', 'all'), ('attn', 'attn'),
                     ('alt', 'alt'), ('none_again', 'none')):
    mcfg = dataclasses.replace(cfg, remat=mode)
    m = build_model('mulan_velocity', mcfg, device=dev, state=state)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (bpd, grads), c = counted(lambda: step_grads(ex, m, batch, noise),
                              route_totals)
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    del m
    whole = torch.cat(list(grads.values()))
    parts = {}
    for n, g in grads.items():
      parts.setdefault(grad_part(n), []).append(g)
    runs[name] = (bpd, whole, {p: torch.cat(gs) for p, gs in parts.items()},
                  peak_gb)
    del grads
    want = expected_launches(mcfg, 'train')
    log('remat_step', mode=name, bpd=bpd, peak_above_start_gb=peak_gb,
        launches=c, expected=want)
    assert c == want, (name, c, want)
    counts[name] = c
  bpd0, whole0, parts0, _ = runs['none']
  result = {}
  for name, (bpd, whole, parts, peak_gb) in runs.items():
    if name == 'none':
      continue
    result[name] = dict(
        loss_equal=bpd == bpd0, whole_cos=cosine(whole, whole0),
        norm_rel_diff=abs(whole.norm().item() / whole0.norm().item() - 1),
        part_cos={p: round(cosine(g, parts0[p]), 7) for p, g in parts.items()},
        peak_above_start_gb=peak_gb)
  log('remat_vs_none', tol_cos=REMAT_COS_MIN, norm_rtol=GRAD_NORM_RTOL,
      peak_above_start_gb_none=runs['none'][3], **result)
  for name, r in result.items():
    assert r['loss_equal'], (name, r)
    assert r['whole_cos'] >= REMAT_COS_MIN, (name, r)
    assert r['norm_rel_diff'] <= GRAD_NORM_RTOL, (name, r)
  return counts


def check_dense_kernels(dev, gen, cfg, sfu_rate):
  """K1 at the dense VLB's score-UNet and encoder shapes (timed) and the
  in-training sampler's, and K4 at the dense chunk's rows, against their
  plain versions with the tolerances above. Returns ({shape: K1 result},
  {g0 case: K4 result})."""
  k1 = {'x'.join(map(str, shape)): attention_case(
      dev, gen, shape, torch.bfloat16, ATTN_TOL_BF16, timed_case)
        for shape, timed_case in ((DENSE_ATTN, True),
                                  (DENSE_ENCODER_ATTN, True),
                                  (WORKDIR_SAMPLER_ATTN, False))}
  per_pixel, gamma_min = check_decoder(dev, gen, cfg, sfu_rate,
                                       batch=DENSE_ROWS)
  return k1, {'per_pixel': per_pixel, 'gamma_min': gamma_min}


def state_tensors(state) -> dict:
  """Every tensor of a TrainState by name: params, EMA, the AdamW moments
  and steps, and its step and count."""
  out = {f'params/{k}': v for k, v in state.params.items()}
  out.update({f'ema/{k}': v for k, v in state.ema_params.items()})
  for i, slots in state.optimizer.adamw.state_dict()['state'].items():
    out.update({f'adamw/{i}/{k}': v for k, v in slots.items()})
  out['step'] = torch.tensor(state.step)
  out['count'] = torch.tensor(state.optimizer.count)
  return out


def run_workdir_train(train_cfg, state, dev, route_totals, workdir):
  """`Experiment.train_and_evaluate` in `workdir`: WORKDIR_STEPS steps at
  batch 128, a checkpoint every 2 (2 kept), an evaluation of 2 batches and
  a sample grid (T cut to SAMPLE_STEPS) after step 1, every 2 steps and at
  the last. Then a fresh Experiment restored from the last checkpoint must
  hold the run's state bit for bit; step 3 run again from the step-2
  checkpoint on the same batch and step key must give its bpd; the last
  checkpoint exported to a `ckpt-N.flax` and read by EvalExperiment must
  give the run's EMA bit for bit. Returns (launches, the EvalExperiment,
  the `ckpt-N.flax`'s path)."""
  from mulan_tpu_torch import compat, configs
  from mulan_tpu_torch.evals.harness import EvalExperiment
  from mulan_tpu_torch.train import checkpoint as ckpt_lib
  from mulan_tpu_torch.train.loop import Experiment
  cfg_w = configs.replace(train_cfg, training={
      'num_steps_train': WORKDIR_STEPS, 'steps_per_save': 2,
      'steps_per_eval': 2, 'num_steps_eval': 2, 'steps_per_logging': 1})
  cfg = cfg_w.model
  ex = Experiment(cfg_w, device=dev, state=state)
  ex.draw_samples = functools.partial(ex.draw_samples, T=SAMPLE_STEPS)
  steps = []
  train_step = ex.train_step

  def recording_step(batch, noise=None):
    steps.append((batch, train_step(batch, noise)))
    return steps[-1][1]
  ex.train_step = recording_step
  save_secs = []
  save = ckpt_lib.CheckpointManager.save

  def timed_save(self, step, st):
    path, secs = timed(lambda: save(self, step, st))
    save_secs.append(secs)
    return path
  ckpt_lib.CheckpointManager.save = timed_save
  try:
    (_, secs), counts = counted(lambda: timed(
        lambda: ex.train_and_evaluate(workdir, max_to_keep=2)), route_totals)
  finally:
    ckpt_lib.CheckpointManager.save = save
  n_evals = 3  # after step 1, at step 2 and at step 4
  want = times(expected_launches(cfg, 'train'), WORKDIR_STEPS)
  for path, n in (('eval', n_evals * 2), ('sample', n_evals * SAMPLE_STEPS)):
    for k, v in times(expected_launches(cfg, path), n).items():
      want[k] += v
  ckpt_dir = os.path.join(workdir, 'checkpoints')
  mngr = ckpt_lib.CheckpointManager(ckpt_dir)
  log('workdir_train', steps=WORKDIR_STEPS,
      batch=cfg_w.training.batch_size_train, seconds=secs,
      bpd=[round(s['bpd'].item(), 4) for _, s in steps],
      checkpoints=mngr.steps(), save_s=save_secs, launches=counts)
  assert counts == want, (counts, want)
  assert mngr.steps() == [2, 4] and len(save_secs) == 2, mngr.steps()
  assert all(math.isfinite(s['bpd'].item()) for _, s in steps)

  fresh = Experiment(cfg_w, device=dev, state=state)
  _, restore_s = timed(lambda: mngr.restore(fresh.state))
  got, saved = state_tensors(fresh.state), state_tensors(ex.state)
  assert got.keys() == saved.keys()
  unequal = [k for k, v in saved.items() if not torch.equal(got[k], v)]
  assert not unequal, unequal[:8]
  mngr.restore(fresh.state, 2)
  again = fresh.train_step(steps[2][0])['bpd'].item()
  first = steps[2][1]['bpd'].item()
  del fresh

  path, export_s = timed(lambda: compat.export_reference_checkpoint(
      ckpt_dir, os.path.join(workdir, 'reference')))
  ev, import_s = timed(lambda: EvalExperiment(cfg_w, path, device=dev))
  ema_equal = all(torch.equal(ev.state.ema_params[k], v)
                  for k, v in ex.state.ema_params.items())
  log('checkpoints', tensors=len(saved), restored_bit_exact=True,
      step3_bpd=first, step3_bpd_resumed=again,
      step3_abs_delta=abs(again - first), tol=TRAIN_BPD_TOL,
      save_s=save_secs, restore_s=restore_s, export_s=export_s,
      import_s=import_s, checkpoint_bytes=os.path.getsize(mngr.path(4)),
      flax_bytes=os.path.getsize(path), flax_ema_bit_exact=ema_equal)
  assert abs(again - first) <= TRAIN_BPD_TOL, (again, first)
  assert ev.checkpoint_step == WORKDIR_STEPS and ema_equal
  return counts, ev, path


def run_dense_eval(ev, images, gen, dev, route_totals):
  """`eval_bpd_dense` of the EvalExperiment's EMA model over DENSE_IMAGES
  images at DENSE_T times (chunks of DENSE_ROWS rows): K1 2 and K4 1 a
  chunk, the encoder once a chunk on its images; rows per second on a
  second run; the dense minus the sparse bpd on the same images; one
  chunk's bpd (the mean of its images') kernels against plain on the same
  noise, within BPD_TOL. Returns the launches."""
  from mulan_tpu_torch.evals import vlb
  from mulan_tpu_torch.models import build_model, latents
  model = ev.state.ema_model
  cfg = model.config
  sizes = []
  hook = model.encoder_model.register_forward_hook(
      lambda m, args, out: sizes.append(args[0].shape[0]))
  batches = [images[:DENSE_IMAGES]]

  def dense():
    return vlb.eval_bpd_dense(model, batches, n_timesteps=DENSE_T,
                              generator=gen)
  (bpd, secs), counts = counted(lambda: timed(dense), route_totals)
  hook.remove()
  chunks = DENSE_IMAGES * DENSE_T // DENSE_ROWS
  assert sizes == [DENSE_ROWS // DENSE_T] * chunks, sizes
  assert counts == times(expected_launches(cfg, 'eval'), chunks), counts
  assert math.isfinite(bpd), bpd
  _, warm_secs = timed(dense)
  rows_per_s = DENSE_IMAGES * DENSE_T / warm_secs
  sparse = vlb.eval_bpd_sparse(model, batches, generator=gen)

  n_img = DENSE_ROWS // DENSE_T
  u = torch.rand((n_img,), generator=gen, device=dev)
  eps = torch.randn((DENSE_ROWS, *cfg.image_shape), generator=gen,
                    device=dev)
  topk = latents.gamma_variates(cfg.latent_k, (DENSE_ROWS, cfg.latent_size),
                                generator=gen, device=dev)
  plain = build_model('mulan_velocity',
                      dataclasses.replace(cfg, use_kernels=False),
                      device=dev, state=model.state_dict())
  with torch.inference_mode():
    got, want = (vlb.dense_chunk_bpd(m, images[:n_img], DENSE_T, u=u,
                                     eps0=eps, eps=eps, latent_noise=topk)
                 for m in (model, plain))
  delta = abs(got.mean() - want.mean()).item()
  log('dense_eval', images=DENSE_IMAGES, n_timesteps=DENSE_T,
      rows_per_chunk=DENSE_ROWS, bpd=bpd, seconds_first=secs,
      seconds=warm_secs, rows_per_s=rows_per_s,
      images_per_s=DENSE_IMAGES / warm_secs,
      sweep_10k_images_s=10_000 * DENSE_T / rows_per_s,
      sparse_bpd=sparse, dense_minus_sparse=bpd - sparse,
      chunk_bpd_kernels=got.tolist(), chunk_bpd_plain=want.tolist(),
      chunk_abs_delta=delta, tol=BPD_TOL,
      per_image_max_abs_delta=(got - want).abs().max().item(),
      encoder_calls=sizes,
      launches=counts)
  assert delta <= BPD_TOL, delta
  return counts


def ode_solve_launches(cfg, nfe: int, solves: int = 1,
                       vdm: bool = False) -> dict:
  """Launches of `solves` ODE-likelihood solves of `nfe` RHS evaluations
  each: the encoder once a solve (MuLAN's), the score UNet's forward and
  input gradient once an evaluation."""
  want = times(expected_launches(cfg, 'ode_rhs', vdm), nfe)
  for k, v in times(expected_launches(cfg, 'encoder', vdm), solves).items():
    want[k] += v
  return want


def check_ode_solver(dev):
  """DoPri5 and RK4 on the card against the same solves on the CPU, on
  closed-form right-hand sides: the exponential, reverse-time and nonlinear
  cases of the CPU tests, and the nonlinear RHS on a state of the ODE
  likelihood's shape (ODE_ROWS x 3073). Equal accepted and rejected steps
  and RHS evaluations, y within ODE_SOLVER_RTOL."""
  from mulan_tpu_torch.ops import ode
  cpu_gen = torch.Generator().manual_seed(SEED)
  a = torch.linspace(0.5, 1.5, 8)
  w = torch.rand((ODE_ROWS, 3073), generator=cpu_gen) + 0.5
  w0 = 2 * torch.rand((ODE_ROWS, 3073), generator=cpu_gen) - 1

  def nonlinear(c):
    return lambda t, y: torch.sin(3 * t) * y - 0.5 * y ** 3 + c.to(y.device)
  cases = (('exponential', lambda t, y: -y, torch.ones(4), 0.0, 1.0,
            dict(rtol=1e-6, atol=1e-8)),
           ('reverse_time', lambda t, y: y, torch.full((3,), 2.0), 1.0, 0.0,
            dict(rtol=1e-6, atol=1e-8)),
           ('nonlinear', nonlinear(a), torch.linspace(-1, 1, 8), 0.0, 1.0,
            dict(rtol=1e-5, atol=1e-5)),
           ('likelihood_state', nonlinear(w), w0, 0.0, 1.0,
            dict(rtol=1e-3, atol=1e-3)))
  results = {}
  for name, rhs, y0, t0, t1, kw in cases:
    for solver in (ode.odeint_dopri5, ode.odeint_rk4):
      cpu = solver(rhs, y0, t0, t1, **kw)
      gpu, secs = timed(lambda: solver(rhs, y0.to(dev), t0, t1, **kw))
      counts = [s[1:] for s in (cpu, gpu)]
      err = rel_err(gpu.y.cpu(), cpu.y)
      results[f'{name}/{solver.__name__}'] = dict(
          steps_rejected_nfe_success=counts[1], cpu=counts[0], rel_err=err,
          seconds=secs)
      assert counts[0] == counts[1] and err <= ODE_SOLVER_RTOL, (
          name, solver.__name__, counts, err)
  log('ode_solver', rtol=ODE_SOLVER_RTOL, **results)


def ode_rhs(model, images, u, probe):
  """The ODE likelihood's RHS for `images` with the dequantization draw u
  and the probe, and its initial state (a solver that records them)."""
  from mulan_tpu_torch.evals import nll_ode
  from mulan_tpu_torch.ops import ode
  got = {}

  def odeint(func, y0, t0, t1, **unused):
    got.update(func=func, y0=y0)
    return ode.ODESolution(y0, 0, 0, 0, True)
  nll_ode.make_ode_likelihood_fn(model, odeint=odeint)(images, u=u,
                                                       probe=probe)
  return got['func'], got['y0']


def ode_noise(cfg, gen, dev):
  """A truncated-normal dequantization draw and a Rademacher probe for
  ODE_ROWS images."""
  shape = (ODE_ROWS, *cfg.image_shape)
  u = torch.nn.init.trunc_normal_(torch.empty(shape, device=dev), a=-3.0,
                                  b=3.0, generator=gen)
  probe = (2 * torch.randint(0, 2, shape, generator=gen, device=dev)
           - 1).float()
  return u, probe


def ode_bpd(cfg, log_p, aux) -> float:
  """bpd of one importance sample with 'tn' dequantization."""
  from mulan_tpu_torch.evals import nll_ode
  return ((-log_p + aux).mean().item() / (cfg.n_pixels * math.log(2.0))
          + nll_ode.bpd_offset('tn', 1, cfg.gamma_min))


def compare_ode_nll(cfg, state, batch, gen, dev, route_totals):
  """One RK4 solve of the ODE likelihood (ODE_RK4_STEPS steps, 128 rows)
  through the kernels, through the plain versions and through a float32
  plain twin, on the same dequantization draw and probe, with the gates
  described at ODE_BPD_NOISE. Then one RHS evaluation: its ms and peak
  memory, and the score UNet's attention block alone at the input and
  output cotangent it recorded there: every leaf's gradient and the
  input's, kernels against plain, to ATTN_ALONE_COS_MIN, which planted
  faults in K2 and K3 must fail. Returns (the launches of the kernels'
  solve, the kernels' model, its RHS and initial state)."""
  from mulan_tpu_torch.evals import nll_ode
  from mulan_tpu_torch.models import build_model
  from mulan_tpu_torch.ops import ode
  u, probe = ode_noise(cfg, gen, dev)
  rk4 = functools.partial(ode.odeint_rk4, num_steps=ODE_RK4_STEPS)
  to_bpd = 1.0 / (cfg.n_pixels * math.log(2.0))

  def solve(model):
    """(bpd, its prior term's and its divergence term's parts, stats)."""
    got = {}

    def odeint(*args, **kwargs):
      got['sol'] = rk4(*args, **kwargs)
      return got['sol']
    log_p, _, aux, stats = nll_ode.make_ode_likelihood_fn(
        model, odeint=odeint)(batch, u=u, probe=probe)
    divergence = -got['sol'].y[:, cfg.n_pixels].mean().item() * to_bpd
    bpd = ode_bpd(cfg, log_p, aux)
    return dict(bpd=bpd, divergence_part=divergence,
                prior_part=bpd - divergence), stats

  models, runs = {}, {}
  for name, overrides in (('kernels', {}), ('plain', dict(use_kernels=False)),
                          ('f32', dict(use_kernels=False,
                                       compute_dtype='float32'))):
    models[name] = build_model(
        'mulan_velocity', dataclasses.replace(cfg, **overrides), device=dev,
        state=state).requires_grad_(False)
    if name == 'kernels':
      ((runs[name], stats), secs), counts = counted(lambda: timed(
          lambda: solve(models[name])), route_totals)
    else:
      (runs[name], stats), secs = timed(lambda: solve(models[name]))
    runs[name]['seconds'] = secs
    if name == 'f32':
      del models[name]
  nfe = stats['nfe']
  assert nfe == 4 * ODE_RK4_STEPS and stats['success'], stats
  assert counts == ode_solve_launches(cfg, nfe), counts

  def delta(a, b, part='bpd'):
    return abs(runs[a][part] - runs[b][part])
  noise = delta('plain', 'f32')
  bpd_tol = BPD_TOL + ODE_BPD_NOISE * noise

  rhs = {name: ode_rhs(m, batch, u, probe) for name, m in models.items()}
  t = ode.f32(0.5)
  rhs_ms = {name: cuda_ms(lambda: func(t, y0), n=5)
            for name, (func, y0) in rhs.items()}
  func, y0 = rhs['kernels']
  torch.cuda.synchronize()
  base = torch.cuda.memory_allocated()
  torch.cuda.reset_peak_memory_stats()
  func(t, y0)
  torch.cuda.synchronize()
  peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9

  # The block alone, its leaves made to require grad for the check only.
  block = models['kernels'].score_model.mid_attn_1
  captured, hooks = capture_io({'unet': block})
  func(t, y0)
  for h in hooks:
    h.remove()
  block.requires_grad_(True)
  plain = block_grads(block, *captured['unet'], False)
  # The residual passes dy to the input unchanged; the attention branch's
  # share of the input gradient, beside it.
  dy = captured['unet'][1].flatten().double()
  branch_ratio = ((plain['input'] - dy).norm() / dy.norm()).item()

  def alone():
    return leaf_cosines(block_grads(block, *captured['unet'], True), plain)
  cos = alone()
  faults = {}
  for kernel in ('dk', 'dq'):
    with planted_fault(kernel):
      faults[kernel] = alone()
  block.requires_grad_(False)

  def passes(c):
    return all(v >= ATTN_ALONE_COS_MIN for v in c.values())
  log('ode_nll_kernels_vs_plain', rows=ODE_ROWS, rk4_steps=ODE_RK4_STEPS,
      nfe=nfe, runs=runs, abs_delta=delta('kernels', 'plain'),
      plain_minus_f32=noise, tol=bpd_tol,
      prior_part_abs_delta=delta('kernels', 'plain', 'prior_part'),
      prior_tol=BPD_TOL, kernels_minus_f32=delta('kernels', 'f32'),
      ms_per_rhs_kernels=rhs_ms['kernels'], ms_per_rhs_plain=rhs_ms['plain'],
      rhs_peak_above_start_gb=peak_gb,
      alone_cos_min=min(cos.values()), tol_alone=ATTN_ALONE_COS_MIN,
      alone_cos={n: round(c, 7) for n, c in cos.items()},
      planted_faults_rejected={k: not passes(c) for k, c in faults.items()},
      fault_cos_min={k: min(c.values()) for k, c in faults.items()},
      fault_input_cos={k: c['input'] for k, c in faults.items()},
      branch_to_residual_norm=branch_ratio, launches=counts)
  assert delta('kernels', 'plain', 'prior_part') <= BPD_TOL, runs
  assert delta('kernels', 'plain') <= bpd_tol, runs
  assert passes(cos), cos
  for kernel, c in faults.items():
    assert not passes(c), (f'a planted {kernel} fault passed', c)
  del models['plain'], rhs['plain']
  return counts, models['kernels'], func, y0


def run_ode_dopri5(model, batch, gen, dev, route_totals):
  """One adaptive DoPri5 solve of the ODE likelihood at 128 rows
  (rtol = atol = ODE_DOPRI5_TOL, at most ODE_DOPRI5_MAX_STEPS steps),
  twice on the same noise: each must succeed; whether the two agree is
  printed, not gated. Returns the launches of both."""
  from mulan_tpu_torch.evals import nll_ode
  u, probe = ode_noise(model.config, gen, dev)
  likelihood = nll_ode.make_ode_likelihood_fn(
      model, rtol=ODE_DOPRI5_TOL, atol=ODE_DOPRI5_TOL,
      max_steps=ODE_DOPRI5_MAX_STEPS)
  runs, total = [], None
  for _ in range(2):
    ((log_p, _, aux, stats), secs), counts = counted(lambda: timed(
        lambda: likelihood(batch, u=u, probe=probe)), route_totals)
    runs.append(dict(stats, seconds=secs, bpd=ode_bpd(model.config, log_p,
                                                      aux),
                     log_p=log_p))
    assert stats['success'], stats
    assert counts == ode_solve_launches(model.config, stats['nfe']), counts
    total = counts if total is None else {k: v + counts[k]
                                          for k, v in total.items()}
  log('ode_dopri5', rows=ODE_ROWS, rtol=ODE_DOPRI5_TOL, atol=ODE_DOPRI5_TOL,
      max_steps=ODE_DOPRI5_MAX_STEPS,
      runs=[{k: v for k, v in r.items() if k != 'log_p'} for r in runs],
      ms_per_rhs=[1e3 * r['seconds'] / r['nfe'] for r in runs],
      nfe_agree=runs[0]['nfe'] == runs[1]['nfe'],
      log_p_equal=torch.equal(runs[0]['log_p'], runs[1]['log_p']),
      log_p_max_abs_diff=(runs[0]['log_p'] - runs[1]['log_p']).abs().max()
      .item())
  return total


def ode_cli_config(name: str = 'cifar10_conditioned'):
  """The command lines' arguments for config `name` (the flagship) on
  synthetic data, one eval batch of ODE_ROWS images."""
  return [f'--config={name}', '--config.data.dataset=synthetic',
          f'--config.data.synthetic_examples={4 * ODE_ROWS}',
          f'--config.training.batch_size_eval={ODE_ROWS}']


def run_ode_nll_cli(cfg, flax_path, route_totals,
                    name: str = 'cifar10_conditioned',
                    phase: str = 'ode_nll'):
  """`eval_bpd --config=<name> --bpd_eval_method=ode --solver=rk4` on the
  exported `ckpt-N.flax` of that config's model, one batch of ODE_ROWS
  images, one importance sample: finite bpd, launches of one solve, every
  K1-K3 launch on 'sm90'. Returns the launches."""
  from mulan_tpu_torch import eval_bpd
  vdm = name == 'vdm_cifar10'
  argv = [*ode_cli_config(name), f'--checkpoint_directory={flax_path}',
          '--bpd_eval_method=ode', '--solver=rk4',
          f'--rk4_steps={ODE_RK4_STEPS}', '--n_is=1']
  (bpd, secs), counts = counted(lambda: timed(lambda: eval_bpd.main(argv)),
                                route_totals)
  log(phase, argv=' '.join(argv[-4:]), config=name, bpd=bpd, seconds=secs,
      nfe=4 * ODE_RK4_STEPS, launches=counts)
  assert math.isfinite(bpd), bpd
  assert counts == ode_solve_launches(cfg, 4 * ODE_RK4_STEPS, vdm=vdm), (
      counts)
  return counts


def run_ode_sample_cli(cfg, flax_path, workdir, route_totals):
  """`main --mode sample --sampler=ode` on the exported `ckpt-N.flax` at
  batch SAMPLE_BATCH, its tolerances loosened to ODE_SAMPLE_TOL: a uint8
  grid in [0, 255], z_0 finite, launches of nfe forward evaluations.
  Returns the launches."""
  from mulan_tpu_torch import main as main_lib
  from mulan_tpu_torch.evals import nll_ode
  from mulan_tpu_torch.utils import metrics
  make_sample_fn, write_png = nll_ode.make_ode_sample_fn, metrics.write_png
  got = {}

  def loose_sample_fn(model, mesh=None):
    sample = make_sample_fn(model, rtol=ODE_SAMPLE_TOL, atol=ODE_SAMPLE_TOL,
                            mesh=mesh)

    def recorded(*args, **kwargs):
      (got['z_0'], got['nfe']), got['solve_s'] = timed(
          lambda: sample(*args, **kwargs))
      return got['z_0'], got['nfe']
    return recorded

  def recording_write_png(path, image):
    got['grid'] = image
    write_png(path, image)
  nll_ode.make_ode_sample_fn = loose_sample_fn
  metrics.write_png = recording_write_png
  try:
    (_, secs), counts = counted(lambda: timed(lambda: main_lib.main([
        *ode_cli_config(), '--mode=sample', '--sampler=ode',
        f'--sample_batch={SAMPLE_BATCH}', f'--checkpoint={flax_path}',
        f'--workdir={workdir}'])), route_totals)
  finally:
    nll_ode.make_ode_sample_fn, metrics.write_png = make_sample_fn, write_png
  grid, z_0, nfe = got['grid'], got['z_0'], got['nfe']
  log('ode_sample', batch=SAMPLE_BATCH, rtol=ODE_SAMPLE_TOL,
      atol=ODE_SAMPLE_TOL, nfe=nfe, seconds=secs, solve_s=got['solve_s'],
      ms_per_rhs=1e3 * got['solve_s'] / nfe, grid_shape=list(grid.shape),
      dtype=str(grid.dtype), min=int(grid.min()), max=int(grid.max()),
      z0_abs_max=z_0.abs().max().item(), launches=counts)
  assert grid.dtype.name == 'uint8' and 0 <= grid.min() <= grid.max() <= 255
  assert torch.isfinite(z_0).all()
  assert counts == times(expected_launches(cfg, 'ode_sample_rhs'), nfe), (
      counts)
  return counts


def compare_ode_fused(cfg, state, batch, gen, dev, route_totals):
  """One RHS evaluation with `fused_gn_swish` through the kernels (K8 and
  K8's backward at every GN-swish site, a plain GroupNorm+swish backward on
  the card raising) against its plain twin on the same state and probe:
  cosines of the drift and of the divergence >= ODE_FUSED_COS_MIN.
  Returns the launches."""
  from mulan_tpu_torch.models import build_model
  from mulan_tpu_torch.ops import ode
  fused_cfg = dataclasses.replace(cfg, fused_gn_swish=True)
  u, probe = ode_noise(cfg, gen, dev)
  out = {}
  for name, use_kernels in (('kernels', True), ('plain', False)):
    m = build_model(
        'mulan_velocity',
        dataclasses.replace(fused_cfg, use_kernels=use_kernels), device=dev,
        state=state).requires_grad_(False)
    func, y0 = ode_rhs(m, batch, u, probe)
    if use_kernels:
      with no_plain_gn_bwd_on_cuda():
        out[name], counts = counted(lambda: func(ode.f32(0.5), y0),
                                    route_totals)
    else:
      out[name] = func(ode.f32(0.5), y0)
    del m, func
  d = cfg.n_pixels
  cos = {part: cosine(out['kernels'][:, s].flatten().double(),
                      out['plain'][:, s].flatten().double())
         for part, s in (('drift', slice(0, d)), ('divergence', d))}
  log('ode_fused', rows=ODE_ROWS, cos=cos, tol=ODE_FUSED_COS_MIN,
      launches=counts)
  assert counts == expected_launches(fused_cfg, 'ode_rhs'), counts
  assert min(cos.values()) >= ODE_FUSED_COS_MIN, cos
  return counts


def check_score_jvp_raises(model, batch):
  """`score_jvp` needs forward-mode AD, which the kernels lack: with them on
  the card it must raise."""
  x = torch.randn((2, *model.config.image_shape), device=batch.device)
  emb = model.deterministic_embedding(2)
  try:
    model.score_jvp(x, torch.zeros_like(x), emb, torch.ones_like(x))
  except NotImplementedError as e:
    log('score_jvp', raises=True, message=repr(str(e)[:60]))
    return
  raise AssertionError('score_jvp ran with the kernels on the card')


def compare_vdm_step(ex, model, build_plain, batch, noise):
  """One VDM train step through `model` (the kernels) and its plain twin
  on the same batch, noise and dropout masks: |delta bpd| within
  TRAIN_BPD_TOL, gradient norms within GRAD_NORM_RTOL, the cosine of each
  leaf of the schedule (`gamma.*`) and of the mid attention block, and of
  the schedule's whole gradient, to ATTN_LEAF_COS_MIN (see VDM_TRAIN_STEPS
  for the schedule's one-number leaves); the attention block alone at the
  step's input and cotangent to ATTN_ALONE_COS_MIN; and K5 alone at the
  step's inputs (its one launch, recorded) to DECODER_BWD_ALONE_MIN on dz
  and dg0, which K5 with dg0 = 0 and with dz's sign flipped must each
  fail. Returns K5's recorded (x, z, g0, ct)."""
  block = model.score_model.mid_attn_1
  captured, hooks = capture_io({'unet': block})
  calls = []
  with recording_decoder_bwd(calls):
    bpd_k, grads_k = step_grads(ex, model, batch, noise)
  for h in hooks:
    h.remove()
  assert len(calls) == 1, len(calls)
  x, z, g0, ct = calls[0]
  assert g0.dim() == 0 and z.shape == (batch['images'].shape[0],
                                       *model.config.image_shape)
  bpds, grads = {'kernels': bpd_k}, {'kernels': grads_k}
  for name, overrides in (('plain', {}), ('f32', {'compute_dtype':
                                                  'float32'})):
    other = build_plain(**overrides)
    bpds[name], grads[name] = step_grads(ex, other, batch, noise)
    del other
  leaves = [n for n in grads_k
            if n.startswith(('gamma.', 'score_model.mid_attn_1.'))]
  gamma = [n for n in leaves if n.startswith('gamma.')]
  step_cos = leaf_cosines(grads_k, grads['plain'], leaves)
  step_cos['gamma'] = cosine(*(torch.cat([grads[m][n] for n in gamma])
                               for m in ('kernels', 'plain')))

  def rel(a, b, n):
    return abs((grads[a][n] - grads[b][n]) / grads[b][n]).item()
  one_number = {n: {f'{a}_vs_{b}': rel(a, b, n) for a, b in (
      ('kernels', 'plain'), ('plain', 'f32'), ('kernels', 'f32'))}
                for n in gamma if grads_k[n].numel() == 1}
  alone = leaf_cosines(block_grads(block, *captured['unet'], True),
                       block_grads(block, *captured['unet'], False))
  k5 = decoder_bwd_alone(x, z, g0, ct)
  faults = {}
  for kind in ('dg0_zero', 'dz_sign'):
    with planted_decoder_bwd_fault(kind):
      faults[kind] = decoder_bwd_alone(x, z, g0, ct)

  def k5_passes(agree):
    return min(agree.values()) >= DECODER_BWD_ALONE_MIN
  whole = {k: torch.cat(list(g.values())) for k, g in grads.items()}
  norm_rel = abs(whole['kernels'].norm().item()
                 / whole['plain'].norm().item() - 1)
  log('vdm_train_kernels_vs_plain', bpd=bpds,
      abs_delta=abs(bpds['kernels'] - bpds['plain']), tol=TRAIN_BPD_TOL,
      grad_norm_rel_diff=norm_rel, norm_rtol=GRAD_NORM_RTOL,
      gamma_leaf_cos={n: round(c, 7) for n, c in step_cos.items()
                      if n.startswith('gamma')},
      gamma_one_number_rel_diff=one_number,
      attn_leaf_cos_min=min(c for n, c in step_cos.items()
                            if not n.startswith('gamma')),
      tol_leaf=ATTN_LEAF_COS_MIN, attn_alone_cos_min=min(alone.values()),
      tol_alone=ATTN_ALONE_COS_MIN, decoder_bwd_alone=k5,
      decoder_bwd_tol=DECODER_BWD_ALONE_MIN,
      g0=g0.item(), decoder_bwd_planted_faults=faults,
      planted_faults_rejected={k: not k5_passes(a) for k, a in faults.items()},
      whole_cos=cosine(whole['kernels'], whole['plain']),
      whole_cos_to_f32={k: cosine(whole[k], whole['f32'])
                        for k in ('kernels', 'plain')},
      gamma_cos_to_f32={k: cosine(*(torch.cat([grads[m][n] for n in gamma])
                                     for m in (k, 'f32')))
                        for k in ('kernels', 'plain')})
  assert abs(bpds['kernels'] - bpds['plain']) <= TRAIN_BPD_TOL, bpds
  assert norm_rel <= GRAD_NORM_RTOL, norm_rel
  assert min(step_cos.values()) >= ATTN_LEAF_COS_MIN, step_cos
  assert min(alone.values()) >= ATTN_ALONE_COS_MIN, alone
  assert k5_passes(k5), k5
  for kind, agree in faults.items():
    assert not k5_passes(agree), (f'a planted K5 {kind} fault passed', agree)
  return x, z, g0, ct


def run_vdm(dev, gen, images, sfu_rate, online_lib, route_totals):
  """The baseline VDM (vdm_cifar10: the flagship's score UNet at full width
  and depth, the learned scalar schedule, no latent) through its entry
  points, its weights seeded as the flagship's: VDM_TRAIN_STEPS steps of
  `Experiment.train` at batch 128 (K5 once a step); one step kernels
  against plain with K5 alone at its inputs (`compare_vdm_step`); K5 timed
  there, at g0 per example and at gamma_max, beside the online K5
  (`time_decoder_bwd`); `eval_bpd_sparse` over VDM_EVAL_BATCHES batches of
  128 and one batch's ELBO kernels against plain; the ancestral sampler;
  and, on a checkpoint of the trained state exported as `ckpt-N.flax`,
  `eval_bpd --config=vdm_cifar10 --bpd_eval_method=ode --solver=rk4`.
  Returns ({path: launches}, K5's timed cases, the Experiment)."""
  from mulan_tpu_torch import compat, configs, data, params
  from mulan_tpu_torch.evals import harness, vlb
  from mulan_tpu_torch.models import build_model
  from mulan_tpu_torch.ops.decoder_logprob import encode
  from mulan_tpu_torch.models.vdm import sample_times
  from mulan_tpu_torch.train import checkpoint as ckpt_lib
  from mulan_tpu_torch.train.loop import Experiment
  train_cfg = configs.replace(
      configs.vdm_cifar10(), data={'dataset': 'synthetic'},
      training={'steps_per_logging': VDM_TRAIN_STEPS, 'substeps': 1})
  cfg = train_cfg.model
  state = params.init_params(cfg, torch.Generator().manual_seed(SEED),
                             perturb_zero_init=0.02, vdm_type='vdm')
  paths = {}

  # Training: the first update has lr 0, later ones move every leaf.
  ex = Experiment(train_cfg, device=dev, state=state)
  (history, first_s), counts = counted(lambda: timed(lambda: ex.train(1)),
                                       route_totals)
  (more, secs), more_counts = counted(lambda: timed(
      lambda: ex.train(VDM_TRAIN_STEPS - 1)), route_totals)
  history += more
  paths['vdm_train'] = {k: v + more_counts[k] for k, v in counts.items()}
  ms_per_step = 1e3 * secs / (VDM_TRAIN_STEPS - 1)
  per_step = expected_launches(cfg, 'train', vdm=True)
  log('vdm_train', steps=VDM_TRAIN_STEPS, batch=EVAL_BATCH,
      bpd=[round(h['bpd'], 4) for h in history], ms_per_step=ms_per_step,
      images_per_s=1e3 * EVAL_BATCH / ms_per_step,
      first_step_s=first_s,
      g0=ex.state.ema_model.apply_gamma(0.0).item(),
      launches=paths['vdm_train'], launches_per_step=per_step)
  assert per_step['decoder_logprob_bwd'] == 1, per_step
  assert all(math.isfinite(h['bpd']) for h in history), history
  assert paths['vdm_train'] == times(per_step, VDM_TRAIN_STEPS), (
      paths['vdm_train'])

  # One step, kernels against plain, and K5 alone at its inputs.
  model = build_model('vdm', cfg, device=dev, state=state)
  batch = torch.as_tensor(images[:EVAL_BATCH], device=dev)
  t = sample_times(EVAL_BATCH, generator=gen, device=dev)
  eps = torch.randn((EVAL_BATCH, *cfg.image_shape), generator=gen,
                    device=dev)
  step_noise = dict(t=t, eps0=eps, eps=eps, dropout_seed=1234)
  step_inputs = compare_vdm_step(ex, model, lambda **kw: build_model(
      'vdm', dataclasses.replace(cfg, use_kernels=False, **kw), device=dev,
      state=state), {'images': batch}, step_noise)

  # K5 timed at the step's inputs, at g0 per example and at gamma_max.
  x = step_inputs[0]
  e_x = encode(x, cfg.vocab_size)
  span = cfg.gamma_max - cfg.gamma_min
  per_example = cfg.gamma_min + span * torch.rand(
      (EVAL_BATCH, 1, 1, 1), generator=gen, device=dev)
  top = torch.tensor(cfg.gamma_max, device=dev)
  cases = {'vdm_step': step_inputs}
  for name, g0 in (('per_example', per_example), ('gamma_max', top)):
    z = e_x + torch.exp(0.5 * g0) * torch.randn(
        e_x.shape, generator=gen, device=dev)
    cases[name] = (x, z, g0, torch.randn((EVAL_BATCH,), generator=gen,
                                         device=dev))
  k5 = time_decoder_bwd(cases, cfg, sfu_rate, online_lib)

  # Evaluation: the sparse VLB, one batch kernels against plain, sampling.
  (bpd, secs), paths['vdm_eval'] = counted(lambda: timed(
      lambda: vlb.eval_bpd_sparse(
          model, data.eval_batches(images, EVAL_BATCH), generator=gen,
          max_batches=VDM_EVAL_BATCHES)), route_totals)
  plain = build_model('vdm', dataclasses.replace(cfg, use_kernels=False),
                      device=dev, state=state)
  rates, bpds = {}, {}
  for name, m in (('kernels', model), ('plain', plain)):
    def run():
      with torch.inference_mode():
        out = m.elbo(batch, t, eps0=eps, eps=eps)
        return vlb.bpd_terms(out, cfg.n_pixels).mean().item()
    run()
    runs = [timed(run) for _ in range(3)]
    bpds[name] = runs[0][0]
    rates[name] = EVAL_BATCH / statistics.median(s for _, s in runs)
  del plain
  delta = abs(bpds['kernels'] - bpds['plain'])
  log('vdm_eval_bpd_sparse', batches=VDM_EVAL_BATCHES, batch=EVAL_BATCH,
      bpd=bpd, seconds=secs, images_per_s=EVAL_BATCH * VDM_EVAL_BATCHES
      / secs, elbo_bpd=bpds, abs_delta=delta, tol=BPD_TOL,
      elbo_images_per_s=rates, launches=paths['vdm_eval'])
  assert math.isfinite(bpd), bpd
  assert delta <= BPD_TOL, bpds
  assert paths['vdm_eval'] == times(expected_launches(cfg, 'eval', True),
                                    VDM_EVAL_BATCHES), paths['vdm_eval']
  ((samples, z_0), secs), paths['vdm_sample'] = counted(lambda: timed(
      lambda: harness.random_samples(model, SAMPLE_BATCH, SAMPLE_STEPS,
                                     generator=gen)), route_totals)
  log('vdm_random_samples', batch=SAMPLE_BATCH, steps=SAMPLE_STEPS,
      ms_per_step=1e3 * secs / SAMPLE_STEPS, min=int(samples.min()),
      max=int(samples.max()), z0_abs_max=z_0.abs().max().item(),
      launches=paths['vdm_sample'])
  assert samples.dtype.name == 'uint8' and torch.isfinite(z_0).all()
  assert samples.shape == (SAMPLE_BATCH, *cfg.image_shape)
  assert paths['vdm_sample'] == times(expected_launches(cfg, 'sample', True),
                                      SAMPLE_STEPS), paths['vdm_sample']
  del model

  # The ODE likelihood's command line on the trained state's export.
  with tempfile.TemporaryDirectory() as workdir:
    ckpt_dir = os.path.join(workdir, 'checkpoints')
    _, save_s = timed(lambda: ckpt_lib.CheckpointManager(ckpt_dir).save(
        ex.state.step, ex.state))
    flax_path, export_s = timed(lambda: compat.export_reference_checkpoint(
        ckpt_dir, os.path.join(workdir, 'reference')))
    log('vdm_checkpoint', step=ex.state.step, save_s=save_s,
        export_s=export_s, flax_bytes=os.path.getsize(flax_path))
    paths['vdm_ode_nll_cli'] = run_ode_nll_cli(
        cfg, flax_path, route_totals, 'vdm_cifar10', phase='vdm_ode_nll')
  return paths, k5, ex


def run_imagenet32(dev, gen, sfu_rate, route_totals):
  """MuLAN-epsilon at ImageNet32's width and depth (`imagenet32`: a 256-channel
  score UNet with one head, so K1-K3 at head_dim 256, each on its 'sm90'
  route; synthetic 32x32x3 data; weights seeded as the flagship's) through
  its entry points. K1 alone at IN32_EVAL_ATTN, IN32_TRAIN_ATTN (both
  timed beside SDPA's forward and K1's 'simt' entry point), the sampler's
  and an encoder chunk's shapes (timed beside SDPA's forward), K2 and K3
  at IN32_TRAIN_ATTN (timed beside SDPA's backward and their 'simt' entry
  points);
  `eval_bpd_sparse` over IN32_EVAL_BATCHES batches of 512 and one batch's
  ELBO kernels against plain; the ancestral sampler; IN32_TRAIN_STEPS
  steps of `Experiment.train` at batch 128 and one step kernels against
  plain (the gates of phase 7, planted K1, K2 and K3 faults rejected);
  and, on a checkpoint of the trained state exported as `ckpt-N.flax`,
  `eval_bpd --config=imagenet32 --bpd_eval_method=ode --solver=rk4`. Every
  K1, K2 and K3 launch must take the 'sm90' route, the kernels-vs-plain
  step's and its planted faults' included. Last, K8 and its backward
  alone at the 256-wide UNet's channel counts (IN32_GN_CASES), and one
  train step with `fused_gn_swish` (off on the path above), K8 and its
  backward launched at every one of its sites. Returns ({path:
  launches}, {K1 shape / 'dkv' / 'dq' / 'gn_swish' / 'gn_swish_bwd':
  results}, the Experiment)."""
  from mulan_tpu_torch import compat, configs, data, params
  from mulan_tpu_torch.evals import harness, vlb
  from mulan_tpu_torch.models import build_model, latents
  from mulan_tpu_torch.models.vdm import sample_times
  from mulan_tpu_torch.train import checkpoint as ckpt_lib
  from mulan_tpu_torch.train.loop import Experiment

  def count(fn):
    return counted(fn, route_totals)

  # The kernels alone at the path's shapes.
  kernels = {}
  for shape, n, simt_n in ((IN32_EVAL_ATTN, IN32_TIMED_CALLS,
                            IN32_TIMED_CALLS),
                           (IN32_TRAIN_ATTN, IN32_TIMED_CALLS,
                            IN32_TIMED_CALLS),
                           (IN32_SAMPLER_ATTN, 20, 0),
                           (IN32_ENCODER_ATTN, 20, 0)):
    kernels['x'.join(map(str, shape))] = r = attention_case(
        dev, gen, shape, torch.bfloat16, ATTN_TOL_BF16, True, n, simt_n)
    assert r['route'] == 'sm90', r
  kernels['dkv'], kernels['dq'] = attention_bwd_case(
      dev, gen, IN32_TRAIN_ATTN, torch.bfloat16, True, simt_n=IN32_TIMED_CALLS)
  assert kernels['dkv']['route'] == kernels['dq']['route'] == 'sm90'
  torch.cuda.empty_cache()

  train_cfg = configs.replace(
      configs.imagenet32(), data={'dataset': 'synthetic'},
      training={'batch_size_train': IN32_TRAIN_BATCH,
                'steps_per_logging': IN32_TRAIN_STEPS, 'substeps': 1},
      model={'remat': IN32_REMAT})
  cfg = train_cfg.model
  state = params.init_params(cfg, torch.Generator().manual_seed(SEED),
                             perturb_zero_init=0.02, vdm_type='mulan_epsilon')
  images, _ = data.synthetic_split('eval', cfg.image_shape, seed=SEED)
  model = build_model('mulan_epsilon', cfg, device=dev, state=state)
  assert model.parameterization == 'epsilon'
  paths = {}

  # Evaluation: the sparse VLB at batch 512, one batch kernels against
  # plain on the same noise, and the sampler.
  (bpd, secs), paths['in32_eval'] = count(lambda: timed(
      lambda: vlb.eval_bpd_sparse(
          model, data.eval_batches(images, IN32_EVAL_BATCH), generator=gen,
          max_batches=IN32_EVAL_BATCHES)))
  batch = torch.as_tensor(images[:IN32_EVAL_BATCH], device=dev)
  t = sample_times(IN32_EVAL_BATCH, generator=gen, device=dev)
  eps = torch.randn((IN32_EVAL_BATCH, *cfg.image_shape), generator=gen,
                    device=dev)
  topk = latents.gamma_variates(cfg.latent_k,
                                (IN32_EVAL_BATCH, cfg.latent_size),
                                generator=gen, device=dev)
  plain = build_model('mulan_epsilon',
                      dataclasses.replace(cfg, use_kernels=False),
                      device=dev, state=state)
  bpds, rates = {}, {}
  for name, m in (('kernels', model), ('plain', plain)):
    def run():
      with torch.inference_mode():
        out = m.elbo(batch, t, eps0=eps, eps=eps, latent_noise=topk)
        return vlb.bpd_terms(out, cfg.n_pixels).mean().item()
    bpds[name], _ = timed(run)
    rates[name] = IN32_EVAL_BATCH / timed(run)[1]
  del plain
  delta = abs(bpds['kernels'] - bpds['plain'])
  log('in32_eval_bpd_sparse', batches=IN32_EVAL_BATCHES,
      batch=IN32_EVAL_BATCH, bpd=bpd, seconds=secs,
      images_per_s=IN32_EVAL_BATCH * IN32_EVAL_BATCHES / secs,
      elbo_bpd=bpds, abs_delta=delta, tol=BPD_TOL,
      elbo_images_per_s=rates, launches=paths['in32_eval'])
  assert math.isfinite(bpd), bpd
  assert delta <= BPD_TOL, bpds
  assert paths['in32_eval'] == times(expected_launches(cfg, 'eval'),
                                     IN32_EVAL_BATCHES), paths['in32_eval']
  ((samples, z_0), secs), paths['in32_sample'] = count(lambda: timed(
      lambda: harness.random_samples(model, SAMPLE_BATCH, SAMPLE_STEPS,
                                     generator=gen)))
  log('in32_random_samples', batch=SAMPLE_BATCH, steps=SAMPLE_STEPS,
      ms_per_step=1e3 * secs / SAMPLE_STEPS, dtype=str(samples.dtype),
      min=int(samples.min()), max=int(samples.max()),
      z0_abs_max=z_0.abs().max().item(), launches=paths['in32_sample'])
  assert samples.dtype.name == 'uint8' and torch.isfinite(z_0).all()
  assert samples.shape == (SAMPLE_BATCH, *cfg.image_shape)
  assert paths['in32_sample'] == times(expected_launches(cfg, 'sample'),
                                       SAMPLE_STEPS), paths['in32_sample']
  del batch, eps, topk
  torch.cuda.empty_cache()

  # Training at batch 128: the first update has lr 0, later ones move the
  # parameters.
  ex = Experiment(train_cfg, device=dev, state=state)
  torch.cuda.synchronize()
  base = torch.cuda.memory_allocated()
  torch.cuda.reset_peak_memory_stats()
  history, counts = count(lambda: ex.train(1))
  (more, secs), more_counts = count(lambda: timed(
      lambda: ex.train(IN32_TRAIN_STEPS - 1)))
  peak = torch.cuda.max_memory_allocated()
  history += more
  paths['in32_train'] = {k: v + more_counts[k] for k, v in counts.items()}
  per_step = expected_launches(cfg, 'train')
  ms_per_step = 1e3 * secs / (IN32_TRAIN_STEPS - 1)
  log('in32_train', steps=IN32_TRAIN_STEPS, batch=IN32_TRAIN_BATCH,
      remat=cfg.remat, bpd=[round(h['bpd'], 4) for h in history],
      ms_per_step=ms_per_step,
      images_per_s=1e3 * IN32_TRAIN_BATCH / ms_per_step,
      peak_memory_gb=peak / 1e9, peak_above_start_gb=(peak - base) / 1e9,
      launches=paths['in32_train'], launches_per_step=per_step)
  assert all(math.isfinite(h['bpd']) for h in history), history
  assert paths['in32_train'] == times(per_step, IN32_TRAIN_STEPS), (
      paths['in32_train'])

  # One step kernels against plain (the gates of phase 7), without the
  # float32 twin: its activations would be twice those of the bf16 step,
  # which holds 40 GB above its start.
  n = IN32_TRAIN_BATCH
  step_batch = torch.as_tensor(images[:n], device=dev)
  eps = torch.randn((n, *cfg.image_shape), generator=gen, device=dev)
  step_noise = dict(
      t=sample_times(n, generator=gen, device=dev), eps0=eps, eps=eps,
      latent_noise=latents.gamma_variates(cfg.latent_k, (n, cfg.latent_size),
                                        generator=gen, device=dev),
      dropout_seed=1234)
  # Counted: every K1, K2 and K3 launch of the kernels' step, of the blocks
  # alone and of the planted-fault steps must take 'sm90'.
  _, paths['in32_train_vs_plain'] = count(lambda: compare_train_step(
      ex, model, lambda **kw: build_model(
          'mulan_epsilon', dataclasses.replace(cfg, use_kernels=False, **kw),
          device=dev, state=state), {'images': step_batch}, step_noise,
      tag='in32_train', with_f32=False, planted=('fwd', 'dk', 'dq')))
  assert all(paths['in32_train_vs_plain'][k] > 0 for k in SM90_KERNELS), (
      paths['in32_train_vs_plain'])
  del model, step_batch, step_noise, eps
  torch.cuda.empty_cache()

  # The ODE likelihood's command line on the trained state's export.
  with tempfile.TemporaryDirectory() as workdir:
    ckpt_dir = os.path.join(workdir, 'checkpoints')
    _, save_s = timed(lambda: ckpt_lib.CheckpointManager(ckpt_dir).save(
        ex.state.step, ex.state))
    flax_path, export_s = timed(lambda: compat.export_reference_checkpoint(
        ckpt_dir, os.path.join(workdir, 'reference')))
    log('in32_checkpoint', step=ex.state.step, save_s=save_s,
        export_s=export_s, flax_bytes=os.path.getsize(flax_path))
    paths['in32_ode_nll_cli'] = run_ode_nll_cli(
        cfg, flax_path, route_totals, 'imagenet32', phase='in32_ode_nll')
  torch.cuda.empty_cache()
  kernels['gn_swish'] = check_gn_swish(dev, gen, sfu_rate, IN32_GN_CASES)
  kernels['gn_swish_bwd'] = check_gn_swish_bwd(dev, gen, sfu_rate,
                                               IN32_GN_CASES)
  # With `fused_gn_swish`: one train step through K8 and its backward at
  # the UNet's 2 (2 sm_n_layer + 3) sites (C = 256; 512 at each up block's
  # first GroupNorm, after the skip concat).
  fused_cfg = configs.replace(train_cfg, model={'fused_gn_swish': True})
  ex_fused = Experiment(fused_cfg, device=dev, state=state)
  fused_history, paths['in32_fused_train'] = count(
      lambda: ex_fused.train(1))
  k8_sites = 2 * (2 * cfg.sm_n_layer + 3)
  log('in32_fused_train', bpd=fused_history[0]['bpd'], k8_sites=k8_sites,
      launches=paths['in32_fused_train'])
  assert math.isfinite(fused_history[0]['bpd']), fused_history
  assert paths['in32_fused_train'] == expected_launches(
      fused_cfg.model, 'train'), paths['in32_fused_train']
  assert paths['in32_fused_train']['gn_swish_bwd'] == k8_sites, (
      paths['in32_fused_train'])
  del ex_fused
  torch.cuda.empty_cache()
  return paths, kernels, ex


def variant_elbo_vs_plain(name, cfg, state, batch, labels, gen, dev):
  """One ELBO batch of a variant through the kernels and its plain twin on
  the same noise: (bpds, images/s of each, median of 3 after a warm-up);
  asserts |delta| <= BPD_TOL."""
  from mulan_tpu_torch.evals import vlb
  from mulan_tpu_torch.models import build_model, latents
  from mulan_tpu_torch.models.vdm import sample_times
  n = batch.shape[0]
  t = sample_times(n, generator=gen, device=dev)
  eps = torch.randn((n, *cfg.image_shape), generator=gen, device=dev)
  noise = latents.latent_variates(cfg, n, generator=gen, device=dev)
  bpds, rates = {}, {}
  for kind, use_kernels in (('kernels', True), ('plain', False)):
    m = build_model('mulan_velocity', dataclasses.replace(
        cfg, use_kernels=use_kernels), device=dev, state=state)

    def run():
      with torch.inference_mode():
        out = m.elbo(batch, t, labels=labels, eps0=eps, eps=eps,
                     latent_noise=noise)
        return vlb.bpd_terms(out, cfg.n_pixels).mean().item()
    run()
    runs = [timed(run) for _ in range(3)]
    bpds[kind] = runs[0][0]
    rates[kind] = n / statistics.median(s for _, s in runs)
    del m
  delta = abs(bpds['kernels'] - bpds['plain'])
  log(f'{name}_elbo_kernels_vs_plain', batch=n, bpd=bpds, abs_delta=delta,
      tol=BPD_TOL, images_per_s=rates)
  assert math.isfinite(bpds['kernels']) and delta <= BPD_TOL, bpds
  return bpds, rates


def run_variants(dev, gen, images, labels, flagship_ms, route_totals):
  """Phase 15: MuLAN's model variants (VARIANTS) at the flagship's width
  and depth, each through its entry points with its launches counted and
  held against `expected_launches`. V1: VARIANT_TRAIN_STEPS steps of
  `Experiment.train` at batch 128 (K5 once a step: its g0 is learned),
  timed beside the flagship's step of phase 6 (`flagship_ms`); one step
  kernels against plain (`compare_train_step`, the gates of phase 7); the
  sparse VLB over one batch and one ELBO batch kernels against plain; the
  ancestral sampler (`sample_softmax` decode); an RK4 likelihood. V2-V4:
  VARIANT_SMALL_STEPS train steps and one ELBO batch kernels against plain
  (V4 embeds the batch's labels). Returns ({path: launches}, the phase's
  numbers, V1's Experiment)."""
  from mulan_tpu_torch import configs, data, params
  from mulan_tpu_torch.evals import harness, nll_ode, vlb
  from mulan_tpu_torch.models import build_model, latents
  from mulan_tpu_torch.models.vdm import sample_times
  from mulan_tpu_torch.ops import ode
  from mulan_tpu_torch.train.loop import Experiment
  t0 = time.perf_counter()
  base_cfg = configs.replace(
      configs.cifar10_conditioned(), data={'dataset': 'synthetic'},
      training={'steps_per_logging': VARIANT_TRAIN_STEPS, 'substeps': 1})
  batch = torch.as_tensor(images[:EVAL_BATCH], device=dev)
  batch_labels = torch.as_tensor(labels[:EVAL_BATCH], device=dev)
  paths, numbers = {}, {}
  for name, overrides in VARIANTS.items():
    train_cfg = configs.replace(base_cfg, model=overrides)
    cfg = train_cfg.model
    state = params.init_params(cfg, torch.Generator().manual_seed(SEED),
                               perturb_zero_init=0.02)
    steps = VARIANT_TRAIN_STEPS if name == 'v1' else VARIANT_SMALL_STEPS
    ex = Experiment(train_cfg, device=dev, state=state)
    first, first_counts = counted(lambda: ex.train(1), route_totals)
    (more, secs), more_counts = counted(lambda: timed(
        lambda: ex.train(steps - 1)), route_totals)
    history = first + more
    counts = {k: v + more_counts[k] for k, v in first_counts.items()}
    per_step = expected_launches(cfg, 'train')
    ms = 1e3 * secs / (steps - 1)
    paths[f'{name}_train'] = counts
    log(f'{name}_train', model=overrides, steps=steps, batch=EVAL_BATCH,
        bpd=[round(h['bpd'], 4) for h in history], ms_per_step=ms,
        flagship_ms_per_step=flagship_ms, ratio_to_flagship=ms / flagship_ms,
        launches=counts, launches_per_step=per_step)
    assert all(math.isfinite(h['bpd']) for h in history), history
    assert counts == times(per_step, steps), counts
    numbers[name] = {'train_ms_per_step': ms}
    bpds, rates = variant_elbo_vs_plain(
        name, cfg, state, batch,
        batch_labels if cfg.reparam_type != 'true' else None, gen, dev)
    numbers[name]['elbo_images_per_s'] = rates['kernels']
    if name != 'v1':
      del ex
      torch.cuda.empty_cache()
      continue

    # V1: every kernel of the flagship's paths, and K5 (g0 is learned).
    for k in ('flash_attention', 'flash_attention_bwd_dkv',
              'flash_attention_bwd_dq', 'decoder_logprob',
              'decoder_logprob_bwd', 'dropout_mask'):
      assert counts[k] > 0, (k, counts)
    model = build_model('mulan_velocity', cfg, device=dev, state=state)
    t = sample_times(EVAL_BATCH, generator=gen, device=dev)
    eps = torch.randn((EVAL_BATCH, *cfg.image_shape), generator=gen,
                      device=dev)
    step_noise = dict(t=t, eps0=eps, eps=eps, dropout_seed=1234,
                      latent_noise=latents.latent_variates(
                          cfg, EVAL_BATCH, generator=gen, device=dev))
    compare_train_step(ex, model, lambda **kw: build_model(
        'mulan_velocity', dataclasses.replace(cfg, use_kernels=False, **kw),
        device=dev, state=state), {'images': batch}, step_noise,
                       tag='v1_train', with_f32=False, planted=())
    ex_v1 = ex
    (bpd, secs), paths['v1_eval'] = counted(lambda: timed(
        lambda: vlb.eval_bpd_sparse(
            model, data.eval_batches(images, EVAL_BATCH), generator=gen,
            max_batches=1)), route_totals)
    log('v1_eval_bpd_sparse', batch=EVAL_BATCH, bpd=bpd, seconds=secs,
        launches=paths['v1_eval'])
    assert math.isfinite(bpd), bpd
    assert paths['v1_eval'] == expected_launches(cfg, 'eval'), (
        paths['v1_eval'])
    ((samples, z_0), secs), paths['v1_sample'] = counted(lambda: timed(
        lambda: harness.random_samples(model, SAMPLE_BATCH,
                                       VARIANT_SAMPLE_STEPS, generator=gen)),
                                                        route_totals)
    log('v1_random_samples', batch=SAMPLE_BATCH, steps=VARIANT_SAMPLE_STEPS,
        ms_per_step=1e3 * secs / VARIANT_SAMPLE_STEPS,
        min=int(samples.min()), max=int(samples.max()),
        z0_abs_max=z_0.abs().max().item(), launches=paths['v1_sample'])
    assert samples.dtype.name == 'uint8' and torch.isfinite(z_0).all()
    assert samples.shape == (SAMPLE_BATCH, *cfg.image_shape)
    assert paths['v1_sample'] == times(expected_launches(cfg, 'sample'),
                                       VARIANT_SAMPLE_STEPS)
    rk4 = functools.partial(ode.odeint_rk4, num_steps=ODE_RK4_STEPS)
    model.requires_grad_(False)
    ((log_p, _, aux, stats), secs), paths['v1_ode_nll'] = counted(
        lambda: timed(lambda: nll_ode.make_ode_likelihood_fn(
            model, odeint=rk4)(batch[:VARIANT_ODE_ROWS], key=SEED)),
        route_totals)
    ode_bpd_value = ode_bpd(cfg, log_p, aux)
    log('v1_ode_nll', rows=VARIANT_ODE_ROWS, rk4_steps=ODE_RK4_STEPS,
        nfe=stats['nfe'], bpd=ode_bpd_value, seconds=secs,
        launches=paths['v1_ode_nll'])
    assert stats['success'] and math.isfinite(ode_bpd_value), stats
    assert paths['v1_ode_nll'] == ode_solve_launches(cfg, stats['nfe'])
    del model
    torch.cuda.empty_cache()
  wall = time.perf_counter() - t0
  numbers['wall_s'] = wall
  log('variants', wall_s=wall, numbers=numbers)
  return paths, numbers, ex_v1


# -- phase 16: data parallelism and FSDP -----------------------------------------


def free_port() -> int:
  import socket
  with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
    sock.bind(('127.0.0.1', 0))
    return sock.getsockname()[1]


def par_batches(images, steps: int):
  """The phase's global train batches: consecutive EVAL_BATCH-image slices
  of the synthetic eval images."""
  return [{'images': images[s * EVAL_BATCH:(s + 1) * EVAL_BATCH]}
          for s in range(steps)]


def par_train(ex, batches, route_totals, after_first=None):
  """Runs ex.train_step on each batch (the first alone, then
  `after_first(ex)`, the others timed): (bpds, ms a step, peak memory
  above the start in GB, launches)."""
  torch.cuda.synchronize()
  base = torch.cuda.memory_allocated()
  torch.cuda.reset_peak_memory_stats()
  bpds = []
  first, counts = counted(lambda: ex.train_step(batches[0]), route_totals)
  bpds.append(float(first['bpd']))
  if after_first is not None:
    after_first(ex)
  (rest, secs), more = counted(lambda: timed(lambda: [
      float(ex.train_step(b)['bpd']) for b in batches[1:]]), route_totals)
  bpds += rest
  peak = (torch.cuda.max_memory_allocated() - base) / 1e9
  counts = {k: v + more[k] for k, v in counts.items()}
  assert counts == times(expected_launches(ex.config.model, 'train'),
                         len(batches)), counts
  return bpds, 1e3 * secs / (len(batches) - 1), peak, counts


def par_grads(ex):
  """(the global gradient norm, {leaf: whole gradient} of the attention
  blocks) of the experiment's last train step (its first, from the seeded
  state, where every run's parameters are alike: the encoder's top-k makes
  later gradients depend on any rounding in the updates before)."""
  from mulan_tpu_torch.parallel.wrap import full
  from mulan_tpu_torch.train.optimizer import global_norm
  params = ex.state.params
  norm = float(global_norm([p.grad for p in params.values()
                            if p.grad is not None]))
  leaves = {n: full(p.grad).flatten().double() for n, p in params.items()
            if '_attn' in n and p.grad is not None}
  return norm, leaves


def run_parallel(dev, train_cfg, images, route_totals,
                 want_profile: bool = False):
  """Phase 16. Returns ({path: launches}, the phase's numbers). With
  `want_profile`, profiles the train step unwrapped, under DDP and under
  FSDP2 at world 1 (`[profile]` lines)."""
  import torch.distributed as dist
  from torch.distributed.device_mesh import init_device_mesh
  from mulan_tpu_torch import params
  from mulan_tpu_torch.models import build_model, layers
  from mulan_tpu_torch.parallel import mesh as mesh_lib
  from mulan_tpu_torch.parallel.wrap import full, is_sharded
  from mulan_tpu_torch.train.loop import EVAL, Experiment
  cfg = train_cfg.model
  state = params.init_params(cfg, torch.Generator().manual_seed(SEED),
                             perturb_zero_init=0.02)
  batches = par_batches(images, PAR_STEPS)
  numbers, paths = {}, {}

  # 1. One rank: the unwrapped Experiment (twice: how far its own steps
  # repeat), then DDP and FSDP2 in a process group of one over NCCL.
  grads = {}
  ex0 = Experiment(train_cfg, device=dev, state=state)
  bpd0, ms0, peak0, paths['parallel_unwrapped'] = par_train(
      ex0, batches, route_totals, lambda ex: grads.update(one=par_grads(ex)))
  norm0, leaves0 = grads['one']

  def profile_step(ex, name):
    if want_profile:
      log('profile', call=f'{name}_train_step_b128',
          **profile(lambda: ex.train_step(batches[0])))
  profile_step(ex0, 'parallel_unwrapped')
  again = Experiment(train_cfg, device=dev, state=state)
  bpd_again = par_train(again, batches, {})[0]  # not a path: a repeat
  del again
  repeats = bpd_again == bpd0
  dist.init_process_group('nccl' if dev.type == 'cuda' else 'gloo',
                          init_method=f'tcp://127.0.0.1:{free_port()}',
                          rank=0, world_size=1)
  try:
    exd = Experiment(train_cfg, device=dev, state=state)
    assert isinstance(exd.train_model,
                      torch.nn.parallel.DistributedDataParallel)
    bpd_d, ms_d, peak_d, paths['parallel_ddp_w1'] = par_train(
        exd, batches, route_totals)
    profile_step(exd, 'parallel_ddp_w1')
    del exd
    ddp_delta = max(abs(a - b) for a, b in zip(bpd_d, bpd0))
    log('parallel_ddp_world1', bpd=bpd_d, unwrapped_bpd=bpd0,
        bit_for_bit=bpd_d == bpd0, unwrapped_repeats_bit_for_bit=repeats,
        unwrapped_repeat_bpd=bpd_again, max_abs_delta=ddp_delta,
        ms_per_step=ms_d, unwrapped_ms_per_step=ms0,
        peak_above_start_gb=peak_d, unwrapped_peak_above_start_gb=peak0)
    # Bit for bit wherever the unwrapped steps repeat themselves bit for
    # bit; else within the train gate (the kernels' own run-to-run spread).
    assert bpd_d == bpd0 if repeats else ddp_delta <= TRAIN_BPD_TOL, (
        bpd_d, bpd0, bpd_again)

    fsdp_mesh = init_device_mesh(dev.type, (1, 1), mesh_dim_names=(
        mesh_lib.DATA_AXIS, mesh_lib.FSDP_AXIS))
    exf = Experiment(train_cfg, device=dev, state=state, mesh=fsdp_mesh)
    sharded = [n for n, p in exf.state.params.items() if is_sharded(p)]
    assert sharded and all(not n.startswith('gamma.') for n in sharded)
    assert all(is_sharded(p) or n.startswith('gamma.')
               for n, p in exf.state.params.items())
    bpd_f, ms_f, peak_f, paths['parallel_fsdp_w1'] = par_train(
        exf, batches, route_totals,
        lambda ex: grads.update(fsdp=par_grads(ex)))
    norm_f, leaves_f = grads['fsdp']
    profile_step(exf, 'parallel_fsdp_w1')
    cos = leaf_cosines(leaves_f, leaves0)
    fsdp_delta = max(abs(a - b) for a, b in zip(bpd_f, bpd0))
    log('parallel_fsdp_world1', bpd=bpd_f, max_abs_delta=fsdp_delta,
        tol=TRAIN_BPD_TOL, first_step_grad_norm=norm_f,
        unwrapped_first_step_grad_norm=norm0,
        attention_leaf_cos_min=min(cos.values()), ms_per_step=ms_f,
        peak_above_start_gb=peak_f, sharded_leaves=len(sharded))
    assert fsdp_delta <= TRAIN_BPD_TOL, (bpd_f, bpd0)
    assert abs(norm_f - norm0) <= GRAD_NORM_RTOL * norm0, (norm_f, norm0)
    assert min(cos.values()) >= ATTN_LEAF_COS_MIN, cos

    # An evaluation, an optimizer step, the evaluation again: the FSDP2
    # EMA's bf16 casts are made afresh every call (none is cached across
    # its all-gathers), and the evaluation after the step is the plain
    # model's on the EMA gathered then, within BPD_TOL: their bf16
    # forwards round apart (2.5e-5 and 1.1e-4 bpd in two runs on an H100
    # 80GB HBM3 at 700 W).
    def evaluate():
      before = layers.cast_param.casts
      (scalars, secs), counts = counted(lambda: timed(
          lambda: exf.eval_step(batches[0], 0)), route_totals)
      assert counts == expected_launches(cfg, 'eval'), counts
      return float(scalars['bpd']), layers.cast_param.casts - before, secs
    bpd_e1, casts_e1, eval_s = evaluate()
    exf.train_step(batches[0])
    bpd_e2, casts_e2, _ = evaluate()
    paths['parallel_fsdp_eval'] = times(expected_launches(cfg, 'eval'), 2)
    ema = {k: full(v) for k, v in exf.state.ema_params.items()}
    plain = build_model(train_cfg.vdm_type, cfg, device=dev, state=ema)
    exf.reseed(EVAL, 0)
    with torch.no_grad():
      bpd_plain = float(exf.loss_fn(plain, batches[0], train=False)[0])
    del plain, ema
    log('parallel_fsdp_eval', bpd_before_step=bpd_e1, bpd_after_step=bpd_e2,
        plain_on_gathered_ema=bpd_plain,
        after_step_from_plain=abs(bpd_e2 - bpd_plain),
        before_step_from_plain=abs(bpd_e1 - bpd_plain),
        casts_before_step=casts_e1, casts_after_step=casts_e2,
        eval_seconds=eval_s)
    # The casts are the check that nothing stale is reused: one step moves
    # the EMA's bpd by less than BPD_TOL (2.7e-3 on the same card).
    assert casts_e1 > 0 and casts_e2 == casts_e1, (casts_e1, casts_e2)
    assert abs(bpd_e2 - bpd_plain) <= BPD_TOL, (bpd_e2, bpd_plain)

    # PAR_SAMPLE_STEPS sampler steps under FSDP2 and unwrapped: the bf16
    # casts and the time a step.
    sampled = {}
    for name, ex in (('fsdp', exf), ('unwrapped', ex0)):
      before = layers.cast_param.casts
      ((grid, secs)), counts = counted(lambda: timed(lambda: ex.draw_samples(
          SAMPLE_BATCH, T=PAR_SAMPLE_STEPS)), route_totals)
      assert counts == times(expected_launches(cfg, 'sample'),
                             PAR_SAMPLE_STEPS), counts
      assert grid.dtype.name == 'uint8' and grid.size > 0
      sampled[name] = dict(
          casts=layers.cast_param.casts - before,
          ms_per_step=1e3 * secs / PAR_SAMPLE_STEPS)
      paths[f'parallel_{name}_sample'] = counts
    log('parallel_fsdp_sampler', steps=PAR_SAMPLE_STEPS, batch=SAMPLE_BATCH,
        **{f'{k}_{name}': v for name, r in sampled.items()
           for k, v in r.items()})
    # Unwrapped, the first step casts the score UNet's weights and the
    # others reuse the casts; under FSDP2 every step casts them.
    assert sampled['unwrapped']['casts'] > 0 and sampled['fsdp']['casts'] == (
        PAR_SAMPLE_STEPS * sampled['unwrapped']['casts']), sampled
    del exf
  finally:
    dist.destroy_process_group()
  del ex0
  torch.cuda.empty_cache()
  numbers.update(
      unwrapped_ms_per_step=ms0, ddp_w1_ms_per_step=ms_d,
      fsdp_w1_ms_per_step=ms_f, unwrapped_peak_gb=peak0, ddp_w1_peak_gb=peak_d,
      fsdp_w1_peak_gb=peak_f, ddp_w1_bit_for_bit=bpd_d == bpd0,
      unwrapped_repeats_bit_for_bit=repeats, fsdp_w1_max_abs_delta=fsdp_delta,
      fsdp_eval_casts=casts_e1, sampler=sampled)

  # 2. PAR_RANKS ranks on the one card over gloo, against the unwrapped
  # steps on the same global batches and noise.
  out_dir = tempfile.mkdtemp()
  spawn_ranks('--parallel-rank', out_dir)
  ranks = [json.loads(pathlib.Path(out_dir, f'rank{r}.json').read_text())
           for r in range(PAR_RANKS)]
  for mode in ('ddp', 'fsdp'):
    got = ranks[0][mode]['bpd']
    assert all(r[mode]['bpd'] == got for r in ranks), ranks
    delta = max(abs(a - b) for a, b in zip(got, bpd0))
    log(f'parallel_gloo_{mode}', ranks=PAR_RANKS, rows_a_rank=EVAL_BATCH //
        PAR_RANKS, bpd=got, one_process_bpd=bpd0[:PAR_GLOO_STEPS],
        max_abs_delta=delta, tol=TRAIN_BPD_TOL,
        ms_per_step_two_ranks_on_one_card=[r[mode]['ms_per_step']
                                           for r in ranks],
        peak_gb=[r[mode]['peak_gb'] for r in ranks])
    assert delta <= TRAIN_BPD_TOL, (mode, got, bpd0)
    paths[f'parallel_gloo_{mode}_rank0'] = ranks[0][mode]['launches']
    for name, by_route in ranks[0][mode]['routes'].items():
      total = route_totals.setdefault(name, dict.fromkeys(by_route, 0))
      for r, n in by_route.items():
        total[r] += n
    numbers[f'gloo_{mode}'] = dict(
        bpd=got, max_abs_delta=delta,
        ms_per_step_two_ranks_on_one_card=[r[mode]['ms_per_step']
                                           for r in ranks],
        peak_gb=[r[mode]['peak_gb'] for r in ranks])
  numbers['rank_masks'] = [r['masks'] for r in ranks]
  return paths, numbers


def rank_mask_times(dev, cfg, imul_rate):
  """K6 at one site and K7 at the score UNet's sites, at a rank's rows
  (EVAL_BATCH // PAR_RANKS) and rank 1's first_index, timed beside their
  plain versions and bounds; bit for bit the rows of the global masks."""
  from mulan_tpu_torch.ops.dropout import (dropout_mask, dropout_mask_batch,
                                           dropout_mask_batch_plain,
                                           dropout_mask_plain)
  rate = cfg.sm_pdrop
  rows = EVAL_BATCH // PAR_RANKS
  shape = (rows, cfg.sm_n_embd, cfg.image_size, cfg.image_size)
  first = rows * math.prod(shape[1:])
  n_sites = 2 * cfg.sm_n_layer + 3
  out = {}
  for name, run, plain, n_masks in (
      ('dropout_mask', lambda: dropout_mask(
          PAR_MASK_SEED, PAR_MASK_SITE, shape, rate, torch.bfloat16, dev,
          first_index=first), lambda: dropout_mask_plain(
              PAR_MASK_SEED, PAR_MASK_SITE, shape, rate, torch.bfloat16,
              dev, first_index=first), 1),
      ('dropout_mask_batch', lambda: dropout_mask_batch(
          PAR_MASK_SEED, 0, n_sites, shape, rate, torch.bfloat16, dev,
          first_index=first), lambda: dropout_mask_batch_plain(
              PAR_MASK_SEED, 0, n_sites, shape, rate, torch.bfloat16, dev,
              first_index=first), n_sites)):
    mask = run()
    ref = plain()
    assert torch.equal(mask, ref), name
    counters = n_masks * ((math.prod(shape) + 7) // 8)
    out[name] = dict(
        shape=list(shape), first_index=first, ms=cuda_ms(run),
        back_to_back_ms=back_to_back_ms(run, n=5),
        plain_ms=cuda_ms(plain, n=3 if n_masks > 1 else 20),
        max_abs_err=(mask.float() - ref.float()).abs().max().item(),
        **bound(0.0, nbytes(mask), imuls=PHILOX_MULS * counters,
                imul_rate=imul_rate))
    del mask, ref
    log(f'{name}_at_rank_rows', **out[name])
  return out


def parallel_worker(flag: str) -> None:
  """One of the ranks that share the card over gloo (`--parallel-rank R
  --port P --out DIR --world N`: phase 16's, see `gloo_rank`;
  `--tensor-rank R ...` and `--gn-rank R ...`: phase 17's, see
  `tensor_rank` and `gathered_gn_rank`)."""
  import torch.distributed as dist
  from mulan_tpu_torch.ops import _build
  if not torch.cuda.is_available():
    raise SystemExit('chip_smoke: the parallel worker needs a CUDA device')
  argv = sys.argv[1:]
  rank = int(argv[argv.index(flag) + 1])
  port = int(argv[argv.index('--port') + 1])
  out_dir = argv[argv.index('--out') + 1]
  world = int(argv[argv.index('--world') + 1])
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device('cuda', 0)
  torch.cuda.set_device(dev)
  _build.load_library()  # built by the parent: loaded, not rebuilt
  dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}',
                          rank=rank, world_size=world)
  try:
    {'--parallel-rank': gloo_rank, '--tensor-rank': tensor_rank,
     '--gn-rank': gathered_gn_rank}[flag](rank, dev, out_dir)
  finally:
    dist.destroy_process_group()


def gloo_rank(rank: int, dev, out_dir: str) -> None:
  """Rank `rank` of phase 16's gloo pod: PAR_GLOO_STEPS flagship train
  steps at its EVAL_BATCH // PAR_RANKS rows of each global batch under DDP,
  then under training.fsdp = PAR_RANKS; its K6 and K7 masks at its
  first_index against the rows of the global masks; the attention blocks'
  inputs and K1-K3's routes. Writes OUT_DIR/rank<R>.json."""
  from mulan_tpu_torch import configs, data, params
  from mulan_tpu_torch.models import layers
  from mulan_tpu_torch.ops.dropout import dropout_mask, dropout_mask_batch
  from mulan_tpu_torch.ops.flash_attention import attention_route
  from mulan_tpu_torch.train.loop import Experiment
  train_cfg = configs.replace(
      configs.cifar10_conditioned(), data={'dataset': 'synthetic'},
      training={'steps_per_logging': TRAIN_STEPS, 'substeps': 1})
  cfg = train_cfg.model
  state = params.init_params(cfg, torch.Generator().manual_seed(SEED),
                             perturb_zero_init=0.02)
  images, _ = data.synthetic_split('eval', cfg.image_shape, seed=SEED)
  rows = EVAL_BATCH // PAR_RANKS
  batches = [{'images': b['images'][rank * rows:(rank + 1) * rows]}
             for b in par_batches(images, PAR_GLOO_STEPS)]
  result = {}
  attn_inputs = set()
  for mode, fsdp in (('ddp', 1), ('fsdp', PAR_RANKS)):
    ex = Experiment(configs.replace(train_cfg, training={'fsdp': fsdp}),
                    device=dev, state=state)
    hooks = [m.register_forward_pre_hook(
        lambda m, a: attn_inputs.add(tuple(a[0].shape)))
             for m in ex.model.modules() if isinstance(m, layers.AttnBlock)]
    route_totals = {}
    bpds, ms, peak, counts = par_train(ex, batches, route_totals)
    for h in hooks:
      h.remove()
    result[mode] = dict(bpd=bpds, ms_per_step=ms, peak_gb=peak,
                        launches=counts, routes=route_totals)
    log(f'gloo_{mode}', rank=rank, **result[mode])
    del ex
    torch.cuda.empty_cache()
  # K1-K3 saw the rank's rows: the attention blocks' inputs, one
  # (rows, C, H, W) shape, (rows, 1, H W, C) in the kernels.
  assert attn_inputs == {(rows, cfg.sm_n_embd, cfg.image_size,
                          cfg.image_size)}, attn_inputs
  assert attention_route(torch.bfloat16, cfg.sm_n_embd) == 'sm90'
  # The rank's K6 and K7 masks at its first_index: the global masks'
  # rows, bit for bit.
  shape = (rows, cfg.sm_n_embd, cfg.image_size, cfg.image_size)
  first = rank * rows * math.prod(shape[1:])
  n_sites = 2 * cfg.sm_n_layer + 3
  args = (cfg.sm_pdrop, torch.bfloat16, dev)
  glob = (EVAL_BATCH, *shape[1:])
  k6 = torch.equal(
      dropout_mask(PAR_MASK_SEED, PAR_MASK_SITE, shape, *args,
                   first_index=first),
      dropout_mask(PAR_MASK_SEED, PAR_MASK_SITE, glob, *args)[
          rank * rows:(rank + 1) * rows])
  k7 = torch.equal(
      dropout_mask_batch(PAR_MASK_SEED, 0, n_sites, shape, *args,
                         first_index=first),
      dropout_mask_batch(PAR_MASK_SEED, 0, n_sites, glob, *args)[
          :, rank * rows:(rank + 1) * rows])
  result['masks'] = dict(first_index=first, k6_rows_equal=k6,
                         k7_rows_equal=k7)
  log('gloo_masks', rank=rank, **result['masks'])
  assert k6 and k7, result['masks']
  pathlib.Path(out_dir, f'rank{rank}.json').write_text(json.dumps(result))


# -- phase 17: tensor parallelism ----------------------------------------------------


def tp_config(train_cfg, tp: int):
  """The flagship at TP_ROWS rows a batch (every rank of a tensor group
  holds the same rows), with a 'tensor' axis of tp ranks."""
  from mulan_tpu_torch import configs
  return configs.replace(train_cfg, training={
      'tp': tp, 'batch_size_train': TP_ROWS, 'batch_size_eval': TP_ROWS})


def tp_batches(images):
  return [{'images': images[s * TP_ROWS:(s + 1) * TP_ROWS]}
          for s in range(TP_STEPS)]


def tp_grads(ex):
  """(the global gradient norm, {leaf: whole gradient} of the attention
  blocks' and GroupNorms' leaves) of the experiment's last step: whole
  over the tensor group (a collective under tensor parallelism)."""
  from mulan_tpu_torch.parallel import tensor as tensor_lib
  from mulan_tpu_torch.train.optimizer import global_norm
  opt = ex.state.optimizer
  grads = [p.grad for p in opt.params]
  norm = float(global_norm(grads, opt._tensor_split, opt.tensor))
  leaves = {n: tensor_lib.gather_tensor(n, p.grad, opt.tensor).flatten()
            .double().cpu() for n, p in ex.state.params.items()
            if ('_attn' in n or 'GroupNorm' in n) and p.grad is not None}
  return norm, leaves


def tp_sparse_bpd(model, images, mesh=None):
  """The sparse VLB of one TP_ROWS batch, its noise from SEED, its rows
  split over the batch coordinates of `mesh`."""
  from mulan_tpu_torch.evals import vlb
  gen = torch.Generator(device=next(model.parameters()).device)
  return vlb.eval_bpd_sparse(model, [{'images': images[:TP_ROWS]}],
                             generator=gen.manual_seed(SEED), mesh=mesh)


def tp_window_masks(dev, cfg, rank: int, size: int):
  """K6 at one site and K7 under `dropout_masks` (the path of
  `dropout_mask_batch`) at rank's channel window of a (TP_ROWS, C, H, W)
  site: kernel against plain, both against the window of the
  one-process mask, bit for bit."""
  from mulan_tpu_torch.ops import dropout as drop
  shape = (TP_ROWS, cfg.sm_n_embd, cfg.image_size, cfg.image_size)
  c = shape[1] // size
  local = (TP_ROWS, c, *shape[2:])
  window = (rank * c, shape[1])
  first, stride = drop.channel_window(0, local, window)
  n_sites = 2 * cfg.sm_n_layer + 3
  args = (cfg.sm_pdrop, torch.bfloat16, dev)
  k6 = drop.dropout_mask(PAR_MASK_SEED, PAR_MASK_SITE, local, *args,
                         first_index=first, row_stride=stride)
  k6_plain = drop.dropout_mask_plain(PAR_MASK_SEED, PAR_MASK_SITE, local,
                                     *args, first_index=first,
                                     row_stride=stride)
  k6_whole = drop.dropout_mask(PAR_MASK_SEED, PAR_MASK_SITE, shape, *args)[
      :, rank * c:(rank + 1) * c]
  k7 = drop.dropout_masks(PAR_MASK_SEED, 0, n_sites, local, *args, True, 0,
                          window)
  k7_plain = drop.dropout_masks(PAR_MASK_SEED, 0, n_sites, local, *args,
                                False, 0, window)
  k7_whole = drop.dropout_mask_batch(PAR_MASK_SEED, 0, n_sites, shape,
                                     *args)[:, :, rank * c:(rank + 1) * c]
  out = dict(window=list(window), k6_equals_plain=torch.equal(k6, k6_plain),
             k6_equals_whole=torch.equal(k6, k6_whole),
             k7_equals_plain=torch.equal(k7, k7_plain),
             k7_equals_whole=torch.equal(k7, k7_whole))
  assert all(v for k, v in out.items() if k != 'window'), out
  return out


def tp_window_kernels(dev, gen, cfg, imul_rate, sfu_rate):
  """K6 and K7 at rank 1's channel window of a (TP_ROWS, C, 32, 32) site,
  and K8 and its backward at a rank's (TP_ROWS, C / 2, 32, 32) with 16
  groups: against plain, timed (one launch and back to back) beside the
  plain versions and their bounds."""
  from mulan_tpu_torch.ops import dropout as drop
  shape = (TP_ROWS, cfg.sm_n_embd // PAR_RANKS, cfg.image_size,
           cfg.image_size)
  first, stride = drop.channel_window(0, shape, (shape[1], cfg.sm_n_embd))
  n_sites = 2 * cfg.sm_n_layer + 3
  out = {}
  for name, run, plain, n_masks in (
      ('dropout_mask', lambda: drop.dropout_mask(
          PAR_MASK_SEED, PAR_MASK_SITE, shape, cfg.sm_pdrop, torch.bfloat16,
          dev, first, stride), lambda: drop.dropout_mask_plain(
              PAR_MASK_SEED, PAR_MASK_SITE, shape, cfg.sm_pdrop,
              torch.bfloat16, dev, first, stride), 1),
      ('dropout_mask_batch', lambda: drop.dropout_mask_batch(
          PAR_MASK_SEED, 0, n_sites, shape, cfg.sm_pdrop, torch.bfloat16,
          dev, first, stride), lambda: drop.dropout_mask_batch_plain(
              PAR_MASK_SEED, 0, n_sites, shape, cfg.sm_pdrop,
              torch.bfloat16, dev, first, stride), n_sites)):
    mask, ref = run(), plain()
    assert torch.equal(mask, ref), name
    counters = n_masks * ((math.prod(shape) + 7) // 8)
    out[name] = dict(
        shape=list(shape), first_index=first, row_stride=stride,
        ms=cuda_ms(run), back_to_back_ms=back_to_back_ms(run, n=5),
        plain_ms=cuda_ms(plain, n=3 if n_masks > 1 else 20),
        max_abs_err=(mask.float() - ref.float()).abs().max().item(),
        **bound(0.0, nbytes(mask), imuls=PHILOX_MULS * counters,
                imul_rate=imul_rate))
    del mask, ref
    log(f'{name}_at_tensor_window', **out[name])
  case = ((shape, torch.bfloat16, 16, True),)
  out['gn_swish'] = check_gn_swish(dev, gen, sfu_rate, case)[0]
  out['gn_swish_bwd'] = check_gn_swish_bwd(dev, gen, sfu_rate, case)[0]
  for name in ('gn_swish', 'gn_swish_bwd'):
    out[name]['shape'] = list(shape)
  return out


class CollectiveMeter:
  """Counts the tensor group's collectives (`parallel/tensor.py`): calls,
  the bytes each result holds (a gather's whole tensor, a sum's float32
  buffer) and the host's seconds inside them, the device synchronized
  before each (the gloo path copies through the host, which would
  otherwise wait there for the compute before it)."""

  def __init__(self):
    from mulan_tpu_torch.parallel import tensor as tensor_lib
    self.lib = tensor_lib
    self.real = {n: getattr(tensor_lib, n) for n in ('_gather_parts', '_sum')}
    self.reset()
    for name, fn in self.real.items():
      setattr(tensor_lib, name, self._wrap(fn))

  def reset(self):
    self.calls, self.bytes, self.seconds = 0, 0, 0.0

  def _wrap(self, fn):
    def counted_call(x, tensor):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      out = fn(x, tensor)
      self.seconds += time.perf_counter() - t0
      self.calls += 1
      self.bytes += out.numel() * (4 if fn.__name__ == '_sum'
                                   else out.element_size())
      return out
    return counted_call

  def close(self):
    for name, fn in self.real.items():
      setattr(self.lib, name, fn)


def tensor_rank(rank: int, dev, out_dir: str) -> None:
  """Rank `rank` of phase 17's gloo pod: TP_STEPS flagship train steps at
  the same TP_ROWS rows on every rank with training.tp = PAR_RANKS, the
  first step's gradient norm and its attention and GroupNorm leaves
  gathered whole (rank 0 saves them), the collectives' calls, bytes and
  host seconds a step, one sparse-VLB batch, its K6 and K7 masks at its
  channel window, and K1-K3's routes. Writes OUT_DIR/tensor<R>.json."""
  from mulan_tpu_torch import configs, data, params
  from mulan_tpu_torch.models import build_model, layers
  from mulan_tpu_torch.ops.flash_attention import attention_route
  from mulan_tpu_torch.train.loop import Experiment
  train_cfg = configs.replace(
      configs.cifar10_conditioned(), data={'dataset': 'synthetic'},
      training={'steps_per_logging': TRAIN_STEPS, 'substeps': 1})
  cfg = train_cfg.model
  state = params.init_params(cfg, torch.Generator().manual_seed(SEED),
                             perturb_zero_init=0.02)
  images, _ = data.synthetic_split('eval', cfg.image_shape, seed=SEED)
  meter = CollectiveMeter()
  ex = Experiment(tp_config(train_cfg, PAR_RANKS), device=dev, state=state)
  tensor = ex.state.optimizer.tensor
  assert (tensor.rank, tensor.size) == (rank, PAR_RANKS), tensor
  attn_inputs = set()
  hooks = [m.register_forward_pre_hook(
      lambda m, a: attn_inputs.add(tuple(a[0].shape)))
           for m in ex.model.score_model.modules()
           if isinstance(m, layers.AttnBlock)]
  grads, route_totals, per_step = {}, {}, []

  def after_first(e):
    per_step.append((meter.calls, meter.bytes, meter.seconds))
    grads['first'] = tp_grads(e)
    meter.reset()
  bpds, ms, peak, counts = par_train(ex, tp_batches(images), route_totals,
                                     after_first)
  per_step.append((meter.calls, meter.bytes, meter.seconds))
  for h in hooks:
    h.remove()
  norm, leaves = grads['first']
  mesh = ex.mesh
  del ex
  torch.cuda.empty_cache()
  model = build_model(train_cfg.vdm_type, cfg, device=dev, state=state,
                      tensor=tensor)
  (bpd_eval, eval_s), eval_counts = counted(lambda: timed(
      lambda: tp_sparse_bpd(model, images, mesh)), route_totals)
  assert eval_counts == expected_launches(cfg, 'eval'), eval_counts
  del model
  meter.close()
  # The score UNet's attention blocks take the rank's channels (and run
  # K1-K3 on the gathered ones, whole on every rank).
  assert attn_inputs == {(TP_ROWS, cfg.sm_n_embd // PAR_RANKS,
                          cfg.image_size, cfg.image_size)}, attn_inputs
  assert attention_route(torch.bfloat16, cfg.sm_n_embd) == 'sm90'
  result = dict(
      bpd=bpds, ms_per_step=ms, peak_gb=peak, launches=counts,
      eval_launches=eval_counts, routes=route_totals, grad_norm=norm,
      sparse_bpd=bpd_eval, sparse_seconds=eval_s,
      collectives_per_step=[dict(calls=c, bytes=b, host_seconds=t)
                            for c, b, t in per_step],
      masks=tp_window_masks(dev, cfg, rank, PAR_RANKS))
  log('tensor_gloo', rank=rank, **result)
  if rank == 0:
    torch.save(leaves, pathlib.Path(out_dir, 'tensor_leaves.pt'))
  pathlib.Path(out_dir, f'tensor{rank}.json').write_text(json.dumps(result))


def gathered_gn_rank(rank: int, dev, out_dir: str) -> None:
  """Rank `rank` of TP_GN_RANKS: the fused GroupNormF32 of TP_GN_CHANNELS
  channels on its slice (see TP_GN_RANKS), forward and backward with the
  kernels, against the plain whole GN-swish (the same inputs on every
  rank, from SEED), and K8's and its backward's launches in that run.
  Writes OUT_DIR/gn<R>.json."""
  import torch.distributed as dist
  from mulan_tpu_torch.models.layers import GroupNormF32
  from mulan_tpu_torch.ops import groupnorm_swish as gn_ops
  from mulan_tpu_torch.parallel import tensor as tensor_lib
  tensor = tensor_lib.TensorGroup(rank, TP_GN_RANKS, dist.group.WORLD)
  c = TP_GN_CHANNELS
  gen = torch.Generator(device=dev).manual_seed(SEED)
  shape = (TP_ROWS, c, 32, 32)
  x = (2 * torch.randn(shape, generator=gen, device=dev) + 0.5).to(
      torch.bfloat16)
  dy = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
  w = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
  b = 0.1 * torch.randn(c, generator=gen, device=dev)
  norm = GroupNormF32(c, fused_swish=True, use_kernels=True,
                      tensor=tensor).to(dev)
  assert norm.gathered, 'the groups must straddle the ranks'
  norm.load_state_dict({'weight': tensor_lib.take(w, tensor, 0),
                        'bias': tensor_lib.take(b, tensor, 0)})
  xr = tensor_lib.take(x, tensor).contiguous().requires_grad_()
  before = (gn_ops.gn_swish_fwd.launches, gn_ops.gn_swish_bwd.launches)
  y = norm(xr)
  y.backward(tensor_lib.take(dy, tensor).contiguous())
  torch.cuda.synchronize()
  launches = [gn_ops.gn_swish_fwd.launches - before[0],
              gn_ops.gn_swish_bwd.launches - before[1]]
  xw, ww, bw = (t.clone().requires_grad_() for t in (x, w, b))
  want = gn_ops.gn_swish(xw, ww, bw, norm.num_groups, 1e-6, False)
  want.backward(dy)
  want_y = tensor_lib.take(want.detach(), tensor).float()
  rtol, atol = GN_TOL[torch.bfloat16]
  diff = (y.detach().float() - want_y).abs()
  result = dict(
      shape=list(xr.shape), groups=norm.num_groups, launches=launches,
      max_abs_err=diff.max().item(),
      max_excess_over_rtol=(diff - rtol * want_y.abs()).max().item(),
      dx_cos=cosine(xr.grad.flatten().double(), tensor_lib.take(
          xw.grad, tensor).flatten().double()),
      dx_max_abs_err=(xr.grad.float() - tensor_lib.take(
          xw.grad, tensor).float()).abs().max().item(),
      dweight_rel_err=rel_err(norm.weight.grad,
                              tensor_lib.take(ww.grad, tensor, 0)),
      dbias_rel_err=rel_err(norm.bias.grad,
                            tensor_lib.take(bw.grad, tensor, 0)))
  log('gathered_gn_swish', rank=rank, rtol=rtol, atol=atol,
      cos_min=GN_ALONE_COS_MIN, sum_rtol=GN_BWD_SUM_RTOL, **result)
  pathlib.Path(out_dir, f'gn{rank}.json').write_text(json.dumps(result))


def spawn_ranks(flag: str, out_dir: str, world: int = PAR_RANKS):
  """Runs `world` copies of this script with `flag` RANK --port P --out
  OUT_DIR --world N; prints their bracketed lines and asserts that each
  exited 0."""
  port = free_port()
  procs = [subprocess.Popen(
      [sys.executable, os.path.abspath(__file__), flag, str(r), '--port',
       str(port), '--out', out_dir, '--world', str(world)],
      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
           for r in range(world)]
  outs = []
  try:
    for proc in procs:
      try:
        outs.append(proc.communicate(timeout=PAR_WORKER_TIMEOUT_S)[0])
      except subprocess.TimeoutExpired:
        for p in procs:
          p.kill()
        outs.append(proc.communicate()[0] + '\n<<< timed out >>>')
  finally:
    for proc in procs:
      if proc.poll() is None:
        proc.kill()
  for r, (proc, out) in enumerate(zip(procs, outs)):
    for line in out.splitlines():
      if line.startswith('['):
        print(f'[rank {r}] {line}', flush=True)
    assert proc.returncode == 0, f'rank {r} failed:\n{out[-6000:]}'


def run_tensor_parallel(dev, gen, train_cfg, images, route_totals,
                        imul_rate, sfu_rate):
  """Phase 17. Returns ({path: launches}, the phase's numbers, the window
  kernels' results)."""
  import torch.distributed as dist
  from torch.distributed.device_mesh import init_device_mesh
  from mulan_tpu_torch import params
  from mulan_tpu_torch.models import build_model
  from mulan_tpu_torch.parallel import mesh as mesh_lib
  from mulan_tpu_torch.train.loop import Experiment
  cfg = train_cfg.model
  one_cfg = tp_config(train_cfg, 1)
  state = params.init_params(cfg, torch.Generator().manual_seed(SEED),
                             perturb_zero_init=0.02)
  batches = tp_batches(images)
  paths, grads = {}, {}

  # 1. One process on the TP_ROWS rows (twice: how far its steps repeat);
  # the sparse VLB of one batch.
  ex0 = Experiment(one_cfg, device=dev, state=state)
  bpd0, ms0, _, paths['tensor_unwrapped'] = par_train(
      ex0, batches, route_totals, lambda ex: grads.update(one=tp_grads(ex)))
  del ex0
  again = Experiment(one_cfg, device=dev, state=state)
  repeats = par_train(again, batches, {})[0] == bpd0  # a repeat, not a path
  del again
  model = build_model(train_cfg.vdm_type, cfg, device=dev, state=state)
  bpd_eval0 = tp_sparse_bpd(model, images)
  del model
  torch.cuda.empty_cache()

  # 2. A tensor mesh of size 1 at world 1 over NCCL: the unwrapped step.
  dist.init_process_group('nccl' if dev.type == 'cuda' else 'gloo',
                          init_method=f'tcp://127.0.0.1:{free_port()}',
                          rank=0, world_size=1)
  try:
    mesh = init_device_mesh(dev.type, (1, 1), mesh_dim_names=(
        mesh_lib.DATA_AXIS, mesh_lib.TENSOR_AXIS))
    ext = Experiment(one_cfg, device=dev, state=state, mesh=mesh)
    assert ext.state.optimizer.tensor.size == 1
    bpd_t1, ms_t1, _, paths['tensor_w1'] = par_train(ext, batches,
                                                     route_totals)
    del ext
  finally:
    dist.destroy_process_group()
  log('tensor_world1', bpd=bpd_t1, unwrapped_bpd=bpd0,
      bit_for_bit=bpd_t1 == bpd0, unwrapped_repeats_bit_for_bit=repeats,
      ms_per_step=ms_t1, unwrapped_ms_per_step=ms0)
  assert bpd_t1 == bpd0 if repeats else max(
      abs(a - b) for a, b in zip(bpd_t1, bpd0)) <= TRAIN_BPD_TOL, (
          bpd_t1, bpd0)
  torch.cuda.empty_cache()

  # 3. PAR_RANKS ranks on the card over gloo, tp = PAR_RANKS.
  out_dir = tempfile.mkdtemp()
  spawn_ranks('--tensor-rank', out_dir)
  ranks = [json.loads(pathlib.Path(out_dir, f'tensor{r}.json').read_text())
           for r in range(PAR_RANKS)]
  got = ranks[0]
  assert all(r['bpd'] == got['bpd'] for r in ranks), ranks
  norm0, leaves0 = grads['one']
  leaves = torch.load(pathlib.Path(out_dir, 'tensor_leaves.pt'))
  cos = leaf_cosines(leaves, leaves0)
  attn_cos = min(v for k, v in cos.items() if '_attn' in k)
  gn_cos = min(v for k, v in cos.items() if 'GroupNorm' in k)
  delta = max(abs(a - b) for a, b in zip(got['bpd'], bpd0))
  eval_delta = abs(got['sparse_bpd'] - bpd_eval0)
  steps = got['collectives_per_step']
  numbers = dict(
      ranks=PAR_RANKS, rows=TP_ROWS, bpd=got['bpd'], one_process_bpd=bpd0,
      max_abs_delta=delta, tol=TRAIN_BPD_TOL, first_step_grad_norm=[
          r['grad_norm'] for r in ranks], one_process_grad_norm=norm0,
      attention_leaf_cos_min=attn_cos, groupnorm_leaf_cos_min=gn_cos,
      ms_per_step_two_ranks_on_one_card=[r['ms_per_step'] for r in ranks],
      one_process_ms_per_step=ms0, world1_ms_per_step=ms_t1,
      world1_bit_for_bit=bpd_t1 == bpd0,
      collectives_second_step=steps[-1], collectives_first_step=steps[0],
      collective_share_of_second_step=steps[-1]['host_seconds'] / (
          got['ms_per_step'] / 1e3),
      peak_gb=[r['peak_gb'] for r in ranks], sparse_bpd=got['sparse_bpd'],
      one_process_sparse_bpd=bpd_eval0, sparse_abs_delta=eval_delta,
      masks=[r['masks'] for r in ranks])
  log('tensor_gloo', **numbers)
  assert delta <= TRAIN_BPD_TOL, (got['bpd'], bpd0)
  assert all(abs(r['grad_norm'] - norm0) <= TP_GRAD_NORM_RTOL * norm0
             for r in ranks), (numbers['first_step_grad_norm'], norm0)
  assert min(attn_cos, gn_cos) >= ATTN_LEAF_COS_MIN, cos
  assert eval_delta <= BPD_TOL, (got['sparse_bpd'], bpd_eval0)
  assert got['launches'] == times(expected_launches(cfg, 'train'),
                                  TP_STEPS), got['launches']
  paths['tensor_gloo_rank0'] = got['launches']
  paths['tensor_gloo_rank0_eval'] = got['eval_launches']
  for name, by_route in got['routes'].items():
    total = route_totals.setdefault(name, dict.fromkeys(by_route, 0))
    for r, n in by_route.items():
      total[r] += n

  # 4. TP_GN_RANKS ranks over gloo: the gathered GroupNorm's K8 and its
  # backward.
  gn_dir = tempfile.mkdtemp()
  spawn_ranks('--gn-rank', gn_dir, TP_GN_RANKS)
  gn = [json.loads(pathlib.Path(gn_dir, f'gn{r}.json').read_text())
        for r in range(TP_GN_RANKS)]
  numbers['gathered_gn_swish'] = gn
  rtol, atol = GN_TOL[torch.bfloat16]
  for r in gn:
    assert r['launches'] == [1, 1], gn
    assert r['max_excess_over_rtol'] <= atol, gn
    assert r['dx_cos'] >= GN_ALONE_COS_MIN, gn
    assert max(r['dweight_rel_err'], r['dbias_rel_err']) <= (
        GN_BWD_SUM_RTOL), gn

  # 5. K6, K7 and K8 at the window's shapes, timed.
  window = tp_window_kernels(dev, gen, cfg, imul_rate, sfu_rate)
  return paths, numbers, window


def trace_kernel_counts(path: str):
  """({counter: kernel events}, kernel ms) of a torch.profiler Chrome
  trace: each CUDA kernel event named as TRACE_KERNEL_NAMES names a
  wrapper's kernel, and the time of every kernel event."""
  import re
  with open(path) as f:
    events = [e for e in json.load(f)['traceEvents']
              if e.get('cat') == 'kernel']
  owner = {k: name for name, kernels in TRACE_KERNEL_NAMES.items()
           for k in kernels}
  counts = dict.fromkeys(TRACE_KERNEL_NAMES, 0)
  for e in events:
    base = re.match(r'\w+', e['name'].replace('(anonymous namespace)::', '')
                    .removeprefix('void ')).group(0)
    if base in owner:
      counts[owner[base]] += 1
  return counts, sum(e['dur'] for e in events) / 1e3


def host_array(x):
  """A batch's array on the host: a copy of a tensor (the super-step hands
  `train_step` views of its device copy), or numpy's own."""
  import numpy as np
  if isinstance(x, torch.Tensor):
    return x.cpu().numpy()
  return np.array(x)


def check_augmented_batches(steps, conditioning, source, seed: int,
                            batch: int):
  """Each recorded train batch holds per-image permutations of the pixels
  of its source images (the train split in the order of the iterator's
  first permutation, drawn from `seed`); an image whose aug bit is 0 is
  its source unchanged; the conditioning that reached `loss_fn` is the
  batch's aug bit. Returns (the bits' share of ones, the share of images
  that differ from their source)."""
  import numpy as np
  order = np.random.default_rng(seed).permutation(len(source))
  bits, changed = [], []
  for i, (b, _) in enumerate(steps):
    images = host_array(b['images'])
    src = source[order[i * batch:(i + 1) * batch]]
    flat, src_flat = images.reshape(batch, -1), src.reshape(batch, -1)
    assert (np.sort(flat, axis=1) == np.sort(src_flat, axis=1)).all(), i
    bit = host_array(b['conditioning'])
    assert bit.dtype == np.uint8 and set(np.unique(bit)) <= {0, 1}, bit
    differs = (flat != src_flat).any(axis=1)
    assert not differs[bit == 0].any(), i
    np.testing.assert_array_equal(np.asarray(conditioning[i]), bit)
    bits.append(bit)
    changed.append(differs)
  return (float(np.concatenate(bits).mean()),
          float(np.concatenate(changed).mean()))


def run_remaining_surface(dev, route_totals):
  """Phase 18: augmentation, the profile hook, nan_guard, the writer and
  the analysis primitives on the flagship, as described at
  SURFACE_EXAMPLES. Returns ({path: launches}, the numbers logged)."""
  import numpy as np
  from types import SimpleNamespace
  from mulan_tpu_torch import analysis, configs, data, params
  from mulan_tpu_torch import main as main_lib
  from mulan_tpu_torch.models import build_model, latents, layers
  from mulan_tpu_torch.train.loop import Experiment
  from mulan_tpu_torch.utils import metrics
  numbers, paths = {}, {}
  tmp = tempfile.TemporaryDirectory()
  root = os.path.join(tmp.name, 'cifar10_aug_with_channel')
  os.makedirs(root)
  args, overrides = main_lib.parser().parse_known_args([
      '--config=cifar10_conditioned', f'--workdir={tmp.name}', '--nan_guard',
      f'--config.data.dataset=npz:{root}',
      '--config.training.profile=True', '--config.training.substeps=1',
      f'--config.training.num_steps_train={SURFACE_STEPS}',
      f'--config.training.num_steps_eval={SURFACE_EVAL_BATCHES}',
      '--config.training.steps_per_logging=1',
      f'--config.training.steps_per_eval={SURFACE_STEPS}',
      f'--config.training.steps_per_save={SURFACE_STEPS}'])
  cfg = main_lib.config_from_args(args, overrides)
  assert cfg.training.nan_guard and cfg.training.profile, cfg.training
  shape = cfg.model.image_shape
  splits = {s: data.synthetic_split(s, shape, seed=SEED,
                                    examples=SURFACE_EXAMPLES)
            for s in ('train', 'eval')}
  for split, (images, labels) in splits.items():
    np.savez(os.path.join(root, f'{split}.npz'), images=images,
             labels=labels)
  state = params.init_params(cfg.model, torch.Generator().manual_seed(SEED),
                             perturb_zero_init=0.02)

  # 1. train_and_evaluate with augmentation, the profile hook and the guard.
  ex = Experiment(cfg, device=dev, state=state)
  ex.draw_samples = functools.partial(ex.draw_samples, T=SAMPLE_STEPS)
  counters = kernel_counters()
  steps, conditioning = [], []
  real_step, real_loss = ex.train_step, ex.loss_fn

  def recording_step(batch, noise=None):
    before = {k: f.launches for k, f in counters.items()}
    out = real_step(batch, noise)
    torch.cuda.synchronize()
    steps.append((batch, {k: f.launches - before[k]
                          for k, f in counters.items()}))
    return out

  def recording_loss(model, batch, **kwargs):
    if kwargs.get('train'):
      conditioning.append(host_array(batch['conditioning']))
    return real_loss(model, batch, **kwargs)
  ex.train_step, ex.loss_fn = recording_step, recording_loss
  workdir = os.path.join(tmp.name, 'run')
  (_, secs), counts = counted(lambda: timed(
      lambda: ex.train_and_evaluate(workdir, max_to_keep=1)), route_totals)
  del ex.train_step, ex.loss_fn
  want = times(expected_launches(cfg.model, 'train'), SURFACE_STEPS)
  n_evals = 2  # after step 1 and at the last
  for path, n in (('eval', n_evals * SURFACE_EVAL_BATCHES),
                  ('sample', n_evals * SAMPLE_STEPS)):
    for k, v in times(expected_launches(cfg.model, path), n).items():
      want[k] += v
  assert counts == want, (counts, want)
  assert len(steps) == SURFACE_STEPS, len(steps)
  per_step = expected_launches(cfg.model, 'train')
  assert all(c == per_step for _, c in steps), [c for _, c in steps]
  paths['surface_train'] = counts
  share, changed = check_augmented_batches(
      steps, conditioning, splits['train'][0], cfg.training.seed,
      cfg.training.batch_size_train)
  numbers['augmentation'] = dict(aug_share=share, want=AUG_SHARE,
                                 tol=AUG_SHARE_TOL, changed_share=changed)
  log('surface_train', steps=SURFACE_STEPS, seconds=secs,
      dataset=cfg.data.dataset.replace(tmp.name, '<tmp>'),
      launches=counts, step_launches=steps[1][1], **numbers['augmentation'])
  assert abs(share - AUG_SHARE) <= AUG_SHARE_TOL, share

  # 2. The trace of step 1 (the second): its kernel events against that
  # step's counted launches.
  profile_dir = os.path.join(workdir, 'profile')
  assert os.listdir(profile_dir) == ['train_1.pt.trace.json'], (
      os.listdir(profile_dir))
  traced, kernel_ms = trace_kernel_counts(
      os.path.join(profile_dir, 'train_1.pt.trace.json'))
  launched = dict(steps[1][1])
  launched['dropout_mask'] += launched.pop('dropout_mask_batch')
  numbers['profile'] = dict(trace_kernels=traced, step_kernel_ms=kernel_ms)
  log('surface_profile', trace='profile/train_1.pt.trace.json',
      trace_kernels=traced, step_launches=launched, kernel_ms=kernel_ms)
  assert traced == launched, (traced, launched)

  # 3. nan_guard: a copy of the state with its parameters times NaN raises
  # naming 'bpd' at step 1; the clean step's time with and without it.
  guard_cfg = configs.replace(cfg, training={'profile': False})
  bad = Experiment(guard_cfg, device=dev, state={
      k: v * float('nan') for k, v in state.items()})
  try:
    bad.train(1)
  except FloatingPointError as e:
    message = str(e)
  else:
    raise AssertionError('nan_guard let a NaN step pass')
  del bad
  assert message.startswith("nan_guard: non-finite 'bpd' at substep 0 of "
                            'the super-step ending at step 1 '), message
  ms = {True: [], False: []}
  for _ in range(SURFACE_GUARD_TURNS):
    for guard in (True, False):
      ex.config = configs.replace(ex.config, training={'nan_guard': guard})
      _, s = timed(lambda: ex.train(SURFACE_GUARD_STEPS))
      ms[guard].append(1e3 * s / SURFACE_GUARD_STEPS)
  scalars = ex.train_step({k: v[0] for k, v in next(ex.train_iter).items()})
  torch.cuda.synchronize()
  read_ms = host_ms(lambda: ex._nan_guard(scalars), 20)
  rng = np.random.default_rng(SEED)
  source = splits['train'][0]
  idx = rng.permutation(len(source))[:cfg.training.batch_size_train]
  aug_ms = host_ms(lambda: data.augment_batch(rng, source[idx], True), 20)
  gather_ms = host_ms(lambda: source[idx].copy(), 20)
  numbers['nan_guard'] = dict(
      message=message, ms_per_step_guard=ms[True],
      ms_per_step_no_guard=ms[False], guard_read_host_ms=read_ms)
  numbers['host'] = dict(augment_batch_ms=aug_ms, gather_batch_ms=gather_ms)
  log('surface_nan_guard', **numbers['nan_guard'])
  log('surface_host', batch=len(idx), **numbers['host'])

  # 4. The writer: rank 0's, where TensorBoard may not import.
  writer = metrics.create_writer(os.path.join(tmp.name, 'writer'), 0)
  numbers['writer'] = [type(w).__name__ for w in writer.writers]
  log('surface_writer', writers=numbers['writer'])

  # 5. The analysis primitives: the encoder's logits (K1) with the kernels,
  # the plain model's and with its attention in float32; the schedules of
  # the clusters' leaders.
  (logits, images), logit_counts = counted(lambda: analysis.get_logits(
      ex, SURFACE_LOGIT_BATCHES), route_totals)
  assert logit_counts == times(expected_launches(cfg.model, 'encoder'),
                               SURFACE_LOGIT_BATCHES), logit_counts
  paths['surface_logits'] = logit_counts
  ema = {k: v.detach().clone()
         for k, v in ex.state.ema_model.state_dict().items()}
  plain = build_model(cfg.vdm_type, dataclasses.replace(
      cfg.model, use_kernels=False), device=dev, state=ema)
  batch = cfg.training.batch_size_eval

  @torch.no_grad()
  def plain_logits():
    return torch.cat([plain.apply_encoder(images[i:i + batch])
                      for i in range(0, len(images), batch)])
  got_plain = plain_logits()
  attend = layers.flash_attention_plain
  layers.flash_attention_plain = lambda q, k, v, s, **kw: attend(
      q.float(), k.float(), v.float(), s, **kw).to(q.dtype)
  try:
    got_f32 = plain_logits()
  finally:
    layers.flash_attention_plain = attend
  err = (logits - got_plain).abs().max().item()
  delta = (got_plain - got_f32).abs().max().item()
  bound = LOGITS_BOUND_FACTOR * delta
  embeddings = latents.logits_to_embeddings(logits, cfg.model.latent_k)
  clusters = analysis.cluster_embeddings(embeddings.cpu().numpy())
  probe = (clusters.leaders[:6] if clusters.n_clusters
           else np.arange(4))
  probe = embeddings[torch.as_tensor(probe, device=dev)]
  grids = analysis.noise_schedule_per_embedding(ex, probe)
  plain_grids = analysis.noise_schedule_per_embedding(
      SimpleNamespace(state=SimpleNamespace(ema_model=plain)), probe)
  equal = all(torch.equal(g, p) for g, p in zip(grids, plain_grids))
  min_step = min((g[1:] - g[:-1]).min().item() for g in grids)
  numbers['analysis'] = dict(
      logits_max_abs_err=err, attention_f32_delta=delta, bound=bound,
      logits_max_abs=logits.abs().max().item(),
      n_clusters=clusters.n_clusters, grids=len(grids),
      grid_shape=list(grids[0].shape), grids_bit_equal=equal,
      grid_min_step=min_step, grid_step_tol=GAMMA_STEP_TOL)
  log('surface_analysis', images=len(images), launches=logit_counts,
      **numbers['analysis'])
  assert 0 < delta and err <= bound, (err, bound)
  assert grids[0].shape == (128, cfg.model.n_pixels), grids[0].shape
  assert equal and min_step >= -GAMMA_STEP_TOL, (equal, min_step)
  del plain, ex
  tmp.cleanup()
  return paths, numbers


def trace_annotation_ms(path: str, name: str = 'train') -> float:
  """The duration of the host annotation `name` in a torch.profiler Chrome
  trace, in ms (the one such event)."""
  with open(path) as f:
    durs = [e['dur'] for e in json.load(f)['traceEvents']
            if e.get('cat') == 'user_annotation' and e.get('name') == name]
  assert len(durs) == 1, durs
  return durs[0] / 1e3


def run_superstep(dev, route_totals):
  """Phase 19: JAX's super-step on the flagship, as described at
  SUPER_SUBSTEPS: `train_and_evaluate` (each super-step's launches, the
  steps it evaluates and logs at, the logged means, the trace of the second
  super-step), the state against single steps, the timings, the copy of a
  super-batch and a NaN planted at substep SUPER_PLANTED_SUBSTEP. Returns
  ({path: launches}, the numbers logged)."""
  import numpy as np
  from mulan_tpu_torch import configs, params
  from mulan_tpu_torch import main as main_lib
  from mulan_tpu_torch.train.loop import Experiment
  from mulan_tpu_torch.utils import metrics
  numbers, paths = {}, {}
  tmp = tempfile.TemporaryDirectory()
  args, overrides = main_lib.parser().parse_known_args([
      '--config=cifar10_conditioned', f'--workdir={tmp.name}', '--nan_guard',
      '--config.data.dataset=synthetic',
      f'--config.training.substeps={SUPER_SUBSTEPS}',
      f'--config.training.num_steps_train={SUPER_STEPS}',
      f'--config.training.num_steps_eval={SUPER_EVAL_BATCHES}',
      f'--config.training.steps_per_logging={SUPER_SUBSTEPS}',
      f'--config.training.steps_per_eval={SUPER_STEPS}',
      f'--config.training.steps_per_save={SUPER_STEPS}',
      '--config.training.profile=True'])
  cfg = main_lib.config_from_args(args, overrides)
  training = cfg.training
  assert training.nan_guard and training.profile, training
  assert training.substeps == SUPER_SUBSTEPS, training
  log('superstep_cuts', substeps=SUPER_SUBSTEPS, jax_substeps=JAX_SUBSTEPS,
      sampler_steps=SAMPLE_STEPS, jax_sampler_steps=JAX_SAMPLE_T,
      steps=SUPER_STEPS, batch=training.batch_size_train)
  state = params.init_params(cfg.model, torch.Generator().manual_seed(SEED),
                             perturb_zero_init=0.02)

  # 1. train_and_evaluate: each super-step's launches and batches, the
  # steps evaluated at, what the writer logs.
  ex = Experiment(cfg, device=dev, state=state)
  ex.draw_samples = functools.partial(ex.draw_samples, T=SAMPLE_STEPS)
  counters = kernel_counters()
  supers, evals, logged = [], [], []
  real_superstep, real_eval = ex.train_superstep, ex.run_eval
  real_create = metrics.create_writer

  def recording_superstep(superbatch):
    before = {k: f.launches for k, f in counters.items()}
    sm90 = {k: counters[k].launches_by_route['sm90'] for k in SM90_KERNELS}
    out = real_superstep(superbatch)
    torch.cuda.synchronize()
    supers.append(dict(
        batch={k: np.array(v) for k, v in superbatch.items()},
        scalars={k: v.cpu() for k, v in out.items()},
        launches={k: f.launches - before[k] for k, f in counters.items()},
        sm90={k: counters[k].launches_by_route['sm90'] - sm90[k]
              for k in SM90_KERNELS}))
    return out

  def recording_eval(num_steps=None):
    evals.append(ex.state.step)
    return real_eval(num_steps)

  def recording_writer(logdir, rank):
    writer = real_create(logdir, rank)
    write = writer.write_scalars

    def write_scalars(step, scalars):
      logged.append((step, dict(scalars)))
      write(step, scalars)
    writer.write_scalars = write_scalars
    return writer
  ex.train_superstep, ex.run_eval = recording_superstep, recording_eval
  metrics.create_writer = recording_writer
  workdir = os.path.join(tmp.name, 'run')
  try:
    (_, secs), counts = counted(lambda: timed(
        lambda: ex.train_and_evaluate(workdir, max_to_keep=1)), route_totals)
  finally:
    metrics.create_writer = real_create
    del ex.train_superstep, ex.run_eval
  per_super = times(expected_launches(cfg.model, 'train'), SUPER_SUBSTEPS)
  want = times(expected_launches(cfg.model, 'train'), SUPER_STEPS)
  n_evals = 2  # after the first super-step and at the last
  for path, n in (('eval', n_evals * SUPER_EVAL_BATCHES),
                  ('sample', n_evals * SAMPLE_STEPS)):
    for k, v in times(expected_launches(cfg.model, path), n).items():
      want[k] += v
  train_logs = [(step, sc) for step, sc in logged if 'train_bpd' in sc]
  eval_logs = [step for step, sc in logged if 'eval_bpd' in sc]
  mean_errs = []
  for (step, sc), sup in zip(train_logs, supers):
    values = sup['scalars']['bpd'].double()
    mean_errs.append(abs(sc['train_bpd'] - values.mean().item())
                     / abs(values.mean().item()))
  numbers['train'] = dict(
      seconds=secs, supersteps=len(supers),
      superstep_launches=[s['launches'] for s in supers],
      superstep_bpd=[s['scalars']['bpd'].tolist() for s in supers],
      evaluated_at=evals, eval_logged_at=eval_logs,
      train_logged_at=[step for step, _ in train_logs],
      logged_train_bpd=[sc['train_bpd'] for _, sc in train_logs],
      logged_mean_rel_err=mean_errs, mean_rtol=SUPER_MEAN_RTOL)
  log('superstep_train', launches=counts, **numbers['train'])
  assert counts == want, (counts, want)
  assert len(supers) == SUPER_STEPS // SUPER_SUBSTEPS, len(supers)
  for sup in supers:
    assert sup['launches'] == per_super, (sup['launches'], per_super)
    assert all(sup['sm90'][k] == per_super[k] for k in SM90_KERNELS), sup
    assert sup['batch']['images'].shape[:2] == (
        SUPER_SUBSTEPS, training.batch_size_train)
  assert evals == eval_logs == [SUPER_SUBSTEPS, SUPER_STEPS], (evals,
                                                              eval_logs)
  assert [step for step, _ in train_logs] == [SUPER_SUBSTEPS, SUPER_STEPS]
  assert max(mean_errs) <= SUPER_MEAN_RTOL, mean_errs
  assert ex.state.step == SUPER_STEPS
  paths['superstep_train'] = counts

  # 2. The trace of the second super-step: its kernel events against its
  # counted launches; the card's busy share of the traced super-step.
  name = f'train_{SUPER_SUBSTEPS}.pt.trace.json'
  profile_dir = os.path.join(workdir, 'profile')
  assert os.listdir(profile_dir) == [name], os.listdir(profile_dir)
  traced, kernel_ms = trace_kernel_counts(os.path.join(profile_dir, name))
  span_ms = trace_annotation_ms(os.path.join(profile_dir, name))
  launched = dict(supers[1]['launches'])
  launched['dropout_mask'] += launched.pop('dropout_mask_batch')
  numbers['profile'] = dict(trace=f'profile/{name}', trace_kernels=traced,
                            kernel_ms=kernel_ms, superstep_ms=span_ms,
                            busy_share=kernel_ms / span_ms)
  log('superstep_profile', superstep_launches=launched, **numbers['profile'])
  assert traced == launched, (traced, launched)

  # 3. The state after the run against SUPER_STEPS single train_step calls
  # from the same state on the same batches.
  after = {k: v.detach().clone() for k, v in state_tensors(ex.state).items()}
  del ex
  torch.cuda.empty_cache()
  one_cfg = configs.replace(cfg, training={'nan_guard': False,
                                           'profile': False})
  one = Experiment(one_cfg, device=dev, state=state)
  one_bpds = []
  for sup in supers:
    for i in range(SUPER_SUBSTEPS):
      one_bpds.append(float(one.train_step(
          {k: v[i] for k, v in sup['batch'].items()})['bpd']))
  super_bpds = torch.cat([s['scalars']['bpd'] for s in supers]).tolist()
  got = state_tensors(one.state)
  assert got.keys() == after.keys()
  bitwise = one_bpds == super_bpds and all(torch.equal(got[k], v)
                                           for k, v in after.items())
  leaves = [k for k, v in after.items()
            if v.is_floating_point() and v.numel() > 1]
  cosines = {k: cosine(got[k].flatten().double(), after[k].flatten().double())
             for k in leaves}
  worst = min(cosines, key=cosines.get)
  max_diff = max((got[k].double() - after[k].double()).abs().max().item()
                 for k in leaves)
  bpd_delta = max(abs(a - b) for a, b in zip(one_bpds, super_bpds))
  numbers['vs_single_steps'] = dict(
      bit_for_bit=bitwise, steps=len(one_bpds), leaves=len(leaves),
      max_abs_diff=max_diff, max_bpd_delta=bpd_delta, bpd_tol=TRAIN_BPD_TOL,
      min_leaf_cosine=cosines[worst], min_cosine_leaf=worst,
      cos_min=SUPER_LEAF_COS_MIN)
  log('superstep_vs_single_steps', **numbers['vs_single_steps'])
  assert bitwise or (bpd_delta <= TRAIN_BPD_TOL
                     and cosines[worst] >= SUPER_LEAF_COS_MIN), (
                         numbers['vs_single_steps'])
  assert one.state.step == SUPER_STEPS

  # 4. Timings, in turns: the steps of a super-step against single calls;
  # the copy of a super-batch to the card, at SUPER_SUBSTEPS and at JAX's.
  sb = supers[0]['batch']
  ms = {'superstep': [], 'single': []}
  for _ in range(SUPER_TIMING_TURNS):
    _, s = timed(lambda: one.train_superstep(sb))
    ms['superstep'].append(1e3 * s / SUPER_SUBSTEPS)
    _, s = timed(lambda: [one.train_step({k: v[i] for k, v in sb.items()})
                          for i in range(SUPER_SUBSTEPS)])
    ms['single'].append(1e3 * s / SUPER_SUBSTEPS)
  copies = {}
  for substeps in (SUPER_SUBSTEPS, JAX_SUBSTEPS):
    batch = {k: np.resize(v, (substeps, *v.shape[1:])) for k, v in sb.items()}
    secs = [timed(lambda: one._put_superbatch(batch))[1] for _ in range(3)]
    copies[substeps] = dict(bytes=sum(v.nbytes for v in batch.values()),
                            ms=[1e3 * t for t in secs])
    del batch
  numbers['timing'] = dict(
      ms_per_step_in_superstep=ms['superstep'],
      ms_per_step_single_calls=ms['single'],
      superbatch_copy={str(k): v for k, v in copies.items()})
  log('superstep_timing', **numbers['timing'])

  # 5. nan_guard: NaN parameters from substep SUPER_PLANTED_SUBSTEP of a
  # super-step on: the guard names 'bpd' there.
  one.config = configs.replace(one.config, training={'nan_guard': True})
  base = one.state.step
  real_step = one.train_step

  def planting_step(batch, noise=None):
    if one.state.step == base + SUPER_PLANTED_SUBSTEP:
      with torch.no_grad():
        for p in one.state.params.values():
          p.mul_(float('nan'))
    return real_step(batch, noise)
  one.train_step = planting_step
  try:
    one.train(SUPER_SUBSTEPS)
  except FloatingPointError as e:
    message = str(e)
  else:
    raise AssertionError('nan_guard let a NaN super-step pass')
  numbers['nan_guard'] = dict(message=message, planted_substep=(
      SUPER_PLANTED_SUBSTEP))
  log('superstep_nan_guard', **numbers['nan_guard'])
  assert message.startswith(
      f"nan_guard: non-finite 'bpd' at substep {SUPER_PLANTED_SUBSTEP} of "
      f'the super-step ending at step {base + SUPER_SUBSTEPS} '), message
  del one
  tmp.cleanup()
  return paths, numbers


def main() -> None:
  if not torch.cuda.is_available():
    raise SystemExit('chip_smoke: torch.cuda.is_available() is False; this '
                     'script runs only on a CUDA device')
  from mulan_tpu_torch import configs, data, params
  from mulan_tpu_torch.evals import harness, vlb
  from mulan_tpu_torch.models import build_model, latents
  from mulan_tpu_torch.models.vdm import sample_times
  from mulan_tpu_torch.ops import _build
  from mulan_tpu_torch.train.loop import Experiment
  want_profile = '--profile' in sys.argv[1:]
  clock = PhaseClock()

  # 1. Device and build.
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device('cuda', 0)
  smi = subprocess.run(
      ['nvidia-smi', '-i', '0', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True, check=True)
  card = smi.stdout.strip()
  # The online K5 (an ablation variant, `ops/ablations/k5_bwd.json`)
  # builds beside the kernels' library.
  k5_tmp = tempfile.TemporaryDirectory()
  pool = concurrent.futures.ThreadPoolExecutor(1)
  online_build = pool.submit(build_online_decoder_bwd, k5_tmp.name)
  t0 = time.perf_counter()
  _build.load_library()
  log('device', card=repr(card), torch=torch.__version__,
      cuda=torch.version.cuda, tf32='off (matmul and cudnn)',
      build_s=round(time.perf_counter() - t0, 3))
  gen = torch.Generator(device=dev).manual_seed(SEED)
  train_cfg = configs.replace(
      configs.cifar10_conditioned(), data={'dataset': 'synthetic'},
      training={'steps_per_logging': TRAIN_STEPS, 'substeps': 1})
  cfg = train_cfg.model
  clock.done(1, 'device and build')

  # 2. Each kernel against its plain version.
  results = {}
  results['flash_attention'], k1_sampler = check_attention(dev, gen)
  (results['flash_attention_bwd_dkv'],
   results['flash_attention_bwd_dq']) = check_attention_bwd(dev, gen)
  sfu_rate = sm_ops_per_s(SFU_PER_CLOCK_PER_SM)
  imul_rate = sm_ops_per_s(IMUL_PER_CLOCK_PER_SM)
  results['decoder_logprob'], k4_gamma_min = check_decoder(dev, gen, cfg,
                                                           sfu_rate)
  check_decoder_bwd(dev, gen, cfg)
  results['dropout_mask'] = check_dropout(dev, cfg, imul_rate)
  results['gn_swish'], gn_swish_c256 = check_gn_swish(dev, gen, sfu_rate)
  results['gn_swish_bwd'], gn_bwd_c256 = check_gn_swish_bwd(dev, gen,
                                                           sfu_rate)
  results['dropout_mask_batch'] = check_mask_batch(dev, cfg, imul_rate)
  rank_masks = rank_mask_times(dev, cfg, imul_rate)
  torch.cuda.empty_cache()
  clock.done(2, 'kernels against plain')

  # 3. Evaluation: sparse VLB over synthetic eval batches. Every counted
  # run of a main path adds its launches by route to route_totals.
  route_totals = {}
  state = params.init_params(cfg, torch.Generator().manual_seed(SEED),
                             perturb_zero_init=0.02)
  model = build_model('mulan_velocity', cfg, device=dev, state=state)
  images, labels = data.synthetic_split('eval', cfg.image_shape, seed=SEED)

  def run_eval(m):
    return counted(lambda: timed(lambda: vlb.eval_bpd_sparse(
        m, data.eval_batches(images, EVAL_BATCH), generator=gen,
        max_batches=EVAL_BATCHES)), route_totals)

  (bpd, secs), eval_counts = run_eval(model)
  log('eval_bpd_sparse', batches=EVAL_BATCHES, batch=EVAL_BATCH, bpd=bpd,
      seconds=secs, launches=eval_counts)
  assert math.isfinite(bpd), bpd
  # Two attention blocks (encoder, UNet) and one decoder call per batch,
  # no backward and no dropout.
  assert eval_counts == dict(
      flash_attention=2 * EVAL_BATCHES, decoder_logprob=EVAL_BATCHES,
      flash_attention_bwd_dkv=0, flash_attention_bwd_dq=0,
      decoder_logprob_bwd=0, dropout_mask=0, dropout_mask_batch=0,
      gn_swish=0, gn_swish_bwd=0), eval_counts
  assert eval_counts == times(expected_launches(cfg, 'eval'), EVAL_BATCHES)
  clock.done(3, 'sparse VLB')

  # 4. Sampling: T cut to SAMPLE_STEPS; every step is a full-size UNet pass.
  def run_sampler(m):
    ((samples, z_0), secs), counts = counted(lambda: timed(
        lambda: harness.random_samples(m, SAMPLE_BATCH, SAMPLE_STEPS,
                                       generator=gen)), route_totals)
    log('random_samples', fused=m.config.fused_gn_swish, batch=SAMPLE_BATCH,
        steps=SAMPLE_STEPS, ms_per_step=1e3 * secs / SAMPLE_STEPS,
        shape=list(samples.shape), dtype=str(samples.dtype),
        min=int(samples.min()), max=int(samples.max()),
        z0_abs_max=z_0.abs().max().item(), launches=counts)
    assert samples.dtype.name == 'uint8'
    assert samples.shape == (SAMPLE_BATCH, *cfg.image_shape)
    assert 0 <= samples.min() and samples.max() <= 255
    assert torch.isfinite(z_0).all()
    assert counts == times(expected_launches(m.config, 'sample'),
                           SAMPLE_STEPS), counts
    return counts

  sample_counts = run_sampler(model)
  assert sample_counts['flash_attention'] == SAMPLE_STEPS, sample_counts
  assert sum(sample_counts.values()) == SAMPLE_STEPS, sample_counts
  clock.done(4, 'sampler')

  # 5. The ELBO, kernels against the plain path, on one batch with the same
  # noise (outside the counted runs).
  batch = torch.as_tensor(images[:EVAL_BATCH], device=dev)
  t = sample_times(EVAL_BATCH, generator=gen, device=dev)
  eps = torch.randn((EVAL_BATCH, *cfg.image_shape), generator=gen,
                    device=dev)
  noise = latents.gamma_variates(cfg.latent_k, (EVAL_BATCH, cfg.latent_size),
                                 generator=gen, device=dev)

  def elbo_bpd_and_rate(m):
    """bpd on the batch above and images/s, median of 3 after a warm-up."""
    def run():
      with torch.inference_mode():
        out = m.elbo(batch, t, eps0=eps, eps=eps, latent_noise=noise)
        return vlb.bpd_terms(out, cfg.n_pixels).mean().item()
    run()
    secs = []
    for _ in range(3):
      bpd, s = timed(run)
      secs.append(s)
    return bpd, EVAL_BATCH / statistics.median(secs)

  plain = build_model('mulan_velocity',
                      dataclasses.replace(cfg, use_kernels=False),
                      device=dev, state=state)
  rates, bpds = {}, {}
  for name, m in (('kernels', model), ('plain', plain)):
    bpds[name], rates[name] = elbo_bpd_and_rate(m)
  delta = abs(bpds['kernels'] - bpds['plain'])
  log('kernels_vs_plain', bpd_kernels=bpds['kernels'],
      bpd_plain=bpds['plain'], abs_delta=delta, tol=BPD_TOL,
      images_per_s_kernels=rates['kernels'],
      images_per_s_plain=rates['plain'])
  assert delta <= BPD_TOL, delta
  del plain
  clock.done(5, 'ELBO kernels against plain')

  # 6. Training: Experiment.train at batch 128 with dropout 0.1. The first
  # update has lr 0 (the warm-up is read before it), so step 1 leaves the
  # parameters as they were and later steps move them and the EMA.
  train_ms = {}

  def run_train(ex, steps, name, after_first=None):
    """`steps` steps of ex.train, the first alone (then `after_first()`),
    the others timed; logs the bpds, ms a step, the peak memory (in all and
    above what was held before the first step) and the launches, asserts
    them against `expected_launches`, and returns the launches."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    history, counts = counted(lambda: ex.train(1), route_totals)
    if after_first is not None:
      after_first()
    (more, secs), more_counts = counted(lambda: timed(
        lambda: ex.train(steps - 1)), route_totals)
    history += more
    counts = {k: v + more_counts[k] for k, v in counts.items()}
    peak = torch.cuda.max_memory_allocated()
    ms_per_step = train_ms[name] = 1e3 * secs / (steps - 1)
    batch_size = ex.config.training.batch_size_train
    log(name, steps=steps, batch=batch_size,
        bpd=[round(h['bpd'], 4) for h in history], ms_per_step=ms_per_step,
        images_per_s=1e3 * batch_size / ms_per_step,
        peak_memory_gb=peak / 1e9, peak_above_start_gb=(peak - base) / 1e9,
        launches=counts)
    assert len(history) == steps
    assert all(math.isfinite(h['bpd']) for h in history), history
    assert counts == times(expected_launches(
        ex.config.model, 'train', ex.config.vdm_type == 'vdm'), steps), counts
    return counts

  ex = Experiment(train_cfg, device=dev, state=state)
  start = {k: p.detach().clone() for k, p in ex.state.params.items()}

  def nothing_moved():
    assert all(torch.equal(start[k], p) for k, p in ex.state.params.items())
  train_counts = run_train(ex, TRAIN_STEPS, 'train', nothing_moved)
  moved = sum(not torch.equal(start[k], p)
              for k, p in ex.state.params.items())
  ema_moved = sum(not torch.equal(start[k], p)
                  for k, p in ex.state.ema_params.items())
  finite = all(torch.isfinite(p).all() for p in
               [*ex.state.params.values(), *ex.state.ema_params.values()])
  log('train_state', steps=TRAIN_STEPS, params_moved=f'{moved}/{len(start)}',
      ema_moved=f'{ema_moved}/{len(start)}')
  assert moved > 0.5 * len(start) and ema_moved > 0.5 * len(start)
  assert finite
  n_sites = 2 * cfg.sm_n_layer + 3 + cfg.forward_n_layer + 2
  per_step = dict(flash_attention=2, flash_attention_bwd_dkv=2,
                  flash_attention_bwd_dq=2, decoder_logprob=1,
                  decoder_logprob_bwd=0, dropout_mask=2 * n_sites,
                  dropout_mask_batch=0, gn_swish=0, gn_swish_bwd=0)
  assert train_counts == {k: TRAIN_STEPS * v for k, v in per_step.items()}, (
      train_counts)
  eval_scalars = ex.run_eval(1)
  assert math.isfinite(eval_scalars['eval_bpd']), eval_scalars
  clock.done(6, 'training')

  # 7. One train step, kernels against plain and against float32.
  del start
  step_noise = dict(t=t, eps0=eps, eps=eps, latent_noise=noise,
                    dropout_seed=1234)
  compare_train_step(ex, model, lambda **kw: build_model(
      'mulan_velocity', dataclasses.replace(cfg, use_kernels=False, **kw),
      device=dev, state=state), {'images': batch}, step_noise)
  clock.done(7, 'train step kernels against plain')

  # 8. The fused configuration (fused_gn_swish and dropout_mask_batch) on the
  # same weights: evaluation, sampling and training, then one fused train
  # step against its plain twin.
  fused_cfg = dataclasses.replace(cfg, fused_gn_swish=True,
                                  dropout_mask_batch=True)
  model_f = build_model('mulan_velocity', fused_cfg, device=dev, state=state)
  (bpd, secs), fused_eval_counts = run_eval(model_f)
  log('fused_eval_bpd_sparse', batches=EVAL_BATCHES, batch=EVAL_BATCH,
      bpd=bpd, seconds=secs, launches=fused_eval_counts)
  assert math.isfinite(bpd), bpd
  assert fused_eval_counts == times(expected_launches(fused_cfg, 'eval'),
                                    EVAL_BATCHES), fused_eval_counts
  fused_sample_counts = run_sampler(model_f)
  bpds['fused'], rates['fused'] = elbo_bpd_and_rate(model_f)
  bpds['unfused'], rates['unfused'] = elbo_bpd_and_rate(model)
  delta = abs(bpds['fused'] - bpds['unfused'])
  log('fused_vs_unfused', bpd_fused=bpds['fused'],
      bpd_unfused=bpds['unfused'], abs_delta=delta, tol=FUSED_BPD_TOL,
      images_per_s_fused=rates['fused'],
      images_per_s_unfused=rates['unfused'])
  assert delta <= FUSED_BPD_TOL, delta

  ex_f = Experiment(configs.replace(train_cfg, model={
      'fused_gn_swish': True, 'dropout_mask_batch': True}), device=dev,
                    state=state)
  with no_plain_gn_bwd_on_cuda():
    fused_train_counts = run_train(ex_f, FUSED_TRAIN_STEPS, 'fused_train')
  compare_fused_step(ex_f, model_f, lambda: build_model(
      'mulan_velocity', dataclasses.replace(fused_cfg, use_kernels=False),
      device=dev, state=state), {'images': batch}, step_noise)
  clock.done(8, 'fused')

  # 9. bench.py --attention: with_attention and remat='attn', fresh weights.
  attn_cfg = dataclasses.replace(cfg, with_attention=True, remat='attn')
  attn_state = params.init_params(attn_cfg,
                                  torch.Generator().manual_seed(SEED),
                                  perturb_zero_init=0.02)
  ex_a = Experiment(configs.replace(train_cfg, model={
      'with_attention': True, 'remat': 'attn'}), device=dev, state=attn_state)
  attn_train_counts = run_train(ex_a, ATTN_TRAIN_STEPS, 'attention_train')
  clock.done(9, 'with_attention')

  # 10. Every remat mode gives the step without remat, with attention blocks
  # and the fused GroupNorm+swish (so that a checkpointed ResNet block
  # recomputes K8 and regenerates its K6 masks).
  with no_plain_gn_bwd_on_cuda():
    remat_counts = compare_remat(
        ex_a, dataclasses.replace(attn_cfg, fused_gn_swish=True), attn_state,
        {'images': batch}, step_noise, dev, route_totals)
  torch.cuda.empty_cache()
  clock.done(10, 'remat')

  # 11. Checkpoints and their evaluation: K1 and K4 at the dense VLB's
  # shapes; a workdir run that saves, restores, exports and imports its
  # checkpoints; the dense VLB through EvalExperiment on the export.
  dense_k1, dense_k4 = check_dense_kernels(dev, gen, cfg, sfu_rate)
  torch.cuda.empty_cache()
  with tempfile.TemporaryDirectory() as workdir:
    workdir_counts, ev, flax_path = run_workdir_train(
        train_cfg, state, dev, route_totals, workdir)
    dense_counts = run_dense_eval(ev, images, gen, dev, route_totals)
    del ev
    torch.cuda.empty_cache()
    clock.done(11, 'checkpoints and the dense VLB')

    # 12. The probability-flow ODE: the solvers on the card against the CPU;
    # an RK4 likelihood kernels against plain, with one RHS evaluation's
    # attention block alone; `eval_bpd --bpd_eval_method=ode` and `main
    # --mode sample --sampler=ode` on the exported checkpoint; an adaptive
    # DoPri5 solve; one fused RHS against its plain twin; `score_jvp`.
    check_ode_solver(dev)
    ode_batch = torch.as_tensor(images[:ODE_ROWS], device=dev)
    ode_counts, ode_model, ode_func, ode_y0 = compare_ode_nll(
        cfg, state, ode_batch, gen, dev, route_totals)
    ode_cli_counts = run_ode_nll_cli(cfg, flax_path, route_totals)
    ode_sample_counts = run_ode_sample_cli(
        cfg, flax_path, os.path.join(workdir, 'ode_samples'), route_totals)
  dopri5_counts = run_ode_dopri5(ode_model, ode_batch, gen, dev,
                                 route_totals)
  ode_fused_counts = compare_ode_fused(cfg, state, ode_batch, gen, dev,
                                       route_totals)
  check_score_jvp_raises(ode_model, ode_batch)
  torch.cuda.empty_cache()
  clock.done(12, 'the probability-flow ODE')

  # 13. The baseline VDM: training (K5 on its path), one step kernels
  # against plain with K5 alone at its inputs, K5 timed there beside the
  # online K5, evaluation, sampling, and the ODE likelihood's command line on
  # its checkpoint.
  online_lib, online_notes = online_build.result()
  pool.shutdown()
  log('decoder_logprob_bwd_online_build', ptxas=repr(online_notes[:400]))
  vdm_paths, k5_cases, ex_v = run_vdm(dev, gen, images, sfu_rate, online_lib,
                                      route_totals)
  results['decoder_logprob_bwd'] = k5_cases['vdm_step']
  k5_tmp.cleanup()
  torch.cuda.empty_cache()
  clock.done(13, 'the baseline VDM')

  # 14. MuLAN-epsilon at ImageNet32's width: K1-K3 at head_dim 256 (on their
  # 'sm90' kernels for D <= 256), alone and through evaluation, sampling,
  # training and the ODE likelihood's command line. Its launches by route
  # are kept apart.
  in32_routes = {}
  in32_paths, in32_kernels, ex_in32 = run_imagenet32(dev, gen, sfu_rate,
                                                     in32_routes)
  torch.cuda.empty_cache()
  clock.done(14, 'MuLAN-epsilon at ImageNet32 width')

  # 15. The MuLAN variants at the flagship's width and depth: the 'ldm'
  # UNet with the learned schedule and the Gumbel latent through training,
  # evaluation, sampling and the ODE likelihood; the Gaussian latent, the
  # CNN encoder and the label embedding through training and an ELBO.
  variant_paths, _, ex_v1 = run_variants(dev, gen, images, labels,
                                         train_ms['train'], route_totals)
  torch.cuda.empty_cache()
  clock.done(15, 'the MuLAN variants')

  # 16. Data parallelism and FSDP: the train step unwrapped, under DDP and
  # under FSDP2 in a process group of one over NCCL, an evaluation and the
  # sampler under FSDP2; then two ranks on the card over gloo.
  parallel_paths, parallel = run_parallel(dev, train_cfg, images,
                                          route_totals, want_profile)
  torch.cuda.empty_cache()
  clock.done(16, 'data parallelism and FSDP')

  # 17. Tensor parallelism: TP_STEPS flagship steps at TP_ROWS rows
  # unwrapped and on a tensor mesh of size 1 over NCCL (bit for bit), then
  # PAR_RANKS ranks on the card over gloo with training.tp = PAR_RANKS
  # against one process; TP_GN_RANKS ranks on a GroupNorm whose groups
  # straddle them; K6, K7 and K8 at a rank's channel window.
  tensor_paths, tensor, tensor_window = run_tensor_parallel(
      dev, gen, train_cfg, images, route_totals, imul_rate, sfu_rate)
  torch.cuda.empty_cache()
  clock.done(17, 'tensor parallelism')

  # 18. The remaining surface: an augmented dataset through
  # train_and_evaluate with the profile hook and nan_guard, the trace's
  # kernels against the step's launches, a NaN state refused, the writer,
  # and the analysis primitives against the plain model.
  surface_paths, surface = run_remaining_surface(dev, route_totals)
  torch.cuda.empty_cache()
  clock.done(18, 'the remaining surface')

  # 19. JAX's super-step: the flagship through train_and_evaluate in
  # super-steps of SUPER_SUBSTEPS, each super-step's launches, the trace of
  # the second, the steps evaluated and logged at and the logged means, the
  # state against single steps, the timings and a planted NaN's substep.
  superstep_paths, superstep = run_superstep(dev, route_totals)
  torch.cuda.empty_cache()
  clock.done(19, 'the super-step')

  if want_profile:
    ode_t = torch.tensor(0.5)
    in32_batch = torch.as_tensor(images[:IN32_TRAIN_BATCH], device=dev)

    def train_step(e):
      return lambda: e.train_step({'images': batch})

    def elbo(m):
      def run():
        with torch.inference_mode():
          m(batch, generator=gen)
      return run

    def dense_chunk():
      with torch.inference_mode():
        vlb.dense_chunk_bpd(model, images[:DENSE_ROWS // DENSE_T], DENSE_T,
                            generator=gen)
    for name, fn in (('elbo_b128', elbo(model)),
                     ('dense_chunk_512_rows', dense_chunk),
                     ('train_step_b128', train_step(ex)),
                     ('fused_elbo_b128', elbo(model_f)),
                     ('fused_train_step_b128', train_step(ex_f)),
                     ('attention_train_step_b128', train_step(ex_a)),
                     ('ode_rhs_b128', lambda: ode_func(ode_t, ode_y0)),
                     ('vdm_train_step_b128', train_step(ex_v)),
                     ('in32_train_step_b128', lambda: ex_in32.train_step(
                         {'images': in32_batch})),
                     ('v1_train_step_b128', train_step(ex_v1))):
      log('profile', call=name, **profile(fn))

  sources = {
      'flash_attention': ('mulan_tpu_torch/csrc/flash_attention.cu',
                          'mulan_tpu/ops/flash_bwd.py:287'),
      'flash_attention_bwd_dkv': ('mulan_tpu_torch/csrc/flash_attention_bwd.cu',
                                  'mulan_tpu/ops/flash_bwd.py:72'),
      'flash_attention_bwd_dq': ('mulan_tpu_torch/csrc/flash_attention_bwd.cu',
                                 'mulan_tpu/ops/flash_bwd.py:124'),
      'decoder_logprob': ('mulan_tpu_torch/csrc/decoder_logprob.cu',
                          'mulan_tpu/ops/decoder_logprob.py:36'),
      'decoder_logprob_bwd': ('mulan_tpu_torch/csrc/decoder_logprob.cu',
                              'mulan_tpu/ops/decoder_logprob.py:61'),
      'dropout_mask': ('mulan_tpu_torch/csrc/dropout.cu',
                       'mulan_tpu/ops/dropout.py:40'),
      'dropout_mask_batch': ('mulan_tpu_torch/csrc/dropout.cu',
                             'mulan_tpu/ops/dropout.py:120'),
      'gn_swish': ('mulan_tpu_torch/csrc/groupnorm_swish.cu',
                   'mulan_tpu/ops/groupnorm_swish.py:64'),
      'gn_swish_bwd': ('mulan_tpu_torch/csrc/groupnorm_swish.cu',
                       'mulan_tpu/ops/groupnorm_swish.py:123'),
  }
  paths = {'eval': eval_counts, 'sample': sample_counts,
           'train': train_counts, 'fused_eval': fused_eval_counts,
           'fused_sample': fused_sample_counts,
           'fused_train': fused_train_counts,
           'attention_train': attn_train_counts,
           'workdir_train': workdir_counts, 'dense_eval': dense_counts,
           'ode_nll_rk4': ode_counts, 'ode_nll_cli': ode_cli_counts,
           'ode_dopri5': dopri5_counts, 'ode_sample': ode_sample_counts,
           'ode_fused_rhs': ode_fused_counts, **vdm_paths, **variant_paths,
           **parallel_paths, **tensor_paths, **surface_paths,
           **superstep_paths,
           **{f'remat_{mode}': c for mode, c in remat_counts.items()}}
  keys = ('max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
          'bound_ops_ms', 'bound_bytes_ms', 'library_ms')
  # Measured for some kernels only.
  extras = ('back_to_back_ms', 'host_ms', 'library_back_to_back_ms',
            'c_call_ms', 'c_call_back_to_back_ms', 'online_kernel_ms',
            'online_kernel_back_to_back_ms',
            'with_dkv', 'simt_ms', 'simt_back_to_back_ms', 'simt_rel_err',
            'simt_max_abs_err',
            'window_bins_per_pixel', 'bound_full_vocab_ms',
            'unfused_pair_ms', 'unfused_pair_bwd_ms', 'design',
            'regs_c_call_back_to_back_ms')
  kernels = []
  for name, (source, replaces) in sources.items():
    by_path = {path: counts[name] for path, counts in paths.items()}
    if name not in SM90_KERNELS:  # phase 14's K1-K3 have rows of their own
      by_path.update({path: c[name] for path, c in in32_paths.items()})
    kernels.append(dict(name=name, route='cuda', source=source,
                        replaces=replaces, launches=sum(by_path.values()),
                        launches_by_path=by_path,
                        **{k: results[name][k] for k in keys},
                        **{k: results[name][k] for k in extras
                           if k in results[name]}))
    if name in route_totals:
      kernels[-1]['launches_by_route'] = route_totals[name]
      assert sum(route_totals[name].values()) == kernels[-1]['launches']
    assert kernels[-1]['launches'] > 0, name
  k1 = kernels[0]
  k1['at_sampler_shape'] = {k: k1_sampler[k] for k in (
      'ms', 'plain_ms', 'library_ms', 'bound_ms', 'max_abs_err')}
  by_name = {k['name']: k for k in kernels}
  k1['at_dense_shapes'] = {shape: {k: r[k] for k in (
      'ms', 'plain_ms', 'library_ms', 'bound_ms', 'bound_by', 'max_abs_err')
                                     if k in r}
                            for shape, r in dense_k1.items()}
  by_name['decoder_logprob']['at_dense_rows'] = {case: {k: r[k] for k in (
      'ms', 'back_to_back_ms', 'plain_ms', 'bound_ms', 'bound_by',
      'window_bins_per_pixel', 'max_abs_err')} for case, r in dense_k4.items()}
  by_name['decoder_logprob']['at_gamma_min'] = {k: k4_gamma_min[k] for k in (
      'ms', 'back_to_back_ms', 'plain_ms', 'bound_ms', 'bound_full_vocab_ms',
      'window_bins_per_pixel', 'max_abs_err')}
  for c, r in (('c256', gn_swish_c256),
               ('c512', in32_kernels['gn_swish'][1])):
    by_name['gn_swish'][f'at_{c}'] = {k: r[k] for k in (
        'ms', 'back_to_back_ms', 'plain_ms', 'unfused_pair_ms', 'bound_ms',
        'max_abs_err')}
  k5_keys = ('ms', 'back_to_back_ms', 'c_call_back_to_back_ms',
             'online_kernel_ms', 'online_kernel_back_to_back_ms', 'plain_ms',
             'bound_ms', 'bound_by', 'bound_full_vocab_ms',
             'window_bins_per_pixel', 'max_abs_err')
  for case in ('per_example', 'gamma_max'):
    by_name['decoder_logprob_bwd'][f'at_{case}'] = {
        k: k5_cases[case][k] for k in k5_keys}
  for c, r in (('c256', gn_bwd_c256),
               ('c512', in32_kernels['gn_swish_bwd'][1])):
    by_name['gn_swish_bwd'][f'at_{c}'] = {k: r[k] for k in (
        'ms', 'back_to_back_ms', 'host_ms', 'c_call_ms',
        'c_call_back_to_back_ms', 'regs_c_call_back_to_back_ms', 'design',
        'plain_ms', 'unfused_pair_bwd_ms', 'bound_ms', 'max_abs_err')
        if k in r}
  # K1-K3 at head_dim 256 (phase 14): their launches on its paths, each on
  # 'sm90', and the kernels alone at its shapes.
  in32_results = {'flash_attention': in32_kernels['x'.join(
      map(str, IN32_EVAL_ATTN))], 'flash_attention_bwd_dkv':
                  in32_kernels['dkv'], 'flash_attention_bwd_dq':
                  in32_kernels['dq']}
  for name in SM90_KERNELS:
    source, replaces = sources[name]
    r = in32_results[name]
    by_path = {path: c[name] for path, c in in32_paths.items()}
    row = dict(name=f'{name}_d256', route='cuda', source=source,
               replaces=replaces, launches=sum(by_path.values()),
               launches_by_path=by_path,
               launches_by_route=in32_routes[name],
               shape=list(IN32_EVAL_ATTN if name == 'flash_attention'
                          else IN32_TRAIN_ATTN),
               attention_route=r['route'], **{k: r[k] for k in keys},
               **{k: r[k] for k in extras if k in r})
    assert row['launches'] > 0 and in32_routes[name]['sm90'] == (
        row['launches']), row
    kernels.append(row)
  for at, shape in (('train', IN32_TRAIN_ATTN),
                    ('sampler', IN32_SAMPLER_ATTN),
                    ('encoder', IN32_ENCODER_ATTN)):
    r = in32_kernels['x'.join(map(str, shape))]
    kernels[-3][f'at_{at}_shape'] = {k: r[k] for k in (
        'ms', 'back_to_back_ms', 'ms_with_lse', 'plain_ms', 'library_ms',
        'library_back_to_back_ms', 'simt_ms', 'simt_back_to_back_ms',
        'bound_ms', 'bound_by', 'max_abs_err') if k in r}
  for name in ('dropout_mask', 'dropout_mask_batch'):
    by_name[name]['at_rank_rows'] = rank_masks[name]
  for name in ('dropout_mask', 'dropout_mask_batch', 'gn_swish',
               'gn_swish_bwd'):
    by_name[name]['at_tensor_window'] = {k: tensor_window[name][k] for k in (
        'shape', 'ms', 'back_to_back_ms', 'c_call_back_to_back_ms',
        'regs_c_call_back_to_back_ms', 'design', 'plain_ms', 'bound_ms', 'bound_by',
        'max_abs_err') if k in tensor_window[name]}
  log('parallel_summary', **{k: json.dumps(v) for k, v in parallel.items()})
  log('tensor_summary', **{k: json.dumps(v) for k, v in tensor.items()})
  log('surface_summary', **{k: json.dumps(v) for k, v in surface.items()})
  log('superstep_summary',
      **{k: json.dumps(v) for k, v in superstep.items()})
  log('phase_seconds', total=sum(clock.seconds.values()),
      **{f'phase_{k}': v for k, v in clock.seconds.items()})
  print(json.dumps({'kernels': kernels}))
  print(card)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
  for worker_flag in ('--parallel-rank', '--tensor-rank', '--gn-rank'):
    if worker_flag in sys.argv[1:]:
      parallel_worker(worker_flag)
      break
  else:
    main()
