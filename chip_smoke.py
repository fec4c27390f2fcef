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
--bpd_eval_method=ode` on its exported `ckpt-N.flax`. Every check raises on
failure.

With `--profile` it also profiles one ELBO, one dense-VLB chunk, one train
step (unfused, fused, with `with_attention`, and the VDM's) and one ODE RHS
evaluation by kernel category with `torch.profiler` and prints the tables as
`[profile]` lines.

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
# Kernels every one of whose launches on the flagship paths must take the
# 'sm90' route (TMA-fed, warp-specialised wgmma kernels).
SM90_KERNELS = ('flash_attention', 'flash_attention_bwd_dkv',
                'flash_attention_bwd_dq')

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


def attention_case(dev, gen, shape, dtype, tol, timed_case):
  """K1 at one shape against its plain version (the output and the row
  log-sum-exp written under autograd, which must leave the output
  unchanged); with `timed_case`, timed beside the plain version, SDPA and
  its bound. Logs and returns the result."""
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
                lse_rel_err=lse_err.item())
  del ref, ref_lse
  if timed_case:
    result['ms'] = cuda_ms(lambda: flash_attention_fwd(q, k, v, scale))
    result['ms_with_lse'] = cuda_ms(lambda: flash_attention_fwd(
        q, k, v, scale, return_lse=True))
    result['plain_ms'] = cuda_ms(
        lambda: flash_attention_plain(q, k, v, scale))
    result['library_ms'] = cuda_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
    b, h, t, d = shape
    result.update(bound(4.0 * b * h * t * t * d, nbytes(q, k, v, out),
                        dtype))
  log('flash_attention', shape=list(shape), dtype=str(dtype),
      route=attention_route(dtype, shape[-1]), tol=tol, lse_rtol=LSE_RTOL,
      **result)
  assert result['max_abs_err'] <= tol, (shape, dtype, result)
  assert result['lse_rel_err'] <= LSE_RTOL, (shape, dtype, result)
  return result


def check_attention(dev, gen):
  """K1. The flagship shape and the sampler's (bf16, sm90 route) and the
  tiny config's float32 with a ragged T (simt route) are checked and timed;
  the others cover the sm90 route at a head_dim that is not a multiple of 16
  and at D = 64 with a T ragged across a 128-row tile, on two heads, and the
  simt route for bf16 with head_dim > 128. Returns the flagship's and the
  sampler's results."""
  cases = ((FLAGSHIP_ATTN, torch.bfloat16, ATTN_TOL_BF16, True),
           (SAMPLER_ATTN, torch.bfloat16, ATTN_TOL_BF16, True),
           ((3, 1, 60, 32), torch.float32, ATTN_TOL_F32, True),
           ((2, 2, 100, 40), torch.bfloat16, ATTN_TOL_BF16, False),
           ((2, 2, 200, 64), torch.bfloat16, ATTN_TOL_BF16, False),
           ((2, 1, 130, 256), torch.bfloat16, ATTN_TOL_BF16, False))
  results = [attention_case(dev, gen, *case) for case in cases]
  return results[0], results[1]


def check_attention_bwd(dev, gen):
  """K2 and K3 against the plain backward on the same inputs, on the same
  shapes and routes as `check_attention`. The flagship shape is timed: K2,
  K3 and the pair K2 + K3, one launch and back to back, the host's time a
  K3 call, beside the plain backward and the backward of
  `F.scaled_dot_product_attention` (fwd + bwd minus fwd; one launch and
  back to back)."""
  from mulan_tpu_torch.ops.flash_attention import (attention_route,
                                                   flash_attention_bwd_dkv,
                                                   flash_attention_bwd_dq,
                                                   flash_attention_bwd_plain,
                                                   flash_attention_fwd)
  cases = ((FLAGSHIP_ATTN, torch.bfloat16), (SAMPLER_ATTN, torch.bfloat16),
           ((3, 1, 60, 32), torch.float32), ((2, 2, 100, 40), torch.bfloat16),
           ((2, 2, 200, 64), torch.bfloat16),
           ((2, 1, 130, 256), torch.bfloat16))
  dkv = dq = None
  for shape, dtype in cases:
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
    log('flash_attention_bwd', shape=list(shape), dtype=str(dtype),
        route=attention_route(dtype, shape[-1]), tol=tol,
        max_abs_ref=max(r.float().abs().max().item() for r in ref),
        **{f'{n}_rel_err': e for n, e in errs.items()})
    assert max(errs.values()) <= tol, (shape, dtype, errs)
    if dkv is None:
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
      sdpa_bwd = cuda_ms(sdpa_fwd_bwd) - cuda_ms(sdpa_fwd)
      sdpa_bwd_b2b = back_to_back_ms(sdpa_fwd_bwd) - back_to_back_ms(sdpa_fwd)
      dkv = dict(max_abs_err=max((dk.float() - ref[1].float()).abs().max(),
                                 (dv.float() - ref[2].float()).abs().max())
                 .item(),
                 ms=cuda_ms(run_dkv), back_to_back_ms=back_to_back_ms(run_dkv),
                 plain_ms=plain_ms, library_ms=sdpa_bwd,
                 library_back_to_back_ms=sdpa_bwd_b2b,
                 **bound(4 * product, nbytes(q, k, v, do, lse, di, dk, dv),
                         dtype))
      dq = dict(max_abs_err=(dq_k.float() - ref[0].float()).abs().max()
                .item(),
                ms=cuda_ms(run_dq), back_to_back_ms=back_to_back_ms(run_dq),
                host_ms=host_ms(run_dq), plain_ms=plain_ms, library_ms=None,
                **bound(3 * product, nbytes(q, k, v, do, lse, di, dq_k),
                        dtype))
      pair = dict(ms=cuda_ms(run_pair), back_to_back_ms=back_to_back_ms(
          run_pair))
      dq['with_dkv'] = pair
      log('flash_attention_bwd_timing', shape=list(shape),
          dkv_ms=dkv['ms'], dkv_back_to_back_ms=dkv['back_to_back_ms'],
          dq_ms=dq['ms'], dq_back_to_back_ms=dq['back_to_back_ms'],
          dq_host_ms=dq['host_ms'], dkv_dq_ms=pair['ms'],
          dkv_dq_back_to_back_ms=pair['back_to_back_ms'], plain_ms=plain_ms,
          sdpa_bwd_ms=sdpa_bwd, sdpa_bwd_back_to_back_ms=sdpa_bwd_b2b)
  return dkv, dq


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


def check_gn_swish(dev, gen, sfu_rate):
  """K8 against `gn_swish_plain` at the flagship's two shapes (C = 128 and
  C = 256, bf16), in float32, at C = 48 (16 groups), and at an H x W that is
  no multiple of 8 (the kernel's scalar path). The flagship shapes are timed
  (one launch and back to back) beside the plain version and the unfused
  path's two calls,
  F.silu(F.group_norm(...)) (no single PyTorch call computes the function)."""
  from mulan_tpu_torch.ops.groupnorm_swish import gn_swish_fwd, gn_swish_plain
  results = []
  for shape, dtype, groups in GN_CASES:
    c = shape[1]
    x = (2 * torch.randn(shape, generator=gen, device=dev) + 0.5).to(dtype)
    w = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
    b = 0.1 * torch.randn(c, generator=gen, device=dev)
    out = gn_swish_fwd(x, w, b, groups)
    torch.cuda.synchronize()
    ref = gn_swish_plain(x, w, b, groups)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    rtol, atol = GN_TOL[dtype]
    diff = (out.float() - ref.float()).abs()
    excess = (diff - rtol * ref.float().abs()).max().item()
    result = dict(max_abs_err=diff.max().item(), max_excess_over_rtol=excess)
    if len(results) < 2:
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
    results.append(result)
  return results[0], results[1]


GN_CASES = (((EVAL_BATCH, 128, 32, 32), torch.bfloat16, 32),
            ((EVAL_BATCH, 256, 32, 32), torch.bfloat16, 32),
            ((8, 128, 32, 32), torch.float32, 32),
            ((4, 48, 16, 16), torch.bfloat16, 16),
            ((3, 48, 5, 7), torch.float32, 16))


def check_gn_swish_bwd(dev, gen, sfu_rate):
  """K8's backward against `gn_swish_bwd_plain` on the cases of
  `check_gn_swish`: dx elementwise and dweight, dbias by their max-abs (see
  GN_BWD_DX_TOL). The flagship shapes are timed (one launch, back to back,
  the host's time a call) beside the plain version and the backward of the
  unfused pair F.silu(F.group_norm(...)) in bf16 (forward and backward minus
  forward; no single PyTorch call computes the function)."""
  from mulan_tpu_torch.ops.groupnorm_swish import (gn_swish_bwd,
                                                   gn_swish_bwd_plain)
  results = []
  for shape, dtype, groups in GN_CASES:
    c = shape[1]
    x = (2 * torch.randn(shape, generator=gen, device=dev) + 0.5).to(dtype)
    dy = torch.randn(shape, generator=gen, device=dev).to(dtype)
    w = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
    b = 0.1 * torch.randn(c, generator=gen, device=dev)
    dx, dw, db = gn_swish_bwd(x, w, b, dy, groups)
    torch.cuda.synchronize()
    ref = gn_swish_bwd_plain(x, w, b, dy, groups)
    assert dx.dtype == ref[0].dtype == dtype and dx.shape == x.shape
    assert dw.dtype == db.dtype == torch.float32 and dw.shape == (c,)
    rtol, atol_frac = GN_BWD_DX_TOL[dtype]
    want = ref[0].float()
    diff = (dx.float() - want).abs()
    dx_excess = ((diff - rtol * want.abs()).max()
                 / want.abs().max()).item()
    errs = dict(dx_excess_over_rtol_frac=dx_excess,
                dweight_rel_err=rel_err(dw, ref[1]),
                dbias_rel_err=rel_err(db, ref[2]))
    result = dict(max_abs_err=max(diff.max(), (dw - ref[1]).abs().max(),
                                  (db - ref[2]).abs().max()).item(), **errs)
    if len(results) < 2:
      xg = x.detach().requires_grad_()
      wl, bl = (t.to(dtype).requires_grad_() for t in (w, b))

      def pair_fwd():
        return F.silu(F.group_norm(xg, groups, wl, bl, 1e-6))

      def pair_fwd_bwd():
        return torch.autograd.grad(pair_fwd(), (xg, wl, bl), dy)

      def run():
        return gn_swish_bwd(x, w, b, dy, groups)
      result.update(
          ms=cuda_ms(run), back_to_back_ms=back_to_back_ms(run),
          host_ms=host_ms(run),
          plain_ms=cuda_ms(lambda: gn_swish_bwd_plain(x, w, b, dy, groups)),
          library_ms=None,
          unfused_pair_bwd_ms=cuda_ms(pair_fwd_bwd) - cuda_ms(pair_fwd),
          # x and dy read and dx written once; ~20 float32 operations, an
          # exp2 and a reciprocal an element.
          **bound(20.0 * x.numel(), nbytes(x, dy, w, b, dx, dw, db),
                  exps=2.0 * x.numel(), sfu_rate=sfu_rate))
    log('gn_swish_bwd', shape=list(shape), dtype=str(dtype), groups=groups,
        rtol=rtol, atol_frac=atol_frac, sum_rtol=GN_BWD_SUM_RTOL, **result)
    assert dx_excess <= atol_frac, (shape, dtype, result)
    assert max(errs['dweight_rel_err'], errs['dbias_rel_err']) <= (
        GN_BWD_SUM_RTOL), (shape, dtype, result)
    results.append(result)
  return results[0], results[1]


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
  and the encoder keeps K6. K5 runs once in the VDM's step (its g0 is
  learned) and never in MuLAN's (`poly_fixedend` pins g0).
  """
  n_unet = 2 * cfg.sm_n_layer + 3
  n_enc = 0 if vdm else cfg.forward_n_layer + 2
  unet_attn = 1 + (2 * cfg.sm_n_layer + 1 if cfg.with_attention else 0)
  enc_attn = 0 if vdm else 1 + (cfg.forward_n_layer if cfg.with_attention
                                else 0)
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
      decoder_logprob=1, decoder_logprob_bwd=int(vdm),
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
  Asserts that every launch of the SM90_KERNELS took the 'sm90' route, and
  adds the launches by route to route_totals ({kernel: {route: n}})."""
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
    for route, n in by_route.items():
      total[route] += n
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
  """A wrong attention backward the train-step gates must reject: K2's dK
  replaced by zeros ('dk'), or K3's dQ zeroed on one consumer warpgroup's
  64 rows of every 128-query tile ('dq')."""
  from mulan_tpu_torch.ops import flash_attention as attn
  name = {'dk': 'flash_attention_bwd_dkv', 'dq': 'flash_attention_bwd_dq'}[
      kernel]
  real = getattr(attn, name)

  def faulty(*args):
    out = real(*args)
    if kernel == 'dk':
      dk, dv = out
      return torch.zeros_like(dk), dv
    rows = torch.arange(out.shape[2], device=out.device) % 128 >= 64
    return out.masked_fill(rows[:, None], 0)
  # The real wrapper counts on the module's name.
  faulty.launches = 0
  faulty.launches_by_route = dict.fromkeys(real.launches_by_route, 0)
  setattr(attn, name, faulty)
  try:
    yield
  finally:
    setattr(attn, name, real)


@contextlib.contextmanager
def planted_gn_fault(kind: str):
  """A wrong GroupNorm+swish the fused train-step gates must reject: K8
  launched with half the groups ('half_groups'), or K8's backward with dx
  missing its rstd xhat mean_grp(w g xhat) term ('missing_term')."""
  from mulan_tpu_torch.ops import groupnorm_swish as gn
  name = {'half_groups': 'gn_swish_fwd', 'missing_term': 'gn_swish_bwd'}[kind]
  real = getattr(gn, name)

  def half_groups(x, weight, bias, num_groups, eps=1e-6):
    return real(x, weight, bias, num_groups // 2, eps)

  def missing_term(x, weight, bias, dy, num_groups, eps=1e-6):
    dx, dweight, dbias = real(x, weight, bias, dy, num_groups, eps)
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


def compare_train_step(ex, model, build_plain, batch, noise):
  """One train step's loss and gradients through `model` (the kernels) and
  its plain twin on the same batch, noise and dropout masks, with the gates
  described at ATTN_LEAF_COS_MIN; the same gates must reject the step with a
  planted fault. The cosines to a float32 twin's gradient, per part of the
  model, are reported."""

  blocks = {'unet': model.score_model.mid_attn_1,
            'encoder': model.encoder_model.trunk.mid_attn_1}
  captured, hooks = capture_io(blocks)
  bpds, grads = {}, {}
  bpds['kernels'], grads['kernels'] = step_grads(ex, model, batch, noise)
  for h in hooks:
    h.remove()
  for name, overrides in (('plain', {}), ('f32', {'compute_dtype':
                                                  'float32'})):
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
  faults = {}
  for kernel in ('dk', 'dq'):
    with planted_fault(kernel):
      faults[kernel] = gates(step_grads(ex, model, batch, noise)[1],
                             alone(True))
  whole = {k: torch.cat(list(g.values())) for k, g in grads.items()}
  norm_rel = abs(whole['kernels'].norm().item()
                 / whole['plain'].norm().item() - 1)
  log('train_kernels_vs_plain', bpd=bpds,
      abs_delta=abs(bpds['kernels'] - bpds['plain']), tol=TRAIN_BPD_TOL,
      grad_norm_rel_diff=norm_rel, norm_rtol=GRAD_NORM_RTOL,
      unet_attn_leaf_cos_min=min(step_cos.values()),
      tol_leaf=ATTN_LEAF_COS_MIN,
      alone_leaf_cos_min={b: min(c.values()) for b, c in alone_cos.items()},
      tol_alone=ATTN_ALONE_COS_MIN,
      planted_faults_rejected={k: not passes(*c) for k, c in faults.items()},
      fault_unet_attn_leaf_cos_min={k: min(c[0].values())
                                    for k, c in faults.items()},
      whole_cos=cosine(whole['kernels'], whole['plain']),
      whole_cos_to_f32={k: cosine(whole[k], whole['f32'])
                        for k in ('kernels', 'plain')})
  log('train_attn_leaf_cosines', **{n.split('mid_attn_1.')[1]: round(c, 6)
                                    for n, c in step_cos.items()})

  # Where the bf16 gradients part from the float32 one, per part of MuLAN.
  parts = {}
  for n in grads['f32']:
    parts.setdefault(grad_part(n), []).append(n)
  total = whole['f32'].square().sum().item()
  log('train_grad_parts', **{part: dict(
      share_of_f32_norm2=round(sum(grads['f32'][n].square().sum().item()
                                   for n in ns) / total, 6),
      **{f'cos_{a}_{b}': round(cosine(
          *(torch.cat([grads[k][n] for n in ns]) for k in (a, b))), 6)
         for a, b in (('kernels', 'f32'), ('plain', 'f32'),
                      ('kernels', 'plain'))})
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
                                     eps0=eps, eps=eps, topk_noise=topk)
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


def run_ode_nll_cli(cfg, flax_path, route_totals, vdm: bool = False):
  """`eval_bpd --bpd_eval_method=ode --solver=rk4` on the exported
  `ckpt-N.flax` (of the flagship, or with `vdm` of vdm_cifar10), one batch
  of ODE_ROWS images, one importance sample: finite bpd, launches of one
  solve. Returns the launches."""
  from mulan_tpu_torch import eval_bpd
  name = 'vdm_cifar10' if vdm else 'cifar10_conditioned'
  argv = [*ode_cli_config(name), f'--checkpoint_directory={flax_path}',
          '--bpd_eval_method=ode', '--solver=rk4',
          f'--rk4_steps={ODE_RK4_STEPS}', '--n_is=1']
  (bpd, secs), counts = counted(lambda: timed(lambda: eval_bpd.main(argv)),
                                route_totals)
  log('vdm_ode_nll' if vdm else 'ode_nll', argv=' '.join(argv[-4:]),
      config=name, bpd=bpd, seconds=secs, nfe=4 * ODE_RK4_STEPS,
      launches=counts)
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

  def loose_sample_fn(model):
    sample = make_sample_fn(model, rtol=ODE_SAMPLE_TOL, atol=ODE_SAMPLE_TOL)

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
      training={'steps_per_logging': VDM_TRAIN_STEPS})
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
    paths['vdm_ode_nll_cli'] = run_ode_nll_cli(cfg, flax_path, route_totals,
                                               vdm=True)
  return paths, k5, ex


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
      training={'steps_per_logging': TRAIN_STEPS})
  cfg = train_cfg.model

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
  torch.cuda.empty_cache()

  # 3. Evaluation: sparse VLB over synthetic eval batches. Every counted
  # run of a main path adds its launches by route to route_totals.
  route_totals = {}
  state = params.init_params(cfg, torch.Generator().manual_seed(SEED),
                             perturb_zero_init=0.02)
  model = build_model('mulan_velocity', cfg, device=dev, state=state)
  images, _ = data.synthetic_split('eval', cfg.image_shape, seed=SEED)

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
        out = m.elbo(batch, t, eps0=eps, eps=eps, topk_noise=noise)
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

  # 6. Training: Experiment.train at batch 128 with dropout 0.1. The first
  # update has lr 0 (the warm-up is read before it), so step 1 leaves the
  # parameters as they were and later steps move them and the EMA.
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
    ms_per_step = 1e3 * secs / (steps - 1)
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

  # 7. One train step, kernels against plain and against float32.
  del start
  step_noise = dict(t=t, eps0=eps, eps=eps, topk_noise=noise,
                    dropout_seed=1234)
  compare_train_step(ex, model, lambda **kw: build_model(
      'mulan_velocity', dataclasses.replace(cfg, use_kernels=False, **kw),
      device=dev, state=state), {'images': batch}, step_noise)

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

  # 9. bench.py --attention: with_attention and remat='attn', fresh weights.
  attn_cfg = dataclasses.replace(cfg, with_attention=True, remat='attn')
  attn_state = params.init_params(attn_cfg,
                                  torch.Generator().manual_seed(SEED),
                                  perturb_zero_init=0.02)
  ex_a = Experiment(configs.replace(train_cfg, model={
      'with_attention': True, 'remat': 'attn'}), device=dev, state=attn_state)
  attn_train_counts = run_train(ex_a, ATTN_TRAIN_STEPS, 'attention_train')

  # 10. Every remat mode gives the step without remat, with attention blocks
  # and the fused GroupNorm+swish (so that a checkpointed ResNet block
  # recomputes K8 and regenerates its K6 masks).
  with no_plain_gn_bwd_on_cuda():
    remat_counts = compare_remat(
        ex_a, dataclasses.replace(attn_cfg, fused_gn_swish=True), attn_state,
        {'images': batch}, step_noise, dev, route_totals)
  torch.cuda.empty_cache()

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
  torch.cuda.empty_cache()

  if want_profile:
    ode_t = torch.tensor(0.5)

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
                     ('vdm_train_step_b128', train_step(ex_v))):
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
           'ode_fused_rhs': ode_fused_counts, **vdm_paths,
           **{f'remat_{mode}': c for mode, c in remat_counts.items()}}
  keys = ('max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
          'bound_ops_ms', 'bound_bytes_ms', 'library_ms')
  # Measured for some kernels only.
  extras = ('back_to_back_ms', 'host_ms', 'library_back_to_back_ms',
            'c_call_ms', 'c_call_back_to_back_ms', 'online_kernel_ms',
            'online_kernel_back_to_back_ms',
            'with_dkv', 'window_bins_per_pixel', 'bound_full_vocab_ms',
            'unfused_pair_ms', 'unfused_pair_bwd_ms')
  kernels = []
  for name, (source, replaces) in sources.items():
    by_path = {path: counts[name] for path, counts in paths.items()}
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
  by_name['gn_swish']['at_c256'] = {k: gn_swish_c256[k] for k in (
      'ms', 'back_to_back_ms', 'plain_ms', 'unfused_pair_ms', 'bound_ms',
      'max_abs_err')}
  k5_keys = ('ms', 'back_to_back_ms', 'c_call_back_to_back_ms',
             'online_kernel_ms', 'online_kernel_back_to_back_ms', 'plain_ms',
             'bound_ms', 'bound_by', 'bound_full_vocab_ms',
             'window_bins_per_pixel', 'max_abs_err')
  for case in ('per_example', 'gamma_max'):
    by_name['decoder_logprob_bwd'][f'at_{case}'] = {
        k: k5_cases[case][k] for k in k5_keys}
  by_name['gn_swish_bwd']['at_c256'] = {k: gn_bwd_c256[k] for k in (
      'ms', 'back_to_back_ms', 'host_ms', 'plain_ms', 'unfused_pair_bwd_ms',
      'bound_ms', 'max_abs_err')}
  print(json.dumps({'kernels': kernels}))
  print(card)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
  main()
