"""Drive the PyTorch port's evaluation and sampling path once on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 (sm_90a), the
CUDA toolkit (`nvcc`) and PyTorch built for CUDA; JAX is not needed. The
script builds the CUDA kernels from `mulan_tpu_torch/csrc/`, checks each
against its plain PyTorch version at the shapes the main path gives it, runs
the flagship MuLAN-velocity model (full width and depth, random weights from
a seed) through the sparse-VLB evaluation and the ancestral sampler, and
checks that both went through the kernels. Every check raises on failure.

Output, one line per phase; the line before the last is a JSON summary of
the kernels, and the last line is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import time

import torch

SEED = 0
EVAL_BATCH = 128
EVAL_BATCHES = 4
SAMPLE_BATCH = 16
SAMPLE_STEPS = 50

# K1 tolerances. bf16: the plain version rounds the normalized softmax
# weights to bf16 before the product with v, the tensor-core kernel the
# unnormalized ones and the CUDA-core kernel none (relative error 2^-9 per
# weight); both round the output to bf16. f32: only the order of the sums
# differs.
ATTN_TOL_BF16 = 2e-2
ATTN_TOL_F32 = 1e-5
# K4: f32 both ways; the kernel runs the recurrence one vocab value at a time,
# the plain version in chunks of 64, and the pixel sums differ in order.
DECODER_RTOL = 1e-5
# |bpd(kernels) - bpd(plain)| on one batch with the same noise: the two runs
# differ only in the attention weights' bf16 rounding (two blocks) and in the
# decoder's summation order, each far below 1e-3 of a bpd near 10.
BPD_TOL = 1e-2


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


def check_attention(dev, gen):
  """The flagship shape (bf16, tensor-core kernel) and the tiny config's
  float32 with a ragged T are checked and timed; the others cover a
  head_dim that is not a multiple of 16 and the CUDA-core kernel for bf16
  with head_dim > 128."""
  from mulan_tpu_torch.ops.flash_attention import (flash_attention,
                                                   flash_attention_plain)
  cases = (((EVAL_BATCH, 1, 1024, 128), torch.bfloat16, ATTN_TOL_BF16),
           ((3, 1, 60, 32), torch.float32, ATTN_TOL_F32),
           ((2, 2, 100, 40), torch.bfloat16, ATTN_TOL_BF16),
           ((2, 1, 130, 256), torch.bfloat16, ATTN_TOL_BF16))
  results = []
  for shape, dtype, tol in cases:
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for _ in range(3))
    scale = shape[-1] ** -0.5
    out = flash_attention(q, k, v, scale)
    torch.cuda.synchronize()
    ref = flash_attention_plain(q, k, v, scale)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    result = dict(max_abs_err=(out.float() - ref.float()).abs().max().item())
    if len(results) < 2:
      result['ms'] = cuda_ms(lambda: flash_attention(q, k, v, scale))
      result['plain_ms'] = cuda_ms(
          lambda: flash_attention_plain(q, k, v, scale))
    log('flash_attention', shape=list(shape), dtype=str(dtype), tol=tol,
        **result)
    assert result['max_abs_err'] <= tol, (shape, dtype, result)
    results.append(result)
  return results[0]


def check_decoder(dev, gen, cfg):
  from mulan_tpu_torch.ops.decoder_logprob import (decoder_logprob,
                                                   decoder_logprob_plain,
                                                   encode)
  shape = (EVAL_BATCH, *cfg.image_shape)
  x = torch.randint(0, 256, shape, generator=gen, device=dev).float()
  per_pixel = cfg.gamma_min + (cfg.gamma_max - cfg.gamma_min) * torch.rand(
      shape, generator=gen, device=dev)
  results = []
  for name, g0 in (('per_pixel', per_pixel),
                   ('gamma_min', torch.full(shape, cfg.gamma_min,
                                            device=dev))):
    z = encode(x, 256) + torch.exp(0.5 * g0) * torch.randn(
        shape, generator=gen, device=dev)
    out = decoder_logprob(x, z, g0)
    torch.cuda.synchronize()
    ref = decoder_logprob_plain(x, z, g0)
    assert out.shape == ref.shape == (EVAL_BATCH,)
    rel = ((out - ref).abs() / ref.abs().clamp_min(1.0)).max().item()
    result = dict(max_abs_err=(out - ref).abs().max().item(),
                  ms=cuda_ms(lambda: decoder_logprob(x, z, g0)),
                  plain_ms=cuda_ms(lambda: decoder_logprob_plain(x, z, g0)))
    log('decoder_logprob', g0=name, shape=list(shape), max_rel_err=rel,
        rtol=DECODER_RTOL, **result)
    assert rel <= DECODER_RTOL, f'decoder_logprob {name}: {rel}'
    results.append(result)
  return results[0]


def timed(fn):
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  out = fn()
  torch.cuda.synchronize()
  return out, time.perf_counter() - t0


def main() -> None:
  if not torch.cuda.is_available():
    raise SystemExit('chip_smoke: torch.cuda.is_available() is False; this '
                     'script runs only on a CUDA device')
  from mulan_tpu_torch import data, params
  from mulan_tpu_torch.evals import harness, vlb
  from mulan_tpu_torch.models import latents
  from mulan_tpu_torch.models.config import flagship_config
  from mulan_tpu_torch.models.mulan import MuLAN
  from mulan_tpu_torch.models.vdm import sample_times
  from mulan_tpu_torch.ops import _build
  from mulan_tpu_torch.ops.decoder_logprob import decoder_logprob
  from mulan_tpu_torch.ops.flash_attention import flash_attention

  # 1. Device and build.
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device('cuda', 0)
  smi = subprocess.run(
      ['nvidia-smi', '-i', '0', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True, check=True)
  card = smi.stdout.strip()
  t0 = time.perf_counter()
  _build.load_library()
  log('device', card=repr(card), torch=torch.__version__,
      cuda=torch.version.cuda, tf32='off (matmul and cudnn)',
      build_s=round(time.perf_counter() - t0, 3))
  gen = torch.Generator(device=dev).manual_seed(SEED)
  cfg = flagship_config()

  # 2-3. Each kernel against its plain version.
  attn = check_attention(dev, gen)
  dec = check_decoder(dev, gen, cfg)

  # 4. The main path: sparse VLB over synthetic eval batches, then sampling.
  model = MuLAN(cfg).to(dev).eval()
  state = params.init_params(cfg, torch.Generator().manual_seed(SEED),
                             perturb_zero_init=0.02)
  model.load_state_dict(state)
  images, _ = data.synthetic_split('eval', cfg.image_shape, seed=SEED)
  flash_attention.launches = 0
  decoder_logprob.launches = 0
  bpd, secs = timed(lambda: vlb.eval_bpd_sparse(
      model, data.eval_batches(images, EVAL_BATCH), generator=gen,
      max_batches=EVAL_BATCHES))
  eval_counts = (flash_attention.launches, decoder_logprob.launches)
  log('eval_bpd_sparse', batches=EVAL_BATCHES, batch=EVAL_BATCH, bpd=bpd,
      seconds=secs, launches_flash=eval_counts[0],
      launches_decoder=eval_counts[1])
  assert math.isfinite(bpd), bpd
  # Two attention blocks (encoder, UNet) and one decoder call per batch.
  assert eval_counts == (2 * EVAL_BATCHES, EVAL_BATCHES), eval_counts

  # 5. Sampling: T cut to SAMPLE_STEPS; every step is a full-size UNet pass.
  (samples, z_0), secs = timed(lambda: harness.random_samples(
      model, SAMPLE_BATCH, SAMPLE_STEPS, generator=gen))
  launches = {'flash_attention': flash_attention.launches,
              'decoder_logprob': decoder_logprob.launches}
  log('random_samples', batch=SAMPLE_BATCH, steps=SAMPLE_STEPS,
      ms_per_step=1e3 * secs / SAMPLE_STEPS, shape=list(samples.shape),
      dtype=str(samples.dtype), min=int(samples.min()),
      max=int(samples.max()), z0_abs_max=z_0.abs().max().item(),
      launches_flash=launches['flash_attention'] - eval_counts[0])
  assert samples.dtype.name == 'uint8'
  assert samples.shape == (SAMPLE_BATCH, *cfg.image_shape)
  assert 0 <= samples.min() and samples.max() <= 255
  assert torch.isfinite(z_0).all()
  assert launches['flash_attention'] == eval_counts[0] + SAMPLE_STEPS

  # 6. Kernels against the plain path, end to end, on one batch with the same
  # noise (outside the counted run).
  batch = torch.as_tensor(images[:EVAL_BATCH], device=dev)
  t = sample_times(EVAL_BATCH, generator=gen, device=dev)
  eps = torch.randn((EVAL_BATCH, *cfg.image_shape), generator=gen,
                    device=dev)
  noise = latents.gamma_variates(cfg.latent_k, (EVAL_BATCH, cfg.latent_size),
                                 generator=gen, device=dev)
  plain = MuLAN(dataclasses.replace(cfg, use_kernels=False)).to(dev).eval()
  plain.load_state_dict(state)
  rates = {}
  bpds = {}
  for name, m in (('kernels', model), ('plain', plain)):
    def run(m=m):
      with torch.inference_mode():
        out = m.elbo(batch, t, eps0=eps, eps=eps, topk_noise=noise)
        return vlb.bpd_terms(out, cfg.n_pixels).mean().item()
    run()
    secs = []
    for _ in range(3):
      bpds[name], s = timed(run)
      secs.append(s)
    rates[name] = EVAL_BATCH / statistics.median(secs)
  delta = abs(bpds['kernels'] - bpds['plain'])
  log('kernels_vs_plain', bpd_kernels=bpds['kernels'],
      bpd_plain=bpds['plain'], abs_delta=delta, tol=BPD_TOL,
      images_per_s_kernels=rates['kernels'],
      images_per_s_plain=rates['plain'])
  assert delta <= BPD_TOL, delta

  kernels = [
      dict(name='flash_attention', route='cuda',
           source='mulan_tpu_torch/csrc/flash_attention.cu',
           replaces='mulan_tpu/ops/flash_bwd.py:287',
           launches=launches['flash_attention'], **attn),
      dict(name='decoder_logprob', route='cuda',
           source='mulan_tpu_torch/csrc/decoder_logprob.cu',
           replaces='mulan_tpu/ops/decoder_logprob.py:36',
           launches=launches['decoder_logprob'], **dec),
  ]
  print(json.dumps({'kernels': kernels}))
  print(card)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
  main()
