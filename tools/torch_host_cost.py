"""Cost of the PyTorch port's no-grad paths on one GPU, where the host
bounds the sampler: kernels launched, device busy share and time, per
ancestral sampler step (batch 16) and per ELBO (batch 128) of the flagship
MuLAN-velocity at full width and depth, random weights from seed 0.

    python3 tools/torch_host_cost.py [--tree DIR] [--reps 7] [--steps 20]
                                     [--fused]

`--tree` names the checkout whose `mulan_tpu_torch` is measured (default:
this one). To compare two commits on one card, unpack the other into a
git-ignored directory and alternate the two on one card. Prints
one JSON line: the card's name and power limit, kernels and busy share per
call from `torch.profiler`, the time of every repetition (host clock around
a synchronized call: a sampler run of `--steps` steps, or one ELBO), and
for the sampler the main thread's CPU time per step spent enqueueing
`--steps` steps with no synchronization between them (`time.thread_time`,
which a busy shared host does not inflate as it does the wall clock).
`--fused` measures the model with `fused_gn_swish` (K8 at the score UNet's
GN-swish sites; a tree from before that flag does not take it). Needs CUDA
and `nvcc`; uses only torch and numpy.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  parser.add_argument('--tree', default=str(
      pathlib.Path(__file__).resolve().parents[1]))
  parser.add_argument('--reps', type=int, default=7)
  parser.add_argument('--steps', type=int, default=20)
  parser.add_argument('--fused', action='store_true')
  args = parser.parse_args()
  sys.path.insert(0, args.tree)
  import torch
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity

  from mulan_tpu_torch import params
  from mulan_tpu_torch.evals import harness
  from mulan_tpu_torch.models import latents
  from mulan_tpu_torch.models.config import flagship_config
  from mulan_tpu_torch.models.mulan import MuLAN
  if not torch.cuda.is_available():
    raise SystemExit('torch_host_cost: needs a CUDA device')
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device('cuda', 0)
  card = subprocess.run(
      ['nvidia-smi', '-i', '0', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True,
      check=True).stdout.strip()

  cfg = flagship_config(**({'fused_gn_swish': True} if args.fused else {}))
  model = MuLAN(cfg)
  model.load_state_dict(params.init_params(
      cfg, torch.Generator().manual_seed(0), perturb_zero_init=0.02))
  model.to(dev)
  gen = torch.Generator(device=dev).manual_seed(0)
  images = torch.randint(0, 256, (128, *cfg.image_shape), generator=gen,
                         device=dev, dtype=torch.uint8)

  @torch.inference_mode()
  def elbo():
    model(images, generator=gen)

  def sample():
    harness.random_samples(model, 16, args.steps, generator=gen)

  @torch.inference_mode()
  def enqueue_cpu_ms():
    """Thread CPU ms per sampler step, enqueued without a sync."""
    emb = latents.logits_to_embeddings(torch.randn(
        (16, cfg.latent_size), generator=gen, device=dev), cfg.latent_k)
    z = torch.randn((16, *cfg.image_shape), generator=gen, device=dev)
    torch.cuda.synchronize()
    t0 = time.thread_time()
    for i in range(args.steps):
      z = model.conditional_sample(i, args.steps, z, emb, generator=gen)
    cpu = time.thread_time() - t0
    torch.cuda.synchronize()
    return 1e3 * cpu / args.steps

  def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0

  def profiled(fn):
    """(kernels, busy share) of one call."""
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
      span = timed(fn)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / (1e6 * span)
    return len(kernels), busy

  result = {'tree': args.tree, 'fused': args.fused, 'card': card,
            'torch': torch.__version__}
  for name, fn, per in (('sample_step_b16', sample, args.steps),
                        ('elbo_b128', elbo, 1)):
    fn()
    fn()
    kernels, busy = profiled(fn)
    ms = [1e3 * timed(fn) / per for _ in range(args.reps)]
    result[name] = {'kernels_per_call': kernels / per,
                    'busy_share_profiled': busy,
                    'ms_median': statistics.median(ms), 'ms': ms}
  cpu_ms = [enqueue_cpu_ms() for _ in range(args.reps)]
  result['sample_step_b16'].update(host_cpu_ms_median=statistics.median(
      cpu_ms), host_cpu_ms=cpu_ms)
  print(json.dumps(result))


if __name__ == '__main__':
  main()
