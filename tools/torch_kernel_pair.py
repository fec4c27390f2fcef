"""K4 and K8 of one checkout on one GPU, through that checkout's own
`chip_smoke.py` checks: the decoder log-likelihood forward (per-pixel g0 and
g0 = gamma_min), the fused GroupNorm+swish forward at the flagship's two
bf16 shapes and, where the checkout has it, its backward, there also at
imagenet32's C = 512 and a tensor rank's (32, 64, 32, 32) window (16
groups); and the backward's C entry point `mulan_gn_swish_bwd` alone at
those four shapes (`GN_BWD_CASES`), with the arguments of the checkout's
signature: the two-launch kernel's (no statistics, no counters) or the
ring's (the statistics K8's forward writes, per-group counters).

    python3 tools/torch_kernel_pair.py [--tree DIR]

`--tree` names the checkout whose `chip_smoke.py` and `mulan_tpu_torch` are
measured (default: this one). To compare two commits on one card, unpack the
other into a git-ignored directory (`runs/`) and alternate the two in one
call: other, this, this, other. Each check prints its `[phase]` lines (every
case, with its timings and bounds); the last line is one JSON object with
the card's name and power limit and the flagship-shape results. Each C-call
case draws its inputs from a generator of its own (the same inputs in
every checkout) and gives `dx_sha256`, the digest of the dx bytes of the
kernel that computes dx as the two-launch kernel does: that kernel itself,
or the registers design (`mulan_gn_swish_bwd_regs`) on the forward's
statistics. Equal digests in two checkouts say that taking the forward's
statistics changed no bit of dx. Needs CUDA and `nvcc`; uses only torch.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import subprocess
import sys

# (shape, groups) of the backward's C call, bf16.
GN_BWD_CASES = (((128, 128, 32, 32), 32), ((128, 256, 32, 32), 32),
                ((128, 512, 32, 32), 32), ((32, 64, 32, 32), 16))


def gn_bwd_c_call(torch, chip_smoke, build, dev):
  """{shape: one launch and back-to-back ms, dx_sha256} of the checkout's
  `mulan_gn_swish_bwd` C call on bf16 inputs seeded per case, its arguments
  by the length of its ctypes signature."""
  lib = build.load_library()
  two_launch = len(build._SIGNATURES['mulan_gn_swish_bwd']) == 15
  # The arithmetic flag (0, K8's own) where the entry points take one.
  fwd_flag = (0,) if len(build._SIGNATURES['mulan_gn_swish']) == 13 else ()
  bwd_flag = (0,) if len(build._SIGNATURES['mulan_gn_swish_bwd']) == 17 \
      else ()
  stream = torch.cuda.current_stream(dev).cuda_stream
  out = {}
  for shape, groups in GN_BWD_CASES:
    n, c, hw = shape[0], shape[1], shape[2] * shape[3]
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    x = (2 * torch.randn(shape, generator=gen, device=dev) + 0.5).to(
        torch.bfloat16)
    dy = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    w = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
    b = 0.1 * torch.randn(c, generator=gen, device=dev)
    dx, dw, db = torch.empty_like(x), torch.empty_like(w), torch.empty_like(b)
    partial = torch.empty((2, n, c), device=dev)
    if two_launch:
      tensors = (x, dy, w, b, dx, partial, dw, db)
      tail = (n, c, hw, groups, 1e-6, 1, stream)
    else:
      stats = torch.empty((n, groups, 2), device=dev)
      assert lib.mulan_gn_swish(
          x.data_ptr(), w.data_ptr(), b.data_ptr(),
          torch.empty_like(x).data_ptr(), stats.data_ptr(), n, c, hw, groups,
          1e-6, 1, *fwd_flag, stream) == 0
      counters = torch.zeros(groups, dtype=torch.int32, device=dev)
      tensors = (x, dy, w, b, stats, dx, partial, counters, dw, db)
      tail = (n, c, hw, groups, 1, *bwd_flag, stream)
    args = (*(t.data_ptr() for t in tensors), *tail)

    def launch(args=args, entry=lib.mulan_gn_swish_bwd):
      assert entry(*args) == 0
    if not two_launch:  # dx as the two-launch kernel computes it
      launch(entry=lib.mulan_gn_swish_bwd_regs)
    else:
      launch()
    torch.cuda.synchronize()
    out['x'.join(map(str, shape))] = {
        'dx_sha256': hashlib.sha256(
            dx.view(torch.int16).cpu().numpy().tobytes()).hexdigest(),
        'c_call_ms': chip_smoke.cuda_ms(launch),
        'c_call_back_to_back_ms': chip_smoke.back_to_back_ms(launch)}
  return out


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  parser.add_argument('--tree', default=str(
      pathlib.Path(__file__).resolve().parents[1]))
  args = parser.parse_args()
  sys.path.insert(0, str(pathlib.Path(args.tree).resolve()))
  import torch

  import chip_smoke
  from mulan_tpu_torch.models.config import flagship_config
  from mulan_tpu_torch.ops import _build
  if not torch.cuda.is_available():
    raise SystemExit('torch_kernel_pair: needs a CUDA device')
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device('cuda', 0)
  card = subprocess.run(
      ['nvidia-smi', '-i', '0', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True,
      check=True).stdout.strip()
  _build.load_library()
  gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
  sfu_rate = chip_smoke.sm_ops_per_s(chip_smoke.SFU_PER_CLOCK_PER_SM)
  keys = ('ms', 'back_to_back_ms', 'host_ms', 'c_call_ms',
          'c_call_back_to_back_ms', 'bound_ms', 'plain_ms')

  def pick(result):
    return {k: result[k] for k in keys if k in result}
  decoder = chip_smoke.check_decoder(dev, gen, flagship_config(), sfu_rate)
  out = {'tree': args.tree, 'card': card,
         'decoder_logprob': [pick(r) for r in decoder]
         if isinstance(decoder, list) else [pick(decoder)],
         'gn_swish': [pick(r) for r in chip_smoke.check_gn_swish(
             dev, gen, sfu_rate)]}
  if hasattr(chip_smoke, 'check_gn_swish_bwd'):
    bf16 = torch.bfloat16
    cases = tuple(c for c in chip_smoke.GN_CASES if c[3]) + (
        ((chip_smoke.EVAL_BATCH, 512, 32, 32), bf16, 32, True),
        ((32, 64, 32, 32), bf16, 16, True))
    out['gn_swish_bwd'] = [pick(r) for r in chip_smoke.check_gn_swish_bwd(
        dev, gen, sfu_rate, cases)]
    out['gn_swish_bwd_c_call'] = gn_bwd_c_call(torch, chip_smoke, _build,
                                               dev)
  print(json.dumps(out), flush=True)


if __name__ == '__main__':
  main()
