"""K4 and K8 of one checkout on one GPU, through that checkout's own
`chip_smoke.py` checks: the decoder log-likelihood forward (per-pixel g0 and
g0 = gamma_min), the fused GroupNorm+swish forward at the flagship's two
bf16 shapes and, where the checkout has it, its backward.

    python3 tools/torch_kernel_pair.py [--tree DIR]

`--tree` names the checkout whose `chip_smoke.py` and `mulan_tpu_torch` are
measured (default: this one). To compare two commits on one card, unpack the
other into a git-ignored directory (`runs/`) and alternate the two in one
call: other, this, this, other. Each check prints its `[phase]` lines (every
case, with its timings and bounds); the last line is one JSON object with
the card's name and power limit and the flagship-shape results. Needs CUDA
and `nvcc`; uses only torch.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys


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
  keys = ('ms', 'back_to_back_ms', 'host_ms', 'bound_ms', 'plain_ms')

  def pick(result):
    return {k: result[k] for k in keys if k in result}
  decoder = chip_smoke.check_decoder(dev, gen, flagship_config(), sfu_rate)
  out = {'tree': args.tree, 'card': card,
         'decoder_logprob': [pick(r) for r in decoder]
         if isinstance(decoder, list) else [pick(decoder)],
         'gn_swish': [pick(r) for r in chip_smoke.check_gn_swish(
             dev, gen, sfu_rate)]}
  if hasattr(chip_smoke, 'check_gn_swish_bwd'):
    out['gn_swish_bwd'] = [pick(r) for r in chip_smoke.check_gn_swish_bwd(
        dev, gen, sfu_rate)]
  print(json.dumps(out), flush=True)


if __name__ == '__main__':
  main()
