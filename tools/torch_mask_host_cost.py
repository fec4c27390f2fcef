"""The host's time per call of the dropout-mask wrapper (K6,
`mulan_tpu_torch.ops.dropout.dropout_mask`) at one flagship site,
(128, 128, 32, 32) bf16 at rate 0.1, and of each part of it, on one GPU.

    python3 tools/torch_mask_host_cost.py [--tree DIR] [--rounds 3]

`--tree` names the checkout whose `mulan_tpu_torch` is measured (default:
this one). To compare two commits on one card, unpack the other into a
git-ignored directory and alternate the two in one call. Prints one JSON
line a round: the card's name and power limit, and microseconds a call of

  * wrapper: `dropout_mask(...)`, 200 calls enqueued with no synchronize
    between them (the kernel's ~20 us on the device stays under the host's
    time, so the launch queue never fills);
  * empty: `torch.empty` of the mask;
  * stream: `torch.cuda.current_stream(device).cuda_stream`;
  * constants_per_call: the keep scale rounded to float32 through a CPU
    tensor, as the wrapper computed it on every call before
    `kernel_constants`; constants_cached: `kernel_constants(rate)`, where
    the tree has it;
  * c_call: the ctypes call of `mulan_dropout_mask` alone, 200 calls.

Needs CUDA and `nvcc`; uses only torch.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

SHAPE = (128, 128, 32, 32)
RATE = 0.1


def us_per_call(fn, calls: int) -> float:
  import torch
  fn()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(calls):
    fn()
  secs = time.perf_counter() - t0
  torch.cuda.synchronize()
  return 1e6 * secs / calls


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  parser.add_argument('--tree', default=str(
      pathlib.Path(__file__).resolve().parents[1]))
  parser.add_argument('--rounds', type=int, default=3)
  args = parser.parse_args()
  sys.path.insert(0, args.tree)
  import torch

  from mulan_tpu_torch.ops import _build
  from mulan_tpu_torch.ops import dropout
  if not torch.cuda.is_available():
    raise SystemExit('torch_mask_host_cost: needs a CUDA device')
  dev = torch.device('cuda', 0)
  card = subprocess.run(
      ['nvidia-smi', '-i', '0', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True,
      check=True).stdout.strip()
  dtype = torch.bfloat16
  lib = _build.load_library()
  out = torch.empty(SHAPE, dtype=dtype, device=dev)
  stream = torch.cuda.current_stream(dev).cuda_stream
  threshold = dropout.threshold16(RATE)
  scale = float(torch.tensor(dropout.keep_scale(RATE), dtype=torch.float32))
  # Trees since K6 took a rank's element offset pass first_index too, and
  # those since it took a channel window its run and row stride.
  offset = {8: (), 9: (0,), 11: (0, 0, 0)}[
      len(_build._SIGNATURES['mulan_dropout_mask'])]
  parts = {
      'wrapper': (lambda: dropout.dropout_mask(1234, 5, SHAPE, RATE, dtype,
                                               dev), 200),
      'empty': (lambda: torch.empty(SHAPE, dtype=dtype, device=dev), 2000),
      'stream': (lambda: torch.cuda.current_stream(dev).cuda_stream, 2000),
      'constants_per_call': (lambda: (dropout.threshold16(RATE), float(
          torch.tensor(dropout.keep_scale(RATE), dtype=torch.float32))),
                             2000),
      'c_call': (lambda: lib.mulan_dropout_mask(
          out.data_ptr(), out.numel(), 1234, 5, threshold, scale, *offset, 1,
          stream),
                 200),
  }
  if hasattr(dropout, 'kernel_constants'):
    parts['constants_cached'] = (lambda: dropout.kernel_constants(RATE),
                                 2000)
  for rnd in range(args.rounds):
    print(json.dumps({'tree': args.tree, 'card': card, 'round': rnd,
                      **{name: us_per_call(fn, calls)
                         for name, (fn, calls) in parts.items()}}),
          flush=True)


if __name__ == '__main__':
  main()
