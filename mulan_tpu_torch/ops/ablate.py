"""Times textual variants of one attention kernel against each other on the
card: an ablation harness for the sm90 kernels.

    python3 -m mulan_tpu_torch.ops.ablate mulan_tpu_torch/ops/ablations/k1_fwd.json

SPEC (`ablations/k1_fwd.json` and `k2_dkv.json` beside this module) names
the source under `mulan_tpu_torch/csrc/` (`flash_attention.cu`
for K1's `mulan_flash_attention_fwd_sm90`, `flash_attention_bwd.cu` for
K2's `mulan_flash_attention_bwd_dkv_sm90`) and a dict of variants, each a
list of [old, new] text substitutions applied to the sources (a variant
whose `old` text is missing fails to build); "tree" with no substitution
is the source as it is. Every variant is built into a library of its own
(one `nvcc` each, all started together, with `-Xptxas -v`: spills and
ptxas performance warnings are printed), then each is timed at the
flagship shape (128, 1, 1024, 128) bf16 in turns, three rounds:

  * single: CUDA events around one launch, median of 20 (as chip_smoke.py
    times a kernel; the host's launch cost is inside when the card idles);
  * back_to_back: around 10 launches, per launch, median of 10 (the
    device's time);
  * host_ms_per_call: the host's time per launch call, 50 calls.

and its outputs are compared with the tree's (a variant that removes
work is only a timing probe). Needs a CUDA device and nvcc; writes only
under a temporary directory.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from mulan_tpu_torch.ops import _build

SHAPE = (128, 1, 1024, 128)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build(name, subs, source, tmp_root):
  """(name, library path or None, ptxas notes or the failure)."""
  tmp = pathlib.Path(tempfile.mkdtemp(dir=tmp_root))
  texts = {f.name: f.read_text() for f in _build._CSRC.iterdir()}
  for old, new in subs:
    hits = [n for n in texts if old in texts[n]]
    if not hits:
      return name, None, f'substitution not found: {old[:60]!r}'
    for n in hits:
      texts[n] = texts[n].replace(old, new)
  for n, text in texts.items():
    (tmp / n).write_text(text)
  lib = tmp / f'lib_{name}.so'
  proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, '-Xptxas', '-v',
                         '-shared', '-o', str(lib), str(tmp / source)],
                        capture_output=True, text=True)
  log = (proc.stdout + proc.stderr).splitlines()
  if proc.returncode:
    return name, None, '\n'.join(log[-30:])
  notes = [line.strip()[:120] for line in log
           if 'C75' in line or ('spill stores' in line
                                and ' 0 bytes spill stores' not in line)]
  return name, str(lib), '; '.join(notes)


def launcher(lib, source, tensors):
  """(launch(), outputs) for the variant's sm90 entry point."""
  q, k, v, do, lse, di = tensors
  b, h, t, d = q.shape
  stream = torch.cuda.current_stream().cuda_stream
  scale = d ** -0.5
  if source == 'flash_attention.cu':
    fn = lib.mulan_flash_attention_fwd_sm90
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P]
    o = torch.empty_like(q)

    def launch():
      status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  None, b * h, t, d, scale, stream)
      assert status == 0, status
    return launch, (o,)
  fn = lib.mulan_flash_attention_bwd_dkv_sm90
  fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P]
  dk, dv = torch.empty_like(k), torch.empty_like(v)

  def launch():
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                b * h, t, d, scale, stream)
    assert status == 0, status
  return launch, (dk, dv)


def cuda_ms(fn, n=20):
  fn()
  torch.cuda.synchronize()
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


def main():
  if not torch.cuda.is_available():
    raise SystemExit('ablate: needs a CUDA device')
  spec = json.loads(pathlib.Path(sys.argv[1]).read_text())
  source = spec['file']
  card = subprocess.run(['nvidia-smi', '-i', '0',
                         '--query-gpu=name,power.limit',
                         '--format=csv,noheader'], capture_output=True,
                        text=True).stdout.strip()
  print('card', card, flush=True)
  with tempfile.TemporaryDirectory() as tmp_root:
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
      built = list(pool.map(lambda kv: build(*kv, source, tmp_root),
                            spec['variants'].items()))
    libs = {}
    for name, path, notes in built:
      print('build', name, 'ok' if path else 'FAILED', notes[:600],
            flush=True)
      if path:
        libs[name] = ctypes.CDLL(path)
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, do = (torch.randn(SHAPE, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    lse = torch.randn(SHAPE[:3], generator=gen, device=dev).abs() + 5
    di = torch.randn(SHAPE[:3], generator=gen, device=dev)
    runs = {n: launcher(lib, source, (q, k, v, do, lse, di))
            for n, lib in libs.items()}
    single = {n: [] for n in runs}
    back = {n: [] for n in runs}
    for _ in range(3):
      for n, (launch, _) in runs.items():
        single[n].append(cuda_ms(launch))
        back[n].append(cuda_ms(lambda: [launch() for _ in range(10)],
                               n=10) / 10)
    ref = runs['tree'][1] if 'tree' in runs else None
    for n, (launch, outs) in runs.items():
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      for _ in range(50):
        launch()
      host_ms = (time.perf_counter() - t0) / 50 * 1e3
      torch.cuda.synchronize()
      diff = (max((a.float() - r.float()).abs().max().item()
                  for a, r in zip(outs, ref)) if ref else None)
      print(json.dumps({'variant': n, 'single_ms': single[n],
                        'back_to_back_ms': back[n],
                        'host_ms_per_call': host_ms,
                        'max_abs_diff_to_tree': diff}), flush=True)


if __name__ == '__main__':
  main()
