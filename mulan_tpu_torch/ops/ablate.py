"""Times textual variants of one kernel's source against each other on the
card: an ablation harness for the hand-written kernels.

    python3 -m mulan_tpu_torch.ops.ablate mulan_tpu_torch/ops/ablations/k3_dq.json

SPEC (`ablations/*.json` beside this module) names the source under
`mulan_tpu_torch/csrc/` (`file`), the C entry points to time (`entries`,
names of `_build._SIGNATURES`: K1's `mulan_flash_attention_fwd_sm90`, K2's
`mulan_flash_attention_bwd_dkv_sm90`, K3's
`mulan_flash_attention_bwd_dq_sm90`, K4's `mulan_decoder_logprob_fwd`, K5's
`mulan_decoder_logprob_bwd`, K6's `mulan_dropout_mask`, K7's
`mulan_dropout_mask_batch`, K8's `mulan_gn_swish`, its backward's
`mulan_gn_swish_bwd` and `mulan_gn_swish_bwd_regs`)
and a dict of variants, each a list of [old, new] text substitutions
applied to the sources (a variant whose `old` text is missing fails to
build); "tree" with no substitution is the source as it is. An attention
spec may name its own `shape` (B, H, T, D), e.g. the imagenet32 backward's
(128, 1, 1024, 256) for the D <= 256 kernels. Every variant is built into a
library of its own (one `nvcc` each, all started together, with
`-Xptxas -v`: spills and ptxas performance warnings are printed), then each
entry point of each variant is timed at the flagship's shape in turns,
three rounds: the attention kernels at (128, 1, 1024, 128) bf16 (or the
spec's `shape`), K6 at one (128, 128, 32, 32) bf16 site, K7 at the score
UNet's 67 such sites, K8 at `GN_CASES` (bf16: the flagship's C = 128 and
256 and imagenet32's 512 at 32 groups, a tensor rank's (32, 64, 32, 32) at
16), K4 at (128, 32, 32, 3) with g0 per pixel uniform over [gamma_min,
gamma_max] and with g0 = gamma_min (the cases of chip_smoke.py), K5 at the
same shape with one g0 at gamma_min (the VDM's train step) and at
gamma_max, g0 per example, and g0 = gamma_min per pixel (how the online
K5's wrapper handed a broadcast g0 to it):

  * single: CUDA events around one launch, median of 20 (as chip_smoke.py
    times a kernel; the host's launch cost is inside when the card idles);
  * back_to_back: around 10 launches, per launch, median of 10 (the
    device's time);
  * host_ms_per_call: the host's time per call of the C entry point, 50
    calls;
  * kernel_us: each CUDA kernel's device time a call (torch.profiler's
    kernel events over 10 calls back to back), where a call launches more
    than one.

and its outputs are compared with the tree's (a variant that removes
work is only a timing probe). Needs a CUDA device and nvcc; writes only
under a temporary directory.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from mulan_tpu_torch.ops import _build
from mulan_tpu_torch.ops.dropout import kernel_constants
from mulan_tpu_torch.ops.groupnorm_swish import group_stats

ATTN_SHAPE = (128, 1, 1024, 128)
MASK_SHAPE = (128, 128, 32, 32)
MASK_SLOTS = 67
MASK_RATE = 0.1
# K8's cases: (shape, groups). The flagship's two bf16 sites, imagenet32's
# C = 512 and a tensor rank's window of the flagship at tp = 2.
GN_CASES = (((128, 128, 32, 32), 32), ((128, 256, 32, 32), 32),
            ((128, 512, 32, 32), 32), ((32, 64, 32, 32), 16))
DECODER_SHAPE = (128, 32 * 32 * 3)
GAMMA_MIN, GAMMA_MAX = -13.3, 5.0


def kernel_name(mangled: str) -> str:
  """A kernel of an anonymous namespace by its name and template
  arguments, e.g. `gn_swish_bwd<I13__nv_bfloat16Li8ELi2E>`, from its
  mangled name (else the name as it is, cut to 64 characters)."""
  found = re.search(r'_cu_[0-9a-f]{8}(\d+)', mangled)
  if not found:
    return mangled[:64]
  start = found.end()
  name = mangled[start:start + int(found.group(1))]
  args = re.match(r'I(.*?)Ev', mangled[start + len(name):])
  return f'{name}<{args.group(1)}>' if args else name


def build(name, subs, source, show, tmp_root):
  """(name, library path or None, ptxas notes or the failure). The notes
  are ptxas's spill and C75xx performance warnings, and the registers and
  spills of every kernel whose mangled name contains `show`."""
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
  notes, kernel = [], ''
  for line in log:
    found = re.search(r"entry function '(\w+)'", line)
    if found:
      kernel = found.group(1)
    shown = show and show in kernel and ('spill stores' in line
                                         or 'Used' in line)
    if (shown or 'C75' in line or ('spill stores' in line
                                   and ' 0 bytes spill stores' not in line)):
      notes.append(f'{kernel_name(kernel)}: {line.strip()[:100]}')
  return name, str(lib), '; '.join(notes)


def load(path, entries):
  """The variant's library, its entry points typed from _SIGNATURES."""
  lib = ctypes.CDLL(path)
  for name in entries:
    fn = getattr(lib, name)
    fn.argtypes = _build._SIGNATURES[name]
    fn.restype = ctypes.c_int
  return lib


def make_inputs(dev, attn_shape=ATTN_SHAPE, entries=()):
  """The shared inputs of every entry point, from seed 0; the attention
  kernels' at `attn_shape`, K8's only where `entries` name it."""
  gen = torch.Generator(device=dev).manual_seed(0)

  def randn(shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)
  q, k, v, do = (randn(attn_shape, torch.bfloat16) for _ in range(4))
  inputs = dict(attn=(q, k, v, do, randn(attn_shape[:3]).abs() + 5,
                      randn(attn_shape[:3])))
  for shape, groups in GN_CASES:
    if not any(e.startswith('mulan_gn_swish') for e in entries):
      break
    c = shape[1]
    inputs[gn_case(shape, groups)] = (
        (2 * randn(shape) + 0.5).to(torch.bfloat16),
        randn(shape, torch.bfloat16), 1 + 0.1 * randn((c,)),
        0.1 * randn((c,)))
  x = torch.randint(0, 256, DECODER_SHAPE, generator=gen,
                    device=dev).float()
  per_pixel = GAMMA_MIN + (GAMMA_MAX - GAMMA_MIN) * torch.rand(
      DECODER_SHAPE, generator=gen, device=dev)
  for name, g0 in (('per_pixel', per_pixel),
                   ('gamma_min', torch.full_like(per_pixel, GAMMA_MIN))):
    z = (2 * (x + 0.5) / 256 - 1) + torch.exp(0.5 * g0) * randn(
        DECODER_SHAPE)
    inputs[f'decoder_{name}'] = (x, z, g0)
  e_x = 2 * (x + 0.5) / 256 - 1
  b = DECODER_SHAPE[0]
  for name, g0 in (
      ('one_gamma_min', torch.full((1,), GAMMA_MIN, device=dev)),
      ('one_gamma_max', torch.full((1,), GAMMA_MAX, device=dev)),
      ('per_example', GAMMA_MIN + (GAMMA_MAX - GAMMA_MIN) * torch.rand(
          (b,), generator=gen, device=dev)),
      ('per_pixel_gamma_min', torch.full(DECODER_SHAPE, GAMMA_MIN,
                                         device=dev))):
    sigma = torch.exp(0.5 * g0).reshape(-1, 1) if g0.dim() == 1 else (
        torch.exp(0.5 * g0))
    inputs[f'decoder_bwd_{name}'] = (x, e_x + sigma * randn(DECODER_SHAPE),
                                     g0, randn((b,)))
  return inputs


def gn_case(shape, groups):
  return f'gn_c{shape[1]}' + ('' if shape[0] == 128 else f'_b{shape[0]}') + (
      '' if groups == 32 else f'_g{groups}')


def launchers(lib, entry, inputs):
  """[(case, launch(), outputs)] of one entry point on the shared inputs."""
  stream = torch.cuda.current_stream().cuda_stream
  fn = getattr(lib, entry)
  cases = []
  if entry.startswith('mulan_flash_attention'):
    q, k, v, do, lse, di = inputs['attn']
    bh, t, d = q.shape[0] * q.shape[1], q.shape[2], q.shape[3]
    scale = d ** -0.5
    if entry == 'mulan_flash_attention_fwd_sm90':
      outs = (torch.empty_like(q),)
      args = (q, k, v, *outs, None, bh, t, d, scale)
    elif entry == 'mulan_flash_attention_bwd_dkv_sm90':
      outs = (torch.empty_like(k), torch.empty_like(v))
      args = (q, k, v, do, lse, di, *outs, bh, t, d, scale)
    elif entry == 'mulan_flash_attention_bwd_dq_sm90':
      outs = (torch.empty_like(q),)
      args = (q, k, v, do, lse, di, *outs, bh, t, d, scale)
    else:
      raise ValueError(f'ablate: no launcher for {entry}')
    cases.append(('', outs, args))
  elif entry == 'mulan_dropout_mask':
    outs = (torch.empty(MASK_SHAPE, dtype=torch.bfloat16,
                        device=inputs['attn'][0].device),)
    cases.append(('', outs, (*outs, outs[0].numel(), 1234, 5,
                             *kernel_constants(MASK_RATE), 0, 0, 0, 1)))
  elif entry == 'mulan_dropout_mask_batch':
    outs = (torch.empty((MASK_SLOTS, *MASK_SHAPE), dtype=torch.bfloat16,
                        device=inputs['attn'][0].device),)
    cases.append(('', outs, (*outs, outs[0][0].numel(), MASK_SLOTS, 1234, 0,
                             *kernel_constants(MASK_RATE), 0, 0, 0, 1)))
  elif entry.startswith('mulan_gn_swish'):
    for shape, groups in GN_CASES:
      case = gn_case(shape, groups)
      x, dy, w, b = inputs[case]
      n, c, hw = shape[0], shape[1], shape[2] * shape[3]
      stats = group_stats(x, groups, 1e-6)
      if entry == 'mulan_gn_swish':
        outs = (torch.empty_like(x), torch.empty_like(stats))
        args = (x, w, b, *outs, n, c, hw, groups, 1e-6, 1, 0)
      else:  # the backward's designs, with the forward's statistics
        outs = (torch.empty_like(x), torch.empty_like(w),
                torch.empty_like(b))
        partial = torch.empty((2, n, c), device=x.device)
        counters = torch.zeros(groups, dtype=torch.int32, device=x.device)
        args = (x, dy, w, b, stats, outs[0], partial, counters, outs[1],
                outs[2], n, c, hw, groups, 1, 0)
      cases.append((case[3:], outs, args))
  elif entry == 'mulan_decoder_logprob_fwd':
    for name in ('per_pixel', 'gamma_min'):
      x, z, g0 = inputs[f'decoder_{name}']
      b, n = x.shape
      n_blocks = -(-n // 1024)
      partial = torch.empty((b, n_blocks), device=x.device)
      outs = (torch.empty((b,), device=x.device),)
      cases.append((name, outs, (x, z, g0, partial, *outs, b, n, n_blocks,
                                 256)))
  elif entry == 'mulan_decoder_logprob_bwd':
    for name, mode in (('one_gamma_min', 2), ('one_gamma_max', 2),
                       ('per_example', 1), ('per_pixel_gamma_min', 0)):
      x, z, g0, ct = inputs[f'decoder_bwd_{name}']
      b, n = x.shape
      n_blocks = -(-n // 256)
      outs = (torch.empty_like(z), torch.empty_like(g0))
      partial = torch.empty((b, n_blocks), device=x.device)
      cases.append((name, outs, (x, z, g0, ct, *outs, partial, b, n,
                                 n_blocks, mode, 256)))
  else:
    raise ValueError(f'ablate: no launcher for {entry}')
  result = []
  for case, outs, args in cases:
    ptrs = tuple(a.data_ptr() if torch.is_tensor(a) else a for a in args)

    # The closure holds the tensors too: a scratch buffer freed here would
    # be handed to the next case (K8's counters must stay zero).
    def launch(ptrs=ptrs, tensors=args):
      status = fn(*ptrs, stream)
      assert status == 0, (entry, status)
    result.append((case, launch, outs))
  return result


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


def kernel_split_us(launch, n=10):
  """{kernel name: device microseconds a call} of the CUDA kernels that
  `launch` runs, from torch.profiler's kernel events over n calls back to
  back (a call's kernels apart, e.g. a main kernel and its reduction)."""
  launch()
  torch.cuda.synchronize()
  activities = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=activities) as prof:
    for _ in range(n):
      launch()
    torch.cuda.synchronize()
  split = {}
  for evt in prof.key_averages():
    if evt.device_type != torch.autograd.DeviceType.CUDA:
      continue
    us = getattr(evt, 'self_device_time_total', None)
    if us is None:
      us = evt.self_cuda_time_total
    name = re.sub(r'\(.*$', '', evt.key.replace('(anonymous namespace)::',
                                                 ''))
    split[name[-96:]] = split.get(name[-96:], 0.0) + us / n
  return split


def main():
  if not torch.cuda.is_available():
    raise SystemExit('ablate: needs a CUDA device')
  spec = json.loads(pathlib.Path(sys.argv[1]).read_text())
  source, entries = spec['file'], spec['entries']
  card = subprocess.run(['nvidia-smi', '-i', '0',
                         '--query-gpu=name,power.limit',
                         '--format=csv,noheader'], capture_output=True,
                        text=True).stdout.strip()
  print('card', card, flush=True)
  with tempfile.TemporaryDirectory() as tmp_root:
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
      built = list(pool.map(
          lambda kv: build(*kv, source, spec.get('show', ''), tmp_root),
          spec['variants'].items()))
    libs = {}
    for name, path, notes in built:
      print('build', name, 'ok' if path else 'FAILED', notes[:8000],
            flush=True)
      if path:
        libs[name] = load(path, entries)
    inputs = make_inputs(torch.device('cuda', 0),
                         tuple(spec.get('shape', ATTN_SHAPE)), entries)
    for entry in entries:
      runs = {(n, case): (launch, outs) for n, lib in libs.items()
              for case, launch, outs in launchers(lib, entry, inputs)}
      single = {key: [] for key in runs}
      back = {key: [] for key in runs}
      for _ in range(3):
        for key, (launch, _) in runs.items():
          single[key].append(cuda_ms(launch))
          back[key].append(cuda_ms(lambda: [launch() for _ in range(10)],
                                   n=10) / 10)
      for (n, case), (launch, outs) in runs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
          launch()
        host_ms = (time.perf_counter() - t0) / 50 * 1e3
        torch.cuda.synchronize()
        ref = runs.get(('tree', case))
        diff = (max((a.float() - r.float()).abs().max().item()
                    for a, r in zip(outs, ref[1])) if ref else None)
        print(json.dumps({'entry': entry, 'case': case, 'variant': n,
                          'single_ms': single[(n, case)],
                          'back_to_back_ms': back[(n, case)],
                          'host_ms_per_call': host_ms,
                          'kernel_us': kernel_split_us(launch),
                          'max_abs_diff_to_tree': diff}), flush=True)
      del runs


if __name__ == '__main__':
  main()
