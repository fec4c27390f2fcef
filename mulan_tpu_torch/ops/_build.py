"""Builds `csrc/*.cu` into one shared library at first use and loads it.

The sources are compiled by `nvcc` for `sm_90a` (H100) into a plain C
interface, keyed by a hash of the flags and of every file under `csrc/`
(the `.cu` sources and the headers they include, such as `sm90.cuh`), under
`mulan_tpu_torch/_build/` (listed in `.gitignore`): one `nvcc -c` per source,
all started together, then one link. Nothing here includes PyTorch's headers,
so a build takes seconds. The library links only the CUDA runtime: the
kernels that use TMA look `cuTensorMapEncodeTiled` up through
`cudaGetDriverEntryPoint` (`csrc/sm90.cuh`), so no `-lcuda` is needed.
Kernels launch on the stream the caller passes (PyTorch's current stream)
and return `cudaGetLastError()`, which `check()` turns into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_PKG = pathlib.Path(__file__).resolve().parent.parent
_CSRC = _PKG / 'csrc'
_BUILD = _PKG / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-O3',
              '-std=c++17', '-Xcompiler', '-fPIC')

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
_SIGNATURES = {
    # (q, k, v, o, lse or None, batch*heads, tokens, head_dim, sm_scale,
    #  stream); bf16, head_dim <= 256
    'mulan_flash_attention_fwd_sm90': [_P, _P, _P, _P, _P, _I, _I, _I, _F,
                                       _P],
    # the same, then is_bf16 before the stream
    'mulan_flash_attention_fwd_simt': [_P, _P, _P, _P, _P, _I, _I, _I, _F,
                                       _I, _P],
    # (q, k, v, do, lse, di, dk, dv, batch*heads, tokens, head_dim,
    #  sm_scale, stream); bf16, head_dim <= 256
    'mulan_flash_attention_bwd_dkv_sm90': [_P, _P, _P, _P, _P, _P, _P, _P,
                                           _I, _I, _I, _F, _P],
    # the same, then is_bf16 before the stream
    'mulan_flash_attention_bwd_dkv_simt': [_P, _P, _P, _P, _P, _P, _P, _P,
                                           _I, _I, _I, _F, _I, _P],
    # (q, k, v, do, lse, di, dq, batch*heads, tokens, head_dim, sm_scale,
    #  stream); bf16, head_dim <= 256
    'mulan_flash_attention_bwd_dq_sm90': [_P, _P, _P, _P, _P, _P, _P, _I,
                                          _I, _I, _F, _P],
    # the same, then is_bf16 before the stream
    'mulan_flash_attention_bwd_dq_simt': [_P, _P, _P, _P, _P, _P, _P, _I,
                                          _I, _I, _F, _I, _P],
    # (x, z, g0, partial, out, batch, pixels, n_blocks, vocab_size, stream)
    'mulan_decoder_logprob_fwd': [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # (x, z, g0, ct, dz or None, dg0 or None, partial, batch, pixels,
    #  n_blocks, g_mode (0 per pixel, 1 per example, 2 one g0), vocab_size,
    #  stream)
    'mulan_decoder_logprob_bwd': [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _P],
    # (out, n, seed, site, threshold16, scale, first_index, run, row_stride,
    #  is_bf16, stream)
    'mulan_dropout_mask': [_P, ctypes.c_longlong, _U, _U, _U, _F,
                           ctypes.c_ulonglong, ctypes.c_ulonglong,
                           ctypes.c_ulonglong, _I, _P],
    # (out, n per mask, n_masks, seed, first_site, threshold16, scale,
    #  first_index, run, row_stride, is_bf16, stream)
    'mulan_dropout_mask_batch': [_P, ctypes.c_longlong, _U, _U, _U, _U, _F,
                                 ctypes.c_ulonglong, ctypes.c_ulonglong,
                                 ctypes.c_ulonglong, _I, _P],
    # (x, weight, bias, out, stats or None, batch, channels, hw, groups,
    #  eps, is_bf16, unfused, stream)
    'mulan_gn_swish': [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P],
    # (x, dy, weight, bias, stats, dx, partial, counters, dweight, dbias,
    #  batch, channels, hw, groups, is_bf16, unfused, stream): the ring
    #  design, and the same arguments for the registers design
    'mulan_gn_swish_bwd': [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                           _I, _I, _I, _I, _P],
    'mulan_gn_swish_bwd_regs': [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                _I, _I, _I, _I, _I, _P],
}


def _nvcc() -> str:
  cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
  path = shutil.which('nvcc') or os.path.join(cuda_home, 'bin', 'nvcc')
  if not os.path.exists(path):
    raise RuntimeError(f'nvcc not found (looked on PATH and at {path})')
  return path


def _sources():
  return sorted(_CSRC.glob('*.cu'))


def _library_path() -> pathlib.Path:
  """The library's path, named by a hash of the flags and of every file
  under `csrc/`, so that an edit to a header alone rebuilds it too."""
  digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
  for path in sorted(p for p in _CSRC.iterdir() if p.is_file()):
    digest.update(path.name.encode())
    digest.update(path.read_bytes())
  return _BUILD / digest.hexdigest()[:16] / 'libmulan_kernels.so'


def _run_all(cmds) -> None:
  """Runs the commands concurrently; raises with the first failure's
  output."""
  procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
           for cmd in cmds]
  outputs = [proc.communicate()[0] for proc in procs]
  for cmd, proc, output in zip(cmds, procs, outputs):
    if proc.returncode != 0:
      raise RuntimeError(f'nvcc failed ({proc.returncode}):\n'
                         f'{" ".join(cmd)}\n{output}')


def _compile(out: pathlib.Path) -> None:
  out.parent.mkdir(parents=True, exist_ok=True)
  tag = f'{os.getpid()}.tmp'
  objs = [out.parent / f'{src.stem}.{tag}.o' for src in _sources()]
  _run_all([[_nvcc(), *NVCC_FLAGS, '-c', '-o', str(obj), str(src)]
            for src, obj in zip(_sources(), objs)])
  tmp = out.with_suffix(f'.{tag}')
  _run_all([[_nvcc(), *NVCC_FLAGS, '-shared', '-o', str(tmp),
             *map(str, objs)]])
  for obj in objs:
    obj.unlink()
  os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def load_library() -> ctypes.CDLL:
  """The kernels' shared library, compiled on the first call."""
  global _lib
  with _lock:
    if _lib is None:
      path = _library_path()
      if not path.exists():
        _compile(path)
      lib = ctypes.CDLL(str(path))
      for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
      lib.mulan_error_string.argtypes = [ctypes.c_int]
      lib.mulan_error_string.restype = ctypes.c_char_p
      _lib = lib
  return _lib


def check(status: int, what: str) -> None:
  if status != 0:
    msg = _lib.mulan_error_string(status).decode()
    raise RuntimeError(f'{what}: CUDA error {status} ({msg})')
