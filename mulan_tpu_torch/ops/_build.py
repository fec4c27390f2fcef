"""Builds `csrc/*.cu` into one shared library at first use and loads it.

The sources are compiled by `nvcc` for `sm_90a` (H100) into a plain C
interface, keyed by a hash of the sources and flags, under
`mulan_tpu_torch/_build/` (listed in `.gitignore`). Nothing here includes
PyTorch's headers, so a build takes seconds. Kernels launch on the stream the
caller passes (PyTorch's current stream) and return `cudaGetLastError()`,
which `check()` turns into an exception.
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
              '-std=c++17', '-shared', '-Xcompiler', '-fPIC')

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # (q, k, v, o, batch*heads, tokens, head_dim, sm_scale, is_bf16, stream)
    'mulan_flash_attention_fwd': [_P, _P, _P, _P, _I, _I, _I,
                                  ctypes.c_float, _I, _P],
    # (x, z, g0, partial, out, batch, pixels, n_blocks, vocab_size, stream)
    'mulan_decoder_logprob_fwd': [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
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
  digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
  for src in _sources():
    digest.update(src.name.encode())
    digest.update(src.read_bytes())
  return _BUILD / digest.hexdigest()[:16] / 'libmulan_kernels.so'


def _compile(out: pathlib.Path) -> None:
  out.parent.mkdir(parents=True, exist_ok=True)
  tmp = out.with_suffix(f'.{os.getpid()}.tmp')
  cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp),
         *[str(s) for s in _sources()]]
  proc = subprocess.run(cmd, capture_output=True, text=True)
  if proc.returncode != 0:
    raise RuntimeError(f'nvcc failed ({proc.returncode}):\n{" ".join(cmd)}\n'
                       f'{proc.stdout}\n{proc.stderr}')
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
