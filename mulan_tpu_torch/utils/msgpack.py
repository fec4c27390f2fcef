"""A standard-library msgpack codec for the trees `flax.serialization`
writes (`to_bytes`, `msgpack_restore`), such as the `ckpt-N.flax` files of
`compat.py`.

The encoder gives the bytes of msgpack-python's `packb(tree,
default=flax's ext hook, strict_types=True)` with its defaults (bin type on,
double-precision floats): nil, bool, int (fixint, int8-64, uint8-64),
float64, str, bin, array and map at the narrowest width that fits; numpy
arrays as ext 1 (the packed tuple (shape, dtype name, C-order bytes)),
numpy scalars as ext 3 (the same, shape ()) and complex as ext 2. Array
leaves larger than `MAX_CHUNK_SIZE` bytes become flax's
`__msgpack_chunked_array__` dicts. The decoder reads all of that plus
float32, and returns arrays as read-only numpy views of the payload.
"""

from __future__ import annotations

import struct
from typing import Any, List

import numpy as np

# flax.serialization.MAX_CHUNK_SIZE: array leaves above it are chunked.
MAX_CHUNK_SIZE = 2 ** 30

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = '__msgpack_chunked_array__'


# -- encoding -----------------------------------------------------------------


def _pack_uint(out: List, value: int) -> None:
  if value < 0x80:
    out.append(bytes((value,)))
  elif value <= 0xff:
    out.append(bytes((0xcc, value)))
  elif value <= 0xffff:
    out.append(struct.pack('>BH', 0xcd, value))
  elif value <= 0xffffffff:
    out.append(struct.pack('>BI', 0xce, value))
  elif value <= 0xffffffffffffffff:
    out.append(struct.pack('>BQ', 0xcf, value))
  else:
    raise OverflowError(f'integer {value} does not fit 64 bits')


def _pack_int(out: List, value: int) -> None:
  if value >= 0:
    _pack_uint(out, value)
  elif value >= -32:
    out.append(struct.pack('>b', value))
  elif value >= -0x80:
    out.append(struct.pack('>Bb', 0xd0, value))
  elif value >= -0x8000:
    out.append(struct.pack('>Bh', 0xd1, value))
  elif value >= -0x80000000:
    out.append(struct.pack('>Bi', 0xd2, value))
  elif value >= -0x8000000000000000:
    out.append(struct.pack('>Bq', 0xd3, value))
  else:
    raise OverflowError(f'integer {value} does not fit 64 bits')


def _pack_len(out: List, n: int, fix: int, fix_max: int, codes) -> None:
  """A header for n items or bytes: the fix form below fix_max, else the
  first of codes (8-, 16- or 32-bit length) whose width fits."""
  if fix is not None and n < fix_max:
    out.append(bytes((fix | n,)))
    return
  for code, fmt, limit in codes:
    if n < limit:
      out.append(struct.pack('>B' + fmt, code, n))
      return
  raise ValueError(f'length {n} does not fit 32 bits')


_STR = ((0xd9, 'B', 1 << 8), (0xda, 'H', 1 << 16), (0xdb, 'I', 1 << 32))
_BIN = ((0xc4, 'B', 1 << 8), (0xc5, 'H', 1 << 16), (0xc6, 'I', 1 << 32))
_ARRAY = ((0xdc, 'H', 1 << 16), (0xdd, 'I', 1 << 32))
_MAP = ((0xde, 'H', 1 << 16), (0xdf, 'I', 1 << 32))
_FIXEXT = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
_EXT = ((0xc7, 'B', 1 << 8), (0xc8, 'H', 1 << 16), (0xc9, 'I', 1 << 32))


def _pack_ext(out: List, code: int, pieces: List) -> None:
  n = sum(len(p) for p in pieces)
  if n in _FIXEXT:
    out.append(bytes((_FIXEXT[n], code)))
  else:
    _pack_len(out, n, None, 0, _EXT)
    out.append(struct.pack('>b', code))
  out.extend(pieces)


def _ndarray_pieces(arr: np.ndarray) -> List:
  """flax's `_ndarray_to_bytes`: the packed (shape, dtype name, bytes),
  the bytes as a view of the array's (contiguous) data."""
  if arr.dtype.hasobject or arr.dtype.isalignedstruct:
    raise ValueError('object and structured dtypes cannot be serialized')
  data = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
  pieces = [b'\x93']  # a 3-array
  _pack(pieces, tuple(int(d) for d in arr.shape))
  _pack(pieces, arr.dtype.name)
  _pack_len(pieces, data.nbytes, None, 0, _BIN)
  pieces.append(memoryview(data))
  return pieces


def _pack(out: List, obj: Any) -> None:
  kind = type(obj)
  if obj is None:
    out.append(b'\xc0')
  elif kind is bool:
    out.append(b'\xc3' if obj else b'\xc2')
  elif kind is int:
    _pack_int(out, obj)
  elif kind is float:
    out.append(struct.pack('>Bd', 0xcb, obj))
  elif kind is str:
    data = obj.encode('utf-8')
    _pack_len(out, len(data), 0xa0, 32, _STR)
    out.append(data)
  elif kind in (bytes, bytearray, memoryview):
    _pack_len(out, len(obj), None, 0, _BIN)
    out.append(bytes(obj))
  elif kind in (list, tuple):
    _pack_len(out, len(obj), 0x90, 16, _ARRAY)
    for item in obj:
      _pack(out, item)
  elif kind is dict:
    _pack_len(out, len(obj), 0x80, 16, _MAP)
    for key, value in obj.items():
      _pack(out, key)
      _pack(out, value)
  elif isinstance(obj, np.ndarray):
    _pack_ext(out, _EXT_NDARRAY, _ndarray_pieces(obj))
  elif isinstance(obj, np.generic):
    _pack_ext(out, _EXT_NPSCALAR, _ndarray_pieces(np.asarray(obj)))
  elif kind is complex:
    pieces = []
    _pack(pieces, (obj.real, obj.imag))
    _pack_ext(out, _EXT_COMPLEX, pieces)
  else:
    raise TypeError(f'cannot serialize {kind.__name__}')


def _chunk(arr: np.ndarray) -> dict:
  """flax's `_chunk`: a flat array split into MAX_CHUNK_SIZE-byte chunks."""
  size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
  flat = arr.reshape(-1)
  chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
  return {_CHUNKED: True,
          'shape': {str(i): d for i, d in enumerate(arr.shape)},
          'chunks': {str(i): c for i, c in enumerate(chunks)}}


def _chunk_leaves(tree):
  """flax's `_chunk_array_leaves_in_place`, on a copy of the dicts."""
  if isinstance(tree, np.ndarray):
    return _chunk(tree) if tree.nbytes > MAX_CHUNK_SIZE else tree
  if type(tree) is not dict:
    return tree
  out = {}
  for key, value in tree.items():
    if isinstance(value, (np.ndarray, dict)):
      value = _chunk_leaves(value)
    out[key] = value
  return out


def serialize_pieces(tree) -> List:
  """The encoding of `tree` as a list of bytes-like pieces (array data as
  views, not copies): write them in turn, or join them."""
  out = []
  _pack(out, _chunk_leaves(tree))
  return out


def serialize(tree) -> bytes:
  """`flax.serialization.msgpack_serialize(tree)` (and `to_bytes` of a tree
  of dicts), byte for byte."""
  return b''.join(serialize_pieces(tree))


# -- decoding -----------------------------------------------------------------


class _Reader:
  """Decodes from `data`; bin payloads come back as bytes, or with
  `bin_views` as memoryviews of `data`."""

  def __init__(self, data, bin_views: bool = False):
    self.buf = memoryview(data).cast('B')
    self.pos = 0
    self.bin_views = bin_views

  def take(self, n: int) -> memoryview:
    if self.pos + n > len(self.buf):
      raise ValueError('msgpack data ends inside an object')
    view = self.buf[self.pos:self.pos + n]
    self.pos += n
    return view

  def unpack(self, fmt: str):
    size = struct.calcsize(fmt)
    if self.pos + size > len(self.buf):
      raise ValueError('msgpack data ends inside an object')
    value = struct.unpack_from(fmt, self.buf, self.pos)
    self.pos += size
    return value[0]

  def read(self, raw: bool = False):
    code = self.unpack('>B')
    if code <= 0x7f:
      return code
    if code >= 0xe0:
      return code - 0x100
    if 0x80 <= code <= 0x8f:
      return self._map(code & 0x0f, raw)
    if 0x90 <= code <= 0x9f:
      return self._array(code & 0x0f, raw)
    if 0xa0 <= code <= 0xbf:
      return self._str(code & 0x1f, raw)
    if code in _SIMPLE:
      return _SIMPLE[code]
    if code in _NUMBERS:
      return self.unpack(_NUMBERS[code])
    if code in _LENGTHS:
      kind, fmt = _LENGTHS[code]
      n = self.unpack(fmt)
      if kind == 'str':
        return self._str(n, raw)
      if kind == 'bin':
        return self.take(n) if self.bin_views else bytes(self.take(n))
      if kind == 'array':
        return self._array(n, raw)
      if kind == 'map':
        return self._map(n, raw)
      return self._ext(self.unpack('>b'), self.take(n))
    if code in _FIXEXT_LEN:
      ext = self.unpack('>b')
      return self._ext(ext, self.take(_FIXEXT_LEN[code]))
    raise ValueError(f'unknown msgpack type byte 0x{code:02x}')

  def _str(self, n: int, raw: bool):
    data = bytes(self.take(n))
    return data if raw else data.decode('utf-8')

  def _array(self, n: int, raw: bool) -> list:
    return [self.read(raw) for _ in range(n)]

  def _map(self, n: int, raw: bool) -> dict:
    out = {}
    for _ in range(n):
      key = self.read(raw)
      out[key] = self.read(raw)
    return out

  @staticmethod
  def _ext(code: int, payload: memoryview):
    if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
      arr = _ndarray_from(payload)
      return arr if code == _EXT_NDARRAY else arr[()]
    if code == _EXT_COMPLEX:
      real, imag = _Reader(payload).read()
      return complex(real, imag)
    raise ValueError(f'unknown msgpack ext type {code}')


_SIMPLE = {0xc0: None, 0xc2: False, 0xc3: True}
_NUMBERS = {0xca: '>f', 0xcb: '>d', 0xcc: '>B', 0xcd: '>H', 0xce: '>I',
            0xcf: '>Q', 0xd0: '>b', 0xd1: '>h', 0xd2: '>i', 0xd3: '>q'}
_LENGTHS = {0xc4: ('bin', '>B'), 0xc5: ('bin', '>H'), 0xc6: ('bin', '>I'),
            0xc7: ('ext', '>B'), 0xc8: ('ext', '>H'), 0xc9: ('ext', '>I'),
            0xd9: ('str', '>B'), 0xda: ('str', '>H'), 0xdb: ('str', '>I'),
            0xdc: ('array', '>H'), 0xdd: ('array', '>I'),
            0xde: ('map', '>H'), 0xdf: ('map', '>I')}
_FIXEXT_LEN = {code: n for n, code in _FIXEXT.items()}


def _ndarray_from(payload: memoryview) -> np.ndarray:
  """flax's `_ndarray_from_bytes`, as a view of the payload."""
  shape, name, data = _Reader(payload, bin_views=True).read(raw=True)
  if name == b'bfloat16':
    raise ValueError('bfloat16 array leaves are not supported (numpy has '
                     'no bfloat16)')
  return np.frombuffer(data, dtype=np.dtype(name.decode())).reshape(shape)


def _unchunk_leaves(tree):
  """flax's `_unchunk_array_leaves_in_place`."""
  if not isinstance(tree, dict):
    return tree
  if _CHUNKED in tree:
    shape = tuple(tree['shape'][str(i)] for i in range(len(tree['shape'])))
    chunks = [tree['chunks'][str(i)] for i in range(len(tree['chunks']))]
    return np.concatenate(chunks).reshape(shape)
  for key, value in tree.items():
    if isinstance(value, dict):
      tree[key] = _unchunk_leaves(value)
  return tree


def restore(data) -> Any:
  """`flax.serialization.msgpack_restore(data)`: maps as dicts, arrays as
  lists, array leaves as numpy arrays (chunked ones joined)."""
  reader = _Reader(data)
  tree = reader.read()
  if reader.pos != len(reader.buf):
    raise ValueError(f'{len(reader.buf) - reader.pos} trailing bytes after '
                     'the msgpack object')
  return _unchunk_leaves(tree)
