"""The subset of msgpack that the JAX package's checkpoints use, decoded and
encoded without the `msgpack` or `flax` packages.

The JAX package writes a checkpoint with `flax.serialization.to_bytes` of
its train state (mocodad_tpu/training/checkpoint.py:21-35): nested maps
with str keys (flax writes every tuple or list of the state, such as the
optimizer state, as a map with keys '0', '1', ...), ndarrays, numpy
scalars, and Python ints, floats, strs, bools and None.  flax packs an
ndarray as msgpack ext type 1 and a numpy scalar as ext type 3; the
payload of either is itself msgpack, the array `(shape, dtype name, raw
C-order bytes)`.

`unpackb` decodes maps, arrays, str and bin, ints, floats, nil, bool and
those two ext types.  It refuses, with a ValueError that names the type,
what a train state of this repository never holds: flax's chunked form of
arrays over 1 GiB (`__msgpack_chunked_array__` maps), complex numbers
(flax's ext type 2), any other ext code, and the msgpack byte 0xc1.  A
bfloat16 array is returned as float32 (every bfloat16 value is a float32
value; NumPy has no bfloat16).  `packb` writes the same subset as flax
would, byte for byte: the shortest form of each int, str and bin,
float64 for Python floats, ext 1 for an ndarray, ext 3 for a numpy scalar.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED_KEY = '__msgpack_chunked_array__'

# fixed-width big-endian codes: byte -> (struct format, size)
_INTS = {0xcc: ('>B', 1), 0xcd: ('>H', 2), 0xce: ('>I', 4), 0xcf: ('>Q', 8),
         0xd0: ('>b', 1), 0xd1: ('>h', 2), 0xd2: ('>i', 4), 0xd3: ('>q', 8)}
_LENGTHS = {1: '>B', 2: '>H', 4: '>I'}
# str8/16/32, bin8/16/32, array16/32, map16/32, ext8/16/32 -> length bytes
_STR = {0xd9: 1, 0xda: 2, 0xdb: 4}
_BIN = {0xc4: 1, 0xc5: 2, 0xc6: 4}
_ARRAY = {0xdc: 2, 0xdd: 4}
_MAP = {0xde: 2, 0xdf: 4}
_EXT = {0xc7: 1, 0xc8: 2, 0xc9: 4}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError('msgpack: truncated input')
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]


def _ndarray(payload: bytes) -> np.ndarray:
    """flax's ndarray payload: msgpack of (shape, dtype name, bytes)."""
    shape, name, buf = unpackb(payload, raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    if name == 'bfloat16':
        bits = np.frombuffer(buf, dtype='<u2').astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise ValueError(f'msgpack: unsupported array dtype {name!r}') from e
    if dtype.kind == 'c':
        raise ValueError(f'msgpack: complex arrays ({name}) are not '
                         'supported')
    return np.frombuffer(bytes(buf), dtype=dtype).reshape(shape)


def _ext(code: int, payload: bytes):
    if code == EXT_NDARRAY:
        return _ndarray(payload)
    if code == EXT_NPSCALAR:
        return _ndarray(payload)[()]
    if code == EXT_COMPLEX:
        raise ValueError('msgpack: complex numbers (ext type 2) are not '
                         'supported')
    raise ValueError(f'msgpack: unknown ext type {code}')


def _str(r: _Reader, n: int, raw: bool):
    b = bytes(r.take(n))
    return b if raw else b.decode('utf-8')


def _read(r: _Reader, raw: bool) -> Any:
    b = r.unpack('>B', 1)
    if b <= 0x7f:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0x80 <= b <= 0x8f:
        return _read_map(r, b & 0x0f, raw)
    if 0x90 <= b <= 0x9f:
        return [_read(r, raw) for _ in range(b & 0x0f)]
    if 0xa0 <= b <= 0xbf:
        return _str(r, b & 0x1f, raw)
    if b == 0xc0:
        return None
    if b in (0xc2, 0xc3):
        return b == 0xc3
    if b in _INTS:
        return r.unpack(*_INTS[b])
    if b == 0xca:
        return r.unpack('>f', 4)
    if b == 0xcb:
        return r.unpack('>d', 8)
    if b in _STR:
        n = _STR[b]
        return _str(r, r.unpack(_LENGTHS[n], n), raw)
    if b in _BIN:
        n = _BIN[b]
        return bytes(r.take(r.unpack(_LENGTHS[n], n)))
    if b in _ARRAY:
        n = _ARRAY[b]
        return [_read(r, raw) for _ in range(r.unpack(_LENGTHS[n], n))]
    if b in _MAP:
        n = _MAP[b]
        return _read_map(r, r.unpack(_LENGTHS[n], n), raw)
    if b in _FIXEXT or b in _EXT:
        if b in _FIXEXT:
            size = _FIXEXT[b]
        else:
            n = _EXT[b]
            size = r.unpack(_LENGTHS[n], n)
        code = r.unpack('>b', 1)
        return _ext(code, bytes(r.take(size)))
    raise ValueError(f'msgpack: byte 0x{b:02x} is not a msgpack type')


def _read_map(r: _Reader, n: int, raw: bool) -> dict:
    out = {}
    for _ in range(n):
        k = _read(r, raw)
        out[k] = _read(r, raw)
    if CHUNKED_KEY in out:
        raise ValueError('msgpack: chunked arrays (flax '
                         f'{CHUNKED_KEY!r} maps, arrays over 1 GiB) are not '
                         'supported')
    return out


def unpackb(data: bytes, raw: bool = False) -> Any:
    """Decode one msgpack object that fills `data`.  `raw` keeps strs as
    bytes (flax reads the ndarray payload that way)."""
    r = _Reader(data)
    out = _read(r, raw)
    if r.pos != len(r.data):
        raise ValueError(f'msgpack: {len(r.data) - r.pos} bytes after the '
                         'object')
    return out


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------

def _len_header(n: int, fix: Tuple[int, int], codes: Tuple[int, ...]
                ) -> bytes:
    """The header of a str, array or map of length n: the fix form up to
    its limit, then the 8/16/32-bit forms `codes` (None where msgpack has
    none)."""
    fix_base, fix_max = fix
    if n <= fix_max:
        return bytes([fix_base | n])
    for code, fmt, limit in zip(codes, ('>B', '>H', '>I'),
                                (0xff, 0xffff, 0xffffffff)):
        if code is not None and n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f'msgpack: length {n} too large')


def _pack_int(v: int) -> bytes:
    if 0 <= v <= 0x7f or -32 <= v < 0:
        return struct.pack('>b', v) if v < 0 else bytes([v])
    if v >= 0:
        for code, fmt, limit in ((0xcc, '>B', 0xff), (0xcd, '>H', 0xffff),
                                 (0xce, '>I', 0xffffffff),
                                 (0xcf, '>Q', 0xffffffffffffffff)):
            if v <= limit:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, limit in ((0xd0, '>b', 0x80), (0xd1, '>h', 0x8000),
                                 (0xd2, '>i', 0x80000000),
                                 (0xd3, '>q', 0x8000000000000000)):
            if v >= -limit:
                return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f'msgpack: int {v} out of range')


def _pack_bin(b: bytes) -> bytes:
    n = len(b)
    for code, fmt, limit in ((0xc4, '>B', 0xff), (0xc5, '>H', 0xffff),
                             (0xc6, '>I', 0xffffffff)):
        if n <= limit:
            return bytes([code]) + struct.pack(fmt, n) + b
    raise ValueError(f'msgpack: bin of {n} bytes too large')


def _pack_ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        head = bytes([fixed[n]])
    elif n <= 0xff:
        head = bytes([0xc7]) + struct.pack('>B', n)
    elif n <= 0xffff:
        head = bytes([0xc8]) + struct.pack('>H', n)
    else:
        head = bytes([0xc9]) + struct.pack('>I', n)
    return head + struct.pack('>b', code) + payload


def _array_payload(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.kind == 'c' or a.dtype.fields:
        raise ValueError(f'msgpack: cannot pack arrays of {a.dtype}')
    return packb([list(a.shape), a.dtype.name, a.tobytes('C')])


def _write(v: Any, out: list) -> None:
    if v is None:
        out.append(b'\xc0')
    elif v is True or v is False:
        out.append(b'\xc3' if v else b'\xc2')
    elif type(v) is int:
        out.append(_pack_int(v))
    elif type(v) is float:
        out.append(b'\xcb' + struct.pack('>d', v))
    elif type(v) is str:
        b = v.encode('utf-8')
        out.append(_len_header(len(b), (0xa0, 31), (0xd9, 0xda, 0xdb)) + b)
    elif type(v) is bytes:
        out.append(_pack_bin(v))
    elif type(v) is list:
        out.append(_len_header(len(v), (0x90, 15), (None, 0xdc, 0xdd)))
        for x in v:
            _write(x, out)
    elif type(v) is dict:
        out.append(_len_header(len(v), (0x80, 15), (None, 0xde, 0xdf)))
        for k, x in v.items():
            _write(k, out)
            _write(x, out)
    elif isinstance(v, np.ndarray):
        out.append(_pack_ext(EXT_NDARRAY, _array_payload(v)))
    elif isinstance(v, np.generic):
        out.append(_pack_ext(EXT_NPSCALAR, _array_payload(np.asarray(v))))
    else:
        raise ValueError(f'msgpack: cannot pack {type(v).__name__}')


def packb(obj: Any) -> bytes:
    """Encode `obj` (dicts, lists, ndarrays, numpy scalars, and Python
    ints, floats, strs, bytes, bools and None) as flax's `to_bytes` would
    encode the same state dict."""
    out: list = []
    _write(obj, out)
    return b''.join(out)
