"""A small msgpack codec for checkpoints, with flax's ndarray extension.

The port reads and writes the JAX package's checkpoints without flax and
without the ``msgpack`` package. It covers what a checkpoint holds: maps,
arrays, str / bin, ints, floats, bools, nil, and ext type 1, in which flax
stores an ndarray as the msgpack tuple ``(shape, dtype name, C-order bytes)``
(``flax.serialization._ndarray_to_bytes``; ext type 3, a numpy scalar, is
read the same way). Decoded arrays are read-only numpy views; bfloat16 arrays
come back as float32 (numpy has no bfloat16).
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

__all__ = ["packb", "unpackb"]

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


# -- encoding ---------------------------------------------------------------


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif 0 <= v <= 0xFF:
        out += b"\xcc" + struct.pack(">B", v)
    elif 0 <= v <= 0xFFFF:
        out += b"\xcd" + struct.pack(">H", v)
    elif 0 <= v <= 0xFFFFFFFF:
        out += b"\xce" + struct.pack(">I", v)
    elif 0 <= v < 1 << 64:
        out += b"\xcf" + struct.pack(">Q", v)
    elif -0x80 <= v:
        out += b"\xd0" + struct.pack(">b", v)
    elif -0x8000 <= v:
        out += b"\xd1" + struct.pack(">h", v)
    elif -0x80000000 <= v:
        out += b"\xd2" + struct.pack(">i", v)
    elif -(1 << 63) <= v:
        out += b"\xd3" + struct.pack(">q", v)
    else:
        raise OverflowError(f"int {v} does not fit msgpack")


def _pack_len(n: int, fix: int, fix_max: int, codes: Tuple[int, int, int],
              out: bytearray) -> None:
    """Header for str / bin / array / map: fix form (when ``fix`` >= 0), then
    8-, 16-, 32-bit lengths (a code of -1 means that width does not exist)."""
    if fix >= 0 and n <= fix_max:
        out.append(fix | n)
    elif codes[0] >= 0 and n <= 0xFF:
        out += bytes([codes[0]]) + struct.pack(">B", n)
    elif n <= 0xFFFF:
        out += bytes([codes[1]]) + struct.pack(">H", n)
    else:
        out += bytes([codes[2]]) + struct.pack(">I", n)


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out += bytes([fixext[n]])
    elif n <= 0xFF:
        out += b"\xc7" + struct.pack(">B", n)
    elif n <= 0xFFFF:
        out += b"\xc8" + struct.pack(">H", n)
    else:
        out += b"\xc9" + struct.pack(">I", n)
    out += struct.pack(">b", code)
    out += data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.fields:
        raise ValueError("object and structured dtypes cannot be stored")
    return packb((list(arr.shape), arr.dtype.name, np.ascontiguousarray(arr).tobytes()))


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(len(data), -1, 0, (0xC4, 0xC5, 0xC6), out)
        out += data
    elif isinstance(obj, np.ndarray):
        _pack_ext(_EXT_NDARRAY, _ndarray_bytes(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)), out)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, (-1, 0xDC, 0xDD), out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, (-1, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# -- decoding ---------------------------------------------------------------


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, name, buf = unpackb(data)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":  # upper 16 bits of an f32
        raw = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return raw.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


_CONST = {0xC0: None, 0xC2: False, 0xC3: True}
_SCALAR = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
           0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_SIZED = {  # type byte -> (length field, kind)
    0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
    0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
    0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
    0xDC: (">H", "array"), 0xDD: (">I", "array"),
    0xDE: (">H", "map"), 0xDF: (">I", "map"),
}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return bytes(chunk)

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def sized(self, kind: str, n: int) -> Any:
        if kind == "bin":
            return self.take(n)
        if kind == "str":
            return self.take(n).decode("utf-8")
        if kind == "array":
            return [self.obj() for _ in range(n)]
        if kind == "map":
            out = {}
            for _ in range(n):
                k = self.obj()
                out[k] = self.obj()
            return out
        code = self.unpack(">b")  # ext
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(data)[()]
        raise ValueError(f"unsupported msgpack ext type {code}")

    def obj(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if t <= 0x8F:
            return self.sized("map", t & 0x0F)
        if t <= 0x9F:
            return self.sized("array", t & 0x0F)
        if t <= 0xBF:
            return self.sized("str", t & 0x1F)
        if t in _CONST:
            return _CONST[t]
        if t in _SCALAR:
            return self.unpack(_SCALAR[t])
        if t in _FIXEXT:
            return self.sized("ext", _FIXEXT[t])
        if t in _SIZED:
            fmt, kind = _SIZED[t]
            return self.sized(kind, self.unpack(fmt))
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")


def unpackb(data: bytes) -> Any:
    reader = _Reader(data)
    obj = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after msgpack object")
    return obj
