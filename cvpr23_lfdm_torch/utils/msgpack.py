"""Reader and writer of the flax msgpack checkpoint format, in plain Python.

The bench checkpoint (`assets/bench_ckpt/*.msgpack`) was written by
`flax.serialization.msgpack_serialize`. The machine that runs the port has
neither `flax` nor `msgpack`, so this module decodes the subset of msgpack
those files use: maps, arrays, strings, bins, nil, booleans, ints, floats,
and ext types 1 and 3, the flax ndarray and numpy scalar. Their ext payload
is itself msgpack: the tuple `(shape, dtype name, C-order bytes)`
(`flax.serialization._ndarray_to_bytes`). :func:`msgpack_serialize` writes
the same bytes as flax's for a tree of string-keyed dicts of numpy arrays,
numpy scalars and Python bools, ints, floats and strings.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3  # flax: ndarray 1, native complex 2, npscalar 3
MAX_CHUNK_SIZE = 2 ** 30  # flax splits a larger array into chunks; not written here


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: (">B", self._bin), 0xC5: (">H", self._bin), 0xC6: (">I", self._bin),
            0xD9: (">B", self._str), 0xDA: (">H", self._str), 0xDB: (">I", self._str),
            0xDC: (">H", self._array), 0xDD: (">I", self._array),
            0xDE: (">H", self._map), 0xDF: (">I", self._map),
        }
        if b in sized:
            fmt, fn = sized[b]
            return fn(self.unpack(fmt))
        scalars = {
            0xCA: ">f", 0xCB: ">d",
            0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if b in scalars:
            return self.unpack(scalars[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(fixext[b])
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext:
            return self._ext(self.unpack(ext[b]))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def _bin(self, n: int) -> bytes:
        return bytes(self.take(n))

    def _ext(self, n: int):
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, buf = _Reader(payload).read()
        arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()
        return arr[()] if code == _EXT_NPSCALAR else arr


def msgpack_restore(data: bytes):
    """Decode one flax-serialized msgpack object (nested dicts of numpy
    arrays and Python scalars), as `flax.serialization.msgpack_restore`."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after msgpack object")
    return out


def _int(n: int) -> bytes:
    if 0 <= n <= 0x7F:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    for lo, hi, head, fmt in ((0, 0xFF, 0xCC, ">B"), (0, 0xFFFF, 0xCD, ">H"), (0, 0xFFFFFFFF, 0xCE, ">I"),
                              (0, 2 ** 64 - 1, 0xCF, ">Q"), (-0x80, 0x7F, 0xD0, ">b"),
                              (-0x8000, 0x7FFF, 0xD1, ">h"), (-2 ** 31, 2 ** 31 - 1, 0xD2, ">i"),
                              (-2 ** 63, 2 ** 63 - 1, 0xD3, ">q")):
        if lo <= n <= hi:
            return bytes([head]) + struct.pack(fmt, n)
    raise OverflowError(f"int {n} does not fit msgpack")


def _sized(n: int, fix: int | None, fix_max: int, heads: tuple) -> bytes:
    """The header of a map, array, str or bin of `n` entries or bytes."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for head, fmt, hi in zip(heads, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if head is not None and n <= hi:
            return bytes([head]) + struct.pack(fmt, n)
    raise OverflowError(f"{n} entries do not fit msgpack")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _sized(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + b


def _bin(b: bytes) -> bytes:
    return _sized(len(b), None, 0, (0xC4, 0xC5, 0xC6)) + b


def _ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = bytes([fixed[n]]) if n in fixed else _sized(n, None, 0, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code) + payload


def _ndarray(arr: np.ndarray) -> bytes:
    """`(shape, dtype name, C-order bytes)` as flax packs it."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise TypeError(f"dtype {arr.dtype} is not written")
    if arr.nbytes > MAX_CHUNK_SIZE:
        raise ValueError(f"array of {arr.nbytes} bytes: flax would chunk it; not written here")
    shape = b"".join(_int(int(d)) for d in arr.shape)
    return (_sized(3, 0x90, 15, (None, 0xDC, 0xDD)) + _sized(len(arr.shape), 0x90, 15, (None, 0xDC, 0xDD))
            + shape + _str(arr.dtype.name) + _bin(arr.tobytes("C")))


def _pack(obj, out: list) -> None:
    t = type(obj)
    if t is dict:
        out.append(_sized(len(obj), 0x80, 15, (None, 0xDE, 0xDF)))
        for k in sorted(obj):  # flax copies the tree through JAX, which sorts dict keys
            if type(k) is not str:
                raise TypeError(f"map key {k!r}: only str keys are written")
            out.append(_str(k))
            _pack(obj[k], out)
    elif t is np.ndarray:
        out.append(_ext(_EXT_NDARRAY, _ndarray(obj)))
    elif isinstance(obj, np.generic):
        out.append(_ext(_EXT_NPSCALAR, _ndarray(np.asarray(obj))))
    elif t is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif t is int:
        out.append(_int(obj))
    elif t is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif t is str:
        out.append(_str(obj))
    else:
        raise TypeError(f"{t.__name__} is not written (dicts of numpy arrays and scalars only)")


def msgpack_serialize(tree) -> bytes:
    """Encode a tree of string-keyed dicts of numpy arrays, numpy scalars and
    Python bools, ints, floats and strings: the bytes of
    `flax.serialization.msgpack_serialize` for the same tree (keys sorted,
    arrays as ext type 1, numpy scalars as ext type 3). Any other type
    raises `TypeError`."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)
