"""Read a flax msgpack file (``flax.serialization.to_bytes``) with the
standard library.

The JAX package saves its detector and pose variables so
(``LearnedDetectorBackend.save``, ``PoseEstimator.save``). The file is one
msgpack object: a map of maps keyed by strings, whose leaves are arrays
packed as msgpack ext type 1, with the payload itself msgpack of
``(shape, dtype name, C-order bytes)``; numpy scalars are ext type 3 with
the same payload. This module decodes that subset of msgpack (maps,
arrays, str, bin, ints, floats, nil and bool, ext 1 and 3) and refuses
the rest with a ValueError: other ext codes (flax's complex numbers),
flax's chunked form for arrays over 2³⁰ bytes, and dtype names it does not
know. ``bfloat16`` leaves are widened to float32 (exactly).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np

_EXT_NDARRAY = 1
_EXT_SCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"
_DTYPES = {name: np.dtype(name) for name in (
    "bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
    "uint64", "float16", "float32", "float64")}


class _Reader:
    """A cursor over msgpack bytes."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("flax msgpack: truncated data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.read_map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.read_array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.read_str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}  # bin 8/16/32
        if b in sized:
            return bytes(self.take(self.unpack(sized[b])))
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}  # ext 8/16/32
        if b in ext:
            n = self.unpack(ext[b])
            return self.read_ext(n)
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            return self.read_ext(1 << (b - 0xD4))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return self.read_str(self.unpack(strs[b]))
        if b in (0xDC, 0xDD):
            return self.read_array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.read_map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"flax msgpack: unused type byte 0x{b:02x}")

    def read_str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def read_array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def read_map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def read_ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_SCALAR:
            return _ndarray(payload)[()]
        raise ValueError(f"flax msgpack: ext type {code} is not an array "
                         "(complex numbers and other ext types are not read)")


def _ndarray(payload: bytes) -> np.ndarray:
    """An ext-1 payload, msgpack of (shape, dtype name, C-order bytes)."""
    r = _Reader(payload)
    shape, name, buf = r.read()
    if isinstance(name, bytes):
        name = name.decode("ascii")
    shape: Tuple[int, ...] = tuple(int(d) for d in shape)
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    if name not in _DTYPES:
        raise ValueError(f"flax msgpack: unknown dtype name {name!r}")
    return np.frombuffer(buf, _DTYPES[name]).reshape(shape).copy()


def _check_unchunked(tree: Any, path: str = "") -> None:
    if isinstance(tree, dict):
        if tree.get(_CHUNKED):
            raise ValueError(f"flax msgpack: {path or '/'} is a chunked array "
                             "(over 2**30 bytes), which this reader refuses")
        for k, v in tree.items():
            _check_unchunked(v, f"{path}/{k}")


def unpack_flax_msgpack(data: bytes) -> Dict[str, Any]:
    """The bytes ``flax.serialization.to_bytes`` wrote → nested dict of
    numpy arrays (and Python scalars)."""
    r = _Reader(data)
    tree = r.read()
    if r.pos != len(r.data):
        raise ValueError(f"flax msgpack: {len(r.data) - r.pos} bytes after "
                         "the object")
    if not isinstance(tree, dict):
        raise ValueError("flax msgpack: the file does not hold a map")
    _check_unchunked(tree)
    return tree


def read_flax_msgpack(path: str) -> Dict[str, Any]:
    """A flax msgpack file → nested dict of numpy arrays."""
    with open(path, "rb") as f:
        return unpack_flax_msgpack(f.read())
