"""Native JPEG decode for the rawframe input pipeline (``native/jpeg.cc``).

The port's own copy of ``workoutdetector_tpu/data/jpeg.py``: a ctypes
wrapper over the repo's tracked ``native/libwdjpeg.so`` (libjpeg), every
function's argtypes and restype declared.

  * ``read_image(path)``: full-resolution RGB decode (what
    ``cv2.imread`` + ``cvtColor`` gives);
  * ``read_batch_prepped(paths, scale, crop)``: a whole clip decoded on
    the library's thread pool with DCT prescaling and the in-decode
    resize(short = scale) → centre-crop(crop) geometry.

Each returns ``None`` where the native path cannot take a file (no
library, a non-JPEG name, a failed or EXIF-rotated decode); the caller
then decodes that file with cv2. ``WD_TPU_JPEG_LIB=`` (empty) disables
the native path.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import numpy as np

from workoutdetector_tpu_torch.settings import NATIVE_JPEG_LIB

_LIB: Optional[ctypes.CDLL] = None
_LIB_FAILED = False


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    if not NATIVE_JPEG_LIB or not os.path.exists(NATIVE_JPEG_LIB):
        _LIB_FAILED = True
        return None
    try:
        lib = ctypes.CDLL(NATIVE_JPEG_LIB)
    except OSError:
        _LIB_FAILED = True
        return None
    ip = ctypes.POINTER(ctypes.c_int)
    lib.wdj_dims.argtypes = [ctypes.c_char_p, ip, ip]
    lib.wdj_dims.restype = ctypes.c_int
    lib.wdj_decode_mem.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long, ip, ip]
    lib.wdj_decode_mem.restype = ctypes.c_int
    lib.wdj_decode_batch_prepped.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    lib.wdj_decode_batch_prepped.restype = ctypes.c_int
    _LIB = lib
    return _LIB


def native_available() -> bool:
    return _load() is not None


def _is_jpeg(path: str) -> bool:
    return path.lower().endswith((".jpg", ".jpeg"))


def read_image(path: str) -> Optional[np.ndarray]:
    """Full-resolution RGB uint8 (H, W, 3) through libjpeg, or None when
    the native path cannot take this file (the C decoder rejects
    EXIF-rotated JPEGs, so cv2's orientation handling applies to them).
    One disk read feeds both the dimensions probe and the decode."""
    lib = _load()
    if lib is None or not _is_jpeg(path):
        return None
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    return decode_bytes(data)


def decode_bytes(data: bytes) -> Optional[np.ndarray]:
    """RGB uint8 decode of in-memory JPEG bytes, or None."""
    lib = _load()
    if lib is None or len(data) < 3 or data[:2] != b"\xff\xd8":
        return None
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.wdj_decode_mem(data, len(data), None, 0, ctypes.byref(h),
                          ctypes.byref(w)) != 0:
        return None
    out = np.empty((h.value, w.value, 3), dtype=np.uint8)
    rc = lib.wdj_decode_mem(data, len(data),
                            out.ctypes.data_as(ctypes.c_void_p), out.nbytes,
                            ctypes.byref(h), ctypes.byref(w))
    return out if rc == 0 else None


def read_batch_prepped(paths: Sequence[str], scale: int, crop: int,
                       threads: int = 0) -> Optional[np.ndarray]:
    """Decode a clip of JPEGs → (N, crop, crop, 3) RGB uint8: short side
    → max(scale, crop), centre crop, across the library's thread pool
    (``threads`` ≤ 0: one per core). None when any file is not a JPEG or
    fails to decode: the caller then takes the per-file path."""
    lib = _load()
    if lib is None or not paths or not all(_is_jpeg(p) for p in paths):
        return None
    n = len(paths)
    out = np.empty((n, crop, crop, 3), dtype=np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.wdj_decode_batch_prepped(arr, n, scale, crop,
                                      out.ctypes.data_as(ctypes.c_void_p),
                                      threads)
    return out if rc == 0 else None
