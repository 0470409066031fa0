"""Host video decode → fixed-shape uint8 frames for the device feed.

The port's own copy of ``workoutdetector_tpu/data/video.py``. Two
backends, both optional:

  * native: the repo's tracked ``native/libwdvideo.so`` (libavformat /
    libavcodec / swscale through ctypes), which emits frames already
    resized (short side = scale) and center-cropped (crop×crop) in one
    swscale pass;
  * cv2: the OpenCV fallback with the same geometry, imported only inside
    the functions that use it.

Both produce (T, crop, crop, 3) RGB uint8. Where neither loads,
``VideoReader`` raises ``RuntimeError`` naming both backends and why each
failed.
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from workoutdetector_tpu_torch.settings import NATIVE_DECODER_LIB

_LIB: Optional[ctypes.CDLL] = None
_LIB_ERROR: Optional[str] = None  # why the native library did not load

# sanity cap on whole-video decodes (~19 GB of 256x256 uint8); the chunked
# scoring path (infer.engine.score_video_chunked) shares it so whole-video
# and chunked outputs stay identical past the cap
DEFAULT_MAX_FRAMES = 100_000


def _load_native() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_ERROR
    if _LIB is not None or _LIB_ERROR is not None:
        return _LIB
    if not os.path.exists(NATIVE_DECODER_LIB):
        _LIB_ERROR = f"{NATIVE_DECODER_LIB}: no such file"
        return None
    try:
        lib = ctypes.CDLL(NATIVE_DECODER_LIB)
    except OSError as exc:
        _LIB_ERROR = str(exc)
        return None
    lib.wd_open.argtypes = [ctypes.c_char_p]
    lib.wd_open.restype = ctypes.c_void_p
    lib.wd_close.argtypes = [ctypes.c_void_p]
    lib.wd_close.restype = None
    lib.wd_frame_count.argtypes = [ctypes.c_void_p]
    lib.wd_frame_count.restype = ctypes.c_longlong
    lib.wd_fps.argtypes = [ctypes.c_void_p]
    lib.wd_fps.restype = ctypes.c_double
    lib.wd_dims.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                            ctypes.POINTER(ctypes.c_int)]
    lib.wd_dims.restype = None
    lib.wd_read_cropped.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int
    ]
    lib.wd_read_cropped.restype = ctypes.c_longlong
    lib.wd_read_raw.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong
    ]
    lib.wd_read_raw.restype = ctypes.c_longlong
    _LIB = lib
    return _LIB


def native_available() -> bool:
    return _load_native() is not None


class VideoReader:
    """Unified reader over the native decoder / cv2.

    read_prepped(scale, crop): all frames resized short-side→scale and
    center-cropped crop×crop (the reference's test transform geometry,
    done during decode).
    read_raw(): all frames at native resolution (for visualization).
    """

    def __init__(self, path: str, prefer_native: bool = True):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self.path = path
        self._lib = _load_native() if prefer_native else None
        self._handle = None
        self._cap = None
        native_why = _LIB_ERROR if prefer_native else \
            "not tried (prefer_native=False)"
        if self._lib is not None:
            self._handle = self._lib.wd_open(path.encode())
            if not self._handle:
                self._lib = None  # fall back to cv2 for this file
                native_why = f"could not open {path}"
        if self._lib is None:
            try:
                import cv2
            except ImportError:
                raise RuntimeError(
                    f"no video decoder for {path}: native/libwdvideo.so: "
                    f"{native_why}; cv2: not installed") from None
            self._cap = cv2.VideoCapture(path)
            if not self._cap.isOpened():
                raise IOError(f"Failed to open {path}")

    # ---------------- metadata ---------------- #
    @property
    def fps(self) -> float:
        if self._lib is not None:
            return float(self._lib.wd_fps(self._handle))
        import cv2
        return float(self._cap.get(cv2.CAP_PROP_FPS))

    @property
    def frame_count(self) -> int:
        if self._lib is not None:
            return int(self._lib.wd_frame_count(self._handle))
        import cv2
        return int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))

    @property
    def dims(self) -> Tuple[int, int]:
        """(height, width) of the source stream."""
        if self._lib is not None:
            w = ctypes.c_int()
            h = ctypes.c_int()
            self._lib.wd_dims(self._handle, ctypes.byref(w), ctypes.byref(h))
            return h.value, w.value
        import cv2
        return (int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
                int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH)))

    # ---------------- decode ---------------- #
    # per-chunk allocation cap for the native paths: buffers are sized
    # from the container's frame count (bounded by this), not max_frames
    _CHUNK_BYTES = 512 * 1024 * 1024

    def _native_read(self, fill, frame_shape, max_frames: int) -> np.ndarray:
        """Chunked native decode: ``fill(ptr, n) -> frames_written``.
        Chunks continue from the stream position, so a container that
        understates frame_count still decodes fully (up to max_frames)."""
        frame_bytes = int(np.prod(frame_shape))
        cap = max(1, self._CHUNK_BYTES // max(frame_bytes, 1))
        est = self.frame_count
        chunk_n = min(max_frames, est if est > 0 else 1024, cap)
        chunks = []
        total = 0
        while total < max_frames:
            chunk_n = max(1, min(chunk_n, max_frames - total))
            buf = np.empty((chunk_n,) + tuple(frame_shape), dtype=np.uint8)
            n = fill(buf.ctypes.data_as(ctypes.c_void_p), chunk_n)
            if n < 0:
                raise IOError(f"native decode failed for {self.path}")
            chunks.append(buf[:n])
            total += n
            if n < chunk_n:
                break
            chunk_n = min(1024, cap)
        if not chunks:
            return np.empty((0,) + tuple(frame_shape), np.uint8)
        if len(chunks) == 1:
            return np.ascontiguousarray(chunks[0])
        return np.concatenate(chunks)

    def read_prepped(self, scale: int = 256, crop: int = 224,
                     max_frames: int = DEFAULT_MAX_FRAMES) -> np.ndarray:
        """Decode all frames → (T, crop, crop, 3) RGB uint8.

        ``crop`` must fit inside the scaled frame; a crop larger than
        ``scale`` resizes the short side to ``crop`` instead."""
        scale = max(scale, crop)
        if self._lib is not None:
            return self._native_read(
                lambda ptr, n: self._lib.wd_read_cropped(
                    self._handle, ptr, n, scale, crop),
                (crop, crop, 3), max_frames)
        return self._cv2_read(scale, crop, max_frames)

    def iter_prepped(self, scale: int = 256, crop: int = 224,
                     chunk: int = 1024) -> Iterator[np.ndarray]:
        """Stream prepped frames in consecutive chunks of ≤ ``chunk``
        (T, crop, crop, 3) RGB uint8 each; concatenated they equal
        read_prepped()."""
        scale = max(scale, crop)
        if self._lib is not None:
            shape = (crop, crop, 3)
            while True:
                buf = np.empty((chunk,) + shape, dtype=np.uint8)
                n = self._lib.wd_read_cropped(
                    self._handle, buf.ctypes.data_as(ctypes.c_void_p),
                    chunk, scale, crop)
                if n < 0:
                    raise IOError(f"native decode failed for {self.path}")
                if n == 0:
                    return
                yield np.ascontiguousarray(buf[:n])
                if n < chunk:
                    return
        else:
            while True:
                frames = self._cv2_read(scale, crop, chunk)
                if len(frames) == 0:
                    return
                yield frames
                if len(frames) < chunk:
                    return

    def read_raw(self, max_frames: int = DEFAULT_MAX_FRAMES) -> np.ndarray:
        """Decode all frames at source resolution → (T, H, W, 3) RGB uint8."""
        if self._lib is not None:
            h, w = self.dims
            return self._native_read(
                lambda ptr, n: self._lib.wd_read_raw(self._handle, ptr, n),
                (h, w, 3), max_frames)
        import cv2
        frames = []
        while len(frames) < max_frames:
            ret, frame = self._cap.read()
            if not ret:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        return np.stack(frames) if frames else np.empty((0, 0, 0, 3), np.uint8)

    def iter_raw(self) -> Iterator[np.ndarray]:
        """Stream frames one by one (RGB uint8)."""
        if self._lib is not None:
            h, w = self.dims
            buf = np.empty((1, h, w, 3), dtype=np.uint8)
            while True:
                n = self._lib.wd_read_raw(self._handle,
                                          buf.ctypes.data_as(ctypes.c_void_p), 1)
                if n <= 0:
                    return
                yield buf[0].copy()
        else:
            import cv2
            while True:
                ret, frame = self._cap.read()
                if not ret:
                    return
                yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)

    def _cv2_read(self, scale: int, crop: int, max_frames: int) -> np.ndarray:
        import cv2
        frames = []
        while len(frames) < max_frames:
            ret, frame = self._cap.read()
            if not ret:
                break
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            h, w = frame.shape[:2]
            if h <= w:
                th, tw = scale, max(1, round(w * scale / h))
            else:
                th, tw = max(1, round(h * scale / w)), scale
            interp = cv2.INTER_AREA if th < h else cv2.INTER_LINEAR
            frame = cv2.resize(frame, (tw, th), interpolation=interp)
            y = max(0, (th - crop) // 2)
            x = max(0, (tw - crop) // 2)
            frames.append(frame[y:y + crop, x:x + crop])
        if not frames:
            return np.empty((0, crop, crop, 3), np.uint8)
        return np.stack(frames)

    def close(self) -> None:
        if self._lib is not None and self._handle:
            self._lib.wd_close(self._handle)
            self._handle = None
        elif self._cap is not None:
            self._cap.release()
            self._cap = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_video(path: str, frames: np.ndarray, fps: float = 30.0) -> None:
    """Write (T, H, W, 3) RGB uint8 frames to mp4/webm (cv2 VideoWriter)."""
    import cv2
    h, w = frames.shape[1:3]
    fourcc = cv2.VideoWriter_fourcc(*("vp80" if path.endswith(".webm") else "mp4v"))
    if not (path.endswith(".webm") or path.endswith(".mp4")):
        path += ".mp4"
    out = cv2.VideoWriter(path, fourcc, fps, (w, h))
    for f in frames:
        out.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    out.release()
