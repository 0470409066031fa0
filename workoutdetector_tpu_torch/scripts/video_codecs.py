"""Video codec probe: which encoders write a clip that reads back.

The port's own copy of ``workoutdetector_tpu/scripts/video_codecs.py``:
for each fourcc and container the port's writers or the server's uploads
may meet, cv2 writes a 4-frame clip and the port's ``VideoReader`` reads
it back; also whether the native libav decoder loads.

    python -m workoutdetector_tpu_torch.scripts.video_codecs
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

# write_video uses mp4v; uploads come as vp8/webm (Chrome) or h264/mp4
# (Safari)
CANDIDATES = [
    ("mp4v", ".mp4"),
    ("avc1", ".mp4"),
    ("h264", ".mp4"),
    ("vp80", ".webm"),
    ("vp90", ".webm"),
    ("mjpg", ".avi"),
]


def probe_write(fourcc: str, suffix: str) -> bool:
    """True when cv2 encodes the clip and it reads back whole."""
    import cv2

    from workoutdetector_tpu_torch.data.video import VideoReader
    frames = np.random.default_rng(0).integers(
        0, 256, size=(4, 32, 48, 3), dtype=np.uint8)
    fd, path = tempfile.mkstemp(suffix=suffix)
    os.close(fd)
    try:
        w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), 30,
                            (48, 32))
        if not w.isOpened():
            return False
        for f in frames:
            w.write(f[..., ::-1])
        w.release()
        if os.path.getsize(path) == 0:
            return False
        with VideoReader(path) as r:
            got = r.read_raw()
        return len(got) == len(frames)
    except Exception:
        return False
    finally:
        if os.path.exists(path):
            os.remove(path)


def probe() -> dict:
    """Every candidate, and whether the native decoder loads."""
    from workoutdetector_tpu_torch.data.video import native_available
    return {
        "native_libav_decode": native_available(),
        "encoders": {f"{fourcc}{suffix}": probe_write(fourcc, suffix)
                     for fourcc, suffix in CANDIDATES},
    }


def main() -> None:
    print(json.dumps(probe(), indent=2))


if __name__ == "__main__":
    main()
