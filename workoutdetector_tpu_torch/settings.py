"""Settings of the port, env-overridable.

The port's own copy of the native library paths from
``workoutdetector_tpu/settings.py``: the same ``WD_TPU_DECODER_LIB`` and
``WD_TPU_JPEG_LIB`` variables and the same defaults, the repo's tracked
``native/libwdvideo.so`` and ``native/libwdjpeg.so``.
"""

import os

PROJ_ROOT = os.environ.get(
    "PROJ_ROOT", os.path.abspath(os.path.dirname(os.path.dirname(__file__))))

# Path of the built native video decoder (see native/).
NATIVE_DECODER_LIB = os.environ.get(
    "WD_TPU_DECODER_LIB", os.path.join(PROJ_ROOT, "native", "libwdvideo.so"))

# Path of the built native rawframe JPEG decoder (see native/jpeg.cc);
# set WD_TPU_JPEG_LIB= (empty) to force the cv2 path.
NATIVE_JPEG_LIB = os.environ.get(
    "WD_TPU_JPEG_LIB", os.path.join(PROJ_ROOT, "native", "libwdjpeg.so"))
