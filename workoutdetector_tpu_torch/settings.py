"""Settings of the port, env-overridable.

The port's own copy of the decoder path from ``workoutdetector_tpu/
settings.py``: the same ``WD_TPU_DECODER_LIB`` variable and the same
default, the repo's tracked ``native/libwdvideo.so``.
"""

import os

PROJ_ROOT = os.environ.get(
    "PROJ_ROOT", os.path.abspath(os.path.dirname(os.path.dirname(__file__))))

# Path of the built native video decoder (see native/).
NATIVE_DECODER_LIB = os.environ.get(
    "WD_TPU_DECODER_LIB", os.path.join(PROJ_ROOT, "native", "libwdvideo.so"))
