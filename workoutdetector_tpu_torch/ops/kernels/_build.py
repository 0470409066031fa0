"""Build and bind the hand kernels: ``csrc/*.cu`` → one shared library.

Each ``.cu`` file is compiled by its own ``nvcc -c`` (all started
together), the objects are linked into one ``.so`` with a plain C
interface, and the library is loaded with ctypes. Nothing includes
PyTorch's headers, so a cold build takes seconds. Pointers and the stream
cross the boundary as ``ctypes.c_void_p``; every entry returns the
``cudaError_t`` of its launch, which ``check`` turns into an exception.

The library is cached by the content of ``csrc/`` under
``workoutdetector_tpu_torch/_build/`` (ignored by git): the first use in
a checkout builds it, later uses load it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo"]

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_int64
# C signatures of the entry points in csrc/*.cu
SIGNATURES: Dict[str, List] = {
    "wd_temporal_shift": [P, P, L, L, I, I, I, I, I, I, P],
    "wd_shift_matmul_bf16": [P, P, P, L, L, I, I, I, I, I, P],
    "wd_fused_bottleneck_bf16": [P] * 10 + [I] * 9 + [P],
    "wd_conv1x1_dx_bf16": [P, P, P, L, I, I, L, I, I, I, P],
    "wd_conv1x1_dw_bf16": [P, P, P, P, L, I, I, L, I, I, L, I, P],
}


class KernelLibrary:
    """The loaded kernel library plus what its build reported."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_seconds: float,
                 ptxas_log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds  # 0.0 when loaded from cache
        self.ptxas_log = ptxas_log
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = I
        self._err = lib.wd_error_string
        self._err.argtypes = [I]
        self._err.restype = ctypes.c_char_p

    def check(self, code: int, what: str) -> None:
        if code != 0:
            raise RuntimeError(
                f"{what}: CUDA error {code} "
                f"({self._err(code).decode(errors='replace')})")


_lock = threading.Lock()
_loaded: Optional[KernelLibrary] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the hand kernels build with the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for p in sorted(SRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, sources: List[Path], out: Path) -> str:
    """nvcc -c for every source at once, then one link; returns the
    ptxas report."""
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(SRC_DIR),
                   "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + "\n"
                               + "\n".join(logs))
        tmp_so = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_so),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + link.stdout)
        os.replace(tmp_so, out)
    return "\n".join(logs)


def load() -> KernelLibrary:
    """Build (once per checkout and source content) and load the library."""
    global _loaded
    with _lock:
        if _loaded is not None:
            return _loaded
        sources = sorted(SRC_DIR.glob("*.cu"))
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out = BUILD_DIR / f"libwdkernels-{_digest()}.so"
        log_path = out.with_suffix(".log")
        seconds = 0.0
        if not out.exists():
            t0 = time.perf_counter()
            log = _compile(_nvcc(), sources, out)
            seconds = time.perf_counter() - t0
            log_path.write_text(log)
        log = log_path.read_text() if log_path.exists() else ""
        _loaded = KernelLibrary(ctypes.CDLL(str(out)), out, seconds, log)
        return _loaded


def stream_handle(device) -> ctypes.c_void_p:
    """The current PyTorch stream of ``device`` for a kernel launch."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
