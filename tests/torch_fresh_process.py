"""Fresh processes for the port's isolation tests, forked from a server
that imported torch once.

``run_code(code)`` runs a Python snippet in a new process forked from
``parallel.distributed.spawn``'s forkserver, whose only imports are
torch, ``torch.distributed``, ``torch._dynamo`` and the port's
``parallel.distributed`` (no jax, flax, optax, yaml, PIL, pandas,
matplotlib, gradio, websockets or cv2): the snippet's checks of
``sys.modules`` see what the port imports, as in a process started from
scratch, without each one paying torch's seconds of start-up. This module
imports no jax.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import traceback
from typing import Dict, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _child(code: str, env: Dict[str, str], out_path: str,
           err_path: str) -> None:
    """The snippet, in the forked process: its stdout and stderr (fd level
    too) to files, ``env`` over the environment, one torch thread, the
    repo as the working directory and on the path; exit 1 on an
    exception."""
    import torch

    out = open(out_path, "w")
    err = open(err_path, "w")
    sys.stdout.flush()
    sys.stderr.flush()
    os.dup2(out.fileno(), 1)
    os.dup2(err.fileno(), 2)
    sys.stdout, sys.stderr = out, err
    os.environ.update(env)
    os.chdir(REPO)
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    try:
        exec(compile(code, "<snippet>", "exec"), {"__name__": "__main__"})
    except BaseException:  # reported through the stderr file
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    sys.stdout.flush()
    os._exit(0)


# about three times the slowest snippet under a loaded test run: a hung
# snippet costs its test, not the run's clock
TIMEOUT_S = 90.0


def run_code(code: str, env: Optional[Dict[str, str]] = None,
             timeout: float = TIMEOUT_S) -> subprocess.CompletedProcess:
    """``code`` in a freshly forked process (module docstring); returns its
    exit code, stdout and stderr as ``subprocess.run`` would. A snippet
    still running after ``timeout`` seconds is killed (SIGTERM, then
    SIGKILL after 10 s) and returns a nonzero code with a line saying so
    after its stderr."""
    from workoutdetector_tpu_torch.parallel.distributed import _rank_context

    ctx = _rank_context()
    with tempfile.TemporaryDirectory() as d:
        out_path, err_path = os.path.join(d, "out"), os.path.join(d, "err")
        proc = ctx.Process(target=_child,
                           args=(code, dict(env or {}), out_path, err_path))
        proc.start()
        proc.join(timeout)
        late = proc.is_alive()
        if late:
            proc.terminate()
            proc.join(10)
            if proc.is_alive():
                proc.kill()
                proc.join(10)
        code_ = proc.exitcode if proc.exitcode is not None else -9

        def read(p):
            return open(p).read() if os.path.exists(p) else ""

        err = read(err_path)
        if late:
            err += f"\nrun_code: killed after {timeout:.0f} s\n"
        return subprocess.CompletedProcess([sys.executable, "-c", code],
                                           code_, read(out_path), err)
