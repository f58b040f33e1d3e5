"""The port's build cache: native libraries compiled at first use into
``seigen_tpu_torch/_build/`` (git-ignored), under names that carry a hash
of what went into them.

Several processes may build the same library at once (test workers, the
ranks of a sharded run): each compiles into a file of its own and moves it
into place with ``os.replace``, so a reader sees either no library or a
whole one.  The CUDA kernels (``ops/cuda_build.py``) and the host mesh
library (``mesh/native``) share it.  Nothing here imports torch.
"""

from __future__ import annotations

import os
import subprocess
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent / "_build"


def build_into(out: Path, cmd) -> tuple[float, int, str | None]:
    """Build ``out`` with ``cmd(tmp)`` (the compiler's command line writing
    ``tmp``) unless it exists.

    Returns (seconds, return code, compiler output): (0.0, 0, None) when
    ``out`` was already there.  ``out`` appears only on success.
    """
    out.parent.mkdir(parents=True, exist_ok=True)
    if out.is_file():
        return 0.0, 0, None
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    res = subprocess.run(cmd(tmp), capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode == 0:
        os.replace(tmp, out)
    return seconds, res.returncode, res.stdout + res.stderr
