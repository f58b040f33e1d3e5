"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each library under ``seigen_tpu_torch/csrc/`` is compiled at first use with
``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC`` into ``seigen_tpu_torch/_build/`` (git-ignored) and loaded
with ctypes.  The output name carries a hash of the sources, the shared
headers (``csrc/*.cuh``) and the flags, so a changed source rebuilds and an
unchanged one loads the existing library.  ``build_all`` runs one nvcc per
library, all at once.
ptxas's register/spill report is kept beside the library as ``*.ptxas.txt``.

Nothing is compiled at import: the CPU tests import every module, and a
build happens only where a kernel is first launched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, else PATH, else the toolkit's default prefix."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


class CudaLibrary:
    """One shared library built from ``sources`` (names under csrc/).

    ``load()`` builds on first use and returns the ctypes handle; the
    seconds the build took (0.0 when an existing library was loaded) are
    kept in ``build_seconds``.
    """

    def __init__(self, name: str, sources: tuple[str, ...]):
        self.name = name
        self.sources = tuple(CSRC_DIR / s for s in sources)
        self._lib = None
        self.build_seconds = None
        self.path = None

    def _digest(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for s in (*self.sources, *sorted(CSRC_DIR.glob("*.cuh"))):
            h.update(s.read_bytes())
        return h.hexdigest()[:16]

    def build(self) -> Path:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out = BUILD_DIR / f"lib{self.name}-{self._digest()}.so"
        if out.is_file():
            self.build_seconds = 0.0
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(s) for s in self.sources)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        self.build_seconds = time.perf_counter() - t0
        log = res.stdout + res.stderr
        out.with_suffix(".ptxas.txt").write_text(log)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}) for {self.name}:\n{log}")
        os.replace(tmp, out)
        return out

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            self.path = self.build()
            self._lib = ctypes.CDLL(str(self.path))
        return self._lib

    def ptxas_report(self) -> str:
        """ptxas's per-kernel register/spill lines from the last build."""
        if self.path is None:
            return ""
        log = self.path.with_suffix(".ptxas.txt")
        if not log.is_file():
            return ""
        return "\n".join(
            ln for ln in log.read_text().splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln)


def build_all(libraries) -> float:
    """Build/load every CudaLibrary at once (one nvcc each, in parallel
    threads); returns the wall seconds."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(libraries)) as pool:
        for f in [pool.submit(lib.load) for lib in libraries]:
            f.result()
    return time.perf_counter() - t0
