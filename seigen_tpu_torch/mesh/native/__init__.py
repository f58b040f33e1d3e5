"""ctypes loader for the native mesh-setup library (host C++, no GPU).

``mesh_native.cpp`` is a byte-for-byte copy of the JAX package's source.
It is compiled at first use, not at import, with the JAX package's flags
(``g++ -O3 -march=native -shared -fPIC -std=c++17``: the same source and
flags on the same host give bitwise the same geometry) into
``seigen_tpu_torch/_build/libseigen_mesh-<hash>.so``, the hash covering the
source, the flags and the first line of ``g++ --version``
(``build_cache.build_into``: a file per process, moved into place).

Every entry point has a NumPy twin in ``mesh/discrete.py`` and
``parallel/partition.py``, which takes the native path when
``available()`` and the NumPy one otherwise; the NumPy path is the oracle.
A build or load that failed is kept, not hidden: ``build_log()`` gives the
compiler's exit code and output, or the loader's error.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import threading
from pathlib import Path

import numpy as np

from ...build_cache import BUILD_DIR, build_into

SRC = Path(__file__).resolve().parent / "mesh_native.cpp"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_I64 = ctypes.POINTER(ctypes.c_int64)
_I32 = ctypes.POINTER(ctypes.c_int32)
_U32 = ctypes.POINTER(ctypes.c_uint32)
_U64 = ctypes.POINTER(ctypes.c_uint64)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_F64 = ctypes.POINTER(ctypes.c_double)

# symbol -> (restype, argtypes), the JAX loader's signatures
_SIGNATURES = {
    "pair_face_nodes": (ctypes.c_int64,
                        [_I64, ctypes.c_int64, ctypes.c_int32, _I64]),
    "morton_codes": (None, [_U32, ctypes.c_int64, ctypes.c_int32,
                            ctypes.c_int32, _U64]),
    "decode_partners": (None, [_I64, ctypes.c_int64, ctypes.c_int32,
                               ctypes.c_int32, ctypes.c_int32, _I64, _I32,
                               _U8]),
    "argsort_u64": (None, [_U64, ctypes.c_int64, _I64]),
    "geometric_factors": (None, [_F64, _I64, ctypes.c_int64, ctypes.c_int32,
                                 _I64, _F64, _F64, _F64, _F64, _F64]),
    "halo_needs": (ctypes.c_int64, [_I64, _I32, _I32, ctypes.c_int64,
                                    ctypes.c_int32, _I64, _I64]),
}


class HostLibrary:
    """The mesh library, built and loaded once (thread-safe).

    ``load()`` returns the ctypes handle, or None where g++ or the load
    failed; ``build_seconds`` (0.0 when an existing library was loaded),
    ``path`` and ``log`` (the compiler's exit code and output, or the
    loader's error) describe the attempt.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._lib = None
        self._tried = False
        self.build_seconds = None
        self.path = None
        self.log = ""

    def _out(self) -> Path:
        version = subprocess.run([CXX, "--version"], capture_output=True,
                                 text=True, check=True).stdout
        h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
        h.update(SRC.read_bytes())
        h.update(version.splitlines()[0].encode())
        return BUILD_DIR / f"libseigen_mesh-{h.hexdigest()[:16]}.so"

    def load(self):
        with self._lock:
            if self._tried:
                return self._lib
            self._tried = True
            try:
                out = self._out()
                self.build_seconds, rc, log = build_into(
                    out, lambda tmp: [CXX, *CXX_FLAGS, str(SRC), "-o",
                                      str(tmp)])
            except (OSError, subprocess.CalledProcessError) as e:
                self.log = f"{CXX} did not run: {e!r}"
                return None
            self.log = (f"{CXX} exited {rc}\n{log}" if log is not None
                        else f"loaded the existing {out.name}")
            if rc != 0:
                return None
            try:
                lib = ctypes.CDLL(str(out))
            except OSError as e:
                self.log += f"\nload failed: {e!r}"
                return None
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            self.path, self._lib = out, lib
            return lib


LIBRARY = HostLibrary()


def _lib():
    lib = LIBRARY.load()
    assert lib is not None, LIBRARY.log
    return lib


def available() -> bool:
    return LIBRARY.load() is not None


def build_log() -> str:
    """What the last build or load attempt said ("" before the first)."""
    return LIBRARY.log


def pair_face_nodes(keys: np.ndarray) -> tuple[np.ndarray, int]:
    """(N, keylen) int64 keys -> (partner (N,) int64, max multiplicity)."""
    lib = _lib()
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    n, keylen = keys.shape
    partner = np.empty(n, dtype=np.int64)
    mult = lib.pair_face_nodes(keys.ctypes.data_as(_I64), ctypes.c_int64(n),
                               ctypes.c_int32(keylen),
                               partner.ctypes.data_as(_I64))
    return partner, int(mult)


def decode_partners(partner: np.ndarray, nf: int, nfp: int, n_p: int,
                    fnodes_flat: np.ndarray):
    """partner (N,) -> (nbr int32 (N,), selfpair bool (N,)) in one C pass."""
    lib = _lib()
    partner = np.ascontiguousarray(partner, dtype=np.int64)
    fn = np.ascontiguousarray(fnodes_flat, dtype=np.int64)
    N = len(partner)
    nbr = np.empty(N, dtype=np.int32)
    sp = np.empty(N, dtype=np.uint8)
    lib.decode_partners(partner.ctypes.data_as(_I64), ctypes.c_int64(N),
                        ctypes.c_int32(nf), ctypes.c_int32(nfp),
                        ctypes.c_int32(n_p), fn.ctypes.data_as(_I64),
                        nbr.ctypes.data_as(_I32), sp.ctypes.data_as(_U8))
    return nbr, sp.astype(bool)


def geometric_factors(verts: np.ndarray, cells: np.ndarray,
                      face_vertices: np.ndarray):
    """Affine-simplex geometry in one C pass (oracle:
    ``mesh/discrete.py:geometric_factors_numpy``).

    Returns (Ginv (E, dim, dim), detJ (E,), normals (E, nf, dim),
    Fscale (E, nf), h (E,)) — nf = dim + 1."""
    lib = _lib()
    verts = np.ascontiguousarray(verts, dtype=np.float64)
    cells = np.ascontiguousarray(cells, dtype=np.int64)
    fv = np.ascontiguousarray(face_vertices, dtype=np.int64)
    E, dim = cells.shape[0], verts.shape[1]
    nf = dim + 1
    assert cells.shape[1] == nf and fv.shape == (nf, dim)
    ginv = np.empty((E, dim, dim), dtype=np.float64)
    detj = np.empty(E, dtype=np.float64)
    normals = np.empty((E, nf, dim), dtype=np.float64)
    fscale = np.empty((E, nf), dtype=np.float64)
    h = np.empty(E, dtype=np.float64)
    lib.geometric_factors(
        verts.ctypes.data_as(_F64), cells.ctypes.data_as(_I64),
        ctypes.c_int64(E), ctypes.c_int32(dim), fv.ctypes.data_as(_I64),
        ginv.ctypes.data_as(_F64), detj.ctypes.data_as(_F64),
        normals.ctypes.data_as(_F64), fscale.ctypes.data_as(_F64),
        h.ctypes.data_as(_F64))
    return ginv, detj, normals, fscale, h


def halo_needs(gids: np.ndarray, src: np.ndarray, dst: np.ndarray,
               P: int) -> dict:
    """Directed cross-shard needs: {(src, dst): sorted unique gids}
    (oracle: ``parallel/partition.py:halo_needs_numpy``)."""
    lib = _lib()
    gids = np.ascontiguousarray(gids, dtype=np.int64)
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    n = len(gids)
    out = np.empty(n, dtype=np.int64)
    counts = np.empty(P * P, dtype=np.int64)
    total = lib.halo_needs(gids.ctypes.data_as(_I64),
                           src.ctypes.data_as(_I32), dst.ctypes.data_as(_I32),
                           ctypes.c_int64(n), ctypes.c_int32(P),
                           out.ctypes.data_as(_I64),
                           counts.ctypes.data_as(_I64))
    needs: dict = {}
    off = 0
    for d_ in range(P):
        for s_ in range(P):
            c = int(counts[d_ * P + s_])
            if c:
                needs[(s_, d_)] = out[off: off + c].copy()
                off += c
    assert off == total
    return needs


def morton_argsort(q: np.ndarray, bits: int = 16) -> np.ndarray:
    """(n, dim) uint32 quantized coords -> Morton-order permutation."""
    lib = _lib()
    q = np.ascontiguousarray(q, dtype=np.uint32)
    n, dim = q.shape
    codes = np.empty(n, dtype=np.uint64)
    lib.morton_codes(q.ctypes.data_as(_U32), ctypes.c_int64(n),
                     ctypes.c_int32(dim), ctypes.c_int32(bits),
                     codes.ctypes.data_as(_U64))
    perm = np.empty(n, dtype=np.int64)
    lib.argsort_u64(codes.ctypes.data_as(_U64), ctypes.c_int64(n),
                    perm.ctypes.data_as(_I64))
    return perm
