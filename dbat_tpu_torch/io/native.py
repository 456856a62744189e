"""ctypes bindings for the host's native helpers
(`csrc/dbat_native.cpp`; counterpart of dbat_tpu/io/native.py).

These are host-side C++ routines (a fast table parser, dense block
products, 3x3 inverses, point covariance blocks, the PNG row unfilter
of io/png.py), not device kernels.
The library is built at first use with the host C++ compiler
(`$CXX`, default g++; `-O2 -shared -fPIC`) into `_build/`, apart from
the CUDA build of `build.py`, so it builds where there is no CUDA
toolkit.  Where it cannot be built every entry point returns the same
numpy result the JAX package's fallback gives (the PNG unfilter, which
the JAX package lacks: the C++ loop in plain Python).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

from ..build import BUILD_DIR, CSRC_DIR

SOURCE = CSRC_DIR / "dbat_native.cpp"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_LIB = None
_TRIED = False


def _library_path():
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libdbat_native_{h.hexdigest()[:16]}.so"


def _build():
    """Path of the built library, compiling it if needed; None when the
    compiler is missing or fails."""
    out = _library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    # Compile to a private name, then rename: a concurrent build never
    # loads a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp,
                        str(SOURCE)], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, out)
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return None
    return out


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    so = _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.parse_numeric_table.restype = ctypes.c_long
    lib.parse_numeric_table.argtypes = [
        ctypes.c_char_p, ctypes.c_char,
        ctypes.POINTER(ctypes.c_double), ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_long),
    ]
    lib.diag_block_outer.restype = None
    lib.diag_block_outer.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.batch_inv3.restype = ctypes.c_long
    lib.batch_inv3.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_long,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.icpc_blocks.restype = None
    lib.icpc_blocks.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_long, ctypes.c_long, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.png_unfilter.restype = ctypes.c_long
    lib.png_unfilter.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.c_char_p,
    ]
    _LIB = lib
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def have_native() -> bool:
    return _load() is not None


def parse_numeric_table(path: str, ncols: int, comment: str = "#",
                        max_rows: int = None) -> np.ndarray:
    """Fast text table parse -> (n, ncols) float64; numpy fallback."""
    lib = _load()
    if lib is None:
        return np.atleast_2d(
            np.genfromtxt(path, delimiter=",", comments=comment)
        )
    if max_rows is None:
        with open(path, "rb") as fh:
            max_rows = sum(1 for _ in fh) + 1
    out = np.empty((max_rows, ncols), dtype=np.float64)
    nc = ctypes.c_long(0)
    n = lib.parse_numeric_table(
        path.encode(), comment.encode(), _ptr(out), max_rows, ncols,
        ctypes.byref(nc),
    )
    if n < 0:
        raise ValueError(f"parse_numeric_table failed on {path}: code {n}")
    if nc.value != ncols:
        raise ValueError(
            f"{path}: expected {ncols} columns, found {nc.value}"
        )
    return out[:n]


def diag_block_outer(A: np.ndarray, B: np.ndarray, n: int) -> np.ndarray:
    """Diagonal (n,n) blocks of B' A B; (m,n,n) for m = B.shape[1]//n."""
    A = np.ascontiguousarray(A, dtype=np.float64)
    B = np.ascontiguousarray(B, dtype=np.float64)
    k = A.shape[0]
    m = B.shape[1] // n
    lib = _load()
    if lib is None:
        AB = A @ B
        out = np.empty((m, n, n))
        for j in range(m):
            s = slice(j * n, (j + 1) * n)
            out[j] = B[:, s].T @ AB[:, s]
        return out
    out = np.empty((m, n, n), dtype=np.float64)
    lib.diag_block_outer(_ptr(A), _ptr(B), k, m, n, _ptr(out))
    return out


def batch_inv3(A: np.ndarray) -> np.ndarray:
    A = np.ascontiguousarray(A, dtype=np.float64)
    lib = _load()
    if lib is None:
        return np.linalg.inv(A)
    out = np.empty_like(A)
    rc = lib.batch_inv3(_ptr(A), A.shape[0], _ptr(out))
    if rc != 0:
        raise np.linalg.LinAlgError(f"singular 3x3 block {rc - 1}")
    return out


def icpc_blocks(Vinv: np.ndarray, Y: np.ndarray, s2: float) -> np.ndarray:
    """COP blocks from Vinv (m,3,3) and backsolved columns Y (k,3m)."""
    Vinv = np.ascontiguousarray(Vinv, dtype=np.float64)
    Y = np.ascontiguousarray(Y, dtype=np.float64)
    m = Vinv.shape[0]
    k = Y.shape[0]
    lib = _load()
    if lib is None:
        Yr = Y.reshape(k, m, 3)
        G = np.einsum("kja,kjb->jab", Yr, Yr)
        return s2 * (Vinv + np.einsum("jab,jbc,jcd->jad", Vinv, G, Vinv))
    out = np.empty((m, 3, 3), dtype=np.float64)
    lib.icpc_blocks(_ptr(Vinv), _ptr(Y), k, m, float(s2), _ptr(out))
    return out


def png_unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo PNG's per-row filters: rows (h, 1 + stride) uint8, each row
    its filter type then its filtered bytes; bpp bytes per pixel.
    Returns the (h, stride) uint8 image bytes; plain Python fallback."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    h, stride = rows.shape[0], rows.shape[1] - 1
    bad = np.flatnonzero(rows[:, 0] > 4)
    if len(bad):
        raise ValueError(f"PNG row {bad[0]}: unknown filter type "
                         f"{rows[bad[0], 0]}")
    lib = _load()
    if lib is None:
        return _png_unfilter_py(rows, bpp)
    out = np.empty((h, stride), dtype=np.uint8)
    rc = lib.png_unfilter(rows.ctypes.data_as(ctypes.c_char_p), h, stride,
                          bpp, out.ctypes.data_as(ctypes.c_char_p))
    if rc != 0:
        raise ValueError(f"PNG row {rc - 1}: unknown filter type")
    return out


def _png_unfilter_py(rows, bpp):
    """The C++ loop of png_unfilter in plain Python, for hosts where the
    library cannot be built: slow, and the same bytes."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.empty((h, stride), dtype=np.uint8)
    up = [0] * stride
    for r in range(h):
        f, kind, o = rows[r, 1:].tolist(), int(rows[r, 0]), [0] * stride
        for i in range(stride):
            a = o[i - bpp] if i >= bpp else 0
            b = up[i]
            c = up[i - bpp] if i >= bpp else 0
            if kind == 4:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
            else:
                pred = (0, a, b, (a + b) >> 1)[kind]
            o[i] = (f[i] + pred) & 0xFF
        out[r] = o
        up = o
    return out
