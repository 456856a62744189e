"""Build and load the port's CUDA kernels.

One `nvcc` call compiles every source under csrc/ for sm_90a (Hopper)
into one shared library with a plain C interface; `solve/kernels.py`
binds it with ctypes.  No PyTorch header is included anywhere, so the
build takes seconds rather than the minutes a torch extension costs.

The library lands in `_build/` next to this file (listed in
.gitignore), named by a hash of the sources and flags: a changed
source builds anew, an unchanged one is loaded as it is.  The build
runs at first use, never at import.

Run `python -m dbat_tpu_torch.build` to build and print the compiler's
register and spill report.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("fused_bilinear.cu", "pair_bucket.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int64
#: C signature of every exported function: name -> argument types
#: (restype int: a launcher's cudaError_t, or the occupancy query's warps).
SIGNATURES = {
    **{f"dbat_fused_bilinear_{t}": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
       for t in ("f32", "f64")},
    **{f"dbat_pair_bucket_acc_{t}": [_P, _I, _I, _P, _P, _P, _P, _I, _P,
                                     _I, _P]
       for t in ("f32", "f64")},
    **{f"dbat_pair_bucket_resident_warps_{t}": [_I, _I]
       for t in ("f32", "f64")},
}


@dataclass
class BuildInfo:
    path: Path
    compiled: bool  # False when an existing library was loaded
    seconds: float
    log: str  # nvcc's output (ptxas register/spill report)


_loaded: dict = {}


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME, else the toolkit's default
    install location."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile the kernels unless a library for these sources exists."""
    out = BUILD_DIR / f"libdbat_kernels_{_digest()}.so"
    if out.exists():
        return BuildInfo(out, False, 0.0, "")
    BUILD_DIR.mkdir(exist_ok=True)
    # Compile to a private name, then rename: a concurrent build never
    # loads a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[str(CSRC_DIR / s) for s in SOURCES]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return BuildInfo(out, True, seconds, log)


def load() -> ctypes.CDLL:
    """The kernel library, built if needed and loaded once per process,
    with every launcher's argument types declared."""
    lib = _loaded.get("lib")
    if lib is None:
        info = build()
        lib = ctypes.CDLL(str(info.path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded["lib"] = lib
        _loaded["info"] = info
    return lib


def build_info() -> BuildInfo:
    """How the loaded library was obtained (loads it if needed)."""
    load()
    return _loaded["info"]


def ptxas_report(log: str) -> list:
    """The register / spill lines of nvcc's ptxas -v output."""
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln
            or "Compiling entry" in ln]


if __name__ == "__main__":
    info = build_info()
    print(f"{info.path} compiled={info.compiled} {info.seconds:.2f} s")
    print("\n".join(ptxas_report(info.log)))
