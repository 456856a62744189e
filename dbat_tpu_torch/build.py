"""Build and load the port's CUDA kernels.

Each source under csrc/ is compiled for sm_90a (Hopper) into a shared
library of its own with a plain C interface, which `solve/kernels.py`
binds with ctypes.  The `nvcc` processes, one per source, are started
together, so the build takes as long as its slowest source.  No
PyTorch header is included anywhere, so the build takes seconds rather
than the minutes a torch extension costs.

The libraries land in `_build/` next to this file (listed in
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
from types import SimpleNamespace

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
    paths: list  # one library per source
    compiled: bool  # False when existing libraries were loaded
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
    """Compile the kernels unless libraries for these sources exist."""
    digest = _digest()
    outs = [BUILD_DIR / f"libdbat_{Path(name).stem}_{digest}.so"
            for name in SOURCES]
    if all(out.exists() for out in outs):
        return BuildInfo(outs, False, 0.0, "")
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = find_nvcc()
    # Compile to private names, then rename: a concurrent build never
    # loads a half-written library.
    tmps = []
    for _ in SOURCES:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        tmps.append(tmp)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / name)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, tmp in zip(SOURCES, tmps)]
    log = "".join(proc.communicate()[0] for proc in procs)
    seconds = time.perf_counter() - t0
    if any(proc.returncode for proc in procs):
        for tmp in tmps:
            os.unlink(tmp)
        raise RuntimeError(f"nvcc failed:\n{log}")
    for tmp, out in zip(tmps, outs):
        os.replace(tmp, out)
    return BuildInfo(outs, True, seconds, log)


def load() -> SimpleNamespace:
    """The kernels' exported functions as attributes, built if needed
    and loaded once per process, with every argument type declared."""
    fns = _loaded.get("fns")
    if fns is None:
        info = build()
        libs = [ctypes.CDLL(str(path)) for path in info.paths]
        fns = SimpleNamespace()
        for name, argtypes in SIGNATURES.items():
            fn = next(getattr(lib, name) for lib in libs
                      if hasattr(lib, name))
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            setattr(fns, name, fn)
        _loaded.update(fns=fns, libs=libs, info=info)
    return fns


def build_info() -> BuildInfo:
    """How the loaded libraries were obtained (loads them if needed)."""
    load()
    return _loaded["info"]


def ptxas_report(log: str) -> list:
    """The register / spill lines of nvcc's ptxas -v output."""
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln
            or "Compiling entry" in ln]


if __name__ == "__main__":
    info = build_info()
    print(" ".join(map(str, info.paths)),
          f"compiled={info.compiled} {info.seconds:.2f} s")
    print("\n".join(ptxas_report(info.log)))
