"""Device, dtype and precision policy for the port.

Counterpart of dbat_tpu/__init__.py (x64 switch), dbat_tpu/config.py
(platform-aware dtypes) and dbat_tpu/solve/precision.py
(`with_highest_precision`):

  * the default device is the CUDA card; when there is none and the
    caller did not ask for the CPU, `resolve_device` raises instead of
    running quietly on the host;
  * dtypes are passed explicitly (`as_dtype`); nothing flips a global
    default;
  * TF32 is off for matmuls and cuDNN.  The reduced camera system
    S = U - sum W V^-1 W' cancels decades of precision, and TF32 keeps
    about three digits — the same reason the JAX package traces every
    normal-equation matmul at HIGHEST precision on the TPU.
"""

from __future__ import annotations

import numpy as np
import torch

_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
}


def highest_precision() -> None:
    """Full-f32 matmuls: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` if given, else CUDA.

    Raises RuntimeError for a CUDA device on a machine without a card,
    so a missing card never turns into a silent CPU run.  Switches TF32
    off (see module docstring)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dbat_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run on the host")
    highest_precision()
    return dev


def as_dtype(dtype) -> torch.dtype:
    """torch dtype from a torch dtype, numpy dtype or name
    ('float32' / 'float64')."""
    if isinstance(dtype, torch.dtype):
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"unsupported dtype {dtype}")
        return dtype
    name = np.dtype(dtype).name
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return _DTYPES[name]


def np_dtype(dtype: torch.dtype) -> np.dtype:
    """numpy dtype matching a torch float dtype."""
    return np.dtype("float32" if dtype == torch.float32 else "float64")
