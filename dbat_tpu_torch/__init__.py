"""dbat_tpu_torch — the PyTorch/CUDA port of dbat_tpu.

Damped bundle adjustment with self-calibration on an NVIDIA Hopper
card: the same data model, camera models, Schur reduced-camera system
and damped loops as the JAX package `dbat_tpu`, written in PyTorch,
with the package's two Pallas TPU kernels rewritten by hand in CUDA C++
(`csrc/`, built by `build.py`, bound with ctypes in `solve/kernels.py`).

Module names mirror `dbat_tpu/` (core/, models/, solve/, pipeline/) so
each module's counterpart is easy to find.  The package never imports
JAX or `dbat_tpu`.

Entry points take an explicit `device=`; the default is the CUDA card,
and asking for it on a machine without one raises (see device.py).
dtypes are explicit: there is no global 64-bit switch.
"""

__version__ = "0.1.0"
