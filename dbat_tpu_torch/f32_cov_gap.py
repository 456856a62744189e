"""What an extraction of the posterior covariance in f32 would give at
the C5 shape, on one CUDA card: the measurement behind Covariance's
extraction in f64.

    python -m dbat_tpu_torch.f32_cov_gap

Runs the bundle of chip_smoke.py's covariance phase (C5_RING perturbed
with seed 18, bundle(gna, f32, schur) to the absolute noise floor), then
extracts the posterior std at its final_x twice: through Covariance
(the ops rebuilt in f64 on the card) and through the same extraction on
the bundle's own f32 ops (the JAX package's design; Covariance has no
such option, so here its f64 rebuild is swapped for the identity).
Prints, beside the card's name and power limit: the jitter rung of
each, the (max, median) relative std difference for IO, EO and OP, the
non-positive f32 variances, and the spectrum of the Jacobi-scaled S in
f64 against the f32 S's deviation from it.

Needs a CUDA card; exits nonzero without one.
"""

from __future__ import annotations

import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

from .core.serial import build_serial
from .pipeline.synthetic import C5_RING, make_ring_network, perturb
from .solve import covariance
from .solve.bundle import bundle
from .solve.covariance import Covariance
from .solve.schur import SchurOps


def scaled_s(cov):
    """The Jacobi-scaled S that cov.factorize() factors, in f64 on the
    host, built again in cov's ops dtype at its x."""
    U, _V, Wb, *_ = cov.ops._assemble_impl(cov._final_x())
    S = cov.ops._schur_S(U, cov._schur["Vinv"], Wb, 0.0)
    S = S.cpu().numpy().astype(np.float64)
    S = 0.5 * (S + S.T)
    dd = np.sqrt(np.diag(S))
    return S / np.outer(dd, dd)


def main():
    if not torch.cuda.is_available():
        print("f32_cov_gap: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    s = make_ring_network(**C5_RING)
    perturb(s, eo_pos=0.02, eo_ang=0.004, op_pos=0.02, seed=18)
    spec = build_serial(s)
    probe = SchurOps(s, spec, dtype=torch.float32, device="cuda")
    floor = float(np.sqrt(probe.n_res - probe.n_x))
    del probe
    t = time.perf_counter()
    _p, ok, iters, sigma0, info = bundle(
        s, damping="gna", dtype="float32", backend="schur", max_iter=20,
        conv_tol=floor, abs_term=True, device="cuda")
    print(f"{card}: C5 bundle(gna, f32, schur): ok {ok}, {iters} "
          f"iterations, sigma0 {sigma0!r}, {time.perf_counter() - t:.3f} s")
    if not ok:
        return 1

    cov64 = Covariance(s, info)
    std64 = cov64.posterior_std()
    with mock.patch.object(covariance, "ops_f64", lambda p, i: i.ops):
        cov32 = Covariance(s, info)
    assert cov32.ops.dtype == torch.float32
    try:
        std32 = cov32.posterior_std()
    except np.linalg.LinAlgError as exc:
        print(f"f32 extraction: failed to factor: {exc}")
        return 0
    print(f"jitter rung: f64 {cov64.jitter}, f32 {cov32.jitter}")
    for nm, a, b in zip(("io", "eo", "op"), std32, std64):
        est = np.isfinite(b)
        r = np.abs(a[est] / b[est] - 1)
        print(f"{nm}: {est.sum()} std, relative difference of f32 to f64 "
              f"max {float(r.max())!r}, median {float(np.median(r))!r}; "
              f"non-positive f32 std {int((a[est] <= 0).sum())}")
    ss64, ss32 = scaled_s(cov64), scaled_s(cov32)
    ev = np.linalg.eigvalsh(ss64)
    d = ss32 - ss64
    print(f"Jacobi-scaled S ({len(ev)}^2), f64: eigenvalues "
          f"{float(ev[0])!r} .. {float(ev[-1])!r}; f32 minus f64: spectral "
          f"norm {float(np.linalg.norm(d, 2))!r}, largest entry "
          f"{float(np.abs(d).max())!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
