"""Rank-deficiency forensics (counterpart of dbat_tpu/solve/forensics.py;
ref code/bundle/bundle.m:370-446).

When the normal matrix is numerically singular the reference estimates
the numerical rank (spnrank) and inspects the near-null-space
eigenvectors to name suspected parameters.  The same is done here on
the Jacobi-scaled normal matrix (dense backend) or on the reduced
camera system S plus the 3x3 point blocks (Schur backend): the matrix
is moved to the host and decomposed with numpy/scipy.  Diagnostics of a
failed solve, not the hot path.
"""

from __future__ import annotations

import numpy as np
import torch


def _suspects(w, V, n, deficient):
    suspects = []
    for j in deficient:
        v = V[:, j]
        order = np.argsort(-np.abs(v))
        keep_thr = 0.5 * (np.sqrt(1.0 / n) + np.abs(v[order[0]]))
        keep = order[np.abs(v[order]) > keep_thr]
        suspects.append({"indices": keep, "values": v[keep], "eig": w[j]})
    return suspects


def numerical_rank_analysis(ops, x, tol_factor: float = 1e4):
    """Estimate the numerical rank of the scaled normal matrix and
    suspect parameters from small-eigenvalue eigenvectors.  Sharded ops
    (parallel/sharded.py) are analysed through their unsharded
    covariance_ops(): the same normal equations, with global point
    indices."""
    if hasattr(ops, "covariance_ops"):
        ops = ops.covariance_ops()
    st = ops.normal(x)
    if not hasattr(st, "N"):
        return _schur_rank_analysis(ops, st, tol_factor)
    N = st.N.cpu().numpy()
    d = np.sqrt(np.diag(N))
    d[d == 0] = 1.0
    Ns = N / d[:, None] / d[None, :]
    n = Ns.shape[0]
    try:
        if n <= 4000:
            w, V = np.linalg.eigh(Ns)
        else:
            import scipy.sparse.linalg as spla

            w, V = spla.eigsh(Ns, k=min(10, n - 1), sigma=0, which="LM")
    except (np.linalg.LinAlgError, ValueError, RuntimeError):
        # eigh did not converge (NaN entries) or ARPACK gave up.
        return {"rank": np.nan, "deficiency": np.nan, "suspected_params": []}

    eps = np.finfo(float).eps
    thresh = max(w.max(), 1.0) * n * eps * tol_factor
    deficient = np.flatnonzero(np.abs(w) < thresh)
    rank = n - len(deficient)
    return {"rank": rank, "deficiency": n - rank,
            "suspected_params": _suspects(w, V, n, deficient)}


def _schur_rank_analysis(ops, st, tol_factor: float = 1e4):
    """Rank analysis for the Schur backend: the reduced camera system S
    plus the per-point 3x3 blocks (a singular V block means a weak
    point; a deficient S means a camera/datum problem)."""
    Vd = torch.linalg.eigvalsh(st.V).cpu().numpy()
    mask = ops.op_mask.cpu().numpy().astype(bool)
    weak_pts = np.flatnonzero(
        (Vd[:, 0] < 1e-10 * np.maximum(Vd[:, -1], 1.0)) & mask.any(axis=1)
    )

    # inv_ex: a singular block gives non-finite entries, not an error.
    Vinv = torch.linalg.inv_ex(st.V)[0]
    S = ops._schur_S(st.U, Vinv, st.Wb, 0.0).cpu().numpy()
    d = np.sqrt(np.abs(np.diag(S)))
    d[d == 0] = 1.0
    Ss = S / d[:, None] / d[None, :]
    n = Ss.shape[0]
    try:
        w, V = np.linalg.eigh(Ss)
    except (np.linalg.LinAlgError, ValueError):
        return {"rank": np.nan, "deficiency": np.nan,
                "suspected_params": [], "weak_points": weak_pts}
    eps = np.finfo(float).eps
    thresh = max(w.max(), 1.0) * n * eps * tol_factor
    deficient = np.flatnonzero(np.abs(w) < thresh)
    return {
        "rank": ops.n_x - len(deficient) - 3 * len(weak_pts),
        "deficiency": len(deficient) + 3 * len(weak_pts),
        "suspected_params": _suspects(w, V, n, deficient),
        "weak_points": weak_pts,
    }
