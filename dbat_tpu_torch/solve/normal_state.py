"""Normal-equation state objects (counterpart of
dbat_tpu/solve/normal_state.py).

A solver iteration needs only these operations on N = J'WJ (plus the
gradient g = J'Wr and the weighted residual):

    diag()            -- diagonal of N (column norms^2 for scaling)
    matvec(p)         -- N @ p          (termination, dogleg geometry)
    solve(rhs, lam)   -- solve (N + lam*I) x = rhs; report singularity
    trace_diag()      -- sum(diag(N))   (LM lambda auto-scale)

Two backends implement it: DenseNormalState (explicit N; the exact
oracle for small networks) and SchurNormalState in schur.py (reduced
camera system, point blocks eliminated).  Tensors stay on the ops'
device; `solve` and `trace_diag` read one host scalar each.
"""

from __future__ import annotations

import numpy as np
import torch


def _dense_solve(N, rhs, lam):
    """Jacobi-scaled Cholesky solve of (N + lam I) x = rhs.

    Column scaling mirrors gauss_newton_armijo.m:146-174; it changes
    conditioning only, not the solution.  One step of iterative
    refinement keeps the step accurate near convergence: at the
    residual floor the raw factored solve carries O(kappa * eps) noise
    that stalls ||Jp|| just above the termination threshold.  Returns
    (x, L); L is all NaN when the factorization failed."""
    eye = torch.eye(N.shape[0], dtype=N.dtype, device=N.device)
    Nd = N + lam * eye
    d = torch.sqrt(torch.diagonal(Nd))
    d = torch.where(d > 0, d, torch.ones_like(d))
    Dinv = 1.0 / d
    Ns = Nd * Dinv[:, None] * Dinv[None, :]
    L, info = torch.linalg.cholesky_ex(Ns)
    L = torch.where(info == 0, L, torch.full_like(L, float("nan")))
    b = Dinv * rhs

    def tri_solve(v):
        y = torch.linalg.solve_triangular(L, v.unsqueeze(-1), upper=False)
        return torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]

    q = tri_solve(b)
    q = q + tri_solve(b - Ns @ q)
    return Dinv * q, L


class DenseNormalState:
    def __init__(self, N, g, rw):
        self.N = N
        self.g = g
        self.rw = rw
        self.n_x = N.shape[0]

    def diag(self):
        return torch.diagonal(self.N)

    def matvec(self, p):
        return self.N @ p

    def trace_diag(self):
        return float(torch.diagonal(self.N).sum())

    def solve(self, rhs, lam: float = 0.0):
        sol, L = _dense_solve(self.N, rhs, lam)
        # Singularity test mirroring MATLAB's (nearly-)singular warning
        # (gauss_newton_armijo.m:176-184): NaN factor = exactly
        # singular; a tiny pivot of the unit-diagonal scaled factor =
        # numerically rank deficient (e.g. datum-free networks).
        tol = np.sqrt(self.n_x * torch.finfo(L.dtype).eps)
        d = torch.diagonal(L)
        nan, dmin = torch.stack([torch.isnan(d).any().to(d.dtype),
                                 d.min()]).tolist()
        return sol, bool(nan) or dmin < tol
