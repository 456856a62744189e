"""Matrix-free preconditioned CG on the reduced camera (Schur) system
(counterpart of dbat_tpu/solve/pcg.py).

Never forms S = U - sum W V^-1 W': each CG iteration applies

    S p = U p + lam p - sum_i W_i  (V_j^-1 (sum_k W_k' p)_j)

with per-observation block products and the SchurOps segment sums and
camera scatter, which run in a fixed order on the card (SegSum levels,
SegScatter; no atomics), so an f32 solve repeats bit for bit.  The
per-observation steps go through `ops._obs_sum`, so the same code runs
on the legacy mesh path (parallel/obs_mesh.py) shard by shard.  The
preconditioner is block-Jacobi: the per-image EO 6x6 diagonal blocks of
S factored with batched Cholesky, scalar Jacobi on the shared IO
columns.

`pcg_solve` is a host loop over device tensors, as `fused_gna` is.  It
reads the stopping test ||r|| <= tol ||b|| after every iteration (one
host sync each): the JAX package's while_loop tests it every iteration,
and testing every k would overshoot by up to k - 1 iterations and
return another iteration count and residual.
"""

from __future__ import annotations

import torch

from .smallblas import chol3x3


def schur_matvec(ops, U, Vinv, Wb, p, lam):
    """S @ p without materializing S.  p: (n_c,)."""
    t = ops._obs_sum(ops._obs_down, Wb, ops._pc_cols(p))  # sum W' p
    s = torch.einsum("jab,jb->ja", Vinv, t)              # V^-1 (.)
    out = ops._scatter_cam(ops._obs_sum(ops._obs_up, Wb, s))
    return U @ p + lam * p - out


def _obs_yy(ob, Wb, Lv3):
    """Per-image sums of Y_i Y_i', Y_i = W_i L_pt(i), over the
    observation set ob (schur.py)."""
    Y = torch.einsum("nab,nbc->nac", Wb, Lv3[ob.obs_pt])
    return ob._seg_img(torch.einsum("nac,nbc->nab", Y, Y))


def block_jacobi_factors(ops, U, Vinv, Wb, lam):
    """Preconditioner setup: per-image EO 6x6 S-diagonal blocks
    (disjoint: each image owns its EO columns) factored with batched
    Cholesky, plus scalar Jacobi on the shared IO columns (a scalar
    diagonal keeps the preconditioner symmetric positive definite)."""
    nc, dt, dev = ops.n_c, ops.dtype, ops.device
    Dimg = ops._obs_sum(_obs_yy, Wb, chol3x3(Vinv))
    icols = ops.icols  # (n_img, n_cb), fixed columns at the dump nc

    # Scalar diagonal of S for every column.
    ddiag = torch.diagonal(Dimg, dim1=1, dim2=2)
    sdiag = torch.diagonal(U) + lam - ops._scatter_cam(ddiag)
    sdiag = torch.where(sdiag > 0, sdiag, torch.ones_like(sdiag))

    # EO 6x6 blocks (the trailing 6 active columns of each image).
    icols_eo = icols[:, -6:]
    U_pad = torch.nn.functional.pad(U, (0, 1, 0, 1))
    Ueo = U_pad[icols_eo[:, :, None], icols_eo[:, None, :]]
    eye6 = torch.eye(6, dtype=dt, device=dev)
    M = Ueo - Dimg[:, -6:, -6:] + lam * eye6
    fixed = (icols_eo == nc).to(dt)
    M = M * (1.0 - fixed)[:, :, None] * (1.0 - fixed)[:, None, :]
    M = M + eye6 * fixed[:, :, None]
    return torch.linalg.cholesky_ex(M).L, sdiag, icols_eo


def block_jacobi_apply(ops, factors, r):
    """Apply the SPD preconditioner to r (n_c,)."""
    L, sdiag, icols_eo = factors
    nc = ops.n_c
    r_pad = torch.cat([r, r.new_zeros(1)])
    y = torch.cholesky_solve(r_pad[icols_eo][:, :, None], L)[:, :, 0]
    # EO columns are disjoint across images, so every kept target is
    # written once; only fixed columns share the dump entry nc, which
    # is sliced away.
    z_eo = r.new_zeros(nc + 1)
    z_eo[icols_eo.reshape(-1)] = y.reshape(-1)
    io_col = torch.arange(nc, device=r.device) < ops.spec.n_io
    return torch.where(io_col, r / sdiag, z_eo[:nc])


def pcg_solve(ops, U, Vinv, Wb, rhs, lam, tol=1e-8, maxiter=200):
    """PCG on S pc = rhs.  Returns (pc, iterations, rel_residual)."""
    factors = block_jacobi_factors(ops, U, Vinv, Wb, lam)
    b_norm = torch.sqrt(rhs @ rhs)
    x = torch.zeros_like(rhs)
    r = rhs
    z = block_jacobi_apply(ops, factors, r)
    p = z
    rz = r @ z
    k = 0
    while k < maxiter and bool(torch.sqrt(r @ r) > tol * b_norm):
        Ap = schur_matvec(ops, U, Vinv, Wb, p, lam)
        alpha = rz / (p @ Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = block_jacobi_apply(ops, factors, r)
        rz_new = r @ z
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    rel = torch.sqrt(r @ r) / torch.clamp(b_norm, min=1e-300)
    return x, k, float(rel)
