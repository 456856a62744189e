"""Per-observation bundle residuals for the DBAT distortion models
(counterpart of dbat_tpu/models/residuals.py).

Model codes (code/bundle/bundle.m:47-56, res_euler_brown_{0..3}.m):

  1  Legacy Photogrammetry, no affine        (math-identical to 2)
  2  Flexible Photogrammetry, no affine      (res_euler_brown_0)
  3  Photogrammetry, affine BEFORE lens dist (res_euler_brown_1, default)
  4  Photogrammetry, affine AFTER lens dist  (res_euler_brown_2)
  5  Aniso-scale before lens dist, skew after(res_euler_brown_3)
 -1  Computer Vision forward model, no affine

IO vector per camera: [cc, px, py, aspect, skew, K1..KnK, P1..PnP].

Backward models (1..5):  v = euler_pinhole(X, C, ang, -cc) - rhs(u)  [mm]
Forward model (-1): Brown distortion is applied to the projection.

Every function here works on the last axis, so the batched functions
below are the single-observation ones applied to (n, ...) arrays; the
Jacobians that need automatic differentiation use torch.func.jacfwd
under torch.func.vmap.
"""

from __future__ import annotations

from functools import partial

import torch
from torch.func import jacfwd, vmap

from . import primitives as pr
from .rotation import dr1, dr2, dr3, r1, r2, r3

#: number of linear IO parameters before K/P: cc, px, py, aspect, skew
N_LIN = 5

BACKWARD_MODELS = (1, 2, 3, 4, 5)


def unpack_io(io, nK: int, nP: int):
    """Split (..., NC) IO into (cc, pp, b, K, P) (ref unpackio.m)."""
    cc = io[..., 0]
    pp = io[..., 1:3]
    b = io[..., 3:5]
    K = io[..., 5:5 + nK]
    P = io[..., 5 + nK:5 + nK + nP]
    return cc, pp, b, K, P


def measured_mm(u_px, px_size):
    """Pixel measurement -> mm with y-flip: diag(1,-1) * (u * px_size)."""
    return pr.yflip(u_px * px_size.unsqueeze(-1))


def _rhs_backward(io, u, model: int, nK: int, nP: int):
    """Measured-side chain of the backward models (1..5): independent
    of EO/OP and of cc (the split the self-cal Jacobian exploits)."""
    _cc, pp, b, K, P = unpack_io(io, nK, nP)
    x = u - pp
    if model in (1, 2):
        return pr.brown_dist(x, -K, -P)
    if model == 3:
        return pr.brown_dist(pr.affine2(x, b), -K, -P)
    if model == 4:
        return pr.affine2(pr.brown_dist(x, -K, -P), b)
    xs = pr.aniscale2b(u, b[..., 0]) - pp
    return pr.skew2(pr.brown_dist(xs, -K, -P), b[..., 1])


def residual_obs(io, eo, op, u_px, px_size, *, model: int, nK: int,
                 nP: int):
    """Residual (..., 2) in mm.

    io: (..., NC); eo: (..., 6) [X,Y,Z,om,ph,ka]; op: (..., 3);
    u_px: (..., 2) measured pixels; px_size: (...) pixel size (mm/px)."""
    cc, pp, _b, K, P = unpack_io(io, nK, nP)
    C, ang = eo[..., :3], eo[..., 3:6]
    u = measured_mm(u_px, px_size)

    if model in BACKWARD_MODELS:
        lhs = pr.euler_pinhole(op, C, ang, -cc)
        return lhs - _rhs_backward(io, u, model, nK, nP)

    if model == -1:
        xy = pr.euler_pinhole(op, C, ang, -cc) + pp
        ld = pr.brown_rad(xy - pp, K) + pr.brown_tang(xy - pp, P)
        return (xy + ld) - u

    raise ValueError(f"Bad distortion model {model}")


def make_obs_residual_fn(model: int, nK: int, nP: int):
    """Batched residual: (n,NC),(n,6),(n,3),(n,2),(n,) -> (n,2)."""
    if model not in BACKWARD_MODELS + (-1,):
        raise ValueError(f"Bad distortion model {model}")
    return partial(residual_obs, model=model, nK=nK, nP=nP)


def make_obs_jacobian_fn(model: int, nK: int, nP: int, *,
                         with_io: bool = True):
    """Batched residual + per-observation Jacobian blocks.

    Returns fn(io, eo, op, u_px, px_size) ->
        (v (n,2), J_io (n,2,NC), J_eo (n,2,6), J_op (n,2,3)),
    or without J_io when with_io=False (fixed-IO networks)."""
    f = make_obs_residual_fn(model, nK, nP)

    if with_io and model in BACKWARD_MODELS:
        # v = lhs(op, eo, cc) - rhs(io without cc, u): J_eo/J_op in
        # closed form, the cc column is lhs/cc, and only the cheap
        # measured-side chain carries the remaining IO tangents.
        def rhs_one(io_, u_):
            return _rhs_backward(io_, u_, model, nK, nP)

        jac_rhs = vmap(jacfwd(rhs_one))

        def val_and_jac(io, eo, op, u_px, px_size):
            u = measured_mm(u_px, px_size)
            cc = io[:, 0]
            lhs = pr.euler_pinhole(op, eo[:, :3], eo[:, 3:6], -cc)
            v = lhs - _rhs_backward(io, u, model, nK, nP)
            jio = -jac_rhs(io, u)
            jio[:, :, 0] = lhs / cc.unsqueeze(-1)
            jeo, jop = projection_jacobian(op, eo[:, :3], eo[:, 3:6], -cc)
            return v, jio, jeo, jop
    elif with_io:
        jac_all = vmap(jacfwd(f, argnums=(0, 1, 2)))

        def val_and_jac(io, eo, op, u_px, px_size):
            v = f(io, eo, op, u_px, px_size)
            jio, jeo, jop = jac_all(io, eo, op, u_px, px_size)
            return v, jio, jeo, jop
    elif model in BACKWARD_MODELS:
        def val_and_jac(io, eo, op, u_px, px_size):
            v = f(io, eo, op, u_px, px_size)
            jeo, jop = projection_jacobian(op, eo[:, :3], eo[:, 3:6],
                                           -io[:, 0])
            return v, jeo, jop
    else:
        jac_eo_op = vmap(jacfwd(f, argnums=(1, 2)))

        def val_and_jac(io, eo, op, u_px, px_size):
            v = f(io, eo, op, u_px, px_size)
            jeo, jop = jac_eo_op(io, eo, op, u_px, px_size)
            return v, jeo, jop

    return val_and_jac


def projection_jacobian(X, C, ang, focal):
    """Closed-form Jacobian of euler_pinhole(X, C, ang, f) wrt (eo, op).

    Returns (J_eo (..., 2, 6), J_op (..., 2, 3)) for M = (R1 R2 R3)^T,
    q = M (X - C), proj = f q_xy / q_z:

        J_q   = f/q3 [[1, 0, -q1/q3], [0, 1, -q2/q3]]
        J_op  = J_q M;   J_C = -J_op
        J_ang = J_q [dM/dom t, dM/dph t, dM/dka t],  t = X - C
    """
    om, ph, ka = ang[..., 0], ang[..., 1], ang[..., 2]
    R1t = r1(om).transpose(-1, -2)
    R2t = r2(ph).transpose(-1, -2)
    R3t = r3(ka).transpose(-1, -2)
    t = X - C
    R1t_t = pr.matvec(R1t, t)
    R2R1t_t = pr.matvec(R2t, R1t_t)
    q = pr.matvec(R3t, R2R1t_t)
    M = R3t @ (R2t @ R1t)

    dq_om = pr.matvec(R3t, pr.matvec(R2t, pr.matvec(
        dr1(om).transpose(-1, -2), t)))
    dq_ph = pr.matvec(R3t, pr.matvec(dr2(ph).transpose(-1, -2), R1t_t))
    dq_ka = pr.matvec(dr3(ka).transpose(-1, -2), R2R1t_t)

    w = (focal / q[..., 2]).unsqueeze(-1)
    qxy = q[..., :2] / q[..., 2:3]

    def jq(d):
        return w * (d[..., :2] - qxy * d[..., 2:3])

    J_op = w.unsqueeze(-1) * (M[..., :2, :]
                              - qxy.unsqueeze(-1) * M[..., 2:3, :])
    J_ang = torch.stack([jq(dq_om), jq(dq_ph), jq(dq_ka)], -1)
    J_eo = torch.cat([-J_op, J_ang], -1)
    return J_eo, J_op
