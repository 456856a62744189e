"""Camera-model primitives (counterpart of dbat_tpu/models/primitives.py).

The same functions as the JAX package, written on the last axis: a 2D
point is (..., 2), a 3D point (..., 3), a scalar parameter (...).  One
observation (under torch.func.vmap / jacfwd) and a batch of them run
the same code.  All functions keep their inputs' dtype.

Python-number arithmetic is done on (..., 1) slices, never on 0-d
tensors: under torch.func.jacfwd a 0-d float32 tensor combined with a
Python float yields a float64 tangent.
"""

from __future__ import annotations

import torch

from .rotation import world_to_cam_matrix


def matvec(M, v):
    """(..., m, k) @ (..., k) -> (..., m), summed in column order."""
    return (M * v.unsqueeze(-2)).sum(-1)


# ---------------------------------------------------------------------------
# Projection chain (reference: eulerpinhole2.m, world2cam.m, pinhole.m)
# ---------------------------------------------------------------------------

def pinhole(pc):
    """Perspective division: (..., 3) -> (..., 2).  Ref pinhole.m."""
    return pc[..., :2] / pc[..., 2:3]


def world_to_cam(X, C, ang):
    """Camera coordinates M_w2c @ (X - C).  Ref world2cam.m:45-48."""
    return matvec(world_to_cam_matrix(ang), X - C)


def euler_pinhole(X, C, ang, f):
    """f * pinhole(M_w2c @ (X-C)).  Ref eulerpinhole2.m:52."""
    return f.unsqueeze(-1) * pinhole(world_to_cam(X, C, ang))


# ---------------------------------------------------------------------------
# Brown (1971) lens distortion (reference: brown_*.m, rad_scale.m,
# tang_scale.m)
# ---------------------------------------------------------------------------

def rad_scale(u, K):
    """sum_i K[i] * r^(2(i+1)) with r2=|u|^2, Horner form.  Ref
    rad_scale.m.  K may have length 0 (returns 0)."""
    if K.shape[-1] == 0:
        return torch.zeros(u.shape[:-1], dtype=u.dtype, device=u.device)
    r2 = (u * u).sum(-1)
    acc = torch.zeros_like(r2)
    for k in reversed(range(K.shape[-1])):
        acc = K[..., k] + r2 * acc
    return r2 * acc


def brown_rad(u, K):
    """Radial distortion term u * rad_scale(u,K).  Ref brown_rad.m."""
    return u * rad_scale(u, K).unsqueeze(-1)


def brown_tang(u, P):
    """Tangential (decentering) distortion.  Ref brown_tang.m.

    v = p*(u.u) + 2*(p.u)*u with p=P[:2]; if len(P)>2 the result is
    scaled by (1 + rad_scale(u, P[2:]))."""
    if P.shape[-1] == 0:
        return torch.zeros_like(u)
    p = P[..., :2]
    utu = (u * u).sum(-1)
    ptu = (p * u).sum(-1)
    v = p * utu.unsqueeze(-1) + 2.0 * ptu.unsqueeze(-1) * u
    if P.shape[-1] > 2:
        v = v * (1.0 + rad_scale(u, P[..., 2:]).unsqueeze(-1))
    return v


def brown_dist(u, K, P):
    """u + brown_rad(u,K) + brown_tang(u,P).  Ref brown_dist.m:52."""
    return u + brown_rad(u, K) + brown_tang(u, P)


# ---------------------------------------------------------------------------
# Affine image-plane transforms (reference: affine2.m, skew.m,
# aniscale2b.m)
# ---------------------------------------------------------------------------

def affine2(u, b):
    """[[1+b0, b1],[0,1]] @ u.  Ref affine2mat.m / affine2.m."""
    u0, u1 = u[..., 0:1], u[..., 1:2]
    return torch.cat([(1.0 + b[..., 0:1]) * u0 + b[..., 1:2] * u1, u1], -1)


def skew2(u, k):
    """[[1,k],[0,1]] @ u.  Ref skew.m."""
    u0, u1 = u[..., 0:1], u[..., 1:2]
    return torch.cat([u0 + k.unsqueeze(-1) * u1, u1], -1)


def aniscale2b(u, k):
    """diag(1+k, 1) @ u.  Ref aniscale2b.m."""
    return torch.cat([(1.0 + k.unsqueeze(-1)) * u[..., 0:1], u[..., 1:2]],
                     -1)


def yflip(u):
    """diag(1,-1) @ u — image y-axis flip."""
    return torch.stack([u[..., 0], -u[..., 1]], -1)
