"""Euler rotations for the DBAT camera convention (counterpart of
dbat_tpu/models/rotation.py).

Convention (reference: code/bundle/cameramodel/eulerrotmat.m,
code/bundle/cameramodel/eulerpinhole2.m:52): the stored EO angles are
omega-phi-kappa; the object-to-camera rotation used by the projection is

    M_w2c = (R1(omega) @ R2(phi) @ R3(kappa)).T

with the standard right-handed elementary rotations.

The torch functions take angles of any batch shape (...) and return
(..., 3, 3) matrices, so they serve one observation (under
torch.func.vmap / jacfwd) and a whole batch alike.  The numpy twins
serve host-side one-time geometry (the synthetic generator).
"""

from __future__ import annotations

import numpy as np
import torch


def _mat(*rows):
    """(..., 3, 3) matrix from nine (...) entries in row-major order."""
    return torch.stack(rows, -1).reshape(rows[0].shape + (3, 3))


def r1(a):
    """Rotation about x by angle a (CCW). Ref eulerrotmat.m:110-113."""
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return _mat(o, z, z, z, c, -s, z, s, c)


def r2(a):
    """Rotation about y by angle a (CCW). Ref eulerrotmat.m:116-119."""
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return _mat(c, z, s, z, o, z, -s, z, c)


def r3(a):
    """Rotation about z by angle a (CCW). Ref eulerrotmat.m:122-124."""
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return _mat(c, -s, z, s, c, z, z, z, o)


def dr1(a):
    """d r1 / d a."""
    c, s = torch.cos(a), torch.sin(a)
    z = torch.zeros_like(a)
    return _mat(z, z, z, z, -s, -c, z, c, -s)


def dr2(a):
    """d r2 / d a."""
    c, s = torch.cos(a), torch.sin(a)
    z = torch.zeros_like(a)
    return _mat(-s, z, c, z, z, z, -c, z, -s)


def dr3(a):
    """d r3 / d a."""
    c, s = torch.cos(a), torch.sin(a)
    z = torch.zeros_like(a)
    return _mat(-s, -c, z, c, -s, z, z, z, z)


def world_to_cam_matrix(ang):
    """M_w2c = (R1(om) @ R2(ph) @ R3(ka)).T for (..., 3) angles
    (eulerpinhole2.m:52)."""
    m = r1(ang[..., 0]) @ r2(ang[..., 1]) @ r3(ang[..., 2])
    return m.transpose(-1, -2)


# ---------------------------------------------------------------------------
# Numpy twins for host-side one-time geometry.
# ---------------------------------------------------------------------------

def w2c_from_angles_np(ang):
    """Stacked w2c matrices from (n,3) omega-phi-kappa angles:
    (R1(w) @ R2(p) @ R3(k)).T — numpy twin of world_to_cam_matrix."""
    ang = np.atleast_2d(np.asarray(ang, float))
    w, p, k = ang[:, 0], ang[:, 1], ang[:, 2]
    cw, sw = np.cos(w), np.sin(w)
    cp, sp = np.cos(p), np.sin(p)
    ck, sk = np.cos(k), np.sin(k)
    o, z = np.ones_like(w), np.zeros_like(w)
    R1 = np.stack([o, z, z, z, cw, -sw, z, sw, cw], -1).reshape(-1, 3, 3)
    R2 = np.stack([cp, z, sp, z, o, z, -sp, z, cp], -1).reshape(-1, 3, 3)
    R3 = np.stack([ck, -sk, z, sk, ck, z, z, z, o], -1).reshape(-1, 3, 3)
    return np.transpose(R1 @ R2 @ R3, (0, 2, 1))


def decompose_w2c_np(M):
    """(omega, phi, kappa) rows from stacked (n,3,3) w2c matrices
    (ref derotmat3d.m)."""
    M = np.asarray(M, float)
    one = M.ndim == 2
    if one:
        M = M[None]
    phi = np.arcsin(np.clip(M[:, 2, 0], -1.0, 1.0))
    omega = np.arctan2(-M[:, 2, 1], M[:, 2, 2])
    kappa = np.arctan2(-M[:, 1, 0], M[:, 0, 0])
    out = np.stack([omega, phi, kappa], axis=1)
    return out[0] if one else out
