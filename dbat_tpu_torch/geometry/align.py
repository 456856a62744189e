"""Network alignment and rigid transforms (a numpy copy of
dbat_tpu/geometry/align.py).

References: code/misc/rigidalign.m (Procrustes, Söderkvist-Wedin),
code/photogrammetry/pm_multixform.m (apply homogeneous transform to a
camera network), pm_multialign.m (align network to a camera).
"""

from __future__ import annotations

import numpy as np

from ..models.rotation import decompose_w2c_np, w2c_from_angles_np


def rigid_align(X: np.ndarray, Y: np.ndarray, scale: bool = False):
    """Best rigid (+scale) transform T with Y ~ alpha*R*X + d.

    X, Y: (m,n) point sets. Returns (T (m+1,m+1), R, d, alpha).
    Mirrors rigidalign.m (SVD of the cross-covariance with det fix).
    """
    X = np.asarray(X, dtype=float)
    Y = np.asarray(Y, dtype=float)
    if X.shape != Y.shape:
        raise ValueError("X and Y must have the same size")
    m, n = X.shape
    xm = X.mean(axis=1, keepdims=True)
    ym = Y.mean(axis=1, keepdims=True)
    A = X - xm
    B = Y - ym
    P, _, Qt = np.linalg.svd(B @ A.T)
    D = np.ones(m)
    D[-1] = np.linalg.det(P @ Qt)
    R = P @ np.diag(D) @ Qt
    if scale:
        alpha = np.trace((R @ A).T @ B) / np.trace(A.T @ A)
    else:
        alpha = 1.0
    d = ym[:, 0] - alpha * R @ xm[:, 0]
    T = np.eye(m + 1)
    T[:m, :m] = alpha * R
    T[:m, m] = d
    return T, R, d, alpha


def transform_network(project, T: np.ndarray) -> None:
    """Apply a homogeneous 4x4 similarity to the whole network in
    place: OP/EO positions and rotations (ref pm_multixform.m)."""
    p = project
    R = T[:3, :3]
    alpha = np.linalg.det(R) ** (1.0 / 3.0)
    Rpure = R / alpha
    d = T[:3, 3]

    ok = np.isfinite(p.op).all(axis=1)
    p.op[ok] = (R @ p.op[ok].T + d[:, None]).T
    for i in range(p.n_img):
        if not np.isfinite(p.eo[i]).all():
            continue
        C = p.eo[i, 0:3]
        M = w2c_from_angles_np(p.eo[i, 3:6])[0]
        p.eo[i, 0:3] = R @ C + d
        # world->cam after transform: M' = M Rpure^T
        p.eo[i, 3:6] = decompose_w2c_np(M @ Rpure.T)


def align_to_camera(project, cam: int = 0) -> None:
    """Transform the network so camera `cam` is at the origin with
    identity orientation (ref pm_multialign.m)."""
    p = project
    C = p.eo[cam, 0:3]
    M = w2c_from_angles_np(p.eo[cam, 3:6])[0]
    T = np.eye(4)
    T[:3, :3] = M
    T[:3, 3] = -M @ C
    transform_network(p, T)
