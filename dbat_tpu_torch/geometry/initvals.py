"""Initial values: spatial resection + forward intersection (a numpy
copy of dbat_tpu/geometry/initvals.py).

Host-side numpy implementations of the reference's initial-value
toolkit (code/photogrammetry/resect.m, pm_resect_3pt.m,
forwintersect.m, pm_multiforwintersect.m, pm_forwintersect3.m).
These run once per project at trivial cost; the heavy iteration is the
bundle itself.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# Undistortion of measured points (ref code/bundle/cammodel/pm_multilenscorr1.m)
# ---------------------------------------------------------------------------

def undistort_obs(project):
    """Undistorted mm coordinates for every observation, (n_obs, 2).

    q = px_size * diag(1,-1) * u_px;  xy = q - lens(q - pp)
    (pm_multilenscorr1.m + pm_lens1.m).  The result is y-flipped,
    uncentered (principal point still in).
    """
    p = project
    q = p.ip_px * np.array([1.0, -1.0]) * p.sensor_px_size[p.obs_img][:, 0:1]
    io = p.io[p.obs_img]
    pp = io[:, 1:3]
    K = io[:, 5:5 + p.nK]
    P = io[:, 5 + p.nK:5 + p.nK + p.nP]
    xb = q - pp
    r2 = np.sum(xb**2, axis=1, keepdims=True)
    kr = np.zeros_like(r2)
    for i in reversed(range(p.nK)):
        kr = K[:, i:i + 1] + r2 * kr
    kr = r2 * kr
    delta_r = xb * kr
    p1 = P[:, 0:1] if p.nP >= 1 else 0.0
    p2 = P[:, 1:2] if p.nP >= 2 else 0.0
    x, y = xb[:, 0:1], xb[:, 1:2]
    delta_t = np.concatenate(
        [p1 * (r2 + 2 * x**2) + 2 * p2 * x * y,
         p2 * (r2 + 2 * y**2) + 2 * p1 * x * y], axis=1,
    )
    return q - (delta_r + delta_t)


def _brown_delta(xb, K, P):
    """Brown radial+tangential distortion delta at centered mm coords
    xb (n,2) with per-obs K (n,nK), P (n,nP) (ref brown_rad.m/brown_tang.m)."""
    r2 = np.sum(xb**2, axis=1, keepdims=True)
    kr = np.zeros_like(r2)
    for i in reversed(range(K.shape[1])):
        kr = K[:, i:i + 1] + r2 * kr
    delta_r = xb * (r2 * kr)
    p1 = P[:, 0:1] if P.shape[1] >= 1 else 0.0
    p2 = P[:, 1:2] if P.shape[1] >= 2 else 0.0
    x, y = xb[:, 0:1], xb[:, 1:2]
    delta_t = np.concatenate(
        [p1 * (r2 + 2 * x**2) + 2 * p2 * x * y,
         p2 * (r2 + 2 * y**2) + 2 * p1 * x * y], axis=1)
    return delta_r + delta_t


def ideal_proj_obs(project):
    """Exact centered ideal projection -cc*(Xc_xy/Xc_z) per observation.

    Evaluates the measured-side chain of the project's distortion model
    (models/residuals.py residual_obs; ref res_euler_brown_*.m) at the
    measurements: in DBAT's backward convention the chain output *is*
    the ideal pinhole projection, so no iterative inversion is needed
    for models 1-5 (model -1, the forward/CV model, uses a fixed-point
    inversion). Unlike undistort_obs (pm_multilenscorr1.m semantics,
    which neglects affine), this removes aspect/skew too — required for
    exact relative orientation on networks with aspect != 1."""
    p = project
    q = p.ip_px * np.array([1.0, -1.0]) * p.sensor_px_size[p.obs_img][:, 0:1]
    io = p.io[p.obs_img]
    pp = io[:, 1:3]
    b = io[:, 3:5]
    K = io[:, 5:5 + p.nK]
    P = io[:, 5 + p.nK:5 + p.nK + p.nP]
    x = q - pp

    def affine(u):
        return np.concatenate(
            [(1.0 + b[:, 0:1]) * u[:, 0:1] + b[:, 1:2] * u[:, 1:2],
             u[:, 1:2]], axis=1)

    m = p.dist_model
    if m in (1, 2):
        return x - _brown_delta(x, K, P)
    if m == 3:
        xa = affine(x)
        return xa - _brown_delta(xa, K, P)
    if m == 4:
        return affine(x - _brown_delta(x, K, P))
    if m == 5:
        xs = np.concatenate(
            [(1.0 + b[:, 0:1]) * q[:, 0:1], q[:, 1:2]], axis=1) - pp
        xu = xs - _brown_delta(xs, K, P)
        return np.concatenate(
            [xu[:, 0:1] + b[:, 1:2] * xu[:, 1:2], xu[:, 1:2]], axis=1)
    if m == -1:
        # Forward model: w + delta(w) = x; fixed-point inversion.
        w = x.copy()
        for _ in range(12):
            w = x - _brown_delta(w, K, P)
        return w
    raise ValueError(f"Bad distortion model {m}")


# ---------------------------------------------------------------------------
# 3-point spatial resection (ref code/photogrammetry/pm_resect_3pt.m,
# Haralick et al. 1994 / Grunert)
# ---------------------------------------------------------------------------

def _vec_angle(a, b):
    """Angle between 1-d subspaces (MATLAB subspace for vectors)."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    # Numerically robust angle
    return np.arctan2(np.linalg.norm(np.cross(a, b)), abs(np.dot(a, b)))


def resect_3pt(X, xn, use, behind=True):
    """Camera matrix from 3 world/image correspondences.

    X: (3,n) world points; xn: (3,n) normalized homogeneous image
    points; use: boolean mask with exactly 3 True. Remaining points
    vote for the best of the up-to-4 solutions. Returns (P (3,4), rms)
    or (None, inf).
    """
    assert use.sum() == 3
    Xa = X[:, use]
    xa = xn[:2, use] / xn[2:3, use]
    x3 = np.vstack([xa, np.ones(3)])
    x3 = x3 / np.linalg.norm(x3, axis=0)

    a = np.linalg.norm(Xa[:, 1] - Xa[:, 2])
    b = np.linalg.norm(Xa[:, 0] - Xa[:, 2])
    c = np.linalg.norm(Xa[:, 0] - Xa[:, 1])
    alpha = _vec_angle(x3[:, 1], x3[:, 2])
    beta = _vec_angle(x3[:, 0], x3[:, 2])
    gamma = _vec_angle(x3[:, 0], x3[:, 1])
    ca, cb, cg = np.cos(alpha), np.cos(beta), np.cos(gamma)

    a2mc2 = (a**2 - c**2) / b**2
    a2pc2 = (a**2 + c**2) / b**2
    b2mc2 = (b**2 - c**2) / b**2
    b2ma2 = (b**2 - a**2) / b**2

    A4 = (a2mc2 - 1) ** 2 - 4 * c**2 / b**2 * ca**2
    A3 = 4 * (a2mc2 * (1 - a2mc2) * cb + 2 * c**2 / b**2 * ca**2 * cb
              - (1 - a2pc2) * ca * cg)
    A2 = 2 * (a2mc2**2 + 2 * a2mc2**2 * cb**2 + 2 * b2mc2 * ca**2
              + 2 * b2ma2 * cg**2 - 4 * a2pc2 * ca * cb * cg - 1)
    A1 = 4 * (-a2mc2 * (1 + a2mc2) * cb + 2 * a**2 / b**2 * cg**2 * cb
              - (1 - a2pc2) * ca * cg)
    A0 = (1 + a2mc2) ** 2 - 4 * a**2 / b**2 * cg**2

    v = np.roots([A4, A3, A2, A1, A0])
    v = v[np.abs(np.imag(v)) / np.maximum(np.abs(v), 1e-300) < 1e-3]
    v = np.real(v)
    if v.size == 0:
        return None, np.inf

    u = ((-1 + a2mc2) * v**2 - 2 * a2mc2 * cb * v + 1 + a2mc2) / (
        2 * (cg - v * ca)
    )
    s12 = b**2 / (1 + v**2 - 2 * v * cb)
    s1 = np.sqrt(np.maximum(s12, 0))
    s3 = v * s1
    s2 = u * s1
    valid = (s1 >= 0) & (s2 >= 0) & (s3 >= 0)
    sols = np.unique(np.stack([s1[valid], s2[valid], s3[valid]], axis=1), axis=0)

    best = (None, np.inf)
    xall = xn[:2] / xn[2:3]
    for s in sols:
        cx = s * x3  # camera-frame points, scaled directions
        if behind:
            cx = -cx
        # Absolute orientation camera<-world from the 3 points
        # (pm_resect_3pt.m:70-97).
        ob = Xa[:, 2] - Xa[:, 0]
        oc = Xa[:, 1] - Xa[:, 0]
        cbv = cx[:, 2] - cx[:, 0]
        ccv = cx[:, 1] - cx[:, 0]

        def triad(u1, u2):
            r1 = u1 / np.linalg.norm(u1)
            r2 = np.cross(u1, u2)
            n2 = np.linalg.norm(r2)
            if n2 == 0:
                return None
            r2 = r2 / n2
            r3 = np.cross(u1, np.cross(u1, u2))
            r3 = r3 / np.linalg.norm(r3)
            return np.stack([r1, r2, r3], axis=1)

        oR = triad(ob, oc)
        cR = triad(cbv, ccv)
        if oR is None or cR is None:
            continue
        cRo = cR @ oR.T
        oxO = Xa[:, 0] - cRo.T @ cx[:, 0]
        P = cRo @ np.hstack([np.eye(3), -oxO[:, None]])

        proj = P @ np.vstack([X, np.ones(X.shape[1])])
        with np.errstate(divide="ignore", invalid="ignore"):
            pe = proj[:2] / proj[2]
        res = np.sqrt(np.nanmean(np.sum((pe - xall) ** 2, axis=0)))
        if res < best[1]:
            best = (P, res)
    return best


def _largest_triangles(pts, n_tri=1):
    """Triangles with largest area from convex hull points
    (code/misc/largesttriangle.m). Returns list of index triples,
    sorted by decreasing area."""
    from itertools import combinations

    try:
        from scipy.spatial import ConvexHull

        hull = np.unique(ConvexHull(pts.T).vertices)
    except Exception:
        hull = np.arange(pts.shape[1])
    tris = []
    for (i, j, k) in combinations(hull, 3):
        a = pts[:, j] - pts[:, i]
        b = pts[:, k] - pts[:, i]
        area = 0.5 * abs(a[0] * b[1] - a[1] * b[0])
        tris.append(((i, j, k), area))
    tris.sort(key=lambda t: -t[1])
    return tris


def resect(project, cams="all", cp_id=None, n_tri=1, min_area_frac=0.0,
           chk_id=None):
    """Spatial resection for selected cameras (ref resect.m).

    Uses control points `cp_id` for the 3-point pose (largest-triangle
    selection) and `chk_id` for solution disambiguation. Updates
    project.eo in place. Returns (rms_per_cam, failed)."""
    p = project
    if cams == "all":
        cams = np.arange(p.n_img)
    if cp_id is None:
        cp_id = p.op_id[p.is_ctrl]
    if chk_id is None:
        chk_id = p.op_id
    xy = undistort_obs(p)
    fail = False
    rms = np.full(len(cams), np.nan)

    for ci, cam in enumerate(cams):
        sel = p.obs_img == cam
        ids = p.op_id[p.obs_pt[sel]]
        keep = np.isin(ids, np.union1d(cp_id, chk_id))
        pts2 = xy[sel][keep]
        ids = ids[keep]
        pts3 = p.prior_op_val[p.obs_pt[sel]][keep]
        # For non-ctrl points fall back to current OP values.
        nanrows = np.isnan(pts3).any(axis=1)
        pts3[nanrows] = p.op[p.obs_pt[sel]][keep][nanrows]

        io = p.io[cam]
        f, ppt = io[0], io[1:3]
        Km = np.array([[-f, 0, ppt[0]], [0, -f, ppt[1]], [0, 0, 1.0]])
        xn = np.linalg.solve(Km, np.vstack([pts2.T, np.ones(len(ids))]))

        valid3 = ~np.isnan(pts3).any(axis=1)
        is_cp = np.isin(ids, cp_id) & valid3
        cp_pos = pts2[is_cp].T
        if is_cp.sum() < 3:
            fail = True
            p.eo[cam, :] = np.nan
            continue
        if is_cp.sum() == 3:
            tries = [np.flatnonzero(is_cp)]
        else:
            tris = _largest_triangles(cp_pos)
            area0 = tris[0][1]
            cp_idx = np.flatnonzero(is_cp)
            tries = [
                cp_idx[list(t)] for t, a in tris[:n_tri]
                if a >= min_area_frac * area0
            ]

        bestP, bestRes = None, np.inf
        for t in tries:
            use = np.zeros(len(ids), dtype=bool)
            use[t] = True
            Pm, res = resect_3pt(pts3[valid3].T, xn[:, valid3],
                                 use[valid3], behind=True)
            if Pm is not None and res < bestRes:
                bestP, bestRes = Pm, res
        rms[ci] = bestRes
        if bestP is None:
            fail = True
            p.eo[cam, :] = np.nan
            continue
        # Camera center: null space of P; angles from rotation part
        # (resect.m:69-71, derotmat3d.m).
        _, _, Vt = np.linalg.svd(bestP)
        Cc = Vt[-1]
        Cc = Cc[:3] / Cc[3]
        M = bestP[:, :3]
        phi = np.arcsin(np.clip(M[2, 0], -1, 1))
        omega = np.arctan2(-M[2, 1], M[2, 2])
        kappa = np.arctan2(-M[1, 0], M[0, 0])
        p.eo[cam, 0:3] = Cc
        p.eo[cam, 3:6] = [omega, phi, kappa]
    return rms, fail


# ---------------------------------------------------------------------------
# Forward intersection (ref forwintersect.m / pm_forwintersect3.m)
# ---------------------------------------------------------------------------

def forward_intersect(project, ids="all", skip_prior=False):
    """Linear multi-ray triangulation of object points; updates
    project.op in place. Returns (ids_done, residuals)."""
    p = project
    if np.any(~np.isfinite(p.eo)):
        raise ValueError("Bad or uninitialized EO data")
    if np.any(~np.isfinite(p.io)):
        raise ValueError("Bad or uninitialized IO data")
    if isinstance(ids, str) and ids == "all":
        ids = p.op_id
    xy = undistort_obs(p)

    if skip_prior:
        do_est = p.est_op.all(axis=1) & ~p.prior_op_use.any(axis=1)
    else:
        do_est = np.ones(p.n_op, dtype=bool)
    target = np.isin(p.op_id, ids) & do_est

    # Rays: camera center C, direction d = R^T Kinv [xy;1] per obs.
    from ..models.rotation import w2c_from_angles_np

    R = w2c_from_angles_np(p.eo[:, 3:6])
    f = p.io[:, 0]
    ppx, ppy = p.io[:, 1], p.io[:, 2]

    res = np.full(p.n_op, np.nan)
    done = []
    for j in np.flatnonzero(target):
        sel = np.flatnonzero(p.obs_pt == j)
        if len(sel) < 2:
            continue
        cams = p.obs_img[sel]
        n = len(sel)
        dirs = np.zeros((n, 3))
        Cs = p.eo[cams, 0:3]
        for k, (o, cam) in enumerate(zip(sel, cams)):
            v = np.array([
                (xy[o, 0] - ppx[cam]) / -f[cam],
                (xy[o, 1] - ppy[cam]) / -f[cam],
                1.0,
            ])
            d = R[cam].T @ v
            dirs[k] = d / np.linalg.norm(d)
        # Solve [I, -t_k] [X; s] = C_k stacked (pm_forwintersect3.m:30-40)
        A = np.zeros((3 * n, 3 + n))
        bvec = Cs.reshape(-1)
        for k in range(n):
            A[3 * k:3 * k + 3, 0:3] = np.eye(3)
            A[3 * k:3 * k + 3, 3 + k] = -dirs[k]
        sol, rss, *_ = np.linalg.lstsq(A, bvec, rcond=None)
        p.op[j] = sol[:3]
        r = bvec - A @ sol
        res[j] = np.linalg.norm(r) / n
        done.append(j)
    return np.array(done), res
