"""Network quality metrics: ray intersection angles and image coverage
(a numpy copy of dbat_tpu/geometry/quality.py).

References: code/photogrammetry/angles.m (maximum pairwise ray angle
per object point), code/photogrammetry/camangles.m, and
code/photogrammetry/coverage.m (rectangular / convex-hull / radial
fraction of the image covered by measurements).
"""

from __future__ import annotations

import numpy as np


def point_angles(project) -> np.ndarray:
    """Maximum pairwise ray-intersection angle per OP, in radians.

    Mirrors angles.m: for each object point, the angle closest to
    orthogonal between pairs of rays — each pairwise angle folds to
    <= 90 deg via acos(abs(inner product)) (angles.m:44-46), then the
    maximum over pairs.  Single-ray points get 0 (angles.m:35-36);
    points without rays get NaN.
    """
    p = project
    out = np.full(p.n_op, np.nan)
    order = np.argsort(p.obs_pt, kind="stable")
    pt_sorted = p.obs_pt[order]
    starts = np.flatnonzero(np.diff(pt_sorted, prepend=-1))
    counts = np.diff(np.append(starts, len(pt_sorted)))
    C = p.eo[:, 0:3]
    for s, c in zip(starts, counts):
        j = pt_sorted[s]
        if c < 2:
            out[j] = 0.0
            continue
        cams = p.obs_img[order[s:s + c]]
        d = C[cams] - p.op[j]
        n = np.linalg.norm(d, axis=1)
        ok = n > 0
        d = d[ok] / n[ok][:, None]
        if len(d) < 2:
            out[j] = 0.0
            continue
        G = np.clip(d @ d.T, -1.0, 1.0)
        iu = np.triu_indices(len(d), 1)
        out[j] = np.max(np.arccos(np.abs(G[iu])))
    return out


def coverage(project, cams=None, convex_hull=False,
             union=False) -> np.ndarray:
    """Fraction of each image covered by measurements (coverage.m).

    Rectangular measure by default (bounding box of the measured points
    over the image area); convex-hull measure with convex_hull=True.
    union=True pools the measurements of all `cams` into one sensor
    frame and returns a single-element array (coverage.m third output,
    the 'union' percentage of the report's camera quality block).
    """
    p = project
    if cams is None:
        cams = np.arange(p.n_img)
    if union:
        sel = np.isin(p.obs_img, cams)
        if not sel.any():
            return np.zeros(1)
        w, h = p.sensor_im_size[cams[0]]
        pts = p.ip_px[sel]
        if convex_hull:
            try:
                from scipy.spatial import ConvexHull

                if len(pts) >= 3:
                    return np.array(
                        [min(ConvexHull(pts).volume / (w * h), 1.0)])
            except Exception:
                pass
            return np.zeros(1)
        ext = pts.max(axis=0) - pts.min(axis=0)
        return np.array([min(ext[0] * ext[1] / (w * h), 1.0)])
    out = np.zeros(len(cams))
    for k, i in enumerate(cams):
        sel = p.obs_img == i
        if not sel.any():
            continue
        pts = p.ip_px[sel]
        w, h = p.sensor_im_size[i]
        if convex_hull:
            try:
                from scipy.spatial import ConvexHull

                if len(pts) >= 3:
                    out[k] = ConvexHull(pts).volume / (w * h)
            except Exception:
                out[k] = 0.0
        else:
            ext = pts.max(axis=0) - pts.min(axis=0)
            out[k] = (ext[0] * ext[1]) / (w * h)
    return np.clip(out, 0.0, 1.0)


def _pp_px(p, i):
    """Principal point in pixel coordinates (coverage.m:55-61): the
    solver-frame (px, py) in mm mapped by the same px->mm factor the
    measurements use; the internal py sign flips to image-down."""
    s = p.sensor_px_size[i, 0]
    return np.array([p.io[i, 1] / s, -p.io[i, 2] / s])


def _max_rad(p, i):
    """Max distance from the principal point to an image corner
    (coverage.m:63-68)."""
    w, h = p.sensor_im_size[i]
    cx = np.array([0.5, 0.5, w + 0.5, w + 0.5])
    cy = np.array([0.5, h + 0.5, h + 0.5, 0.5])
    pp = _pp_px(p, i)
    return np.hypot(cx - pp[0], cy - pp[1]).max()


def radial_coverage(project, cams=None, union=False) -> np.ndarray:
    """Radial coverage: max measured radius about the PRINCIPAL POINT
    over the max corner radius (coverage.m:53-86 — not the image
    center / half-diagonal).  union=True pools all `cams` (see
    coverage)."""
    p = project
    if cams is None:
        cams = np.arange(p.n_img)
    if union:
        sel = np.isin(p.obs_img, cams)
        if not sel.any():
            return np.zeros(1)
        i = cams[0]
        r = np.linalg.norm(p.ip_px[sel] - _pp_px(p, i), axis=1).max()
        return np.clip(np.array([r / _max_rad(p, i)]), 0.0, 1.0)
    out = np.zeros(len(cams))
    for k, i in enumerate(cams):
        sel = p.obs_img == i
        if not sel.any():
            continue
        r = np.linalg.norm(p.ip_px[sel] - _pp_px(p, i), axis=1).max()
        out[k] = r / _max_rad(p, i)
    return np.clip(out, 0.0, 1.0)


def ray_counts(project) -> np.ndarray:
    """Number of observing rays per OP."""
    return np.bincount(project.obs_pt, minlength=project.n_op)


def reprojection_residuals_px(project) -> np.ndarray:
    """Per-observation reprojection residual norm in pixels at the
    current EO/OP values (host numpy; pre-bundle outlier screening).

    Compares the ideal pinhole projection -cc*(Xc_xy/Xc_z) against the
    measured-side chain evaluated at the measurement
    (initvals.ideal_proj_obs) — the same quantity the bundle residual
    minimizes, without weights."""
    from ..models.rotation import w2c_from_angles_np
    from .initvals import ideal_proj_obs

    p = project
    R = w2c_from_angles_np(p.eo[:, 3:6])
    Xc = np.einsum("nab,nb->na", R[p.obs_img],
                   p.op[p.obs_pt] - p.eo[p.obs_img, 0:3])
    cc = p.io[p.obs_img, 0:1]
    lhs = -cc * Xc[:, :2] / Xc[:, 2:3]
    res_mm = lhs - ideal_proj_obs(p)
    px = p.sensor_px_size[p.obs_img][:, 0]
    return np.linalg.norm(res_mm, axis=1) / px
