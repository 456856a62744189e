"""Statistical quality analysis: correlations and significance tests
(a numpy copy of dbat_tpu/solve/quality.py).

References: code/bundle/private/high_io_correlations.m (+eo/op
variants) — parameter pairs with posterior error correlation above a
threshold; code/bundle/private/test_distortion_params.m — chi-square
significance of estimated lens/affine coefficients (individual and
cumulative).
"""

from __future__ import annotations

import numpy as np
from scipy.stats import chi2

from ..models.residuals import N_LIN


def corr_from_cov(C: np.ndarray) -> np.ndarray:
    d = np.sqrt(np.diag(C))
    with np.errstate(divide="ignore", invalid="ignore"):
        R = C / d[:, None] / d[None, :]
    R[~np.isfinite(R)] = 0.0
    return R


def high_correlations(blocks: np.ndarray, thres: float = 0.95):
    """Pairs (entity, i, j, corr) with |corr|>thres within each
    per-entity covariance block (high_io_correlations.m non-cross)."""
    out = []
    for k, C in enumerate(blocks):
        R = corr_from_cov(C)
        n = R.shape[0]
        for i in range(n):
            for j in range(i):
                if abs(R[i, j]) > thres:
                    out.append((k, i, j, R[i, j]))
    return out


def high_eo_correlations(ceo: np.ndarray, eo_block: np.ndarray,
                         thres: float = 0.95):
    """Intra-station EO correlation pairs above threshold
    (ref code/bundle/private/high_eo_correlations.m:1-30, cross=false):
    list of (photo k, i, j, corr) with i > j in 0..5, restricted to
    unique EO blocks (block-shared stations report once, like the
    reference's `unique(s.EO.struct.block','rows')` filter)."""
    _, lead = np.unique(np.asarray(eo_block), axis=0, return_index=True)
    keep = np.zeros(len(ceo), bool)
    keep[lead] = True
    out = []
    for k, C in enumerate(ceo):
        if not keep[k]:
            continue
        R = corr_from_cov(C)
        for i in range(6):
            for j in range(i):
                if abs(R[i, j]) > thres:
                    out.append((k, i, j, R[i, j]))
    return out


def high_io_correlations_cross(ciof: np.ndarray, entries: np.ndarray,
                               thres: float = 0.95):
    """Cross-camera IO correlation pairs above threshold
    (high_io_correlations.m cross=true on CIOF): list of
    ((img_i, col_i), (img_j, col_j), corr) over *leading* estimated IO
    entries (`entries` as returned by Covariance.ciof); block-shared
    duplicates are already excluded by the leading restriction."""
    R = corr_from_cov(ciof)
    n = R.shape[0]
    out = []
    for i in range(n):
        for j in range(i):
            if abs(R[i, j]) > thres:
                out.append((tuple(entries[i]), tuple(entries[j]), R[i, j]))
    return out


def point_correlations(cop: np.ndarray):
    """Signed X-Y/X-Z/Y-Z correlations per point, (n_op, 3)
    (ref high_op_correlations.m; non-finite entries zeroed)."""
    d = np.sqrt(np.einsum("jii->ji", cop))
    with np.errstate(divide="ignore", invalid="ignore"):
        c01 = cop[:, 0, 1] / (d[:, 0] * d[:, 1])
        c02 = cop[:, 0, 2] / (d[:, 0] * d[:, 2])
        c12 = cop[:, 1, 2] / (d[:, 1] * d[:, 2])
    cc = np.stack([c01, c02, c12], axis=1)
    cc[~np.isfinite(cc)] = 0.0
    return cc


def high_point_correlations(cop: np.ndarray, thres: float = 0.95):
    """Flat indices of per-point correlation VALUES with |corr|>thres
    — the reference counts correlations, not points (each point
    contributes up to three: X-Y, X-Z, Y-Z;
    bundle_result_file.m:703-706 nnz(abs(vop)>0.95))."""
    cc = point_correlations(cop)
    return np.flatnonzero(np.abs(cc).reshape(-1) > thres)


def significance(project, spec, cio: np.ndarray):
    """Chi-square significance of distortion/affine parameters
    (test_distortion_params.m).

    Returns dict with 'K' (nK per camera), 'KC' (cumulative K),
    'P' (joint P1P2), 'B' (aspect, skew) p-values per image; NaN where
    not estimated.
    """
    p = project
    nK, nP = p.nK, p.nP
    n_img = p.n_img
    K = np.full((n_img, nK), np.nan)
    KC = np.full((n_img, nK), np.nan)
    P = np.full(n_img, np.nan)
    B = np.full((n_img, 2), np.nan)

    # Unique cameras: first image of each IO block.
    lead = spec.io_leading.any(axis=1)
    for j in np.flatnonzero(lead):
        x = p.io[j]
        C = cio[j]
        for i in range(nK):
            ii = N_LIN + i
            if p.est_io[j, ii] and C[ii, ii] > 0:
                v = x[ii] ** 2 / C[ii, ii]
                K[j, i] = chi2.cdf(v, 1)
            ii = np.arange(N_LIN, N_LIN + i + 1)
            if p.est_io[j, ii].all():
                sub = C[np.ix_(ii, ii)]
                try:
                    v = x[ii] @ np.linalg.solve(sub, x[ii])
                    KC[j, i] = chi2.cdf(v, i + 1)
                except np.linalg.LinAlgError:
                    pass
        ii = np.arange(N_LIN + nK, N_LIN + nK + min(nP, 2))
        if len(ii) and p.est_io[j, ii].all():
            sub = C[np.ix_(ii, ii)]
            try:
                v = x[ii] @ np.linalg.solve(sub, x[ii])
                P[j] = chi2.cdf(v, len(ii))
            except np.linalg.LinAlgError:
                pass
        for b in range(2):
            ii = 3 + b
            if p.est_io[j, ii] and C[ii, ii] > 0:
                v = x[ii] ** 2 / C[ii, ii]
                B[j, b] = chi2.cdf(v, 1)
    return {"K": K, "KC": KC, "P": P, "B": B}


def residual_stats(project):
    """Point/photo residual statistics in pixels
    (bundle_result_file.m Point Marking Residuals)."""
    p = project
    r = p.post["ip_res_px"]  # (n_obs, 2)
    rn = np.linalg.norm(r, axis=1)
    overall_rms = np.sqrt(np.mean(r**2) * 2)  # RMS of the 2-norm

    # Per-point RMS over its images.
    n_pt = p.n_op
    cnt = np.bincount(p.obs_pt, minlength=n_pt).astype(float)
    ss = np.bincount(p.obs_pt, weights=rn**2, minlength=n_pt)
    with np.errstate(invalid="ignore", divide="ignore"):
        pt_rms = np.sqrt(ss / cnt)

    # Per-photo RMS.
    cnt_i = np.bincount(p.obs_img, minlength=p.n_img).astype(float)
    ss_i = np.bincount(p.obs_img, weights=rn**2, minlength=p.n_img)
    with np.errstate(invalid="ignore", divide="ignore"):
        ph_rms = np.sqrt(ss_i / cnt_i)

    imax = int(np.argmax(rn)) if len(rn) else 0
    return {
        "overall_rms": overall_rms,
        "mark_max": (rn[imax] if len(rn) else np.nan,
                     p.op_id[p.obs_pt[imax]] if len(rn) else -1,
                     p.obs_img[imax] + 1 if len(rn) else -1),
        "point_rms": pt_rms,
        "photo_rms": ph_rms,
        "point_count": cnt,
        "photo_count": cnt_i,
    }
