"""Synthetic camera-network generator (counterpart of
dbat_tpu/pipeline/synthetic.py: the same numpy code, so one seed gives
the same network in both packages).

Two uses, mirroring the reference's testing strategy (SURVEY.md §4):
  * zero-residual networks for absolute-termination solver tests
    (the reference's `absterm` option exists for exactly this,
    bundle.m:26-29);
  * large networks at roma/stpierre scale for benchmarking, since the
    mirror is missing those input files (.MISSING_LARGE_BLOBS).

Geometry: a convergent ring of cameras looking at a blob of points
around the origin — every point is seen by a run of consecutive
cameras, giving the banded camera-pair structure typical of
close-range networks.

Everything here is pure NumPy: generating a Hamburg-scale network must
cost seconds of host time, not device round-trips (the round-1 version
paid one TPU sync per camera and ~150 s at stpierre scale).
"""

from __future__ import annotations

import numpy as np

from ..core.project import N_LIN, Project

#: bench.py's C5-shape network: the stpierre C5 counts (239 images,
#: 17,993 points, 196,715 measurements, irregular 3..40 rays, 8
#: self-calibrated IO parameters), perturbed with perturb(eo_pos=0.02,
#: eo_ang=0.004, op_pos=0.02, seed=18).
C5_RING = dict(n_img=239, n_pt=17993, rays_per_pt=(3, 40),
               n_obs_target=196715, n_ctrl=8, noise_px=0.1, ip_std_px=0.1,
               est_io_cols=("cc", "px", "py", "K1", "K2", "K3", "P1", "P2"),
               seed=17)

#: bench.py's roma watchdog network: romabundledemo's shape (353
#: images, 26,321 points, 90,561 measurements, sparse 2..8 rays, mean
#: 3.44; fixed IO, so a 6-wide camera block), perturbed with
#: perturb(eo_pos=0.02, eo_ang=0.004, op_pos=0.02, seed=24).
ROMA_RING = dict(n_img=353, n_pt=26321, rays_per_pt=(2, 8),
                 n_obs_target=90561, n_ctrl=8, noise_px=0.1, ip_std_px=0.1,
                 seed=23)

#: IO column names in serialization order (buildparamtypes.m:11-20).
IO_COLS = {"cc": 0, "px": 1, "py": 2, "as": 3, "sk": 4,
           "K1": 5, "K2": 6, "K3": 7, "P1": 8, "P2": 9}


def _look_at_w2c_np(C, target=None):
    """World-to-camera rotations for cameras at rows of C looking at
    `target` (default origin); vectorized over cameras.

    Rows of each matrix are the camera axes; camera z points from
    target to C (DBAT projection divides by depth with -f, depth
    negative in front), i.e. the viewing direction is -z.
    """
    C = np.asarray(C, float)
    t = np.zeros(3) if target is None else np.asarray(target, float)
    z = C - t
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    up = np.array([0.0, 0.0, 1.0])
    x = np.cross(np.broadcast_to(up, z.shape), z)
    bad = np.linalg.norm(x, axis=1) < 1e-9
    if bad.any():
        x[bad] = np.cross(np.array([0.0, 1.0, 0.0]), z[bad])
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=1)  # (n, 3, 3)


from ..models.rotation import (  # noqa: E402
    decompose_w2c_np as _decompose_w2c_np,
    w2c_from_angles_np as _w2c_from_angles_np,
)


def _ray_counts(rays_per_pt, n_pt, n_img, n_obs_target, rng):
    """Per-point ray counts. `rays_per_pt` is an int (uniform count) or
    a (lo, hi) tuple: skewed counts drawn from a clipped lognormal and
    nudged to hit `n_obs_target` total observations exactly — the
    irregular distribution of a real PhotoScan network (e.g. stpierre
    C5: 17,993 points / 196,715 measurements, ~10.9 mean rays,
    stpierrePS_C5-dbatreport.txt:23-24)."""
    if np.isscalar(rays_per_pt):
        k = min(int(rays_per_pt), n_img)
        return np.full(n_pt, k, dtype=np.int64)
    lo, hi = rays_per_pt
    lo = max(2, int(lo))
    hi = min(int(hi), n_img)
    mean = (n_obs_target / n_pt) if n_obs_target else (lo + hi) / 2
    # Lognormal with sigma 0.5 around the target mean, clipped.
    mu = np.log(max(mean, lo + 0.5)) - 0.5 * 0.5**2
    counts = np.clip(np.round(rng.lognormal(mu, 0.5, n_pt)), lo, hi)
    counts = counts.astype(np.int64)
    if n_obs_target:
        # Nudge random in-range entries by +-1 until the total matches.
        delta = int(n_obs_target) - int(counts.sum())
        while delta != 0:
            step = 1 if delta > 0 else -1
            room = counts < hi if delta > 0 else counts > lo
            idx = np.flatnonzero(room)
            take = min(abs(delta), len(idx))
            if take == 0:
                break
            sel = rng.choice(idx, size=take, replace=False)
            counts[sel] += step
            delta -= step * take
    return counts


def make_ring_network(
    n_img: int = 20,
    n_pt: int = 200,
    rays_per_pt=6,
    n_ctrl: int = 4,
    radius: float = 10.0,
    focal: float = 7.0,
    sensor: tuple = (7.3, 5.4),
    im_size: tuple = (2272, 1704),
    ip_std_px: float = 0.1,
    noise_px: float = 0.0,
    dist_model: int = 3,
    K=(1e-4, 0.0, 0.0),
    P=(1e-5, 0.0),
    est_io_cols=(),
    n_obs_target: int = 0,
    seed: int = 0,
) -> Project:
    """Build a synthetic Project with exact projections (+optional noise).

    Points sit in a unit-ish blob at the origin; cameras on a ring of
    given radius look inward. Point j is observed by a run of
    consecutive cameras starting at a j-dependent offset; run length is
    `rays_per_pt` (int = uniform, (lo, hi) = irregular lognormal counts
    summing to `n_obs_target`).

    `est_io_cols` names IO parameters to self-calibrate (shared across
    all images, block-variant): e.g. ("cc","px","py","K1","K2","K3",
    "P1","P2") reproduces the stpierre C5 8-parameter calibration
    (stpierrePS_C5-dbatreport.txt "Calibration: yes (cc px py K1 K2 K3
    P1 P2)").
    """
    rng = np.random.default_rng(seed)
    nK, nP = 3, 2
    NC = N_LIN + nK + nP

    px_size = sensor[1] / im_size[1]
    ss = np.array(sensor, dtype=float)

    io = np.zeros((n_img, NC))
    io[:, 0] = focal
    io[:, 1] = ss[0] / 2
    io[:, 2] = -ss[1] / 2
    io[:, 3] = 1.0 - (sensor[0] / im_size[0]) / px_size
    io[:, N_LIN:N_LIN + len(K)] = np.asarray(K)
    io[:, N_LIN + nK:N_LIN + nK + len(P)] = np.asarray(P)

    # Cameras on a ring, slight height wobble.
    ang = 2 * np.pi * np.arange(n_img) / n_img
    C = np.stack(
        [radius * np.cos(ang), radius * np.sin(ang),
         2.0 + 0.5 * np.sin(3 * ang)], axis=1,
    )
    eo = np.zeros((n_img, 6))
    eo[:, 0:3] = C
    eo[:, 3:6] = _decompose_w2c_np(_look_at_w2c_np(C))

    # Points in a blob.
    op = rng.uniform(-2.0, 2.0, (n_pt, 3))
    op[:, 2] *= 0.5

    # Observations: consecutive-camera runs per point (vectorized).
    counts = _ray_counts(rays_per_pt, n_pt, n_img, n_obs_target, rng)
    start = (np.arange(n_pt) * 7) % n_img
    within = np.arange(int(counts.sum())) - np.repeat(
        np.cumsum(counts) - counts, counts)
    obs_pt = np.repeat(np.arange(n_pt), counts).astype(np.int32)
    obs_img = ((start[obs_pt] + within) % n_img).astype(np.int32)

    # Exact projections -> pixel measurements: compute the ideal pinhole
    # projection (the residual lhs) for every observation, then invert
    # the measurement chain rhs(u) == lhs by vectorized fixed-point
    # iteration (distortion/affine are small corrections). The w2c
    # matrices are reconstructed from the stored angles so the targets
    # match what the solver's projection model produces bit-for-bit.
    M = _w2c_from_angles_np(eo[:, 3:6])  # (n_img, 3, 3)
    pc = np.einsum("nij,nj->ni", M[obs_img], op[obs_pt] - C[obs_img])
    target = (-io[obs_img, 0:1]) * pc[:, :2] / pc[:, 2:3]  # (n_obs, 2) mm

    pp = io[obs_img][:, 1:3]
    Kv = -io[obs_img][:, N_LIN:N_LIN + nK]  # undistort coefficients
    Pv = -io[obs_img][:, N_LIN + nK:N_LIN + nK + nP]
    b = io[obs_img][:, 3:5]

    def rhs_chain(u_mm):
        x = u_mm - pp
        if dist_model == 3:
            x = np.stack(
                [(1 + b[:, 0]) * x[:, 0] + b[:, 1] * x[:, 1], x[:, 1]], axis=1
            )
        elif dist_model not in (1, 2):
            raise NotImplementedError(f"model {dist_model}")
        r2 = np.sum(x * x, axis=1, keepdims=True)
        kr = np.zeros_like(r2)
        for k in reversed(range(nK)):
            kr = Kv[:, k:k + 1] + r2 * kr
        kr = r2 * kr
        p1, p2 = Pv[:, 0:1], Pv[:, 1:2]
        xx, yy = x[:, 0:1], x[:, 1:2]
        tang = np.concatenate(
            [p1 * (r2 + 2 * xx**2) + 2 * p2 * xx * yy,
             p2 * (r2 + 2 * yy**2) + 2 * p1 * xx * yy], axis=1,
        )
        return x + x * kr + tang

    u_mm = target + pp
    for _ in range(100):
        err = rhs_chain(u_mm) - target
        if np.abs(err).max() < 1e-13:
            break
        u_mm = u_mm - err
    u_px = np.stack([u_mm[:, 0] / px_size, -u_mm[:, 1] / px_size], axis=1)

    if noise_px > 0:
        u_px += rng.normal(0.0, noise_px, u_px.shape)

    ip_std = np.full((len(obs_img), 2), ip_std_px)

    # Control points: first n_ctrl points fixed at their true values.
    is_ctrl = np.zeros(n_pt, dtype=bool)
    is_ctrl[:n_ctrl] = True
    prior_op_val = np.full((n_pt, 3), np.nan)
    prior_op_std = np.full((n_pt, 3), np.nan)
    prior_op_val[:n_ctrl] = op[:n_ctrl]
    prior_op_std[:n_ctrl] = 0.0
    est_op = np.ones((n_pt, 3), dtype=bool)
    est_op[:n_ctrl] = False

    # Self-calibration mask: shared camera (io_block all ones), listed
    # columns estimated on every image.
    est_io = np.zeros((n_img, NC), dtype=bool)
    for c in est_io_cols:
        est_io[:, IO_COLS[c] if isinstance(c, str) else int(c)] = True

    op_id = np.arange(1, n_pt + 1)

    proj = Project(
        io=io,
        eo=eo,
        op=op.copy(),
        dist_model=dist_model,
        nK=nK,
        nP=nP,
        sensor_ss_size=np.tile(ss, (n_img, 1)),
        sensor_im_size=np.tile(np.asarray(im_size, float), (n_img, 1)),
        sensor_px_size=np.full((n_img, 2), px_size),
        io_block=np.ones((n_img, NC), dtype=int),
        eo_block=np.tile(np.arange(1, n_img + 1)[:, None], (1, 6)),
        est_io=est_io,
        est_eo=np.ones((n_img, 6), dtype=bool),
        est_op=est_op,
        prior_io_val=io.copy(),
        prior_io_std=np.full((n_img, NC), np.nan),
        prior_io_use=np.zeros((n_img, NC), dtype=bool),
        prior_eo_val=eo.copy(),
        prior_eo_std=np.full((n_img, 6), np.nan),
        prior_eo_use=np.zeros((n_img, 6), dtype=bool),
        prior_op_val=prior_op_val,
        prior_op_std=prior_op_std,
        prior_op_use=np.zeros((n_pt, 3), dtype=bool),
        is_ctrl=is_ctrl,
        is_check=np.zeros(n_pt, dtype=bool),
        obs_img=obs_img,
        obs_pt=obs_pt,
        ip_px=u_px,
        ip_std_px=ip_std,
        ip_id=op_id[obs_pt],
        ip_sigmas=np.array([ip_std_px]),
        op_id=op_id,
        op_raw_id=op_id.copy(),
        op_labels=[str(i) for i in op_id],
        img_names=[f"synth{i:04d}.jpg" for i in range(n_img)],
        img_labels=[f"synth{i:04d}.jpg" for i in range(n_img)],
        img_ids=np.arange(1, n_img + 1),
        title="synthetic ring network",
        file_name="<synthetic>",
    )
    return proj


def perturb(project: Project, eo_pos=0.1, eo_ang=0.02, op_pos=0.1,
            io_scale=0.0, seed=1):
    """Perturb EO/OP (and optionally IO) initial values
    (cf. romabundledemo.m:66-74)."""
    rng = np.random.default_rng(seed)
    p = project
    p.eo[:, 0:3] += rng.normal(0, eo_pos, (p.n_img, 3))
    p.eo[:, 3:6] += rng.normal(0, eo_ang, (p.n_img, 3))
    est = p.est_op.all(axis=1)
    p.op[est] += rng.normal(0, op_pos, (est.sum(), 3))
    if io_scale:
        # Same relative perturbation on every image of a shared block.
        dio = rng.normal(0, io_scale, p.io.shape[1])
        p.io[:, 0] *= 1.0 + dio[0]
        p.io[:, 1:3] += p.io[:, 0:1] * dio[1:3][None, :] * 0.1
    return p
