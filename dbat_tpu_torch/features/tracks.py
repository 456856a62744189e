"""Track building and measured-network assembly (a numpy copy of
dbat_tpu/features/tracks.py).

Matched keypoint pairs are merged into multi-view tracks with a
union-find over (image, slot) nodes — one-time host work, like the
reference's file import (loadpm.m mark-point table).  Tracks become a
`Project` whose image-point table is the detected subpixel positions;
EO/OP start NaN-poisoned exactly like a freshly imported PhotoModeler
project before resection (cleareo/clearop), ready for
geometry.posegraph.init_from_pose_graph + bundle.
"""

from __future__ import annotations

import numpy as np


class _UnionFind:
    """Union-find whose components carry an image -> node map, so a
    union that would observe the same image through two different
    keypoints is rejected (it must contain a wrong match)."""

    def __init__(self, n):
        self.parent = np.arange(n)
        self.imgmap: dict = {}  # root -> {image: node}

    def find(self, a):
        p = self.parent
        root = a
        while p[root] != root:
            root = p[root]
        while p[a] != root:
            p[a], a = root, p[a]
        return root

    def union_consistent(self, a, b, img_a, img_b):
        ra, rb = self.find(a), self.find(b)
        ma = self.imgmap.setdefault(ra, {img_a: a})
        mb = self.imgmap.setdefault(rb, {img_b: b})
        if ra == rb:
            return ma.get(img_a) == a and ma.get(img_b) == b
        if len(ma) < len(mb):
            ra, rb, ma, mb = rb, ra, mb, ma
        for im, node in mb.items():
            if ma.get(im, node) != node:
                return False  # image conflict: reject this match
        ma.update(mb)
        self.parent[rb] = ra
        del self.imgmap[rb]
        return True


def build_tracks(matches: dict, n_img: int, max_kp: int,
                 min_views: int = 2):
    """Merge pairwise matches into tracks, outlier-robustly.

    matches: {(i, j): (slots_i, slots_j[, sim])} from match_all_pairs.
    Matches are processed globally best-first (by similarity when
    present); a match whose union would put two different keypoints of
    one image into the same track is rejected — by then the correct
    matches have already consolidated the true tracks, so the bad
    match is the one that loses.  Returns a list of tracks, each an
    (m, 2) int array of (image, slot) rows."""
    flat = []
    for (i, j), m in matches.items():
        s1, s2 = m[0], m[1]
        sim = m[2] if len(m) > 2 else np.zeros(len(s1))
        for a, b, s in zip(s1, s2, sim):
            flat.append((float(s), i, int(a), j, int(b)))
    flat.sort(key=lambda t: -t[0])

    uf = _UnionFind(n_img * max_kp)
    for (_s, i, a, j, b) in flat:
        uf.union_consistent(i * max_kp + a, j * max_kp + b, i, j)

    tracks = []
    for root, m in uf.imgmap.items():
        if len(m) < min_views:
            continue
        arr = np.array(sorted(m.values()))
        tracks.append(np.stack([arr // max_kp, arr % max_kp], axis=1))
    return tracks


def project_from_tracks(tracks, xy, *, focal: float, sensor: tuple,
                        im_size: tuple, ip_std_px: float = 0.1,
                        nK: int = 3, nP: int = 2, dist_model: int = 3,
                        est_io_cols=(), title="feature network"):
    """Build a Project from tracks + per-image keypoint positions.

    xy: (n_img, max_kp, 2) detected [x, y] pixel coordinates.
    Camera: a single shared (block-variant) camera with the given
    nominal focal/sensor/image size, principal point at the sensor
    center, zero distortion — the standard EXIF-grade starting point
    (camcaldemo.m:65 setcamvals('default',...)).  EO/OP are
    NaN-poisoned (cleareo/clearop semantics); initialize with
    resection or the pose-graph layer."""
    from ..core.project import N_LIN, Project
    from ..pipeline.synthetic import IO_COLS

    n_img = xy.shape[0]
    NC = N_LIN + nK + nP
    n_op = len(tracks)
    ss = np.asarray(sensor, dtype=float)
    px_size = ss[1] / im_size[1]

    io = np.zeros((n_img, NC))
    io[:, 0] = focal
    io[:, 1] = ss[0] / 2
    io[:, 2] = -ss[1] / 2
    io[:, 3] = 1.0 - (ss[0] / im_size[0]) / px_size

    obs_img, obs_pt, ip = [], [], []
    for t, tr in enumerate(tracks):
        for (i, s) in tr:
            obs_img.append(i)
            obs_pt.append(t)
            ip.append(xy[i, s])
    obs_img = np.asarray(obs_img, np.int32)
    obs_pt = np.asarray(obs_pt, np.int32)
    ip_px = np.asarray(ip, np.float64).reshape(-1, 2)

    est_io = np.zeros((n_img, NC), dtype=bool)
    for c in est_io_cols:
        est_io[:, IO_COLS[c] if isinstance(c, str) else int(c)] = True

    op_id = np.arange(1, n_op + 1)
    return Project(
        io=io,
        eo=np.full((n_img, 6), np.nan),
        op=np.full((n_op, 3), np.nan),
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
        est_op=np.ones((n_op, 3), dtype=bool),
        prior_io_val=io.copy(),
        prior_io_std=np.full((n_img, NC), np.nan),
        prior_io_use=np.zeros((n_img, NC), dtype=bool),
        prior_eo_val=np.full((n_img, 6), np.nan),
        prior_eo_std=np.full((n_img, 6), np.nan),
        prior_eo_use=np.zeros((n_img, 6), dtype=bool),
        prior_op_val=np.full((n_op, 3), np.nan),
        prior_op_std=np.full((n_op, 3), np.nan),
        prior_op_use=np.zeros((n_op, 3), dtype=bool),
        is_ctrl=np.zeros(n_op, dtype=bool),
        is_check=np.zeros(n_op, dtype=bool),
        obs_img=obs_img,
        obs_pt=obs_pt,
        ip_px=ip_px,
        ip_std_px=np.full((len(ip_px), 2), float(ip_std_px)),
        ip_id=op_id[obs_pt],
        ip_sigmas=np.array([float(ip_std_px)]),
        op_id=op_id,
        op_raw_id=op_id.copy(),
        op_labels=[str(i) for i in op_id],
        img_names=[f"img{i:04d}" for i in range(n_img)],
        img_labels=[f"img{i:04d}" for i in range(n_img)],
        img_ids=np.arange(1, n_img + 1),
        title=title,
        file_name="<features>",
    )
