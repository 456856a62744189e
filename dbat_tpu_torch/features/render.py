"""Synthetic coded-target image renderer (test/demo data source; a numpy
copy of dbat_tpu/features/render.py).

Renders a measured network (pipeline.synthetic.make_ring_network) as
images: every observation becomes a target stamped at its exact
subpixel projection — a bright Gaussian blob (the measurable center)
surrounded by a point-unique random code ring (the matchable
identity), the standard coded-target setup of close-range
photogrammetry.  Host-side numpy; one-time test-data generation.
"""

from __future__ import annotations

import numpy as np


def render_network_images(project, *, blob_sigma: float = 1.6,
                          blob_amp: float = 1.0, code_r0: float = 3.0,
                          code_r1: float = 8.0, code_amp: float = 0.45,
                          code_cell: float = 2.5, patch: int = 21,
                          noise: float = 0.01, seed: int = 0):
    """Render (n_img, H, W) float32 images of the project's targets.

    The code ring is a per-point random cell pattern evaluated
    continuously (bilinear in a small texture), so its appearance is
    identical across images up to resampling — matchable by patch
    descriptors without knowing ids."""
    p = project
    rng = np.random.default_rng(seed)
    W, H = int(p.sensor_im_size[0, 0]), int(p.sensor_im_size[0, 1])
    n_img = p.n_img
    images = np.zeros((n_img, H, W), np.float32)

    # Per-point code textures, cells of ~code_cell px.
    ncell = int(np.ceil(2 * code_r1 / code_cell)) + 2
    tex = rng.uniform(-1.0, 1.0, (p.n_op, ncell, ncell)).astype(np.float32)

    half = patch // 2
    d = np.arange(-half, half + 1, dtype=np.float32)

    def code_value(j, dx, dy):
        """Continuous code pattern of point j at offsets (dx, dy)."""
        u = (dx + code_r1) / code_cell
        v = (dy + code_r1) / code_cell
        u0 = np.clip(np.floor(u).astype(int), 0, ncell - 2)
        v0 = np.clip(np.floor(v).astype(int), 0, ncell - 2)
        fu = np.clip(u - u0, 0, 1)
        fv = np.clip(v - v0, 0, 1)
        t = tex[j]
        val = ((1 - fv) * ((1 - fu) * t[v0, u0] + fu * t[v0, u0 + 1])
               + fv * ((1 - fu) * t[v0 + 1, u0] + fu * t[v0 + 1, u0 + 1]))
        r = np.sqrt(dx * dx + dy * dy)
        ring = np.clip(1.0 - np.abs(2 * r - (code_r0 + code_r1))
                       / (code_r1 - code_r0), 0.0, 1.0)
        return code_amp * val * ring

    ip = np.asarray(p.ip_px)
    for o in range(p.n_obs):
        x, y = ip[o]
        i = int(p.obs_img[o])
        j = int(p.obs_pt[o])
        cx, cy = int(round(x)), int(round(y))
        if (cx - half < 0 or cx + half >= W
                or cy - half < 0 or cy + half >= H):
            continue
        dx = d[None, :] + (cx - x)
        dy = d[:, None] + (cy - y)
        blob = blob_amp * np.exp(-0.5 * (dx * dx + dy * dy)
                                 / blob_sigma**2)
        images[i, cy - half:cy + half + 1,
               cx - half:cx + half + 1] += blob + code_value(j, dx, dy)

    if noise > 0:
        images += rng.normal(0.0, noise, images.shape).astype(np.float32)
    return images
