"""Batched patch descriptors via bilinear grid sampling (counterpart of
dbat_tpu/features/describe.py).

A (grid x grid) patch with `spacing`-pixel steps is sampled bilinearly
around each (subpixel) keypoint, mean-removed and L2-normalized — a
photometric-invariant raw-patch descriptor.  The sampling is one
gather over every image and keypoint on the device; descriptor
comparison then runs as a plain matmul (match.py).
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from .detect import _tensor


def _bilinear(img, x, y):
    """Bilinear samples of an (n, H, W) batch at (n, ...) positions, with
    the JAX package's clipping: the cell stays inside the image and the
    fractions inside [0, 1]."""
    n, H, W = img.shape
    x0 = torch.floor(x).to(torch.int64).clamp(0, W - 2)
    y0 = torch.floor(y).to(torch.int64).clamp(0, H - 2)
    fx = (x - x0).clamp(0.0, 1.0)
    fy = (y - y0).clamp(0.0, 1.0)
    b = torch.arange(n, device=img.device).reshape(
        (n,) + (1,) * (x.dim() - 1))
    v00 = img[b, y0, x0]
    v01 = img[b, y0, x0 + 1]
    v10 = img[b, y0 + 1, x0]
    v11 = img[b, y0 + 1, x0 + 1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def describe(images, xy, valid, grid: int = 14, spacing: float = 1.25,
             r_min: float = 3.0, device=None):
    """Descriptors for detected keypoints.

    images (n, H, W); xy (n, max_kp, 2); valid (n, max_kp).
    Returns (n, max_kp, grid*grid) float32 unit descriptors on `device`
    (default: the card), zero rows for invalid slots.  Samples closer
    than r_min px to the keypoint are masked out: they are the
    detection blob itself, identical for every keypoint, a common-mode
    component that floods the cosine similarity if left in."""
    device = resolve_device(device)
    img = _tensor(images, device, torch.float32)
    xy = _tensor(xy, device, torch.float32)
    valid = _tensor(valid, device)
    g = torch.arange(grid, dtype=torch.float32, device=device) \
        - (grid - 1) / 2.0
    offs = torch.stack(torch.meshgrid(g, g, indexing="xy"), dim=-1)
    offs = offs.reshape(-1, 2) * float(spacing)  # (grid*grid, 2)
    w = (torch.linalg.norm(offs, dim=1) >= float(r_min)).to(torch.float32)
    nw = w.sum().clamp(min=1.0)

    sx = xy[..., 0:1] + offs[:, 0]
    sy = xy[..., 1:2] + offs[:, 1]
    vals = _bilinear(img, sx, sy)  # (n, max_kp, grid*grid)
    vals = w * (vals - (w * vals).sum(dim=-1, keepdim=True) / nw)
    norm = torch.linalg.norm(vals, dim=-1, keepdim=True)
    d = vals / norm.clamp(min=1e-8)
    return torch.where(valid[..., None], d, torch.zeros_like(d))
