"""Batched feature detection: blobs (LoG) and corners (Harris)
(counterpart of dbat_tpu/features/detect.py).

Every stage is a static-shape tensor op on the device, batched over
the image axis in float32: separable Gaussian filtering as two
convolutions, non-max suppression as a max-pool comparison, candidate
selection as the top `max_kp` of the flattened response (fixed slots +
validity mask), and subpixel refinement as a batched 3x3 quadratic fit.

Where PyTorch's primitives differ from the JAX package's, this module
follows the JAX semantics:
  * the top-k is a stable descending sort: equal scores (the -inf of
    every slot without a peak) come in index order, as XLA's top_k
    gives them, so the slots repeat bit for bit on the card;
  * the 3x3 and DxD windows are gathers whose start is clamped into the
    image, as `lax.dynamic_slice` clamps it;
  * the border median averages the two middle samples of an even count
    (`jnp.median`), where `torch.median` returns the lower one.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device


def _gauss_kernel(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _sep_conv(img, kernel):
    """Separable 2D cross-correlation with zero padding (SAME) of an
    (n, H, W) batch: one pass along x, then one along y."""
    k = torch.as_tensor(kernel, dtype=img.dtype, device=img.device)
    K = k.shape[0]
    x = img[:, None]
    x = F.conv2d(x, k.reshape(1, 1, 1, K), padding=(0, K // 2))
    x = F.conv2d(x, k.reshape(1, 1, K, 1), padding=(K // 2, 0))
    return x[:, 0]


def _blob_response(img, sigma: float):
    """Scale-normalized LoG approximated by difference-of-Gaussians.

    Bright blobs of scale ~sigma become positive local maxima."""
    r = int(max(2, round(3 * sigma * 1.6)))
    g1 = _sep_conv(img, _gauss_kernel(sigma, r))
    g2 = _sep_conv(img, _gauss_kernel(sigma * 1.6, r))
    return g1 - g2


def _harris_response(img, sigma_d: float, sigma_i: float, k: float):
    rd = int(max(2, round(3 * sigma_d)))
    g = _sep_conv(img, _gauss_kernel(sigma_d, rd))
    Ix = 0.5 * (torch.roll(g, -1, 2) - torch.roll(g, 1, 2))
    Iy = 0.5 * (torch.roll(g, -1, 1) - torch.roll(g, 1, 1))
    ri = int(max(2, round(3 * sigma_i)))
    ki = _gauss_kernel(sigma_i, ri)
    Sxx = _sep_conv(Ix * Ix, ki)
    Syy = _sep_conv(Iy * Iy, ki)
    Sxy = _sep_conv(Ix * Iy, ki)
    det = Sxx * Syy - Sxy * Sxy
    tr = Sxx + Syy
    return det - k * tr * tr


def _window(img, r0, c0, size):
    """(n, K, size, size) windows of an (n, H, W) batch whose top-left
    corners (n, K) are clamped into the image like lax.dynamic_slice."""
    n, H, W = img.shape
    r0 = r0.clamp(0, H - size)
    c0 = c0.clamp(0, W - size)
    d = torch.arange(size, device=img.device)
    rows = (r0[..., None] + d)[..., :, None]
    cols = (c0[..., None] + d)[..., None, :]
    b = torch.arange(n, device=img.device)[:, None, None, None]
    return img[b, rows, cols]


def _select_peaks(R, max_kp: int, min_distance: int, threshold_rel: float,
                  border: int):
    """NMS + top-k + 3x3 quadratic subpixel refinement on (n, H, W)
    responses R."""
    n, H, W = R.shape
    win = 2 * min_distance + 1
    pooled = F.max_pool2d(R[:, None], win, stride=1,
                          padding=min_distance)[:, 0]
    is_max = R >= pooled
    thr = threshold_rel * R.amax(dim=(1, 2), keepdim=True)
    rr = torch.arange(H, device=R.device)[:, None]
    cc = torch.arange(W, device=R.device)[None, :]
    inb = ((rr >= border) & (rr < H - border)
           & (cc >= border) & (cc < W - border))
    score = torch.where(is_max & (R > thr) & inb, R,
                        torch.full_like(R, -torch.inf))
    vals, idx = torch.sort(score.reshape(n, -1), dim=1, descending=True,
                           stable=True)
    vals, idx = vals[:, :max_kp], idx[:, :max_kp]
    valid = torch.isfinite(vals)
    r0 = idx // W
    c0 = idx % W

    # Quadratic fit over the 3x3 neighbourhood (DBAT itself never
    # refines: its measurements come pre-refined from PhotoModeler).
    w = _window(R, r0.clamp(min=1) - 1, c0.clamp(min=1) - 1, 3)
    dx = 0.5 * (w[..., 1, 2] - w[..., 1, 0])
    dy = 0.5 * (w[..., 2, 1] - w[..., 0, 1])
    dxx = w[..., 1, 2] - 2.0 * w[..., 1, 1] + w[..., 1, 0]
    dyy = w[..., 2, 1] - 2.0 * w[..., 1, 1] + w[..., 0, 1]
    dxy = 0.25 * (w[..., 2, 2] - w[..., 2, 0] - w[..., 0, 2] + w[..., 0, 0])
    det = dxx * dyy - dxy * dxy
    fit = det.abs() > 1e-12
    zero = torch.zeros_like(det)
    ox = torch.where(fit, -(dyy * dx - dxy * dy) / det, zero)
    oy = torch.where(fit, -(dxx * dy - dxy * dx) / det, zero)
    ox = ox.clamp(-1.0, 1.0)
    oy = oy.clamp(-1.0, 1.0)
    xy = torch.stack([c0 + ox, r0 + oy], dim=-1)  # (n, max_kp, 2) [x, y] px
    return xy, torch.where(valid, vals, zero), valid


def _tensor(a, device, dtype=None):
    """`a` (a tensor, or an array copied once) on `device`, converted to
    `dtype` there: a uint8 image batch crosses at 1 byte a pixel."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a))
    return a.to(device).to(dtype or a.dtype)


def detect_blobs(images, max_kp: int = 512, sigma: float = 1.5,
                 min_distance: int = 4, threshold_rel: float = 0.15,
                 border: int = 8, device=None):
    """Detect bright blobs in a batch of images.

    images: (n, H, W) float (or uint8) array or tensor.  Returns (xy,
    score, valid) on `device` (default: the card): xy (n, max_kp, 2)
    subpixel [x, y] pixel coordinates, score (n, max_kp), valid
    (n, max_kp) bool mask (fixed-slot layout)."""
    device = resolve_device(device)
    R = _blob_response(_tensor(images, device, torch.float32), float(sigma))
    return _select_peaks(R, int(max_kp), int(min_distance),
                         float(threshold_rel), int(border))


def detect_corners(images, max_kp: int = 512, sigma_d: float = 1.0,
                   sigma_i: float = 2.0, k: float = 0.06,
                   min_distance: int = 4, threshold_rel: float = 0.01,
                   border: int = 8, device=None):
    """Harris corner detection, same layout as detect_blobs."""
    device = resolve_device(device)
    R = _harris_response(_tensor(images, device, torch.float32),
                         float(sigma_d), float(sigma_i), float(k))
    return _select_peaks(R, int(max_kp), int(min_distance),
                         float(threshold_rel), int(border))


def _median(samples):
    """Median over the last axis; an even count averages the two middle
    values, in jnp.median's order of operations."""
    s, _ = torch.sort(samples, dim=-1)
    m = s.shape[-1] - 1
    return (s[..., m // 2] + s[..., (m + 1) // 2]) * 0.5


def refine_centroid(images, xy, valid, radius: int = 12, iters: int = 3,
                    power: float = 2.0, device=None):
    """Background-subtracted intensity-centroid refinement of detected
    blob positions (the classical dot-target measurement: PhotoModeler
    marks circular targets the same way; LoG peak localization alone
    is only good to ~0.5-1 px on large real targets).

    images: (n, H, W) float, bright-target polarity (same array handed
    to detect_blobs).  xy/valid: detector output.  On `device`
    (default: the card), batched over images and keypoints: windows
    gathered around each position, the median of each window's border
    as background, `iters` fixed steps for every keypoint (a step whose
    window leaves the image or holds no positive mass keeps the
    position).

    `power`: exponent on the background-subtracted weights (2, the
    default, emphasizes the target core and suppresses the asymmetric
    illumination-gradient tail).

    Returns refined xy (n, max_kp, 2) as a float32 tensor on `device`;
    slots that are not valid keep the detector position."""
    device = resolve_device(device)
    img = _tensor(images, device, torch.float32)
    xy = _tensor(xy, device, torch.float32)
    valid = _tensor(valid, device)
    n, H, W = img.shape
    r = int(radius)
    D = 2 * r + 1
    ax = torch.arange(-r, r + 1, dtype=torch.float32, device=device)
    inside = ((ax[None, :] ** 2 + ax[:, None] ** 2)
              <= float(r * r)).to(torch.float32)

    x, y = xy[..., 0], xy[..., 1]
    for _ in range(int(iters)):
        cx = torch.round(x).to(torch.int64)
        cy = torch.round(y).to(torch.int64)
        ok = (cx >= r) & (cx < W - r) & (cy >= r) & (cy < H - r)
        cxc = cx.clamp(r, W - r - 1)
        cyc = cy.clamp(r, H - r - 1)
        win = _window(img, cyc - r, cxc - r, D)
        med = _median(torch.cat([win[..., 0, :], win[..., -1, :],
                                 win[..., :, 0], win[..., :, -1]], dim=-1))
        w = (win - med[..., None, None]).clamp(min=0.0) ** power * inside
        m = w.sum(dim=(-2, -1))
        ok = ok & (m > 0)
        safe = torch.where(m > 0, m, torch.ones_like(m))
        nx = cxc + (w.sum(dim=-2) * ax).sum(dim=-1) / safe
        ny = cyc + (w.sum(dim=-1) * ax).sum(dim=-1) / safe
        x = torch.where(ok, nx, x)
        y = torch.where(ok, ny, y)
    out = torch.stack([x, y], dim=-1)
    return torch.where(valid[..., None], out, xy)
