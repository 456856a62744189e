"""images -> measured network: the full feature front-end in one call
(counterpart of dbat_tpu/features/pipeline.py).

The DBAT analog stops at file import (loadpm.m); this closes the loop
from pixels: detect, describe and match all pairs on the device, build
tracks (host union-find), assemble a Project.  Feed the result to
geometry.posegraph.init_from_pose_graph and solve.bundle.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve_device
from ..io.png import UnsupportedImage, read_png
from .describe import describe
from .detect import _tensor, detect_blobs, detect_corners, \
    refine_centroid
from .match import match_all_pairs
from .tracks import build_tracks, project_from_tracks


def _read_image(path):
    """One image file as matplotlib.image.imread reads it: PNG here,
    anything else through matplotlib where it is installed."""
    try:
        return read_png(path)
    except UnsupportedImage:
        try:
            import matplotlib.image as mpimg
        except ImportError:
            raise ValueError(f"{path}: not a PNG this reader decodes, and "
                             "matplotlib is not installed to read it") \
                from None
        return mpimg.imread(path)


def load_images(paths):
    """Load image files into an (n, H, W) float32 grayscale stack.

    PNG is read without matplotlib or Pillow (io/png.py); any other
    format through matplotlib.  RGB(A) is averaged to luminance.  All
    images must share one size — the detector batch is one tensor."""
    out = []
    for p in paths:
        img = np.asarray(_read_image(p), np.float32)
        if img.ndim == 3:
            img = img[..., :3].mean(axis=2)
        out.append(img)
    shapes = {im.shape for im in out}
    if len(shapes) != 1:
        raise ValueError(f"images differ in size: {sorted(shapes)}")
    return np.stack(out)


def network_from_images(images, *, focal: float, sensor: tuple,
                        detector: str = "blob", max_kp: int = 512,
                        min_views: int = 2, ratio: float = 0.9,
                        ip_std_px: float = 0.1, grid: int = 14,
                        spacing: float = 1.25, est_io_cols=(),
                        dist_model: int = 3, pairs=None, device=None,
                        **detect_kw):
    """Build a measured network (Project) from a stack of images.

    images: (n_img, H, W) float array.  focal/sensor: nominal camera
    (EXIF-grade).  Detection, description and matching run on `device`
    (default: the card); tracks and the Project on the host.  Returns
    (project, extras) with extras carrying the raw detections/matches/
    tracks (numpy) for diagnostics, and "times": the seconds of each
    stage ("detect" with the upload and any refinement, "describe",
    "match", "tracks"), each ended by a device synchronisation."""
    device = resolve_device(device)
    times = {}
    start = time.perf_counter()

    def lap(stage):
        nonlocal start
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        times[stage] = now - start
        start = now

    img = _tensor(images, device, torch.float32)  # uploaded once
    n_img, H, W = img.shape
    det = detect_blobs if detector == "blob" else detect_corners
    refine_radius = detect_kw.pop("refine_radius", None)
    xy, score, valid = det(img, max_kp=max_kp, device=device, **detect_kw)
    if refine_radius:
        # Real large circular targets: background-subtracted intensity
        # centroid (the LoG peak alone is ~0.5-1 px on 40 px dots).
        xy = refine_centroid(img, xy, valid, radius=int(refine_radius),
                             device=device)
    lap("detect")
    desc = describe(img, xy, valid, grid=grid, spacing=spacing,
                    device=device)
    lap("describe")
    matches = match_all_pairs(desc, valid, pairs=pairs, ratio=ratio,
                              device=device)
    lap("match")
    xy = xy.cpu().numpy()
    valid = valid.cpu().numpy()
    tracks = build_tracks(matches, n_img, max_kp, min_views=min_views)
    project = project_from_tracks(
        tracks, xy, focal=focal, sensor=sensor, im_size=(W, H),
        ip_std_px=ip_std_px, dist_model=dist_model,
        est_io_cols=est_io_cols)
    lap("tracks")
    extras = {"xy": xy, "valid": valid, "score": score.cpu().numpy(),
              "matches": matches, "tracks": tracks, "times": times}
    return project, extras
