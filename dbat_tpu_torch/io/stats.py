"""Project statistics file writer (ref code/file/writestats.m; a numpy
copy of dbat_tpu/io/stats.py).

Totals, per-image ray counts/angles with histograms, and control/object
point ray-count and intersection-angle statistics — the format of the
shipped *-psstats-*.txt files.
"""

from __future__ import annotations

import time

import numpy as np


def cam_angles(project) -> np.ndarray:
    """Max ray-divergence angle per camera (rad), ref camangles.m:
    largest acos(|cos|) between rays from the camera to its points."""
    p = project
    out = np.zeros(p.n_img)
    for i in range(p.n_img):
        pts = p.op[p.obs_pt[p.obs_img == i]]
        pts = pts[np.isfinite(pts).all(axis=1)]
        if len(pts) < 2:
            continue
        d = p.eo[i, 0:3] - pts
        d = d / np.linalg.norm(d, axis=1, keepdims=True)
        best = 0.0
        for s in range(0, len(d), 2048):
            G = np.clip(np.abs(d[s:s + 2048] @ d.T), 0, 1)
            best = max(best, float(np.arccos(G).max()))
        out[i] = best
    return out


def _hist_lines(vals, edges, fmt="  {:>4.0f}-{:>4.0f}: {}"):
    counts, _ = np.histogram(vals, edges)
    return [fmt.format(edges[k], edges[k + 1] - 1, counts[k])
            for k in range(len(counts))]


def write_stats(project, path: str, desc: str = "") -> None:
    from ..geometry.quality import point_angles, ray_counts

    p = project
    deg = 180 / np.pi
    rays = ray_counts(p)
    pangles = point_angles(p) * deg
    cangles = cam_angles(p) * deg
    img_rays = np.bincount(p.obs_img, minlength=p.n_img)

    L = [desc, "", f"Project file: {p.file_name}", "",
         "Execution time stamp: " + time.strftime("%Y-%m-%d %H:%M:%S"), ""]
    n_cp = int(p.is_ctrl.sum())
    L += [
        f"Total # OP          : {p.n_op - n_cp}",
        f"Total # CP          : {n_cp}",
        f"Total # cams        : {p.n_img}",
        f"Total # image marks : {p.n_obs}",
        f"Project units       : {p.obj_unit}",
        "",
        "Project images: no (id), shortened label, name:",
    ]
    for i in range(p.n_img):
        L.append(f"  {i+1} ({p.img_ids[i]}), {p.img_labels[i]}, "
                 f"{p.img_names[i]}")

    L += ["", "", "IMAGE STATISTICS", "", "Image ray count:",
          f"  min : {img_rays.min()}",
          f"  max : {img_rays.max()}",
          f"  mean: {img_rays.mean():.0f}", ""]
    order = np.argsort(img_rays)
    L.append("Image with lowest ray count: cam no (id), label, count")
    for i in order[: min(5, p.n_img)]:
        L.append(f"  {i+1} ({p.img_ids[i]}), {p.img_labels[i]}, "
                 f"{img_rays[i]:4d}")
    lo = (img_rays.min() // 100) * 100
    hi = (img_rays.max() // 100 + 1) * 100
    L += ["", "Image ray count histogram: nRays, nCams"]
    L += _hist_lines(img_rays, np.arange(lo, hi + 1, 100))

    L += ["", "Image ray angles (deg):",
          f"  min : {cangles.min():.1f}",
          f"  max : {cangles.max():.1f}",
          f"  mean: {cangles.mean():.1f}", ""]
    order = np.argsort(cangles)
    L.append("Smallest image ray angles: cam no (id), label, nRays, angle")
    for i in order[: min(5, p.n_img)]:
        L.append(f"  {i+1} ({p.img_ids[i]}), {p.img_labels[i]}, "
                 f"{img_rays[i]:4d}, {cangles[i]:.1f}")
    L += ["", "Image ray angle histogram: angle, count"]
    counts, _ = np.histogram(cangles, np.arange(0, 95, 5))
    for k, c in enumerate(counts):
        L.append(f"  {k*5:>2d}, {c}")

    for name, mask in (("CONTROL POINT", p.is_ctrl),
                       ("OBJECT POINT", ~p.is_ctrl & ~p.is_check)):
        short = "CP" if name.startswith("CONTROL") else "OP"
        rr = rays[mask]
        if not len(rr):
            continue
        L += ["", "", f"{name} STATISTICS", "", f"{short} ray count:",
              f"  min : {rr.min()}", f"  max : {rr.max()}",
              f"  mean: {rr.mean():.1f}", "",
              f"{short} ray count histogram: nRays, count"]
        for v in np.unique(rr):
            L.append(f"  {v}, {int((rr == v).sum())}")
        ids = p.op_id[mask]
        labels = [p.op_labels[k] for k in np.flatnonzero(mask)]
        order = np.argsort(rr)
        L += ["", f"{short} with lowest ray count: {short} no (id), "
              "label, nRays, (images with rays)"]
        for k in order[: min(4, len(order))]:
            j = np.flatnonzero(mask)[k]
            ims = p.obs_img[p.obs_pt == j]
            imlist = ", ".join(p.img_labels[i] for i in ims[:8])
            L.append(f"  {k+1} ({ids[k]}), {labels[k]}, {rr[k]}, ({imlist})")
        aa = pangles[mask]
        ok = np.isfinite(aa)
        if ok.any():
            L += ["", f"{short} ray angles:",
                  f"  min : {np.nanmin(aa):.1f}",
                  f"  max : {np.nanmax(aa):.1f}",
                  f"  mean: {np.nanmean(aa):.1f}", "",
                  f"{short} ray angle histogram: angle, count"]
            counts, _ = np.histogram(aa[ok], np.arange(0, 95, 5))
            for k, c in enumerate(counts):
                L.append(f"  {k*5:>2d}, {c}")

    with open(path, "wt") as fh:
        fh.write("\n".join(L) + "\n")
