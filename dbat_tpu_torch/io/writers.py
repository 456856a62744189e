"""Result file writers: EO listing, top residuals (a numpy copy of
dbat_tpu/io/writers.py; ref code/script/parseoutputfiles.m
WritePostEOFile / WriteImageResidualsFile)."""

from __future__ import annotations

import uuid as uuid_mod

import numpy as np


def write_eo_file(path: str, project, std_eo=None, script_name: str = ""):
    """EO listing: 'EO number, EO id, x, y, z, omega, phi, kappa,
    sx, sy, sz, so, sp, sk, label' (camera_stations.txt format).

    Note: the reference's header says degrees but writes angles in
    radians (camera_stations.txt vs camcal report values); we write
    radians for file compatibility."""
    p = project
    L = [
        "# EO listing for dbat script file",
        f"# {script_name}.",
        "# Generated by dbat_tpu_torch.",
        f"# Execution UUID: {uuid_mod.uuid4()}.",
        "# Format: EO number, EO id, x, y, z, omega, phi, kappa, "
        "sx, sy, sz, so, sk, label. Unit: degrees.",
    ]
    for i in range(p.n_img):
        vals = list(p.eo[i])
        stds = list(std_eo[i]) if std_eo is not None else [np.nan] * 6
        nums = ", ".join(f"{v:.18g}" for v in vals + stds)
        L.append(f"{i+1}, {p.img_ids[i]}, {nums}, {p.img_labels[i]}")
    with open(path, "wt") as fh:
        fh.write("\n".join(L) + "\n")


def write_top_residuals(path: str, project, top_count: int = 50,
                        script_name: str = ""):
    """Top-residual listing: 'OP id, image id, x, y, resx, resy,
    resTot' (top_residuals.txt format)."""
    p = project
    r = p.post["ip_res_px"]
    rn = np.linalg.norm(r, axis=1)
    order = np.argsort(-rn)[:top_count]
    L = [
        "# Top residual listing for dbat script file",
        f"# {script_name}.",
        "# Generated by dbat_tpu_torch.",
        f"# Execution UUID: {uuid_mod.uuid4()}.",
        f"# Listing top {top_count} residuals.",
        "# Format: OP id, image id, x, y, resx, resy, resTot",
    ]
    for k in order:
        L.append(
            f"{p.op_id[p.obs_pt[k]]}, {p.img_ids[p.obs_img[k]]}, "
            f"{p.ip_px[k,0]:.6g}, {p.ip_px[k,1]:.6g}, "
            f"{-r[k,0]:.6g}, {-r[k,1]:.6g}, {rn[k]:.6g}"
        )
    with open(path, "wt") as fh:
        fh.write("\n".join(L) + "\n")
