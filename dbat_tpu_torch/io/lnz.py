"""PhotoScan Lens (.lnz) calibration project loader
(ref code/file/loadlnz.m; a numpy copy of dbat_tpu/io/lnz.py).

A .lnz is a zip with doc.xml: document/group/photo elements, each with
a camera-to-world transform, an image path, meta properties (width,
height, flength, fplane_xres, fplane_yres) and chessboard corner
measurements (img_x/img_y pixel coords matched to planar obj_x/obj_y
target coordinates).  The corners become fixed planar control points
(z=0) and the photos a camera-calibration network.
"""

from __future__ import annotations

import os.path as osp
import tempfile
import zipfile
from dataclasses import dataclass

import numpy as np

from ..core.project import N_LIN, Project
from ..models.rotation import decompose_w2c_np


@dataclass
class LnzProject:
    file_name: str
    im_names: list
    labels: list
    local_P: np.ndarray  # (n,3,4) world->cam
    local_CC: np.ndarray
    im_size: np.ndarray  # [w,h]
    sensor_format: np.ndarray
    pixel_size: np.ndarray
    nominal_focal: float
    ctrl_pts: np.ndarray  # (m,3) planar targets, z=0
    ctrl_labels: list
    marks: np.ndarray  # (k,4) [photo(0-based), ctrl_idx, x, y]


def load_lnz(path: str) -> LnzProject:
    import xml.etree.ElementTree as ET

    with tempfile.TemporaryDirectory() as tmp:
        with zipfile.ZipFile(path) as z:
            z.extractall(tmp)
        doc = ET.parse(osp.join(tmp, "doc.xml")).getroot()

    group = doc.find("group")
    photos = group.findall("photo")
    n = len(photos)
    D = np.diag([1.0, -1.0, -1.0, 1.0])
    P = np.full((n, 3, 4), np.nan)
    CC = np.full((n, 3), np.nan)
    im_names = []
    metas = []
    corner_rows = []
    for i, ph in enumerate(photos):
        tr = ph.find("transform")
        if tr is not None:
            T = np.array([float(t) for t in tr.text.split()]).reshape(4, 4)
            P[i] = np.linalg.inv(T @ D)[:3]
            M = np.vstack([P[i], [0, 0, 0, 1.0]])
            c = np.linalg.inv(M)[:, 3]
            CC[i] = c[:3] / c[3]
        loc = ph.find("location")
        p = loc.get("path", "") if loc is not None else ""
        if p and not p.startswith(("/", "\\")):
            p = osp.join(osp.dirname(path), p)
        im_names.append(p)
        meta = {}
        for prop in ph.findall("meta/property"):
            meta[prop.get("name")] = prop.get("value")
        metas.append(meta)
        for c in ph.findall("corner"):
            if c.get("valid", "true").lower() in ("true", "1"):
                corner_rows.append([
                    i, float(c.get("img_x")), float(c.get("img_y")),
                    float(c.get("obj_x")), float(c.get("obj_y")),
                ])

    def meta_val(key, conv=float):
        vals = {m.get(key) for m in metas if m.get(key) is not None}
        if len(vals) != 1:
            raise ValueError(f"No unique {key} in lnz metas")
        return conv(vals.pop())

    w = meta_val("width", int)
    h = meta_val("height", int)
    f = meta_val("flength")
    xres = meta_val("fplane_xres")
    yres = meta_val("fplane_yres")

    corners = np.array(corner_rows) if corner_rows else np.zeros((0, 5))
    uc, inv = np.unique(corners[:, 3:5], axis=0, return_inverse=True)
    marks = np.stack(
        [corners[:, 0], inv.astype(float), corners[:, 1], corners[:, 2]],
        axis=1,
    ) if len(corners) else np.zeros((0, 4))

    return LnzProject(
        file_name=path,
        im_names=im_names,
        labels=[osp.basename(p) for p in im_names],
        local_P=P,
        local_CC=CC,
        im_size=np.array([w, h], dtype=float),
        sensor_format=np.array([w / xres, h / yres]),
        pixel_size=np.array([1.0 / xres, 1.0 / yres]),
        nominal_focal=f,
        ctrl_pts=np.concatenate([uc, np.zeros((len(uc), 1))], axis=1),
        ctrl_labels=[f"({int(x)},{int(y)})" for x, y in uc],
        marks=marks,
    )


def lnz_to_project(lnz: LnzProject, dist_model: int = 3):
    """Build a calibration Project from an LNZ: fixed planar control
    points, EO from the stored poses, self-calibration est mask."""
    n_img = len(lnz.im_names)
    nK, nP = 3, 2
    NC = N_LIN + nK + nP
    px = lnz.pixel_size[1]

    io = np.zeros((n_img, NC))
    io[:, 0] = lnz.nominal_focal
    io[:, 1] = lnz.sensor_format[0] / 2
    io[:, 2] = -lnz.sensor_format[1] / 2
    io[:, 3] = 1.0 - lnz.pixel_size[0] / lnz.pixel_size[1]

    eo = np.full((n_img, 6), np.nan)
    for i in range(n_img):
        if np.isfinite(lnz.local_P[i]).all():
            R = lnz.local_P[i][:, :3]
            R = R / np.linalg.det(R) ** (1.0 / 3.0)
            eo[i, 0:3] = lnz.local_CC[i]
            eo[i, 3:6] = decompose_w2c_np(R)

    n_op = len(lnz.ctrl_pts)
    marks = lnz.marks
    order = np.lexsort((marks[:, 1], marks[:, 0]))
    marks = marks[order]
    obs_img = marks[:, 0].astype(np.int32)
    obs_pt = marks[:, 1].astype(np.int32)

    op_id = np.arange(1, n_op + 1)
    proj = Project(
        io=io,
        eo=eo,
        op=lnz.ctrl_pts.copy(),
        dist_model=dist_model,
        nK=nK,
        nP=nP,
        sensor_ss_size=np.tile(lnz.sensor_format, (n_img, 1)),
        sensor_im_size=np.tile(lnz.im_size, (n_img, 1)),
        sensor_px_size=np.full((n_img, 2), px),
        io_block=np.ones((n_img, NC), dtype=int),
        eo_block=np.tile(np.arange(1, n_img + 1)[:, None], (1, 6)),
        est_io=np.zeros((n_img, NC), dtype=bool),
        est_eo=np.ones((n_img, 6), dtype=bool),
        est_op=np.zeros((n_op, 3), dtype=bool),
        prior_io_val=io.copy(),
        prior_io_std=np.full((n_img, NC), np.nan),
        prior_io_use=np.zeros((n_img, NC), dtype=bool),
        prior_eo_val=eo.copy(),
        prior_eo_std=np.full((n_img, 6), np.nan),
        prior_eo_use=np.zeros((n_img, 6), dtype=bool),
        prior_op_val=lnz.ctrl_pts.copy(),
        prior_op_std=np.zeros((n_op, 3)),
        prior_op_use=np.zeros((n_op, 3), dtype=bool),
        is_ctrl=np.ones(n_op, dtype=bool),
        is_check=np.zeros(n_op, dtype=bool),
        obs_img=obs_img,
        obs_pt=obs_pt,
        ip_px=marks[:, 2:4],
        ip_std_px=np.full((len(marks), 2), 0.1),
        ip_id=op_id[obs_pt],
        ip_sigmas=np.array([0.1]),
        op_id=op_id,
        op_raw_id=op_id.copy(),
        op_labels=list(lnz.ctrl_labels),
        img_names=list(lnz.im_names),
        img_labels=list(lnz.labels),
        img_ids=np.arange(n_img),
        title="PhotoScan lens calibration",
        file_name=lnz.file_name,
    )
    proj.set_cam_est("all", "not", "sk")
    return proj
