"""Build a Project from component tables (the script-input path; a numpy
copy of dbat_tpu/pipeline/project_build.py).

The reference assembles the DBAT struct from XML-script inputs via
setdbatcamsandimages/setdbatpts (code/script/parseinput.m); here a
single constructor takes camera specs + image list + measurement
tables + control/check points + prior EO and produces a Project.
"""

from __future__ import annotations

import numpy as np

from ..core.project import N_LIN, Project


def project_from_tables(
    cameras,
    image_ids,
    image_paths,
    image_pts,
    ctrl_pts=None,
    check_pts=None,
    prior_eo=None,
    title: str = "",
    file_name: str = "",
) -> Project:
    """cameras: list[CameraSpec] (first camera shared by all images for
    now — matches every shipped script); image_pts: (n,6)
    [im,id,x,y,sx,sy] with im referring to image_ids.
    """
    cam = cameras[0]
    n_img = len(image_ids)
    nK, nP = cam.nK, cam.nP
    NC = N_LIN + nK + nP

    io_row = cam.io_vector()
    io = np.tile(io_row, (n_img, 1))
    sensor = cam.eval_sensor()
    im_sz = np.tile(np.asarray(cam.image_size, float), (n_img, 1))
    px = sensor[1] / cam.image_size[1]
    px_size = np.full((n_img, 2), px)

    eo = np.full((n_img, 6), np.nan)

    # Observations: map image id -> row, sort per image by point id.
    id2row = {int(v): i for i, v in enumerate(image_ids)}
    im_rows = np.array([id2row[int(v)] for v in image_pts[:, 0]])
    order = np.lexsort((image_pts[:, 1], im_rows))
    image_pts = image_pts[order]
    im_rows = im_rows[order]

    mark_ids = image_pts[:, 1].astype(np.int64)
    all_ids = np.unique(mark_ids)
    for tbl in (ctrl_pts, check_pts):
        if tbl is not None:
            all_ids = np.union1d(all_ids, tbl.id)
    n_op = len(all_ids)

    obs_pt = np.searchsorted(all_ids, mark_ids).astype(np.int32)
    obs_img = im_rows.astype(np.int32)
    ip_px = image_pts[:, 2:4]
    ip_std = image_pts[:, 4:6]

    sigmas = np.unique(ip_std)
    if np.any(sigmas == 0):
        sigmas = np.array([1.0])
        ip_std = np.ones_like(ip_std)

    op = np.full((n_op, 3), np.nan)
    prior_op_val = np.full((n_op, 3), np.nan)
    prior_op_std = np.full((n_op, 3), np.nan)
    is_ctrl = np.zeros(n_op, dtype=bool)
    is_check = np.zeros(n_op, dtype=bool)
    op_labels = ["" for _ in range(n_op)]

    proj = Project(
        io=io,
        eo=eo,
        op=op,
        dist_model=cam.model,
        nK=nK,
        nP=nP,
        cam_unit=cam.unit,
        sensor_ss_size=np.tile(sensor, (n_img, 1)),
        sensor_im_size=im_sz,
        sensor_px_size=px_size,
        io_block=np.ones((n_img, NC), dtype=int),
        eo_block=np.tile(np.arange(1, n_img + 1)[:, None], (1, 6)),
        est_io=np.zeros((n_img, NC), dtype=bool),
        est_eo=np.ones((n_img, 6), dtype=bool),
        est_op=np.ones((n_op, 3), dtype=bool),
        prior_io_val=io.copy(),
        prior_io_std=np.full((n_img, NC), np.nan),
        prior_io_use=np.zeros((n_img, NC), dtype=bool),
        prior_eo_val=np.full((n_img, 6), np.nan),
        prior_eo_std=np.full((n_img, 6), np.nan),
        prior_eo_use=np.zeros((n_img, 6), dtype=bool),
        prior_op_val=prior_op_val,
        prior_op_std=prior_op_std,
        prior_op_use=np.zeros((n_op, 3), dtype=bool),
        is_ctrl=is_ctrl,
        is_check=is_check,
        obs_img=obs_img,
        obs_pt=obs_pt,
        ip_px=ip_px,
        ip_std_px=ip_std,
        ip_id=mark_ids,
        ip_sigmas=sigmas,
        op_id=all_ids,
        op_raw_id=all_ids.copy(),
        op_labels=op_labels,
        img_names=list(image_paths),
        img_labels=[p.split("/")[-1] for p in image_paths],
        img_ids=np.asarray(image_ids),
        title=title,
        file_name=file_name,
    )

    if ctrl_pts is not None and len(ctrl_pts.id):
        i = np.searchsorted(all_ids, ctrl_pts.id)
        proj.set_cpt(ctrl_pts, i, np.arange(len(ctrl_pts.id)), is_ctrl=True)
    if check_pts is not None and len(check_pts.id):
        i = np.searchsorted(all_ids, check_pts.id)
        proj.set_cpt(check_pts, i, np.arange(len(check_pts.id)),
                     is_ctrl=False)
    if prior_eo is not None:
        i, j = proj.match_eo(prior_eo)
        proj.set_prior_eo(prior_eo, i, j)
    return proj
