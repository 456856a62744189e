"""Reference demo pipelines (ref code/demo/*.m) as library functions
(counterpart of dbat_tpu/pipeline/demos.py).

These serve as integration tests: each returns the adjusted Project
plus the BundleInfo, and is expected to reproduce the shipped DBAT
report numbers (see BASELINE.md).  Input is read on the host; the
bundle runs on `device` (default the card, see device.py), in
`dtype` (default float64, as the JAX package's CPU oracle).  The
device is resolved before any input is read, so without a card and
without `device` a demo raises at once."""

from __future__ import annotations

import os.path as osp
import warnings

import numpy as np
import torch

from ..core.project import from_pm
from ..device import resolve_device
from ..geometry.initvals import forward_intersect, resect
from ..geometry.quality import point_angles, ray_counts
from ..io.cpt import load_cpt
from ..io.eotable import legacy_load_eo_table
from ..io.pm import load_pm
from ..io.psz import load_psz, psz_to_pm
from ..io.stats import write_stats
from ..solve.bundle import bundle

#: Root of the shipped demo data (dbat/, prague2016/, script/).
REFERENCE_DATA = "/root/reference/data"


def camcal(damping: str = "gna", data_dir: str = None, trace: bool = False,
           dtype=torch.float64, model: int = 3, prob=None, device=None,
           **bundle_kw):
    """Camera calibration demo (ref code/demo/camcaldemo.m,
    camcaldemo_allmodels.m via `model`).

    21-image Olympus C4040Z calibration network; self-calibration of
    all IO parameters but skew; EO by resection, OP by intersection;
    fixed control points 1001-1004.  Expected (camcal-dbatreport.txt
    and camcal-dbatreport-model*.txt): sigma0 by model:
    -1: 1.62168, 1/2: 1.68901, 3: 1.6148, 4: 1.61247, 5: 1.6148;
    all in 9 GNA iterations; cc = 7.457 mm for model 3.
    """
    device = resolve_device(device)
    data_dir = data_dir or osp.join(REFERENCE_DATA, "dbat")

    # `prob` lets callers substitute their own measurements into the
    # canonical configuration.
    if prob is None:
        prob = load_pm(osp.join(data_dir, "pmexports",
                                "camcal-pmexport.txt"))
    s = from_pm(prob)
    s.dist_model = model  # camcaldemo.m:62 (3); allmodels loops -1,1..5
    s.set_cam_vals_default(7.3)  # EXIF focal
    s.set_cam_est("all", "not", "sk")
    s.set_eo_est("all")
    s.clear_eo()
    if not s.is_ctrl.any():
        s.is_ctrl = s.op_id > 1000  # camcaldemo.m:77-81

    pts = load_cpt(osp.join(data_dir, "ref", "camcal-fixed.txt"))
    i, j = s.match_cpt(pts)
    s.set_cpt(pts, i, j)
    s.clear_op()

    cp_id = s.op_id[s.is_ctrl]
    rms, fail = resect(s, "all", cp_id, 1, 0, cp_id)
    if fail:
        raise RuntimeError("Resection failed")
    forward_intersect(s, "all", skip_prior=True)
    s.x0desc = "Camera calibration from EXIF value"

    return bundle(s, damping=damping, trace=trace, dtype=dtype,
                  device=device, **bundle_kw)


def camcal_error_demo(which: str, damping: str = "gna", device=None):
    """Error-detection demos (ref code/demo/camcaldemo_{1ray,
    missing_obs,no_datum}.m): deliberately broken networks exercising
    the rank-forensics paths.

    which: '1ray' (structural deficiency 1), 'missing-obs' (structural
    deficiency 6: unobserved image), 'no-datum' (numerical deficiency
    7: free-network gauge).  Expected reports:
    camcal-dbatreport-{1ray,missing-obs,no-datum}.txt.
    """
    device = resolve_device(device)
    data_dir = osp.join(REFERENCE_DATA, "dbat")
    suffix = {"1ray": "-1ray", "missing-obs": "-missing-obs",
              "no-datum": ""}[which]
    prob = load_pm(
        osp.join(data_dir, "pmexports", f"camcal-pmexport{suffix}.txt")
    )
    s = from_pm(prob)
    s.dist_model = 3
    s.set_cam_vals_default(7.3)
    s.set_cam_est("all", "not", "sk")
    s.set_eo_est("all")

    if which == "no-datum":
        # No control points, no resection: initial values from the PM
        # file; the free network has a 7-dof gauge deficiency.
        return bundle(s, damping=damping, device=device)

    s.clear_eo()
    if not s.is_ctrl.any():
        s.is_ctrl = s.op_id > 1000
    pts = load_cpt(osp.join(data_dir, "ref", "camcal-fixed.txt"))
    i, j = s.match_cpt(pts)
    s.set_cpt(pts, i, j)
    s.clear_op()
    cp_id = s.op_id[s.is_ctrl]
    resect(s, "all", cp_id, 1, 0, cp_id)
    forward_intersect(s, "all", skip_prior=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return bundle(s, damping=damping, device=device)


def prague_sxb(label: str = "s2", orient: bool = False, damping: str = "gna",
               trace: bool = False, dtype=torch.float64, device=None,
               **bundle_kw):
    """Prague 2016 sxb aerial experiments (ref code/demo/prague2016_pm.m).

    label: 's1' fixed CPs (f-op0), 's2' weighted CPs (w-op0),
    's3' weighted + extra OPs (w-op1), 's4' weighted + smart points
    (wsmart).  Expected sigma0 (no-orient reports): s1 1.0419,
    s2 0.984904, s3 0.965375, s4 1.07447.
    """
    device = resolve_device(device)
    stubs = {"s1": ("f-op0", False), "s2": ("w-op0", True),
             "s3": ("w-op1", True), "s4": ("wsmart", True)}
    stub, weighted = stubs[label.lower()]
    orient_str = "-with-orient" if orient else "-no-orient"
    input_dir = osp.join(REFERENCE_DATA, "prague2016", "sxb")
    prob = load_pm(
        osp.join(input_dir, "pmexports", f"{stub}{orient_str}-pmexport.txt")
    )
    s = from_pm(prob)
    s.set_cam_vals_loaded()
    s.set_cam_est("not", "all")

    cp_file = osp.join(
        input_dir, "ref",
        "ctrlpts-weighted.txt" if weighted else "ctrlpts-fixed.txt",
    )
    pts = load_cpt(cp_file)

    # Shift CP file coordinates by the mean offset between the PM
    # project's control points and the file (prague2016_pm.m:127-142).
    pm_ids = prob.ctrl_pts[:, 0].astype(int)
    common, ia, ib = np.intersect1d(pm_ids, pts.id, return_indices=True)
    offset = prob.ctrl_pts[ia, 1:4].T - pts.pos[:, ib]
    pts.pos = pts.pos + offset.mean(axis=1, keepdims=True)

    i, j = s.match_cpt(pts, match="id")
    s.set_cpt(pts, i, j)
    s.clear_eo()
    s.clear_op()

    cp_id = s.op_id[s.is_ctrl]
    rms, fail = resect(s, "all", cp_id, 1, 0, cp_id)
    if fail:
        raise RuntimeError("Resection failed")
    forward_intersect(s, "all", skip_prior=True)

    return bundle(s, damping=damping, trace=trace, dtype=dtype,
                  device=device, **bundle_kw)


def ps_postproc(file_name: str = None, use_semilocal: bool = False,
                min_rays: int = 0, min_angle: float = 0.0,
                damping: str = "gna", trace: bool = False, backend="auto",
                stats_dir: str = None, dtype=torch.float64, device=None,
                **bundle_kw):
    """Re-adjust a PhotoScan/Metashape .psz project
    (ref code/demo/ps_postproc.m).

    Default project: prague2016 sxb.psz. Expected
    (sxb-dbatreport.txt): sigma0 0.710294 (0.0710294 px), 3576 params
    (30 EO, 3546 OP), 8180 obs (8132 IP, 48 OP), 3 iterations.
    """
    device = resolve_device(device)
    if file_name is None:
        file_name = osp.join(REFERENCE_DATA, "prague2016", "sxb",
                             "psprojects", "sxb.psz")
    psz = load_psz(file_name)
    prob = psz_to_pm(psz, use_semilocal=use_semilocal)
    s = from_pm(prob)
    s.dist_model = -1

    stem = osp.splitext(osp.basename(file_name))[0]
    if stats_dir:
        write_stats(s, osp.join(stats_dir, f"{stem}-psstats-prefilt.txt"),
                    "Initial, unfiltered statitistics")

    # Ray-count / intersection-angle OP filtering (loadplotpsz.m:55-80).
    if min_rays > 0 or min_angle > 0:
        bad = np.zeros(s.n_op, dtype=bool)
        if min_rays > 0:
            bad |= (ray_counts(s) < min_rays) & ~s.is_ctrl
        if min_angle > 0:
            ang = point_angles(s) * 180 / np.pi
            bad |= (ang < min_angle) & ~s.is_ctrl
        ids2remove = s.op_id[bad]
        prob.obj_pts = prob.obj_pts[
            ~np.isin(prob.obj_pts[:, 0], ids2remove)
        ]
        prob.mark_pts = prob.mark_pts[
            ~np.isin(prob.mark_pts[:, 1], ids2remove)
        ]
        s = from_pm(prob)
        s.dist_model = -1

    if stats_dir:
        write_stats(
            s, osp.join(stats_dir, f"{stem}-psstats-postfilt.txt"),
            f"Filtered statitistics with minRays={min_rays}, "
            f"minAngle={min_angle:g}",
        )

    # Self-calibration flags per PS project (ps_postproc.m:44-66).
    if psz.camera.is_adjusted:
        g, o = psz.camera.given_params, psz.camera.optimized_params
        s.set_cam_est("not", "all")
        if g.get("f") or o.get("f"):
            s.set_cam_est("cc")
        if g.get("cxcy") or o.get("cxcy"):
            s.set_cam_est("px", "py")
        for i in range(3):
            if g["k"][i] or o["k"][i]:
                s.set_cam_est(f"K{i+1}")
        for i in range(2):
            if g["p"][i] or o["p"][i]:
                s.set_cam_est(f"P{i+1}")

    return bundle(s, damping=damping, trace=trace, dtype=dtype,
                  backend=backend, device=device, **bundle_kw)


def sxb_prior_eo(use_prior_eo: bool = True, damping: str = "gna",
                 trace: bool = False, dtype=torch.float64, device=None,
                 **bundle_kw):
    """Prior-EO observation demo (ref code/demo/sxb_prior_eo.m).

    wsmart-with-orient network with weighted CPs; optionally adds prior
    camera positions from fake-camera-positions.txt (accuracy 5 cm).
    Expected: sigma0 1.07447 without prior EO, 1.06942 with (12 EO
    prior observations), both in 4 iterations
    (sxb-{no-,}prior-eo-dbatreport.txt).
    """
    device = resolve_device(device)
    input_dir = osp.join(REFERENCE_DATA, "prague2016", "sxb")
    prob = load_pm(
        osp.join(input_dir, "pmexports", "wsmart-with-orient-pmexport.txt")
    )
    s = from_pm(prob)
    s.set_cam_vals_loaded()
    s.set_cam_est("not", "all")

    pts = load_cpt(osp.join(input_dir, "ref", "ctrlpts-weighted.txt"))
    i, j = s.match_cpt(pts, match="id")
    s.set_cpt(pts, i, j)

    if use_prior_eo:
        tbl = legacy_load_eo_table(
            osp.join(input_dir, "ref", "fake-camera-positions.txt"),
            has=(False, True),
        )
        i, j = s.match_eo(tbl)
        s.set_prior_eo(tbl, i, j)

    s.clear_eo()
    s.clear_op()
    cp_id = s.op_id[s.is_ctrl]
    rms, fail = resect(s, "all", cp_id, 1, 0, cp_id)
    if fail:
        raise RuntimeError("Resection failed")
    forward_intersect(s, "all", skip_prior=True)

    return bundle(s, damping=damping, trace=trace, dtype=dtype,
                  device=device, **bundle_kw)
