"""XML script pipeline runner (ref code/script/rundbatscript.m;
counterpart of dbat_tpu/pipeline/script.py).

Executes DBAT script documents (dbat_script_version 1.0): meta + input
(cameras/images/image_pts/ctrl_pts/check_pts/prior_eo with
$HERE/$DBAT/$HOME path macros) + operations (check_ray_count,
set_initial_values, set_bundle_estimate_params, set_datum,
spatial_resection, forward_intersection, pose_graph_init,
prune_by_reprojection, bundle_adjustment) + output (report/io/eo/
image_residuals files).

Besides DBAT's <image_pts> tables, the input may be <features>: the
images themselves, detected, described and matched on `device`
(features/), with tracks built on the host.  The output may add
<plots> (plotting/, matplotlib) after the files; a plot that fails
warns and never fails the script.

The input tables, the operations and the writers are host numpy.  The
bundle runs in float64 on `device` (default: the CUDA card; without one
it raises unless the caller passes device="cpu"), and the posterior
covariances of the report, the EO file and the statistics plots run
where the bundle's ops live.
"""

from __future__ import annotations

import os
import os.path as osp
import time
import warnings
import xml.etree.ElementTree as ET

import numpy as np
import torch

from ..core.project import prune_network
from ..device import resolve_device
from ..features.pipeline import load_images, network_from_images
from ..geometry.initvals import forward_intersect, resect
from ..geometry.posegraph import init_from_pose_graph
from ..geometry.quality import ray_counts, reprojection_residuals_px
from ..io.eotable import load_eo_table
from ..io.report import write_report
from ..io.tables import filter_ctrl_pts, load_ctrl_pts, load_image_pts, \
    load_image_table
from ..io.writers import write_eo_file, write_top_residuals
from ..solve.bundle import bundle
from ..solve.covariance import Covariance
from .camera_spec import load_cameras_xml, parse_camera_element, \
    write_camera_xml
from .project_build import project_from_tables

#: Environment variable naming the DBAT installation root that $DBAT
#: stands for in a script's paths (image tables use paths like
#: data/dbat/images/...).
DBAT_ROOT_ENV = "DBAT_ROOT"


class ScriptResult:
    def __init__(self):
        self.project = None
        self.info = None
        self.ok = None
        self.sigma0 = None
        self.iters = None
        self.outputs = []
        #: host seconds per stage: "input" (with the <features> input
        #: also "load_images", "detect", "describe", "match" and
        #: "tracks" within it), each operation by name (summed when
        #: repeated), each output file by its tag, and "plots"
        self.times = {}


def _resolve(path, base_dir, doc_dir):
    if "$DBAT" in path:
        root = os.environ.get(DBAT_ROOT_ENV)
        if not root:
            raise ValueError(f"{path!r} uses $DBAT; set {DBAT_ROOT_ENV} to "
                             "the DBAT installation root")
        path = path.replace("$DBAT", root)
    path = path.replace("$HERE", doc_dir)
    path = path.replace("$HOME", os.path.expanduser("~"))
    if osp.isabs(path):
        return path
    return osp.join(base_dir, path) if base_dir else path


def _base_dir(el, doc_dir, attr="base_dir"):
    raw = el.get(attr, "")
    return _resolve(raw, "", doc_dir) if raw else doc_dir


def _op_name(op):
    """An <operation>'s name, and the element that holds its settings."""
    children = [c for c in op if c.tag != "c"]
    if children:
        return children[0].tag, children[0]
    return (op.text or "").strip(), op


def run_script(xml_path: str, damping: str = "gna", trace: bool = False,
               backend: str = "auto", write_outputs: bool = True,
               output_dir: str = None, device=None) -> ScriptResult:
    """Run a DBAT script; returns a ScriptResult (project, bundle info,
    ok, sigma0, iters, the files written and the time of each stage).
    `device`: where the f64 bundle and the covariances run (default:
    the card)."""
    device = resolve_device(device)
    t_input = time.perf_counter()
    doc_dir = osp.dirname(osp.abspath(xml_path))
    doc = ET.parse(xml_path).getroot()
    version = doc.get("dbat_script_version", "")
    if version and not version.startswith("1."):
        raise ValueError(f"Unsupported dbat_script_version {version}")
    ops = doc.find("operations").findall("operation")
    out = doc.find("output")

    res = ScriptResult()

    # ----- input ------------------------------------------------------
    inp = doc.find("input")
    base = _base_dir(inp, doc_dir)

    cams_el = inp.find("cameras")
    cameras = []
    for c in cams_el.findall("camera"):
        cameras.append(parse_camera_element(c))
    for f in cams_el.findall("file"):
        cameras.extend(
            load_cameras_xml(_resolve(f.text.strip(), base, doc_dir)))

    ims_el = inp.find("images")
    im_base = _base_dir(ims_el, doc_dir, "image_base_dir")
    f = ims_el.find("file")
    image_ids, image_paths = load_image_table(
        _resolve(f.text.strip(), base, doc_dir), f.get("format", "id,path")
    )
    image_paths = [_resolve(p, im_base, doc_dir) for p in image_paths]

    pts_el = inp.find("image_pts")
    feat_el = inp.find("features")
    if pts_el is None and feat_el is None:
        raise ValueError("input needs <image_pts> or <features>")
    if pts_el is not None and feat_el is not None:
        raise ValueError(
            "input has BOTH <image_pts> and <features>; measurements "
            "would silently lose to detector output — remove one")
    if pts_el is not None:
        pts_rows = []
        for f in pts_el.findall("file"):
            default_sxy = float(f.get("sxy", "nan"))
            pts_rows.append(load_image_pts(
                _resolve(f.text.strip(), base, doc_dir),
                f.get("format", "im,id,x,y,sxy"), default_sxy,
            ))
        image_pts = np.concatenate(pts_rows, axis=0)

    def load_pts_section(el):
        f = el.find("file")
        pts = load_ctrl_pts(_resolve(f.text.strip(), base, doc_dir),
                            f.get("format", "id,label,x,y,z"))
        flt = el.find("filter")
        if flt is not None:
            ids = [int(t) for t in flt.get("id", "").split(",") if t]
            pts = filter_ctrl_pts(pts, ids, flt.text.strip())
        return pts

    ctrl = None
    if inp.find("ctrl_pts") is not None:
        ctrl = load_pts_section(inp.find("ctrl_pts"))
    check = None
    if inp.find("check_pts") is not None:
        check = load_pts_section(inp.find("check_pts"))

    prior_eo = None
    if inp.find("prior_eo") is not None:
        f = inp.find("prior_eo").find("file")
        prior_eo = load_eo_table(_resolve(f.text.strip(), base, doc_dir),
                                 f.get("format"))

    meta = doc.find("meta")
    title = ""
    if meta is not None and meta.find("name") is not None:
        title = meta.find("name").text.strip()

    if feat_el is not None:
        # From-pixels input (no DBAT analog: loadpm.m/loadpsz.m stop at
        # measurement-file import): detect, describe and match the
        # images, build tracks and assemble the measured network.  EO/OP
        # start NaN-poisoned; the pose_graph_init (or spatial_resection)
        # operation initializes them.
        if ctrl is not None or check is not None:
            raise ValueError(
                "<features> input has no point ids to match "
                "ctrl_pts/check_pts against; use set_datum or fix "
                "tracks by id downstream")
        cam0 = cameras[0]
        t = time.perf_counter()
        imgs = load_images(image_paths)
        res.times["load_images"] = time.perf_counter() - t
        if feat_el.get("invert", "no") == "yes":
            imgs = imgs.max() - imgs  # dark targets on light background
        extra_kw = {}
        if feat_el.get("sigma"):
            extra_kw["sigma"] = float(feat_el.get("sigma"))
        if feat_el.get("min_distance"):
            extra_kw["min_distance"] = int(feat_el.get("min_distance"))
        if feat_el.get("refine_radius"):
            extra_kw["refine_radius"] = int(feat_el.get("refine_radius"))
        s, extras = network_from_images(
            imgs,
            focal=cam0.camera_constant,
            sensor=tuple(cam0.eval_sensor()),
            detector=feat_el.get("detector", "blob"),
            max_kp=int(feat_el.get("max_kp", "512")),
            min_views=int(feat_el.get("min_views", "2")),
            ratio=float(feat_el.get("ratio", "0.9")),
            ip_std_px=float(feat_el.get("sxy", "0.1")),
            device=device,
            **extra_kw,
        )
        res.times.update(extras["times"])
        s.title = title
        s.file_name = xml_path
        s.img_names = list(image_paths)
        s.img_labels = [osp.basename(p) for p in image_paths]
        s.img_ids = np.asarray(image_ids)
    else:
        s = project_from_tables(
            cameras, image_ids, image_paths, image_pts,
            ctrl_pts=ctrl, check_pts=check, title=title,
            file_name=xml_path,
        )
    if prior_eo is not None:
        # Script prior_eo supplies initial values only
        # (parseinput.m:89-93): no observation/est changes.
        i, j = s.match_eo(prior_eo, match="id")
        s.prior_eo_val[i, 0:3] = prior_eo.pos[:, j].T
        s.prior_eo_val[i, 3:6] = prior_eo.ang[:, j].T
        s.prior_eo_std[i, 0:3] = prior_eo.std[:, j].T
        s.prior_eo_std[i, 3:6] = prior_eo.ang_std[:, j].T
        s.eo_file = prior_eo.file_name
    res.times["input"] = time.perf_counter() - t_input

    # ----- operations -------------------------------------------------
    bundle_out = None
    for op in ops:
        name, el = _op_name(op)
        t_op = time.perf_counter()

        if name == "check_ray_count":
            min_rays = int(op.get("min_rays", "2"))
            rays = ray_counts(s)
            bad = (rays < min_rays) & ~s.is_ctrl
            if bad.any():
                raise ValueError(
                    f"Ray count test failed for OP ids "
                    f"{s.op_id[bad].tolist()}"
                )
        elif name == "set_initial_values":
            _set_initial_values(s, el, cameras)
        elif name == "set_bundle_estimate_params":
            _set_est_params(s, el)
        elif name == "set_datum":
            if (el.text or "").strip() == "depend":
                ref_cam = int(el.get("ref_cam", "1")) - 1
                s.set_eo_est_depend(ref_cam)
        elif name == "spatial_resection":
            cp_id = s.op_id[s.is_ctrl]
            rms, fail = resect(s, "all", cp_id, 1, 0, cp_id)
            if fail:
                raise RuntimeError("Resection failed")
        elif name == "forward_intersection":
            forward_intersect(s, "all", skip_prior=True)
        elif name == "pose_graph_init":
            # Extension beyond DBAT's op set: EO/OP from measurements
            # alone (essential RANSAC + rotation averaging + center
            # recovery, geometry/posegraph.py) — covers networks with
            # too few/no control points for spatial_resection.
            init_from_pose_graph(
                s,
                min_shared=int(el.get("min_shared", "12")),
                ransac_iters=int(el.get("ransac_iters", "100")),
                max_pairs_per_cam=int(el.get("max_pairs_per_cam", "8")),
            )
        elif name == "prune_by_reprojection":
            # Geometric outlier screening (extension op): drop
            # observations whose reprojection residual at the current
            # values exceeds max_px, drop points left with < min_views
            # rays, re-triangulate.
            max_px = float(el.get("max_px", "3.0"))
            min_views = int(el.get("min_views", "2"))
            res_px = reprojection_residuals_px(s)
            stats = prune_network(s, keep_obs=res_px < max_px,
                                  min_views=min_views)
            est_ids = s.op_id[s.est_op.any(axis=1)]
            forward_intersect(s, ids=est_ids, skip_prior=True)
            res.outputs.append(
                ("prune_by_reprojection", stats["n_obs_removed"]))
        elif name == "bundle_adjustment":
            _p, ok, iters, sigma0, info = bundle(
                s, damping=damping, trace=trace, dtype=torch.float64,
                backend=backend, device=device,
            )
            res.ok, res.iters, res.sigma0, res.info = ok, iters, sigma0, info
            bundle_out = info
        else:
            raise ValueError(f"Unknown operation {name!r}")
        res.times[name] = (res.times.get(name, 0.0)
                           + time.perf_counter() - t_op)

    res.project = s

    # ----- output -----------------------------------------------------
    if write_outputs and out is not None and bundle_out is not None:
        files = out.find("files")
        if files is not None:
            fbase = output_dir or _base_dir(files, doc_dir)
            res.outputs = _write_outputs(s, bundle_out, files, fbase,
                                         doc_dir, xml_path, damping,
                                         res.times)
        plots = out.find("plots")
        if plots is not None and (output_dir or files is not None):
            t = time.perf_counter()
            pbase = output_dir or _base_dir(files, doc_dir)
            res.outputs += _write_plots(s, bundle_out, plots, pbase)
            res.times["plots"] = time.perf_counter() - t
    return res


def _write_plots(s, info, plots, base):
    """<plots> section -> PNG files (parseoutput.m plot dispatch).  A plot
    that fails warns: plots never fail the pipeline."""
    from .. import plotting

    written = []
    pdir = osp.join(base, "plots")
    os.makedirs(pdir, exist_ok=True)
    for pl in plots.findall("plot"):
        kind = (pl.text or "").strip()
        path = osp.join(pdir, f"{kind}.png")
        try:
            if kind == "image":
                img_id = int(pl.get("id", "1")) - 1
                plotting.plot_images(s, img_id, save=path)
            elif kind == "image_stats":
                plotting.plot_image_stats(s, info, save=path)
            elif kind == "op_stats":
                plotting.plot_op_stats(
                    s, info, max_op=int(pl.get("max_op", "1000")), save=path
                )
            elif kind == "coverage":
                plotting.plot_coverage(
                    s, convex_hull=pl.get("convex_hull", "") == "true",
                    save=path,
                )
            elif kind == "params":
                plotting.plot_params(s, info, save=path)
            elif kind == "iteration_trace":
                plotting.plot_network(
                    s, info, iteration=-1,
                    cam_size=float(pl.get("cam_size", "0.1")), save=path,
                )
            else:
                continue
            written.append(path)
        except Exception as e:  # plots must never fail the pipeline
            warnings.warn(f"plot {kind} failed: {e}")
    return written


def _set_initial_values(s, el, cameras):
    """<set_initial_values> (parsesetinitial{io,eo,op}values.m)."""
    io = el.find("io")
    cam = cameras[0]
    if io is not None:
        items = ([("all", io.text.strip())] if (io.text or "").strip()
                 else [(c.tag, c.text.strip()) for c in io])
        for tag, val in items:
            if tag == "all":
                if val == "loaded":
                    s.set_cam_vals_loaded()
                elif val == "default":
                    s.set_cam_vals_default(cam.focal_length)
            elif tag == "cc":
                s.io[:, 0] = (cam.focal_length
                              if val in ("focal", "default")
                              else (s.prior_io_val[:, 0] if val == "loaded"
                                    else float(val)))
            elif tag == "pp":
                if val == "default":
                    s.io[:, 1] = 0.5 * s.sensor_ss_size[:, 0]
                    s.io[:, 2] = -0.5 * s.sensor_ss_size[:, 1]
                elif val == "loaded":
                    s.io[:, 1:3] = s.prior_io_val[:, 1:3]
                else:
                    pp = [float(x) for x in val.split(",")]
                    s.io[:, 1] = pp[0]
                    s.io[:, 2] = -pp[1]
            elif tag == "aspect":
                s.io[:, 3] = (0.0 if val == "default"
                              else (s.prior_io_val[:, 3] if val == "loaded"
                                    else 1.0 - float(val)))
            elif tag == "skew":
                s.io[:, 4] = (0.0 if val == "default"
                              else (s.prior_io_val[:, 4] if val == "loaded"
                                    else float(val)))
            elif tag in ("K", "P"):
                cols = s._io_param_indices(tag)
                if val == "loaded":
                    s.io[:, cols] = s.prior_io_val[:, cols]
                elif val == "default":
                    s.io[:, cols] = 0.0
                else:
                    vals = [float(x) for x in val.split(",")]
                    s.io[:, cols] = -np.asarray(vals)
    eo = el.find("eo")
    if eo is not None:
        items = ([("all", eo.text.strip())] if (eo.text or "").strip()
                 else [(c.tag, c.text.strip()) for c in eo])
        for tag, val in items:
            if tag == "all" and val == "loaded":
                s.eo[:] = s.prior_eo_val
    op = el.find("op")
    if op is not None:
        items = ([("all", op.text.strip())] if (op.text or "").strip()
                 else [(c.tag, c.text.strip()) for c in op])
        for tag, val in items:
            if tag == "all" and val == "loaded":
                s.op[:] = s.prior_op_val


def _set_est_params(s, el):
    """<set_bundle_estimate_params> (parsesetbundleest{io,eo,op}.m)."""
    io = el.find("io")
    if io is not None:
        items = ([("all", io.text.strip())] if (io.text or "").strip()
                 else [(c.tag, c.text.strip()) for c in io])
        for tag, val in items:
            name = {"aspect": "as", "skew": "sk"}.get(tag, tag)
            if val == "true":
                s.set_cam_est(name)
            elif val == "false":
                s.set_cam_est("not", name)
    eo = el.find("eo")
    if eo is not None:
        items = ([("all", eo.text.strip())] if (eo.text or "").strip()
                 else [(c.tag, c.text.strip()) for c in eo])
        for tag, val in items:
            if val == "true":
                s.set_eo_est(tag)
            elif val == "false":
                s.set_eo_est("not", tag)
    op = el.find("op")
    if op is not None:
        items = ([("all", op.text.strip())] if (op.text or "").strip()
                 else [(c.tag, c.text.strip()) for c in op])
        groups = {"all": [0, 1, 2], "x": [0], "y": [1], "z": [2]}
        for tag, val in items:
            ix = groups[tag]
            if val in ("true", "false"):
                s.est_op[:, ix] = val == "true"
            elif val == "default":
                with np.errstate(invalid="ignore"):
                    default = (~s.is_ctrl[:, None]) | (
                        np.nan_to_num(s.prior_op_std[:, ix]) != 0
                    )
                s.est_op[:, ix] = default


def _write_outputs(s, info, files, fbase, doc_dir, xml_path, damping,
                   times):
    written = []

    def outpath(el):
        p = el.find("file").text.strip()
        p = p.replace("$HERE", doc_dir)
        full = p if osp.isabs(p) else osp.join(fbase, p)
        os.makedirs(osp.dirname(full), exist_ok=True)
        return full

    rep = files.find("report")
    if rep is not None:
        t = time.perf_counter()
        path = outpath(rep)
        write_report(s, info, path, damping=damping)
        written.append(path)
        times["report"] = time.perf_counter() - t
    io_el = files.find("io")
    if io_el is not None:
        t = time.perf_counter()
        path = outpath(io_el)
        write_camera_xml(path, s)
        written.append(path)
        times["io"] = time.perf_counter() - t
    eo_el = files.find("eo")
    if eo_el is not None:
        t = time.perf_counter()
        path = outpath(eo_el)
        cov = Covariance(s, info).factorize()
        _, std_eo, _ = cov.posterior_std()
        write_eo_file(path, s, std_eo, script_name=xml_path)
        written.append(path)
        times["eo"] = time.perf_counter() - t
    res_el = files.find("image_residuals")
    if res_el is not None:
        t = time.perf_counter()
        path = outpath(res_el)
        write_top_residuals(path, s, int(res_el.get("top_count", "50")),
                            script_name=xml_path)
        written.append(path)
        times["image_residuals"] = time.perf_counter() - t
    return written
