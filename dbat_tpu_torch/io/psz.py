"""PhotoScan/Metashape .psz project loader and writer (ref
code/file/loadpsz.m; a numpy copy of dbat_tpu/io/psz.py).

A .psz is a zip holding doc.xml plus PLY point clouds:
  * chunk/sensors: calibration (fx,fy,cx,cy,k*,p*,skew/b2), pixel size;
  * chunk/cameras: 4x4 camera-to-world transforms;
  * chunk/markers: control points with reference positions/accuracies;
  * chunk/frames/frame: image paths, pinned marker image measurements,
    and the tie-point cloud (points0.ply + per-camera projections);
  * chunk/transform: local->global rotation/translation/scale;
  * chunk/settings: default accuracies.

Conventions mirrored from loadpsz.m:
  * P = eye(3,4) @ inv(T_cam @ diag(1,-1,-1,1)) — PhotoScan cameras
    look down +z; DBAT's model divides by negative depth (loadpsz.m:150-158).
  * Coordinate frames: local (PS internal), semilocal (scaled+shifted,
    no rotation), global (georeferenced): L2G = T@S@R (loadpsz.m:105-120).
  * Camera calibration -> physical units: focal = fx*pixelWidth,
    K_pm = -k * focal^(-2i), P_pm = [-p2/f, p1/f] (loadpsz.m:648-661).
  * Id remapping: DBAT ctrl ids = 1..nMarkers (marker list order);
    DBAT object ids = PS track id + 1 + nMarkers (loadpsz.m:300-320).
"""

from __future__ import annotations

import os.path as osp
import tempfile
import zipfile
from dataclasses import dataclass, field

import numpy as np

from ..models.rotation import decompose_w2c_np, w2c_from_angles_np
from .ply import ply_read, ply_write
from .pm import PmImage, PmProject


def _floats(s):
    return np.array([float(t) for t in s.split()], dtype=np.float64)


@dataclass
class PszCamera:
    name: str = ""
    type: str = "frame"
    im_size: np.ndarray = None
    pixel_size: np.ndarray = None
    sensor_format: np.ndarray = None
    focal: float = np.nan
    pp: np.ndarray = None
    k: np.ndarray = None  # PM-convention radial coeffs
    p: np.ndarray = None  # PM-convention tangential coeffs
    is_fixed: bool = True
    is_adjusted: bool = False
    nominal_focal: float = np.nan
    given_params: dict = field(default_factory=dict)
    optimized_params: dict = field(default_factory=dict)


@dataclass
class PszProject:
    file_name: str
    version: str
    camera: PszCamera
    def_std: dict
    # transforms (4x4)
    L2G: np.ndarray = None
    G2L: np.ndarray = None
    G2SL: np.ndarray = None
    L2SL: np.ndarray = None
    # per kept camera
    camera_ids: np.ndarray = None
    camera_labels: list = None
    im_names: list = None
    local_P: np.ndarray = None  # (n,3,4) world->cam in local frame
    local_CC: np.ndarray = None  # (n,3)
    prior_cam_pos: np.ndarray = None  # (n,3) global, NaN if absent
    prior_cam_std: np.ndarray = None
    # control points (PS markers), global frame
    ctrl_ids_raw: np.ndarray = None
    ctrl_labels: list = None
    ctrl_pos: np.ndarray = None  # (m,3)
    ctrl_std: np.ndarray = None
    ctrl_enabled: np.ndarray = None
    # tie points, local frame: [id,x,y,z]
    obj_pts: np.ndarray = None
    # mark points [dbat_cam(1-based), dbat_id, x, y]
    ctrl_marks: np.ndarray = None
    obj_marks: np.ndarray = None

    def frame_pts(self, which: str, pts_local):
        """Transform local points (n,3) to 'local'/'semilocal'/'global'."""
        M = {"local": np.eye(4), "semilocal": self.L2SL,
             "global": self.L2G}[which]
        q = (M[:3, :3] @ pts_local.T + M[:3, 3:4]).T
        return q


def load_psz(path: str, chunk_no: int = 0, keep_unoriented: bool = False
             ) -> PszProject:
    with tempfile.TemporaryDirectory() as tmp:
        with zipfile.ZipFile(path) as z:
            z.extractall(tmp)
        return _parse(path, tmp, chunk_no, keep_unoriented)


def _parse(path, tmp, chunk_no, keep_unoriented):
    import xml.etree.ElementTree as ET

    doc = ET.parse(osp.join(tmp, "doc.xml")).getroot()
    version = doc.get("version", "0.0.0")
    chunks = doc.find("chunks").findall("chunk")
    chnk = chunks[chunk_no]

    # Default accuracies (loadpsz.m getdefstd).
    def_std = {"tiePoints": np.nan, "projections": np.nan,
               "markers": np.nan, "camPos": np.nan, "camAng": np.nan,
               "scaleBars": np.nan}
    tbl = {"tiepoints": "tiePoints", "cameras": "camPos",
           "cameras_ypr": "camAng", "markers": "markers",
           "scalebars": "scaleBars", "projections": "projections"}
    settings = chnk.find("settings")
    if settings is not None:
        for prop in settings.findall("property"):
            nm = prop.get("name", "")
            if nm.startswith("accuracy_") and nm[9:] in tbl:
                def_std[tbl[nm[9:]]] = float(prop.get("value"))

    # local->global transform.
    R = np.eye(4)
    T = np.eye(4)
    S = np.eye(4)
    xf = chnk.find("transform")
    if xf is not None:
        if xf.find("rotation") is not None:
            R[:3, :3] = _floats(xf.find("rotation").text).reshape(3, 3).T
        if xf.find("translation") is not None:
            T[:3, 3] = _floats(xf.find("translation").text)
        if xf.find("scale") is not None:
            S[:3, :3] *= float(xf.find("scale").text)
    L2G = T @ S @ R
    G2L = R.T @ np.linalg.inv(S) @ np.linalg.inv(T)
    G2SL = np.linalg.inv(S) @ np.linalg.inv(T)
    L2SL = R.copy()

    # Cameras.
    cams = chnk.find("cameras").findall("camera")
    cam_ids, labels, sensor_ids, enabled, xforms = [], [], [], [], []
    prior_pos, prior_std = [], []
    for c in cams:
        cam_ids.append(int(c.get("id")))
        labels.append(c.get("label", ""))
        sensor_ids.append(int(c.get("sensor_id", "0")))
        enabled.append(c.get("enabled", "true").lower() in ("true", "1"))
        tr = c.find("transform")
        xforms.append(
            _floats(tr.text).reshape(4, 4) if tr is not None
            else np.full((4, 4), np.nan)
        )
        ref = c.find("reference")
        if ref is not None and ref.get("x") is not None:
            prior_pos.append([float(ref.get(a)) for a in "xyz"])
            sxy = ref.get("sxy")
            sx = float(ref.get("sx", sxy or def_std["camPos"]))
            sy = float(ref.get("sy", sxy or def_std["camPos"]))
            sz = float(ref.get("sz", def_std["camPos"]))
            prior_std.append([sx, sy, sz])
        else:
            prior_pos.append([np.nan] * 3)
            prior_std.append([np.nan] * 3)
    cam_ids = np.array(cam_ids)
    enabled = np.array(enabled)
    xforms = np.array(xforms)

    # World->cam in local frame with PhotoScan axis flip.
    D = np.diag([1.0, -1.0, -1.0, 1.0])
    n = len(cam_ids)
    P = np.full((n, 3, 4), np.nan)
    CC = np.full((n, 3), np.nan)
    for i in range(n):
        if np.isfinite(xforms[i]).all():
            P[i] = np.linalg.inv(xforms[i] @ D)[:3]
            M = np.vstack([P[i], [0, 0, 0, 1.0]])
            Cc = np.linalg.inv(M)[:, 3]
            CC[i] = Cc[:3] / Cc[3]

    oriented = np.isfinite(CC).all(axis=1)
    keep = enabled if keep_unoriented else (enabled & oriented)

    # Sensor calibration.
    sensors = chnk.find("sensors").findall("sensor")
    want = np.unique(np.array(sensor_ids)[keep[: len(sensor_ids)]])
    if len(want) > 1:
        raise NotImplementedError("multiple sensors not supported")
    sensor = [s for s in sensors if int(s.get("id")) == want[0]][0]

    cals = sensor.findall("calibration")
    cal = None
    is_adjusted = False
    for c in cals:
        if c.get("class") == "adjusted":
            cal = c
            is_adjusted = True
            break
    if cal is None:
        cal = cals[0] if cals else None

    def cal_val(tag, default=None):
        e = cal.find(tag) if cal is not None else None
        return float(e.text) if e is not None else default

    pp_absolute = False
    fx = cal_val("fx")
    fy = cal_val("fy")
    if fx is not None or fy is not None:
        pp_absolute = True
    f_single = cal_val("f")
    if f_single is not None:
        pp_absolute = False
        b1 = cal_val("b1", 0.0)
        fy = f_single
        fx = f_single + b1
    cx = cal_val("cx", 0.0)
    cy = cal_val("cy", 0.0)
    k = []
    for i in range(1, 9):
        v = cal_val(f"k{i}")
        if v is None:
            break
        k.append(v)
    p = []
    for i in range(1, 9):
        v = cal_val(f"p{i}")
        if v is None:
            break
        p.append(v)
    skew = cal_val("skew", cal_val("b2", 0.0)) or 0.0

    res = sensor.find("resolution")
    im_sz = np.array([int(res.get("width")), int(res.get("height"))])
    props = {pr.get("name"): pr.get("value")
             for pr in sensor.findall("property")}
    pw = float(props.get("pixel_width", 1.0))
    ph = float(props.get("pixel_height", 1.0))
    if not pp_absolute:
        cx += im_sz[0] / 2
        cy += im_sz[1] / 2

    focal = fx * pw
    cam = PszCamera(
        name=sensor.get("label", ""),
        type=sensor.get("type", "frame"),
        im_size=im_sz,
        pixel_size=np.array([pw, ph]),
        sensor_format=im_sz * np.array([pw, ph]),
        focal=focal,
        pp=np.array([cx * pw, cy * ph]),
        k=-np.array(k) * focal ** (-2.0 * np.arange(1, len(k) + 1)),
        p=(np.array([-p[1] / focal, p[0] / focal] + list(p[2:]))
           if len(p) >= 2 else np.zeros(0)),
        is_fixed=props.get("fixed", "true").lower() in ("true", "1"),
        is_adjusted=is_adjusted,
        nominal_focal=float(props.get("focal_length", np.nan)),
    )
    given = {
        "f": fx is not None, "cxcy": cal_val("cx") is not None,
        "k": [i < len(k) for i in range(4)],
        "p": [i < len(p) for i in range(4)],
        "skew": cal is not None and cal.find("skew") is not None,
    }
    cam.given_params = given

    # optimize/fit_* meta flags (loadpsz.m:683-752).
    opt = {"f": False, "cxcy": False, "k": [False] * 4, "p": [False] * 4,
           "skew": False}
    meta = chnk.find("meta")
    if meta is not None:
        for prop in meta.findall("property"):
            nm = prop.get("name", "")
            if not nm.startswith("optimize/fit_"):
                continue
            val = prop.get("value") == "1"
            pname = nm[len("optimize/fit_"):]
            if pname == "f":
                opt["f"] = val
            elif pname == "cxcy":
                opt["cxcy"] = val
            elif pname.startswith("k") and pname[1:].isdigit():
                opt["k"][int(pname[1:]) - 1] = val
            elif pname.startswith("p") and pname[1:].isdigit():
                opt["p"][int(pname[1:]) - 1] = val
            elif pname == "skew":
                opt["skew"] = val
    cam.optimized_params = opt

    # Markers (control points) in global frame.
    ctrl_ids, ctrl_labels, ctrl_pos, ctrl_std, ctrl_en = [], [], [], [], []
    markers_el = chnk.find("markers")
    markers = markers_el.findall("marker") if markers_el is not None else []
    for m in markers:
        ctrl_ids.append(int(m.get("id")))
        ctrl_labels.append(m.get("label", ""))
        ref = m.find("reference")
        if ref is not None and ref.get("x"):
            pos = [float(ref.get(a)) for a in "xyz"]
            sxy = ref.get("sxy")
            sx = float(ref.get("sx", sxy) or def_std["markers"])
            sy = float(ref.get("sy", sxy) or def_std["markers"])
            sz = float(ref.get("sz") or def_std["markers"])
            en = ref.get("enabled", "true").lower() in ("true", "1")
        else:
            pos, (sx, sy, sz), en = [np.nan] * 3, [np.nan] * 3, False
        ctrl_pos.append(pos)
        ctrl_std.append([sx, sy, sz])
        ctrl_en.append(en)
    ctrl_ids = np.array(ctrl_ids, dtype=int)
    n_cp = len(ctrl_ids)

    # Id remap closures (loadpsz.m:300-320).
    dbat_cam_id = {int(cid): i + 1 for i, cid in enumerate(cam_ids[keep])}
    dbat_cp_id = {int(cid): i + 1 for i, cid in enumerate(ctrl_ids)}

    def dbat_op_id(ps_id):
        return ps_id + 1 + n_cp

    # Frame: image paths, marker measurements, point cloud.
    frame = chnk.find("frames").find("frame")
    im_names = [""] * int(keep.sum())
    fcams = frame.find("cameras")
    if fcams is not None:
        for c in fcams.findall("camera"):
            cid = int(c.get("camera_id"))
            if cid in dbat_cam_id:
                ph_el = c.find("photo")
                pth = ph_el.get("path", "") if ph_el is not None else ""
                if pth and not pth.startswith(("/", "\\")):
                    pth = osp.normpath(
                        osp.join(osp.dirname(path), pth)
                    )
                im_names[dbat_cam_id[cid] - 1] = pth

    ctrl_marks = []
    fmarks = frame.find("markers")
    if fmarks is not None:
        for m in fmarks.findall("marker"):
            mid = int(m.get("marker_id"))
            for loc in m.findall("location"):
                cid = int(loc.get("camera_id"))
                if cid in dbat_cam_id and mid in dbat_cp_id:
                    ctrl_marks.append([
                        dbat_cam_id[cid], dbat_cp_id[mid],
                        float(loc.get("x")), float(loc.get("y")),
                    ])
    ctrl_marks = (np.array(ctrl_marks) if ctrl_marks
                  else np.zeros((0, 4)))

    pc = frame.find("point_cloud")
    obj_pts = np.zeros((0, 4))
    obj_marks = np.zeros((0, 4))
    if pc is not None:
        pts_el = pc.find("points")
        if pts_el is not None and pts_el.get("path"):
            ply = ply_read(osp.join(tmp, pts_el.get("path")))
            v = ply["vertex"]
            obj_pts = np.stack(
                [dbat_op_id(v["id"].astype(np.int64)),
                 v["x"], v["y"], v["z"]], axis=1,
            )
        rows = []
        for pr in pc.findall("projections"):
            cid = int(pr.get("camera_id"))
            if cid not in dbat_cam_id:
                continue
            ply = ply_read(osp.join(tmp, pr.get("path")))
            v = ply["vertex"]
            m = len(v["id"])
            rows.append(np.stack(
                [np.full(m, dbat_cam_id[cid]),
                 dbat_op_id(v["id"].astype(np.int64)), v["x"], v["y"]],
                axis=1,
            ))
        if rows:
            obj_marks = np.concatenate(rows, axis=0)

    return PszProject(
        file_name=path,
        version=version,
        camera=cam,
        def_std=def_std,
        L2G=L2G, G2L=G2L, G2SL=G2SL, L2SL=L2SL,
        camera_ids=cam_ids[keep],
        camera_labels=[l for l, k2 in zip(labels, keep) if k2],
        im_names=im_names,
        local_P=P[keep],
        local_CC=CC[keep],
        prior_cam_pos=np.array(prior_pos)[keep],
        prior_cam_std=np.array(prior_std)[keep],
        ctrl_ids_raw=ctrl_ids,
        ctrl_labels=ctrl_labels,
        ctrl_pos=np.array(ctrl_pos).reshape(-1, 3),
        ctrl_std=np.array(ctrl_std).reshape(-1, 3),
        ctrl_enabled=np.array(ctrl_en, dtype=bool),
        obj_pts=obj_pts,
        ctrl_marks=ctrl_marks,
        obj_marks=obj_marks,
    )


def psz_to_pm(psz: PszProject, use_semilocal: bool = False) -> PmProject:
    """PhotoScan -> PhotoModeler-style problem (ref code/misc/ps2pmstruct.m).

    Builds the prob in the global (or semilocal) frame with DBAT ids.
    """
    cam = psz.camera
    k13 = np.zeros(3)
    k13[: min(3, len(cam.k))] = cam.k[:3]
    p12 = np.zeros(2)
    p12[: min(2, len(cam.p))] = cam.p[:2]
    def_cam = np.concatenate(
        [[cam.focal], cam.pp, cam.sensor_format, k13, p12]
    )

    M = psz.L2SL if use_semilocal else psz.L2G

    n = len(psz.camera_ids)
    images = []
    for i in range(n):
        # P in target frame: P_local @ inv(M); R normalized by det^(1/3).
        Pt = psz.local_P[i] @ np.linalg.inv(M)
        Rm = Pt[:, :3]
        Rm = Rm / np.linalg.det(Rm) ** (1.0 / 3.0)
        ang = decompose_w2c_np(Rm)
        CC = (M[:3, :3] @ psz.local_CC[i] + M[:3, 3])
        outer = np.concatenate([CC, ang[[2, 1, 0]] * 180 / np.pi])
        images.append(PmImage(
            name=psz.im_names[i], outer=outer,
            outer_std=np.zeros(6), outer_cov=np.full(3, np.nan),
            inner=def_cam.copy(), inner_std=np.zeros(10),
            im_size=cam.im_size.astype(float), id=int(psz.camera_ids[i]),
            label=psz.camera_labels[i],
        ))

    # Control/check points: transform global -> target frame.
    Mg = psz.G2SL if use_semilocal else np.eye(4)
    cp_pos = (Mg[:3, :3] @ psz.ctrl_pos.T + Mg[:3, 3:4]).T
    Rg = Mg[:3, :3]
    # std transform: diag(R diag(v) R')_a = sum_b R[a,b]^2 v[b]
    cp_std = np.sqrt(psz.ctrl_std**2 @ (Rg**2).T)
    dbat_cp = np.arange(1, len(psz.ctrl_ids_raw) + 1)
    en = psz.ctrl_enabled
    ctrl = np.concatenate(
        [dbat_cp[en, None], cp_pos[en], cp_std[en]], axis=1
    ) if en.any() else np.zeros((0, 7))
    # Check points: disabled markers with >=2 measurements.
    chk_rows = []
    for i in np.flatnonzero(~en):
        if (psz.ctrl_marks[:, 1] == dbat_cp[i]).sum() >= 2:
            chk_rows.append(np.concatenate(
                [[dbat_cp[i]], cp_pos[i], cp_std[i]]
            ))
    check = np.array(chk_rows) if chk_rows else np.zeros((0, 7))

    # Object points local -> target frame.
    op = psz.obj_pts
    op_xyz = (M[:3, :3] @ op[:, 1:4].T + M[:3, 3:4]).T if len(op) else op[:, 1:4]
    obj = np.concatenate(
        [np.concatenate([ctrl, check], axis=0),
         np.concatenate([op[:, :1], op_xyz,
                         np.full((len(op), 3), np.nan)], axis=1)],
        axis=0,
    )

    ctrl_std_px = psz.def_std["projections"]
    tie_std_px = psz.def_std["tiePoints"]
    mark_rows = [
        np.concatenate(
            [psz.ctrl_marks,
             np.full((len(psz.ctrl_marks), 2), ctrl_std_px)], axis=1,
        ),
        np.concatenate(
            [psz.obj_marks,
             np.full((len(psz.obj_marks), 2), tie_std_px)], axis=1,
        ),
    ]
    marks = np.concatenate(mark_rows, axis=0)
    order = np.lexsort((marks[:, 1], marks[:, 0]))
    marks = marks[order]
    keep = np.isin(marks[:, 1], obj[:, 0])
    marks = marks[keep]
    marks[:, 0] -= 1  # prob convention: 0-based image numbers

    # Prior camera positions.
    has_prior = np.isfinite(psz.prior_cam_pos).all(axis=1)
    prior_cam = np.concatenate(
        [psz.camera_ids[has_prior, None],
         psz.prior_cam_pos[has_prior], psz.prior_cam_std[has_prior]],
        axis=1,
    ) if has_prior.any() else np.zeros((0, 7))

    return PmProject(
        file_name=psz.file_name,
        title="Photoscan import",
        tol=np.nan, max_iter=np.nan,
        def_std=np.zeros(9),
        def_cam=def_cam,
        def_cam_std=np.zeros(10),
        im_size=cam.im_size.astype(float),
        images=images,
        ctrl_pts=ctrl,
        check_pts=check,
        obj_pts=obj,
        mark_pts=marks,
        prior_cam_pos=prior_cam,
        op_labels_by_id={
            int(dbat_cp[i]): psz.ctrl_labels[i]
            for i in range(len(psz.ctrl_ids_raw))
        },
    )


def write_psz(path: str, s, tie_acc_px: float = 1.0,
              proj_acc_px: float = 0.1, marker_acc: float = 0.005,
              L2G=None):
    """Write a Project as a PhotoScan/Metashape .psz archive — the
    exact inverse of load_psz (zip with doc.xml + points0.ply +
    per-camera projections*.ply; element layout mirrored from the
    shipped sxb.psz; conventions inverted from loadpsz.m):

      * camera transforms: X = inv([P; e4]) @ diag(1,-1,-1,1) with
        P the DBAT world->cam matrix (loadpsz.m:150-158 inverted);
      * calibration: f = cc/pixel_width (px), cx/cy center-relative,
        k_i = K_display_i * focal^(2i), p1 = -P2_display*f,
        p2 = P1_display*f (loadpsz.m:648-661 inverted; display = PM
        sign convention = negated internal io);
      * markers = control points (reference = prior value/std, global
        frame); tie points = remaining OPs with fresh 0-based track
        ids; measurements split into pinned marker locations and
        projection PLYs (px, f32).

    `L2G` (4x4 similarity): when given, cameras and tie points are
    written in the LOCAL frame local = inv(L2G) @ global and the
    chunk transform element carries L2G = T@S@R — exercising the
    loader's frame chain for real.  Requires a single shared camera.

    Built for round-trip testing at C5 scale (the real stpierre C5.psz
    is not shipped) but is a full writer: any single-sensor project
    exports.
    """
    import io as io_mod

    n_img = s.n_img

    def fr(v):
        return repr(float(v))

    W, H = int(s.sensor_im_size[0, 0]), int(s.sensor_im_size[0, 1])
    # True per-axis pixel sizes: the x/y scale difference (the 'as'
    # parameter) travels as pixel_width != pixel_height — from_pm
    # recovers aspect = 1 - pxw/pxh from the sensor format
    # (project.py from_pm; solver px sizes collapse to y afterwards).
    if s.sensor_ss_size is not None:
        pw = float(s.sensor_ss_size[0, 0]) / W
        ph = float(s.sensor_ss_size[0, 1]) / H
    else:
        pw = float(s.sensor_px_size[0, 0])
        ph = float(s.sensor_px_size[0, 1])
    io0 = np.asarray(s.io[0], np.float64)
    f_px = io0[0] / pw
    cx_rel = io0[1] / pw - W / 2.0
    cy_rel = (-io0[2]) / ph - H / 2.0
    nK, nP = s.nK, s.nP
    K_disp = -io0[5:5 + nK]
    P_disp = -io0[5 + nK:5 + nK + nP]
    focal = io0[0]
    k_ps = [float(-K_disp[i] * focal ** (2 * (i + 1)))
            for i in range(nK)]
    p_ps = ([float(P_disp[1] * focal), float(-P_disp[0] * focal)]
            if nP >= 2 else [])

    if L2G is None:
        L2G = np.eye(4)
    G2L = np.linalg.inv(L2G)
    # T@S@R decomposition for the transform element.
    A = L2G[:3, :3]
    scale = float(np.cbrt(np.linalg.det(A)))
    R_l2g = A / scale
    t_l2g = L2G[:3, 3]

    D = np.diag([1.0, -1.0, -1.0, 1.0])
    e4 = np.array([[0.0, 0.0, 0.0, 1.0]])

    X = []
    for i in range(n_img):
        R = w2c_from_angles_np(np.asarray(s.eo[i, 3:6], np.float64))[0]
        C = np.asarray(s.eo[i, 0:3], np.float64)
        P_g = np.concatenate([R, (-R @ C)[:, None]], axis=1)
        P_l = P_g @ L2G
        X.append(np.linalg.inv(np.concatenate([P_l, e4], axis=0)) @ D)

    is_ctrl = np.asarray(s.is_ctrl, bool)
    ctrl_idx = np.flatnonzero(is_ctrl)
    tie_idx = np.flatnonzero(~is_ctrl)
    ps_id_of = {int(j): k for k, j in enumerate(tie_idx)}
    obs_img = np.asarray(s.obs_img)
    obs_pt = np.asarray(s.obs_pt)
    ip = np.asarray(s.ip_px, np.float64)

    x = []
    a = x.append
    a('<?xml version="1.0" encoding="UTF-8"?>')
    a('<document version="1.2.0">')
    a('  <chunks next_id="1">')
    a('    <chunk id="0" label="Chunk 1" enabled="true">')
    a('      <sensors next_id="1">')
    a('        <sensor id="0" label="synthetic" type="frame">')
    a(f'          <resolution width="{W}" height="{H}"/>')
    a(f'          <property name="pixel_width" value="{fr(pw)}"/>')
    a(f'          <property name="pixel_height" value="{fr(ph)}"/>')
    a(f'          <property name="focal_length" value="{fr(focal)}"/>')
    a('          <property name="fixed" value="true"/>')
    a('          <calibration type="frame" class="adjusted">')
    a(f'            <resolution width="{W}" height="{H}"/>')
    a(f'            <f>{fr(f_px)}</f>')
    a(f'            <cx>{fr(cx_rel)}</cx>')
    a(f'            <cy>{fr(cy_rel)}</cy>')
    for i, kv in enumerate(k_ps):
        if kv != 0.0:
            a(f'            <k{i+1}>{fr(kv)}</k{i+1}>')
    for i, pv in enumerate(p_ps):
        if pv != 0.0:
            a(f'            <p{i+1}>{fr(pv)}</p{i+1}>')
    a('          </calibration>')
    a('        </sensor>')
    a('      </sensors>')
    a(f'      <cameras next_id="{n_img}">')
    for i in range(n_img):
        a(f'        <camera id="{i}" label="img{i:04d}.jpg" '
          'sensor_id="0" enabled="true">')
        a('          <transform>'
          + " ".join(f"{v:.16e}" for v in X[i].reshape(-1))
          + '</transform>')
        a('        </camera>')
    a('      </cameras>')
    a(f'      <markers next_id="{len(ctrl_idx)}">')
    for mi, j in enumerate(ctrl_idx):
        v = np.asarray(s.prior_op_val[j], np.float64)
        sd = np.asarray(s.prior_op_std[j], np.float64)
        a(f'        <marker id="{mi}" label="{s.op_labels[j]}">')
        a(f'          <reference x="{fr(v[0])}" y="{fr(v[1])}" '
          f'z="{fr(v[2])}" sx="{fr(sd[0])}" sy="{fr(sd[1])}" '
          f'sz="{fr(sd[2])}" enabled="true"/>')
        a('        </marker>')
    a('      </markers>')
    a('      <frames next_id="1">')
    a('        <frame id="0">')
    a('          <cameras>')
    for i in range(n_img):
        a(f'            <camera camera_id="{i}">')
        a(f'              <photo path="images/img{i:04d}.jpg"/>')
        a('            </camera>')
    a('          </cameras>')
    a('          <markers>')
    for mi, j in enumerate(ctrl_idx):
        rows = np.flatnonzero(obs_pt == j)
        if not len(rows):
            continue
        a(f'            <marker marker_id="{mi}">')
        for r in rows:
            a(f'              <location camera_id="{obs_img[r]}" '
              f'pinned="true" x="{fr(ip[r,0])}" y="{fr(ip[r,1])}"/>')
        a('            </marker>')
    a('          </markers>')
    a('          <point_cloud>')
    a('            <points path="points0.ply"/>')
    for i in range(n_img):
        a(f'            <projections camera_id="{i}" '
          f'path="projections{i}.ply"/>')
    a('          </point_cloud>')
    a('        </frame>')
    a('      </frames>')
    a('      <transform>')
    a('        <rotation>'
      + " ".join(f"{v:.16e}" for v in R_l2g.T.reshape(-1))
      + '</rotation>')
    a('        <translation>'
      + " ".join(f"{v:.16e}" for v in t_l2g) + '</translation>')
    a(f'        <scale>{fr(scale)}</scale>')
    a('      </transform>')
    a('      <settings>')
    a(f'        <property name="accuracy_tiepoints" '
      f'value="{fr(tie_acc_px)}"/>')
    a(f'        <property name="accuracy_markers" '
      f'value="{fr(marker_acc)}"/>')
    a(f'        <property name="accuracy_projections" '
      f'value="{fr(proj_acc_px)}"/>')
    a('      </settings>')
    a('    </chunk>')
    a('  </chunks>')
    a('</document>')

    # Tie points in the LOCAL frame (ps2pmstruct maps them to global).
    op_g = np.concatenate(
        [np.asarray(s.op[tie_idx], np.float64),
         np.ones((len(tie_idx), 1))], axis=1)
    op_l = (G2L @ op_g.T).T[:, :3]

    def ply_bytes(elements):
        buf = io_mod.BytesIO()
        ply_write(buf, elements)
        return buf.getvalue()

    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("doc.xml", "\n".join(x) + "\n")
        z.writestr("points0.ply", ply_bytes({"vertex": {
            "x": op_l[:, 0].astype(np.float32),
            "y": op_l[:, 1].astype(np.float32),
            "z": op_l[:, 2].astype(np.float32),
            "id": np.arange(len(tie_idx), dtype=np.uint32),
        }}))
        for i in range(n_img):
            rows = np.flatnonzero(
                (obs_img == i) & ~is_ctrl[obs_pt])
            ids = np.array([ps_id_of[int(j)] for j in obs_pt[rows]],
                           np.int32)
            z.writestr(f"projections{i}.ply", ply_bytes({"vertex": {
                "x": ip[rows, 0].astype(np.float32),
                "y": ip[rows, 1].astype(np.float32),
                "size": np.ones(len(rows), np.float32),
                "id": ids,
            }}))
