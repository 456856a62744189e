"""The project data model (counterpart of dbat_tpu/core/project.py).

A plain dataclass of numpy arrays: parameter state (io, eo, op), index
structure, estimation masks, priors and metadata, with the setters of
the reference's misc/ layer that the script operations call,
`from_pm` (a PhotoModeler or PhotoScan problem -> Project) and
`prune_network`.  The solvers push the parameter state to the device
themselves; `Project.params()` gives it as `Params`, tensors on an
explicit device, and `set_params()` takes it back.

Layouts (as in the JAX package):
  io: (n_img, NC) with NC = 5+nK+nP: [cc, px, py, aspect, skew, K.., P..]
      `io_block` gives sharing: equal block ids within a column share
      one value (IO.struct.block, code/misc/parseblockvariant.m).
  eo: (n_img, 6): [X, Y, Z, omega, phi, kappa]   (angles in radians)
  op: (n_op, 3)

Observations are index arrays (obs_img, obs_pt) plus measured pixel
coordinates, per image sorted by point id.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..io.pm import PmProject

N_LIN = 5  # cc, px, py, aspect, skew


@dataclass
class Params:
    """The parameter state as tensors on one device."""

    io: torch.Tensor  # (n_img, NC)
    eo: torch.Tensor  # (n_img, 6)
    op: torch.Tensor  # (n_op, 3)


@dataclass
class Project:
    """Full project: parameter state + static structure + metadata."""

    # --- parameter state
    io: np.ndarray
    eo: np.ndarray
    op: np.ndarray

    # --- model
    dist_model: int  # uniform lens distortion model (1..5, -1)
    nK: int
    nP: int
    cam_unit: str = "mm"
    obj_unit: str = "m"

    # --- sensor (per image)
    sensor_ss_size: np.ndarray = None  # (n_img,2) [w,h] physical units
    sensor_im_size: np.ndarray = None  # (n_img,2) [w,h] px
    sensor_px_size: np.ndarray = None  # (n_img,2) pixel size (y used for both)

    # --- sharing structure (ref IO.struct.block / EO.struct.block)
    io_block: np.ndarray = None  # (n_img, NC) int
    eo_block: np.ndarray = None  # (n_img, 6) int

    # --- estimation masks
    est_io: np.ndarray = None  # (n_img, NC) bool
    est_eo: np.ndarray = None  # (n_img, 6) bool
    est_op: np.ndarray = None  # (n_op, 3) bool

    # --- priors (ref prior.IO/EO/OP)
    prior_io_val: np.ndarray = None
    prior_io_std: np.ndarray = None
    prior_io_use: np.ndarray = None
    prior_eo_val: np.ndarray = None
    prior_eo_std: np.ndarray = None
    prior_eo_use: np.ndarray = None
    prior_op_val: np.ndarray = None
    prior_op_std: np.ndarray = None
    prior_op_use: np.ndarray = None
    is_ctrl: np.ndarray = None  # (n_op,) bool
    is_check: np.ndarray = None  # (n_op,) bool

    # --- observations (IP)
    obs_img: np.ndarray = None  # (n_obs,) int32
    obs_pt: np.ndarray = None  # (n_obs,) int32
    ip_px: np.ndarray = None  # (n_obs,2) measured pixel coords
    ip_std_px: np.ndarray = None  # (n_obs,2) std in pixels
    ip_id: np.ndarray = None  # (n_obs,) point id of each measurement
    ip_sigmas: np.ndarray = None  # unique prior sigmas (ref IP.sigmas)

    # --- ids / labels
    op_id: np.ndarray = None  # (n_op,) int
    op_raw_id: np.ndarray = None
    op_labels: list = field(default_factory=list)
    img_names: list = field(default_factory=list)
    img_labels: list = field(default_factory=list)
    img_ids: np.ndarray = None

    # --- metadata
    title: str = ""
    file_name: str = ""
    cpt_file: str = ""
    eo_file: str = ""
    im_dir: str = ""
    x0desc: str = ""

    @property
    def n_img(self) -> int:
        return self.eo.shape[0]

    @property
    def n_op(self) -> int:
        return self.op.shape[0]

    @property
    def n_obs(self) -> int:
        return self.obs_img.shape[0]

    @property
    def NC(self) -> int:
        return N_LIN + self.nK + self.nP

    def params(self, device=None) -> Params:
        """The parameter state as tensors on `device` (default the card;
        see device.py)."""
        dev = resolve_device(device)
        return Params(*(torch.as_tensor(a, device=dev)
                        for a in (self.io, self.eo, self.op)))

    def set_params(self, p: Params) -> None:
        self.io, self.eo, self.op = (t.detach().cpu().numpy().copy()
                                     for t in (p.io, p.eo, p.op))

    def copy(self) -> "Project":
        out = dataclasses.replace(self)
        for f in dataclasses.fields(self):
            v = getattr(out, f.name)
            if isinstance(v, np.ndarray):
                setattr(out, f.name, v.copy())
            elif isinstance(v, list):
                setattr(out, f.name, list(v))
        return out

    # ------------------------------------------------------------------
    # Setters mirroring the reference's misc/ layer
    # ------------------------------------------------------------------
    def set_cam_vals_default(self, cc: float, cams=None) -> None:
        """EXIF-style init (ref code/misc/setcamvals.m 'default'):
        cc given, principal point at sensor center (y negated by the
        image y-flip convention), all other parameters zero."""
        ix = np.arange(self.n_img) if cams is None else np.asarray(cams)
        self.io[ix, 0] = cc
        self.io[ix, 1] = 0.5 * self.sensor_ss_size[ix, 0]
        self.io[ix, 2] = -0.5 * self.sensor_ss_size[ix, 1]
        self.io[ix, 3:] = 0.0

    def set_cam_vals_loaded(self, cams=None) -> None:
        ix = np.arange(self.n_img) if cams is None else np.asarray(cams)
        self.io[ix] = self.prior_io_val[ix]

    _IO_PARAM_GROUPS = {
        "cc": [0], "px": [1], "py": [2], "as": [3], "sk": [4],
        "pp": [1, 2], "lin": [0, 1, 2, 3, 4],
    }

    def _io_param_indices(self, name: str):
        if name in self._IO_PARAM_GROUPS:
            return list(self._IO_PARAM_GROUPS[name])
        if name == "K":
            return list(range(N_LIN, N_LIN + self.nK))
        if name == "P":
            return list(range(N_LIN + self.nK, N_LIN + self.nK + self.nP))
        if name == "af":
            return list(range(5))
        if name == "all":
            return list(range(self.NC))
        if name.startswith("K"):
            n = int(name[1:])
            if not (1 <= n <= self.nK):
                raise ValueError("K number out of range")
            return [N_LIN + n - 1]
        if name.startswith("P"):
            n = int(name[1:])
            if not (1 <= n <= self.nP):
                raise ValueError("P number out of range")
            return [N_LIN + self.nK + n - 1]
        raise ValueError(f"Bad IO parameter {name!r}")

    def set_cam_est(self, *spec, cams=None) -> None:
        """Mirror of code/misc/setcamest.m: e.g. set_cam_est('all','not','sk').

        Arguments before 'not' are set estimated, after 'not' fixed.
        Aspect/skew are masked out for models |model|<3 (setcamest.m:20-31).
        """
        ix = np.arange(self.n_img) if cams is None else np.asarray(cams)
        supports_b = abs(self.dist_model) >= 3
        do_est = True
        for a in spec:
            if a == "not":
                do_est = False
                continue
            cols = self._io_param_indices(a)
            for c in cols:
                val = do_est
                if c in (3, 4) and not supports_b:
                    val = False
                self.est_io[ix, c] = val

    def set_eo_est(self, *spec, cams=None) -> None:
        """Mirror of code/misc/seteoest.m ('all', 'pos', 'ang', 'none'...)."""
        ix = np.arange(self.n_img) if cams is None else np.asarray(cams)
        groups = {
            "x": [0], "y": [1], "z": [2], "pos": [0, 1, 2],
            "om": [3], "ph": [4], "ka": [5], "ang": [3, 4, 5],
            "all": list(range(6)),
        }
        do_est = True
        for a in spec:
            if a == "not":
                do_est = False
                continue
            if a == "none":
                self.est_eo[ix, :] = False
                continue
            self.est_eo[np.ix_(ix, groups[a])] = do_est

    def set_eo_est_depend(self, base_cam: int = 0) -> None:
        """'depend' datum (code/misc/seteoest.m setdepend): fix the base
        camera entirely and, in the camera with the largest offset from
        it, fix the coordinate with the largest offset."""
        self.est_eo[:, :] = True
        self.est_eo[base_cam, :] = False
        d = self.eo[:, :3] - self.eo[base_cam, :3]
        d[base_cam] = 0
        flat = np.nanargmax(np.abs(d))
        cam, coord = np.unravel_index(flat, d.shape)
        self.est_eo[cam, coord] = False

    def clear_eo(self) -> None:
        """NaN-poison EO values to be estimated (code/misc/cleareo.m)."""
        self.eo[self.est_eo & ~self.prior_eo_use] = np.nan

    def clear_op(self) -> None:
        """NaN-poison OP values to be estimated (code/misc/clearop.m)."""
        self.op[self.est_op & ~self.prior_op_use] = np.nan

    def match_cpt(self, pts, match: str = "auto"):
        """Match loaded control points by raw id and/or label
        (code/misc/matchcpt.m). Returns (op_indices, cpt_indices)."""
        by_id = np.any(pts.id >= 0) if match in ("auto",) else match in ("id", "both")
        by_label = any(n for n in pts.name) if match == "auto" else match in (
            "label", "both")
        sel = np.flatnonzero(self.is_ctrl)
        i_id = j_id = i_lb = j_lb = None
        if by_id:
            common, ia, ib = np.intersect1d(
                self.op_raw_id[sel], pts.id, return_indices=True
            )
            i_id, j_id = sel[ia], ib
        if by_label:
            labels = np.array([self.op_labels[k] for k in sel])
            common, ia, ib = np.intersect1d(
                labels, np.array(pts.name), return_indices=True
            )
            i_lb, j_lb = sel[ia], ib
        if by_id and (i_id is not None) and len(i_id):
            return i_id, j_id
        if by_label and i_lb is not None:
            return i_lb, j_lb
        return np.array([], dtype=int), np.array([], dtype=int)

    def match_eo(self, tbl, match: str = "auto"):
        """Match an EO table to images by id and/or label
        (code/misc/matcheo.m). Returns (img_indices, tbl_indices)."""
        by_id = np.any(tbl.id >= 0) if match == "auto" else match in ("id", "both")
        by_label = any(n for n in tbl.name) if match == "auto" else match in (
            "label", "both")
        if by_label:
            labels = np.array(self.img_labels)
            common, ia, ib = np.intersect1d(
                labels, np.array(tbl.name), return_indices=True
            )
            if len(ia):
                return ia, ib
        if by_id:
            common, ia, ib = np.intersect1d(
                self.img_ids, tbl.id, return_indices=True
            )
            return ia, ib
        return np.array([], dtype=int), np.array([], dtype=int)

    def set_prior_eo(self, tbl, i, j) -> None:
        """Install prior EO positions (code/misc/setprioreo.m): fixed
        (std 0) positions become fixed parameters, others prior
        observations."""
        self.eo_file = tbl.file_name
        self.prior_eo_val[i, 0:3] = tbl.pos[:, j].T
        self.eo[i, 0:3] = tbl.pos[:, j].T
        self.prior_eo_std[i, 0:3] = tbl.std[:, j].T
        for k, (ii, jj) in enumerate(zip(i, j)):
            if tbl.name[jj]:
                self.img_labels[ii] = tbl.name[jj]
        is_fixed = (tbl.std[:, j] == 0).T  # (len(i), 3)
        self.prior_eo_use[i, 0:3] = ~is_fixed
        self.est_eo[i, 0:3] = ~is_fixed
        # Angles if present in the table.
        ang_ok = np.isfinite(tbl.ang[:, j]).all(axis=0)
        if ang_ok.any():
            ii = np.asarray(i)[ang_ok]
            jj = np.asarray(j)[ang_ok]
            self.prior_eo_val[ii, 3:6] = tbl.ang[:, jj].T
            self.eo[ii, 3:6] = tbl.ang[:, jj].T
            self.prior_eo_std[ii, 3:6] = tbl.ang_std[:, jj].T
            fixed_a = (tbl.ang_std[:, jj] == 0).T
            self.prior_eo_use[ii, 3:6] = ~fixed_a
            self.est_eo[ii, 3:6] = ~fixed_a

    def set_cpt(self, pts, i, j, is_ctrl: bool = True) -> None:
        """Install control/check points (code/misc/setcpt.m)."""
        self.cpt_file = pts.file_name
        self.prior_op_val[i] = pts.pos[:, j].T
        self.op[i] = pts.pos[:, j].T
        self.prior_op_std[i] = pts.std[:, j].T
        for k, (ii, jj) in enumerate(zip(i, j)):
            if pts.name[jj]:
                self.op_labels[ii] = pts.name[jj]
        self.is_ctrl[i] = is_ctrl
        self.is_check[i] = not is_ctrl
        if is_ctrl:
            is_fixed = np.all(pts.std[:, j] == 0, axis=0)
            self.prior_op_use[i] = ~is_fixed[:, None]
            self.est_op[i] = ~is_fixed[:, None]
        else:
            self.prior_op_use[i] = False
            self.est_op[i] = True


def from_pm(prob: PmProject, individual_cameras: bool = False) -> Project:
    """PhotoModeler prob -> Project (ref code/misc/prob2dbatstruct.m).

    Sign conventions applied here (prob2dbatstruct.m:226-237): principal
    point y is negated (image y-flip) and the PM K/P coefficients are
    negated (PhotoModeler stores the inverse correction).
    """
    n_img = len(prob.images)
    nK, nP = 3, 2
    NC = N_LIN + nK + nP

    if individual_cameras:
        inner = np.stack([im.inner for im in prob.images])  # (n_img,10)
        inner_std = np.stack([im.inner_std for im in prob.images])
        im_sz = np.stack([im.im_size for im in prob.images])
        io_block = np.tile(np.arange(1, n_img + 1)[:, None], (1, NC))
    else:
        inner = np.tile(prob.def_cam, (n_img, 1))
        inner_std = np.tile(prob.def_cam_std, (n_img, 1))
        im_sz = np.tile(prob.im_size, (n_img, 1))
        io_block = np.ones((n_img, NC), dtype=int)

    io = np.full((n_img, NC), np.nan)
    io_std = np.full((n_img, NC), np.nan)
    io[:, 0] = inner[:, 0]  # cc
    io[:, 1] = inner[:, 1]  # px
    io[:, 2] = -inner[:, 2]  # py (y-flip)
    io_std[:, 0:3] = inner_std[:, 0:3]
    io[:, N_LIN:N_LIN + nK] = -inner[:, 5:5 + nK]
    io[:, N_LIN + nK:] = -inner[:, 5 + nK:5 + nK + nP]
    io_std[:, N_LIN:] = inner_std[:, 5:5 + nK + nP]

    sensor_size = inner[:, 3:5]  # [xs, ys]
    px_size = sensor_size / im_sz
    aspect = 1.0 - px_size[:, 0] / px_size[:, 1]
    px_size = np.stack([px_size[:, 1], px_size[:, 1]], axis=1)
    io[:, 3] = aspect
    io[:, 4] = 0.0  # skew

    # EO: PM stores angles as kappa, phi, omega in degrees.
    eo = np.full((n_img, 6), np.nan)
    eo_std = np.full((n_img, 6), np.nan)
    outer = np.stack([im.outer for im in prob.images])
    outer_std = np.stack([im.outer_std for im in prob.images])
    eo[:, 0:3] = outer[:, 0:3]
    eo_std[:, 0:3] = outer_std[:, 0:3]
    eo[:, 3:6] = outer[:, [5, 4, 3]] * np.pi / 180.0
    eo_std[:, 3:6] = outer_std[:, [5, 4, 3]] * np.pi / 180.0
    eo_block = np.tile(np.arange(1, n_img + 1)[:, None], (1, 6))

    # Object points: union of ctrl+obj ids, ascending.
    all_ids = np.union1d(
        prob.ctrl_pts[:, 0].astype(np.int64) if prob.ctrl_pts.size else [],
        prob.obj_pts[:, 0].astype(np.int64) if prob.obj_pts.size else [],
    ).astype(np.int64)
    n_op = all_ids.size
    op = np.full((n_op, 3), np.nan)
    prior_op_val = np.full((n_op, 3), np.nan)
    prior_op_std = np.full((n_op, 3), np.nan)

    obj_ids = prob.obj_pts[:, 0].astype(np.int64)
    idx = np.searchsorted(all_ids, obj_ids)
    op[idx] = prob.obj_pts[:, 1:4]

    ctrl_ids = prob.ctrl_pts[:, 0].astype(np.int64)
    is_ctrl = np.isin(all_ids, ctrl_ids)
    cidx = np.searchsorted(all_ids, ctrl_ids)
    prior_op_val[cidx] = prob.ctrl_pts[:, 1:4]
    prior_op_std[cidx] = prob.ctrl_pts[:, 4:7]

    check_ids = prob.check_pts[:, 0].astype(np.int64) if prob.check_pts.size else []
    is_check = np.isin(all_ids, check_ids)

    # Observations, per image sorted by id (prob2dbatstruct.m:349-365).
    obs_img, obs_pt, ip_px, ip_std, ip_id = [], [], [], [], []
    mp = prob.mark_pts
    for i in range(n_img):
        rows = mp[mp[:, 0] == i]
        rows = rows[np.argsort(rows[:, 1], kind="stable")]
        valid = np.isin(rows[:, 1].astype(np.int64), all_ids)
        rows = rows[valid]
        obs_img.append(np.full(len(rows), i, dtype=np.int32))
        obs_pt.append(
            np.searchsorted(all_ids, rows[:, 1].astype(np.int64)).astype(np.int32)
        )
        ip_px.append(rows[:, 2:4])
        ip_std.append(rows[:, 4:6])
        ip_id.append(rows[:, 1].astype(np.int64))
    obs_img = np.concatenate(obs_img)
    obs_pt = np.concatenate(obs_pt)
    ip_px = np.concatenate(ip_px, axis=0)
    ip_std = np.concatenate(ip_std, axis=0)
    ip_id = np.concatenate(ip_id)

    sigmas = np.unique(ip_std)
    if np.any(sigmas == 0):
        # Ref prob2dbatstruct.m:367-374
        sigmas = np.array([1.0])
        ip_std = np.ones_like(ip_std)

    # Estimation defaults (prob2dbatstruct.m:380-390).
    est_io = np.zeros((n_img, NC), dtype=bool)
    prior_io_use = np.zeros((n_img, NC), dtype=bool)
    est_eo = np.ones((n_img, 6), dtype=bool)
    prior_eo_use = np.zeros((n_img, 6), dtype=bool)
    with np.errstate(invalid="ignore"):
        est_op = ~(prior_op_std == 0)
    use_op = np.tile(
        (is_ctrl & ~np.all(prior_op_std == 0, axis=1))[:, None], (1, 3)
    )

    # Labels: control points labelled by id (loadpm.m:380-382), or by
    # the source's label table when provided (PSZ markers).
    op_labels = ["" for _ in range(n_op)]
    for k in np.flatnonzero(is_ctrl | is_check):
        op_labels[k] = str(all_ids[k])
    if getattr(prob, "op_labels_by_id", None):
        for k, oid in enumerate(all_ids):
            lbl = prob.op_labels_by_id.get(int(oid))
            if lbl:
                op_labels[k] = lbl

    # Prior camera positions (prob2dbatstruct.m:466-472).
    pcp = getattr(prob, "prior_cam_pos", None)
    if pcp is not None and len(pcp):
        cam_id_arr = np.array([im.id for im in prob.images])
        common, ia, ib = np.intersect1d(
            cam_id_arr, pcp[:, 0].astype(int), return_indices=True
        )
        # applied below after prior arrays are built

    import os.path as osp

    names = [im.name for im in prob.images]
    im_dir = osp.dirname(osp.commonprefix(names)) if names else ""
    labels = [n[len(im_dir) + 1:] if im_dir else n for n in names]

    prior_eo_val = eo.copy()
    prior_eo_std = eo_std
    if pcp is not None and len(pcp) and len(ia):
        prior_eo_val[ia, 0:3] = pcp[ib, 1:4]
        prior_eo_std[ia, 0:3] = pcp[ib, 4:7]
        prior_eo_use[ia, 0:3] = True

    return Project(
        io=io,
        eo=eo,
        op=op,
        dist_model=1,
        nK=nK,
        nP=nP,
        sensor_ss_size=sensor_size,
        sensor_im_size=im_sz,
        sensor_px_size=px_size,
        io_block=io_block,
        eo_block=eo_block,
        est_io=est_io,
        est_eo=est_eo,
        est_op=est_op,
        prior_io_val=io.copy(),
        prior_io_std=io_std,
        prior_io_use=prior_io_use,
        prior_eo_val=prior_eo_val,
        prior_eo_std=prior_eo_std,
        prior_eo_use=prior_eo_use,
        prior_op_val=prior_op_val,
        prior_op_std=prior_op_std,
        prior_op_use=use_op,
        is_ctrl=is_ctrl,
        is_check=is_check,
        obs_img=obs_img,
        obs_pt=obs_pt,
        ip_px=ip_px,
        ip_std_px=ip_std,
        ip_id=ip_id,
        ip_sigmas=sigmas,
        op_id=all_ids,
        op_raw_id=all_ids.copy(),
        op_labels=op_labels,
        img_names=names,
        img_labels=labels,
        img_ids=np.array([im.id for im in prob.images]),
        title=prob.title,
        file_name=prob.file_name,
        im_dir=im_dir,
    )


def project_from_arrays(fields: dict) -> Project:
    """Build a Project from a {field name: value} dict.

    Arrays are copied (numpy), lists are copied, scalars and strings
    are taken as they are.  This is how a network built elsewhere (for
    example by the JAX package, field by field as numpy arrays) is
    carried into the port so both solve the same problem.  Unknown
    field names raise."""
    names = {f.name for f in dataclasses.fields(Project)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"unknown Project fields: {sorted(unknown)}")
    kw = {}
    for k, v in fields.items():
        if isinstance(v, np.ndarray):
            v = v.copy()
        elif isinstance(v, (list, tuple)) and k in (
                "op_labels", "img_names", "img_labels"):
            v = list(v)
        kw[k] = v
    return Project(**kw)


def prune_network(project, keep_obs=None, min_views: int = 2) -> dict:
    """Remove observations and under-observed points, in place.

    keep_obs: (n_obs,) bool mask of observations to keep (None = all).
    After observation removal, estimated points with fewer than
    `min_views` remaining rays are removed entirely (with their
    observations); control points are kept regardless (the reference's
    check_ray_count / loadplotpsz.m:55-80 filtering rule).  Returns
    {"n_obs_removed", "n_op_removed", "op_keep"} (op_keep maps old ->
    kept rows for callers tracking per-point side data)."""
    p = project
    n_obs0 = p.n_obs
    keep = (np.ones(n_obs0, bool) if keep_obs is None
            else np.asarray(keep_obs, bool).copy())

    counts = np.bincount(p.obs_pt[keep], minlength=p.n_op)
    fixed = ~p.est_op.any(axis=1) | p.is_ctrl
    op_keep = (counts >= min_views) | (fixed & (counts > 0))
    keep &= op_keep[p.obs_pt]

    remap = np.cumsum(op_keep) - 1
    p.obs_img = p.obs_img[keep]
    p.obs_pt = remap[p.obs_pt[keep]].astype(p.obs_pt.dtype)
    p.ip_px = p.ip_px[keep]
    p.ip_std_px = p.ip_std_px[keep]
    if p.ip_id is not None:
        p.ip_id = p.ip_id[keep]

    p.op = p.op[op_keep]
    p.est_op = p.est_op[op_keep]
    p.is_ctrl = p.is_ctrl[op_keep]
    p.is_check = p.is_check[op_keep]
    p.op_id = p.op_id[op_keep]
    if p.op_raw_id is not None:
        p.op_raw_id = p.op_raw_id[op_keep]
    if p.op_labels:
        p.op_labels = [l for l, k in zip(p.op_labels, op_keep) if k]
    for name in ("prior_op_val", "prior_op_std", "prior_op_use"):
        v = getattr(p, name)
        if v is not None:
            setattr(p, name, v[op_keep])

    return {"n_obs_removed": int(n_obs0 - keep.sum()),
            "n_op_removed": int((~op_keep).sum()),
            "op_keep": op_keep}
