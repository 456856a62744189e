"""The project data model (counterpart of dbat_tpu/core/project.py).

A plain dataclass of numpy arrays: parameter state (io, eo, op), index
structure, estimation masks, priors and metadata, with the setters of
the reference's misc/ layer that the script operations call, and
`prune_network`.  The solvers push the parameter state to the device
themselves.

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

N_LIN = 5  # cc, px, py, aspect, skew


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
