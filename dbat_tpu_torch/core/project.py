"""The project data model (counterpart of dbat_tpu/core/project.py).

A plain dataclass of numpy arrays: parameter state (io, eo, op), index
structure, estimation masks, priors and metadata.  The solvers push
the parameter state to the device themselves.

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
