"""PhotoModeler text-export loader (a numpy copy of dbat_tpu/io/pm.py).

Reads the same format as the reference's code/file/loadpm.m into a
`PmProject` of plain numpy arrays:

  line 1: title
  line 2: tol maxIter [imWidth imHeight]
  line 3: default point stdevs
  line 4: default camera [c xp yp xs ys K1 K2 K3 P1 P2]
  line 5: default camera stdevs
  photo blocks (until a block starts with a blank line):
      N FILE
      N X Y Z KAPPA PHI OMEGA          (m / degrees)
      N std...
      N cov... | blank                 (position covariances, often absent)
      N c xp yp xs ys K1 K2 K3 P1 P2
      N std...
  blank-terminated control point list  [id x y z sx sy sz]
  blank-terminated object point list   [id x y z sx sy sz]
  blank-terminated mark point list     [photo id x y sx sy]
  (optional features / feature-visibility blocks, parsed with
   skip_features=False)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class PmImage:
    name: str
    outer: np.ndarray  # [X,Y,Z,kappa,phi,omega] (m, degrees) as in file
    outer_std: np.ndarray
    outer_cov: np.ndarray
    inner: np.ndarray  # [c,xp,yp,xs,ys,K1,K2,K3,P1,P2]
    inner_std: np.ndarray
    im_size: np.ndarray  # [w,h] px
    id: int
    label: str = ""


@dataclass
class PmProject:
    file_name: str
    title: str
    tol: float
    max_iter: float
    def_std: np.ndarray
    def_cam: np.ndarray
    def_cam_std: np.ndarray
    im_size: np.ndarray
    images: list = field(default_factory=list)
    ctrl_pts: np.ndarray = None  # (n,7) [id,x,y,z,sx,sy,sz]
    check_pts: np.ndarray = None
    obj_pts: np.ndarray = None  # (n,7)
    mark_pts: np.ndarray = None  # (n,6) [photo,id,x,y,sx,sy]
    prior_cam_pos: np.ndarray = None  # (n,7) [id,x,y,z,sx,sy,sz] or None
    op_labels_by_id: dict = None  # optional {id: label}
    features: dict = None  # {feature_id: point-id array} (loadpm.m:335-353)
    feat_vis: np.ndarray = None  # (n,2) [photo, feature] (loadpm.m:357-375)


def _numbers(s: str) -> np.ndarray:
    return np.array([float(t) for t in s.split()], dtype=np.float64)


def load_pm(path: str, im_size=None, skip_features: bool = True) -> PmProject:
    """Parse a PhotoModeler export file (ref code/file/loadpm.m).

    skip_features=False also parses the optional trailing feature /
    feature-visibility blocks (loadpm.m:335-375; the reference's
    ...=LOADPM(...,FALSE) mode)."""
    with open(path, "rt") as fh:
        lines = fh.read().splitlines()
    it = iter(lines)

    title = next(it)
    tol = _numbers(next(it))
    def_std = _numbers(next(it))
    def_cam = _numbers(next(it))
    def_cam_std = _numbers(next(it))

    global_im_size = np.array([np.nan, np.nan])
    if im_size is not None:
        global_im_size = np.asarray(im_size, dtype=np.float64)
    elif len(tol) > 2:
        global_im_size = tol[2:4]

    images = []
    # Photo blocks (loadpm.m:140-211). Each block: name line, outer,
    # outerStd, outerCov (possibly blank), inner, innerStd. The photo
    # sequence is terminated by a blank line where a name line is
    # expected.
    while True:
        try:
            s = next(it)
        except StopIteration:
            break
        parts = s.split(None, 1)
        if not parts:
            break  # blank terminates photo sequence
        im_name = parts[1] if len(parts) > 1 else ""
        outer = _numbers(next(it))[1:]
        outer_std = _numbers(next(it))[1:]
        cov_line = _numbers(next(it))
        outer_cov = cov_line[1:] if cov_line.size else np.full(3, np.nan)
        inner = _numbers(next(it))[1:]
        inner_std = _numbers(next(it))[1:]
        images.append(
            PmImage(
                name=im_name.replace("\\", "/"),
                outer=outer,
                outer_std=outer_std,
                outer_cov=outer_cov,
                inner=inner,
                inner_std=inner_std,
                im_size=global_im_size.copy(),
                id=len(images) + 1,
                label=im_name.replace("\\", "/"),
            )
        )

    def read_table(ncols_min):
        rows = []
        while True:
            try:
                s = next(it)
            except StopIteration:
                break
            v = _numbers(s)
            if v.size == 0:
                break
            rows.append(v)
        if not rows:
            return np.zeros((0, ncols_min))
        return np.vstack(rows)

    ctrl_pts = read_table(7)
    obj_pts = read_table(7)
    mark_pts = read_table(6)

    # Optional trailing feature blocks (loadpm.m:335-375): each feature
    # line is [feature_id, n_pts, pt_id...]; the visibility block lists
    # [photo, feature] pairs.
    features = {}
    feat_vis = np.zeros((0, 2), dtype=np.int64)
    if not skip_features:
        while True:
            try:
                s = next(it)
            except StopIteration:
                break
            v = _numbers(s)
            if v.size == 0:
                break
            fid, npts = int(v[0]), int(v[1])
            features[fid] = v[2:2 + npts].astype(np.int64)
        vis_rows = []
        while True:
            try:
                s = next(it)
            except StopIteration:
                break
            v = _numbers(s)
            if v.size == 0:
                break
            vis_rows.append(v[:2].astype(np.int64))
        if vis_rows:
            feat_vis = np.vstack(vis_rows)

    # Smart-point renumbering (loadpm.m:384-410): PM "smart" points have
    # zero mark std and restart id numbering; shift them above the
    # normal ids when both kinds are present and obj ids are not
    # ascending.
    if mark_pts.size and obj_pts.size:
        is_smart_mark = np.all(mark_pts[:, 4:6] == 0, axis=1)
        norm_ids = np.unique(mark_pts[~is_smart_mark, 1])
        smart_ids = np.unique(mark_pts[is_smart_mark, 1])
        split = np.flatnonzero(np.diff(obj_pts[:, 0]) < 0)
        if split.size and norm_ids.size and smart_ids.size:
            shift = norm_ids.max() + 1 - smart_ids.min()
            mark_pts[is_smart_mark, 1] += shift
            is_smart_obj = np.isin(obj_pts[:, 0], smart_ids)
            is_smart_obj[: split[0] + 1] = False
            obj_pts[is_smart_obj, 0] += shift

    # Use image names sans longest common path as labels (loadpm.m:215-234).
    names = [im.name for im in images]
    if names:
        import os.path as osp

        common = osp.dirname(osp.commonprefix(names))
        if common:
            for im in images:
                im.label = im.name[len(common) + 1:]

    return PmProject(
        file_name=path,
        title=title,
        tol=float(tol[0]),
        max_iter=float(tol[1]) if len(tol) > 1 else np.nan,
        def_std=def_std,
        def_cam=def_cam,
        def_cam_std=def_cam_std,
        im_size=global_im_size,
        images=images,
        ctrl_pts=ctrl_pts,
        check_pts=np.zeros((0, 7)),
        obj_pts=obj_pts,
        mark_pts=mark_pts,
        features=features,
        feat_vis=feat_vis,
    )
