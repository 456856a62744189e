"""Format-string-driven text table loaders (a numpy copy of
dbat_tpu/io/tables.py).

References: code/file/loadimagetable.m (id,path), code/file/loadimagepts.m
(im,id,x,y[,sxy|sx,sy]), code/file/loadctrlpts.m
(id[,label],x,y,z[,sx,sy,sz|sxy|sxyz]).  Comma separated, '#' comments.
"""

from __future__ import annotations

import numpy as np

from .cpt import CtrlPts


def _rows(path, cmt="#"):
    with open(path, "rt") as fh:
        for line in fh:
            s = line.strip()
            if not s or s.startswith(cmt):
                continue
            yield [t.strip() for t in s.split(",")]


def load_image_table(path: str, fmt: str = "id,path"):
    """Image list -> (ids (n,), paths list)  (loadimagetable.m)."""
    parts = [p.strip() for p in fmt.split(",")]
    ids, paths = [], []
    for toks in _rows(path):
        d = dict(zip(parts, toks))
        ids.append(int(d["id"]))
        paths.append(d["path"])
    return np.array(ids), paths


def load_image_pts(path: str, fmt: str = "im,id,x,y,sxy",
                   default_sxy: float = np.nan) -> np.ndarray:
    """Image measurements -> (n,6) [im,id,x,y,sx,sy]  (loadimagepts.m).

    Vectorized parse (the reference optimized this loader 'some orders
    of magnitude' in v0.9.1.3 — ChangeLog.txt:14-16)."""
    parts = [p.strip() for p in fmt.split(",")]
    raw = np.genfromtxt(path, delimiter=",", comments="#", dtype=np.float64)
    raw = np.atleast_2d(raw)
    if raw.shape[1] != len(parts):
        raise ValueError(
            f"{path}: got {raw.shape[1]} columns, format has {len(parts)}"
        )
    col = {p: raw[:, i] for i, p in enumerate(parts)}
    n = raw.shape[0]
    sx = col.get("sx", col.get("sxy"))
    sy = col.get("sy", col.get("sxy"))
    if sx is None:
        sx = np.full(n, default_sxy)
    if sy is None:
        sy = np.full(n, default_sxy)
    return np.stack([col["im"], col["id"], col["x"], col["y"], sx, sy], axis=1)


def load_ctrl_pts(path: str, fmt: str = "id,label,x,y,z") -> CtrlPts:
    """Control point table with explicit format (loadctrlpts.m)."""
    parts = [p.strip() for p in fmt.split(",")]
    ids, names, poss, stds = [], [], [], []
    for toks in _rows(path):
        if len(toks) != len(parts):
            raise ValueError(
                f"{path}: got {len(toks)} items, format has {len(parts)}"
            )
        d = dict(zip(parts, toks))
        ids.append(int(d["id"]) if "id" in d else -1)
        names.append(d.get("label", ""))
        poss.append([float(d.get(a, "nan")) for a in "xyz"])
        sd = np.zeros(3)
        if "sxyz" in d:
            sd[:] = float(d["sxyz"])
        if "sxy" in d:
            sd[0] = sd[1] = float(d["sxy"])
        for k, a in enumerate(("sx", "sy", "sz")):
            if a in d:
                sd[k] = float(d[a])
        stds.append(sd)
    return CtrlPts(
        id=np.array(ids, dtype=np.int64),
        name=names,
        pos=np.array(poss).T if poss else np.zeros((3, 0)),
        std=np.array(stds).T if stds else np.zeros((3, 0)),
        cov=None,
        file_name=path,
    )


def filter_ctrl_pts(pts: CtrlPts, ids, mode: str) -> CtrlPts:
    """<filter id="..">keep|remove</filter> on a point table
    (parseinput.m ctrl_pts filter)."""
    ids = np.asarray(ids)
    sel = np.isin(pts.id, ids)
    if mode == "remove":
        sel = ~sel
    elif mode != "keep":
        raise ValueError(f"Bad filter mode {mode!r}")
    return CtrlPts(
        id=pts.id[sel],
        name=[n for n, s in zip(pts.name, sel) if s],
        pos=pts.pos[:, sel],
        std=pts.std[:, sel],
        cov=None if pts.cov is None else pts.cov[:, :, sel],
        file_name=pts.file_name,
    )
