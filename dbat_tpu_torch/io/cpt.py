"""Control/check point table loader (ref code/file/loadcpt.m; a numpy
copy of dbat_tpu/io/cpt.py).

Comma-separated lines `id[,label],x,y,z[,std...]` with '#' comments.
Std interpretation by count of trailing numbers (loadcpt.m:46-63):
  3 values  -> exact point (std 0)
  4 values  -> sigma_xyz
  5 values  -> sigma_xy, sigma_z
  6 values  -> sigma_x, sigma_y, sigma_z
  12 values -> full 3x3 covariance (row-major)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CtrlPts:
    id: np.ndarray  # (n,) int
    name: list  # of str
    pos: np.ndarray  # (3,n)
    std: np.ndarray  # (3,n)
    cov: np.ndarray | None  # (3,3,n) or None
    file_name: str


def load_cpt(path: str, has_id: bool = True, has_name: bool = True) -> CtrlPts:
    ids, names, poss, stds, covs = [], [], [], [], []
    any_cov = False
    with open(path, "rt") as fh:
        for line in fh:
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            toks = [t.strip() for t in s.split(",")]
            i = 0
            if has_id:
                ids.append(int(toks[0]))
                i += 1
            else:
                ids.append(-1)
            if has_name:
                names.append(toks[i])
                i += 1
            else:
                names.append("")
            a = np.array([float(t) for t in toks[i:] if t != ""])
            poss.append(a[:3])
            n = a.size
            cc = np.full((3, 3), np.nan)
            if n == 3:
                st = np.zeros(3)
            elif n == 4:
                st = np.full(3, a[3])
            elif n == 5:
                st = np.array([a[3], a[3], a[4]])
            elif n == 6:
                st = a[3:6]
            elif n == 12:
                cc = a[3:].reshape(3, 3)
                st = np.sqrt(np.diag(cc))
                any_cov = True
            else:
                raise ValueError(f"Bad number of items on CP line: {s!r}")
            if np.all(np.isnan(cc)):
                cc = np.diag(st**2)
            stds.append(st)
            covs.append(cc)
    return CtrlPts(
        id=np.array(ids, dtype=np.int64),
        name=names,
        pos=np.array(poss).T if poss else np.zeros((3, 0)),
        std=np.array(stds).T if stds else np.zeros((3, 0)),
        cov=np.stack(covs, axis=-1) if any_cov else None,
        file_name=path,
    )
