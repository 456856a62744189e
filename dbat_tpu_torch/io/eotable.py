"""Prior camera-station (EO) table loaders (a numpy copy of
dbat_tpu/io/eotable.py).

References: code/file/loadeotable.m (format-string driven) and
code/file/legacyloadeotable.m (= control-point format with label).
Known format parts (loadeotable.m:14-16): id, label, ignored, x, y, z,
sx, sy, sz, sxy, sxyz, omega, phi, kappa, so, sp, sk, sang.
Angles are given in degrees and stored in radians.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class EoTable:
    id: np.ndarray
    name: list
    pos: np.ndarray  # (3,n)
    std: np.ndarray  # (3,n)
    ang: np.ndarray  # (3,n) radians [omega,phi,kappa]
    ang_std: np.ndarray  # (3,n)
    cov: np.ndarray | None
    file_name: str


def legacy_load_eo_table(path: str, has=(True, True)) -> EoTable:
    """CSV `[id,][label,]x,y,z[,std...]` (legacyloadeotable.m)."""
    from .cpt import load_cpt

    pts = load_cpt(path, has_id=has[0], has_name=has[1])
    n = pts.pos.shape[1]
    return EoTable(
        id=pts.id, name=pts.name, pos=pts.pos, std=pts.std,
        ang=np.full((3, n), np.nan), ang_std=np.full((3, n), np.nan),
        cov=pts.cov, file_name=path,
    )


def load_eo_table(path: str, fmt: str, sep: str = ",", cmt: str = "#"
                  ) -> EoTable:
    """Format-string driven loader (loadeotable.m)."""
    parts_known = {"id", "label", "ignored", "x", "y", "z", "sx", "sy",
                   "sz", "sxy", "sxyz", "omega", "phi", "kappa", "so",
                   "sp", "sk", "sang"}
    fmt_parts = [p.strip() for p in fmt.split(sep)]
    bad = set(fmt_parts) - parts_known
    if bad:
        raise ValueError(f"Invalid format parts: {sorted(bad)}")

    ids, names, poss, stds, angs, angstds = [], [], [], [], [], []
    deg = np.pi / 180.0
    with open(path, "rt") as fh:
        for line in fh:
            s = line.strip()
            if not s or s.startswith(cmt):
                continue
            toks = [t.strip() for t in s.split(sep)]
            if len(toks) != len(fmt_parts):
                raise ValueError(
                    f"{path}: wrong number of elements "
                    f"(got {len(toks)}, expected {len(fmt_parts)})"
                )
            ii, nm = -1, ""
            p = np.full(3, np.nan)
            sd = np.zeros(3)
            a = np.full(3, np.nan)
            asd = np.full(3, np.nan)
            for f, t in zip(fmt_parts, toks):
                if f == "id":
                    ii = int(t)
                elif f == "label":
                    nm = t
                elif f in ("x", "y", "z"):
                    p["xyz".index(f)] = float(t)
                elif f in ("sx", "sy", "sz"):
                    sd["xyz".index(f[1])] = float(t)
                elif f == "sxy":
                    sd[0] = sd[1] = float(t)
                elif f == "sxyz":
                    sd[:] = float(t)
                elif f in ("omega", "phi", "kappa"):
                    a[["omega", "phi", "kappa"].index(f)] = float(t) * deg
                elif f in ("so", "sp", "sk"):
                    asd[["so", "sp", "sk"].index(f)] = float(t) * deg
                elif f == "sang":
                    asd[:] = float(t) * deg
            ids.append(ii)
            names.append(nm)
            poss.append(p)
            stds.append(sd)
            angs.append(a)
            angstds.append(asd)
    return EoTable(
        id=np.array(ids), name=names,
        pos=np.array(poss).T if poss else np.zeros((3, 0)),
        std=np.array(stds).T if stds else np.zeros((3, 0)),
        ang=np.array(angs).T if angs else np.zeros((3, 0)),
        ang_std=np.array(angstds).T if angstds else np.zeros((3, 0)),
        cov=None, file_name=path,
    )
