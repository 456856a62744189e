"""PhotoModeler exported point tables and status reports (a numpy copy
of dbat_tpu/io/pmtables.py).

References: code/file/loadpm3dtbl.m (3D point table with precisions),
code/file/loadpm2dtbl.m (2D mark/residual table),
code/file/loadpmreport.m (status report: EO values/deviations, totals).
These feed the external-verification workflows (prague2016 demos
compare DBAT results against PhotoModeler's own output).
"""

from __future__ import annotations

import csv
import re
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Pm3dTable:
    id: np.ndarray
    name: list
    pos: np.ndarray  # (3,n)
    std: np.ndarray  # (3,n)
    rms: np.ndarray  # (n,)
    vis: np.ndarray  # (n_img_max, n) bool — photos (used)


@dataclass
class Pm2dTable:
    id: np.ndarray
    im_no: np.ndarray
    pos: np.ndarray  # (2,n) px
    res: np.ndarray  # (2,n) px residuals


@dataclass
class PmReport:
    """Parsed PhotoModeler processing report (loadpmreport.m struct)."""

    eo: np.ndarray = None  # (n_img, 6) [X,Y,Z,omega,phi,kappa] rad
    eo_std: np.ndarray = None
    eo_corr: list = field(default_factory=list)  # (photo, p_i, p_j, corr)
    photo_labels: list = field(default_factory=list)
    n_iterations: int = -1
    n_stages: int = -1
    first_error: float = np.nan
    last_error: float = np.nan
    status: str = ""
    proj_name: str = ""
    run_date: str = ""
    pm_version: str = ""
    proc_opts: dict = field(default_factory=dict)  # orient/global/cal/constr
    image_count: dict = field(default_factory=dict)  # total/bad/weak/ok/...
    cameras: list = field(default_factory=list)  # dicts: name/calibrated/...
    pts_uncalibrated: list = field(default_factory=list)  # (pt_id, im_no)
    mark_residuals: dict = field(default_factory=dict)
    tightness: dict = field(default_factory=dict)
    pt_precision: dict = field(default_factory=dict)
    pt_angles: dict = field(default_factory=dict)


def _csv_rows(path):
    with open(path, "rt", newline="") as fh:
        header_found = False
        rd = csv.reader(fh)
        cols = None
        for row in rd:
            if not row:
                continue
            if not header_found:
                if row[0].strip() == "Id" or row[0].strip() == \
                        "Object Point ID":
                    cols = [c.strip() for c in row]
                    header_found = True
                continue
            yield cols, row


def load_pm_3d_tbl(path: str, smart: bool = False) -> Pm3dTable:
    ids, names, poss, stds, rmss, viss = [], [], [], [], [], []
    max_photo = 0
    for cols, row in _csv_rows(path):
        d = dict(zip(cols, row))
        ids.append(int(d["Id"]))
        names.append(d.get("Name", "").strip())
        poss.append([float(d[k]) for k in cols if k.startswith(("X (", "Y (", "Z ("))][:3])
        stds.append([float(d.get(k, "nan")) for k in
                     ("X Precision", "Y Precision", "Z Precision")])
        rmss.append(float(d.get("RMS Residual (pixels)", "nan") or "nan"))
        photos = [int(t) for t in d.get("Photos (used)", "").split(",")
                  if t.strip().isdigit()]
        viss.append(photos)
        if photos:
            max_photo = max(max_photo, max(photos))
    vis = np.zeros((max_photo, len(ids)), dtype=bool)
    for j, photos in enumerate(viss):
        for ph in photos:
            vis[ph - 1, j] = True
    return Pm3dTable(
        id=np.array(ids), name=names,
        pos=np.array(poss).T, std=np.array(stds).T,
        rms=np.array(rmss), vis=vis,
    )


def load_pm_2d_tbl(path: str) -> Pm2dTable:
    ids, ims, poss, ress = [], [], [], []
    for cols, row in _csv_rows(path):
        d = dict(zip(cols, row))
        ids.append(int(d["Object Point ID"]))
        ims.append(int(d["Photo #"]))
        poss.append([float(d["X (pixels)"]), float(d["Y (pixels)"])])
        ress.append([float(d.get("Residual X", "nan")),
                     float(d.get("Residual Y", "nan"))])
    return Pm2dTable(
        id=np.array(ids), im_no=np.array(ims),
        pos=np.array(poss).T, res=np.array(ress).T,
    )


_EO_NAMES = ("Omega", "Phi", "Kappa", "Xc", "Yc", "Zc")
# PM correlation lines name X/Y/Z for Xc/Yc/Zc.
_EO_INDEX = {"Omega": 3, "Phi": 4, "Kappa": 5, "X": 0, "Y": 1, "Z": 2,
             "Xc": 0, "Yc": 1, "Zc": 2}
_NUM = r"([-\d.eE+]+)"


def _grab(pat, txt, cast=float, default=None):
    m = re.search(pat, txt, re.IGNORECASE)
    return cast(m.group(1)) if m else default


def _grab_stat(txt, label, unit=r"[^\s]*"):
    """'<label>: <num> <unit>' followed by an optional 'Point <id>'."""
    m = re.search(label + r":\s*" + _NUM + r"[^\n]*\n(?:\s*Point (\d+))?",
                  txt)
    if not m:
        return {}
    out = {"value": float(m.group(1))}
    if m.group(2):
        out["id"] = int(m.group(2))
    return out


def load_pm_report(path: str) -> PmReport:
    """Parse a PhotoModeler processing report (loadpmreport.m: project
    header, status, processing options, total error, per-photo EO
    values/deviations/correlations, image counts, cameras, uncalibrated
    points, mark residuals, tightness, precision and angle statistics)."""
    rep = PmReport()
    txt = open(path, "rt", errors="replace").read()

    rep.proj_name = _grab(r"Project Name:\s*(\S+)", txt, str, "")
    rep.run_date = _grab(r"Last Processing Attempt:\s*([^\n]+)", txt,
                         str, "").strip()
    rep.pm_version = _grab(r"Version:\s*([^\n]+)", txt, str, "").strip()
    rep.status = _grab(r"Status:\s*(\w+)", txt, str, "")
    rep.n_iterations = _grab(r"Number of Processing Iterations:\s*(\d+)",
                             txt, int, -1)
    rep.n_stages = _grab(r"Number of Processing Stages:\s*(\d+)", txt,
                         int, -1)
    rep.first_error = _grab(r"First Error:\s*" + _NUM, txt, float, np.nan)
    rep.last_error = _grab(r"Last Error:\s*" + _NUM, txt, float, np.nan)

    onoff = lambda s: s is not None and s.lower() == "on"  # noqa: E731
    rep.proc_opts = {
        "orient": onoff(_grab(r"Orientation:\s*(\w+)", txt, str)),
        "global_opt": onoff(_grab(r"Global Optimization:\s*(\w+)", txt,
                                  str)),
        "calibration": onoff(_grab(r"\n\s*Calibration:\s*(\w+)", txt, str)),
        "constraints": onoff(_grab(r"Constraints:\s*(\w+)", txt, str)),
    }

    # Photo blocks: "Photo N: label" followed by the six EO parameters,
    # each with Value / Deviation / optional Correlations lines.
    photos = re.split(r"Photo (\d+): (\S+)", txt)
    eo_rows, std_rows, labels = [], [], []
    deg = np.pi / 180.0
    for k in range(1, len(photos) - 2, 3):
        label = photos[k + 1]
        body = photos[k + 2]
        photo_no = int(photos[k])
        vals, devs = {}, {}
        for nm in _EO_NAMES:
            blk = re.search(
                nm + r"\s*\n\s*Value:\s*" + _NUM +
                r"[^\n]*(?:\n\s*Deviation:[^:]*:\s*" + _NUM + r"[^\n]*)?"
                r"(?:\n\s*Correlations over\s*[\d.]+%:\s*([^\n]*))?",
                body)
            if blk is None:
                vals[nm] = devs[nm] = np.nan
                continue
            vals[nm] = float(blk.group(1))
            devs[nm] = float(blk.group(2)) if blk.group(2) else np.nan
            if blk.group(3):
                for cm in re.finditer(r"(\w+):" + _NUM + r"%",
                                      blk.group(3)):
                    j = _EO_INDEX.get(cm.group(1))
                    if j is not None:
                        rep.eo_corr.append(
                            (photo_no, _EO_INDEX[nm], j,
                             float(cm.group(2)) / 100.0))
        eo_rows.append([vals["Xc"], vals["Yc"], vals["Zc"],
                        vals["Omega"] * deg, vals["Phi"] * deg,
                        vals["Kappa"] * deg])
        std_rows.append([devs["Xc"], devs["Yc"], devs["Zc"],
                         devs["Omega"] * deg, devs["Phi"] * deg,
                         devs["Kappa"] * deg])
        labels.append(label)
    if eo_rows:
        rep.eo = np.array(eo_rows)
        rep.eo_std = np.array(std_rows)
        rep.photo_labels = labels

    rep.image_count = {
        "total": _grab(r"Total Number:\s*(\d+)", txt, int),
        "bad": _grab(r"Bad Photos:\s*(\d+)", txt, int),
        "weak": _grab(r"Weak Photos:\s*(\d+)", txt, int),
        "ok": _grab(r"OK Photos:\s*(\d+)", txt, int),
        "oriented": _grab(r"Number Oriented:\s*(\d+)", txt, int),
        "inv_cam": _grab(r"Number with inverse camera flags set:\s*(\d+)",
                         txt, int),
    }

    for cm in re.finditer(
            r"Camera(\d+):\s*(\S+)\s*\n\s*Calibration:\s*(\w+)\s*\n"
            r"\s*Number of photos using camera:\s*(\d+)", txt):
        rep.cameras.append({
            "name": cm.group(2),
            "calibrated": cm.group(3).lower() in ("yes", "on"),
            "used_in_images": int(cm.group(4)),
        })

    for um in re.finditer(r"Point (\d+) on Photo (\d+)\s*\n",
                          txt[txt.find("calibrated coverage region"):
                              txt.find("Point Marking Residuals")]
                          if "coverage region" in txt else ""):
        rep.pts_uncalibrated.append((int(um.group(1)), int(um.group(2))))

    mr = txt[txt.find("Point Marking Residuals"):]
    m = re.search(r"Maximum:\s*" + _NUM +
                  r" pixels\s*\n\s*Point (\d+) on Photo (\d+)", mr)
    rep.mark_residuals = {
        "overall_rms": _grab(r"Overall RMS:\s*" + _NUM, mr),
        "mark_max": ({"rms": float(m.group(1)), "id": int(m.group(2)),
                      "im_no": int(m.group(3))} if m else {}),
        "obj_max_rms": _grab_stat(mr, r"Maximum RMS"),
        "obj_min_rms": _grab_stat(mr, r"Minimum RMS"),
    }
    tg = txt[txt.find("Point Tightness"):]
    rep.tightness = {"max": _grab_stat(tg, "Maximum"),
                     "min": _grab_stat(tg, "Minimum")}
    pp = txt[txt.find("Point Precisions"):]
    rep.pt_precision = {
        "overall_3d_rms": _grab(r"Overall RMS Vector Length:\s*" + _NUM,
                                pp),
        "max_vector": _grab_stat(pp, "Maximum Vector Length"),
        "min_vector": _grab_stat(pp, "Minimum Vector Length"),
        "max": [_grab(rf"Maximum {c}:\s*" + _NUM, pp) for c in "XYZ"],
        "min": [_grab(rf"Minimum {c}:\s*" + _NUM, pp) for c in "XYZ"],
    }
    pa = txt[txt.find("Point Angles"):]
    rep.pt_angles = {"max": _grab_stat(pa, "Maximum"),
                     "min": _grab_stat(pa, "Minimum"),
                     "avg": _grab(r"Average:\s*" + _NUM, pa)}
    return rep
