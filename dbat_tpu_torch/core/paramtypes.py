"""Human-readable parameter names for the unknown vector x.

Ref code/misc/buildparamtypes.m: IO params cc/px/py/as/sk/K1../P1..
(suffixed with the camera number when multiple), EO params
EX/EY/EZ/om/ph/ka-<label>, OP params OX/OY/OZ (CX/CY/CZ for control,
HX/HY/HZ for check points) suffixed with the point id. Used by the
rank-forensics output and the report.
"""

from __future__ import annotations

import numpy as np


def param_names(project, spec) -> list:
    """Name for every entry of x, in x order."""
    p = project
    names = [""] * spec.n_x
    io_names = ["cc", "px", "py", "as", "sk"] + [
        f"K{i+1}" for i in range(p.nK)
    ] + [f"P{i+1}" for i in range(p.nP)]
    io_x = np.asarray(spec.io_x)
    lead = np.asarray(spec.io_leading)
    multi = len(np.unique(p.io_block[:, 0])) > 1
    for i in range(p.n_img):
        for j in range(io_x.shape[1]):
            if lead[i, j]:
                nm = io_names[j]
                if multi:
                    nm = f"{nm}-{i+1}"
                names[io_x[i, j]] = nm
    eo_names = ["EX", "EY", "EZ", "om", "ph", "ka"]
    eo_x = np.asarray(spec.eo_x)
    eo_lead = np.asarray(spec.eo_leading)
    for i in range(p.n_img):
        label = p.img_labels[i] if p.img_labels else str(i + 1)
        for j in range(6):
            if eo_lead[i, j]:
                names[eo_x[i, j]] = f"{eo_names[j]}-{label}"
    op_x = np.asarray(spec.op_x)
    for k in range(p.n_op):
        if p.is_ctrl[k]:
            pre = ("CX", "CY", "CZ")
        elif p.is_check[k]:
            pre = ("HX", "HY", "HZ")
        else:
            pre = ("OX", "OY", "OZ")
        for j in range(3):
            if op_x[k, j] >= 0:
                names[op_x[k, j]] = f"{pre[j]}-{p.op_id[k]}"
    return names
