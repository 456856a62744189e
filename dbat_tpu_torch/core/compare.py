"""Project comparison with tolerances — the regression tool (a numpy copy
of dbat_tpu/core/compare.py).

Analog of the reference's comp_struct (code/xchg/comp_struct/, used to
diff results against saved references, SURVEY.md §4.2).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def compare_projects(a, b, rtol=1e-9, atol=1e-12, verbose=False):
    """Compare two Projects field by field.

    Returns a list of difference descriptions (empty = equal within
    tolerance)."""
    diffs = []
    for f in dataclasses.fields(a):
        va = getattr(a, f.name)
        vb = getattr(b, f.name)
        if isinstance(va, np.ndarray):
            if va.shape != vb.shape:
                diffs.append(f"{f.name}: shape {va.shape} vs {vb.shape}")
                continue
            if va.dtype.kind in "fc":
                ok = np.allclose(va, vb, rtol=rtol, atol=atol,
                                 equal_nan=True)
                if not ok:
                    with np.errstate(invalid="ignore"):
                        d = np.nanmax(np.abs(va - vb))
                    diffs.append(f"{f.name}: max abs diff {d:g}")
            else:
                if not np.array_equal(va, vb):
                    diffs.append(f"{f.name}: integer/bool mismatch")
        elif isinstance(va, list):
            if va != vb:
                diffs.append(f"{f.name}: list mismatch")
        else:
            if va != vb:
                diffs.append(f"{f.name}: {va!r} != {vb!r}")
    if verbose:
        for d in diffs:
            print("DIFF:", d)
    return diffs
