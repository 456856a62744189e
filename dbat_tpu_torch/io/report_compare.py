"""Structured numeric comparison of DBAT-style result files (a copy of
dbat_tpu/io/report_compare.py).

The report analog of core/compare.py (ref comp_struct,
code/xchg/comp_struct/): parse two reports into indentation-structured
(path, label) -> numbers maps and diff EVERY numeric field to the
tolerance implied by its printed precision — per-parameter values and
deviations, significance levels, correlation percentages, quality
tables — instead of a handful of golden substrings
(ref generator: code/bundle/bundle_result_file.m:292-965).

Printed-precision tolerance: two implementations that agree to the
last printed digit may still round that digit differently (f64 vs
long-double accumulation order), so tokens compare equal within
1.6 ulp of the coarser of the two printed precisions; integers
compare exactly.
"""

from __future__ import annotations

import re

_NUM_RE = re.compile(r"[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?")


def _ulp(tok: str) -> float:
    """Unit-in-the-last-printed-place of a numeric literal."""
    m = re.match(r"[-+]?(\d+)\.?(\d*)(?:[eE]([-+]?\d+))?$", tok)
    if not m:
        return 0.0
    dec = len(m.group(2))
    exp = int(m.group(3) or 0)
    # Clamp: pseudo-numbers inside UUID-like tokens can carry huge
    # exponents (e.g. '15e-247788' out of a hex UUID).
    return 10.0 ** max(min(exp - dec, 300), -300)


def _is_int(tok: str) -> bool:
    return re.match(r"[-+]?\d+$", tok) is not None


def parse_report(text: str):
    """Parse a report into {key: [numbers...]} with keys qualified by
    the indentation path.

    Each line's key is the path of enclosing (shallower-indented)
    lines plus its own label with numeric tokens replaced by '#'.
    Values are (float, ulp, is_int) tuples in line order; repeated
    keys append.  Lines whose value part is a file path keep only the
    label (paths are machine-specific).
    """
    entries = {}
    stack = []  # (indent, normalized label)
    for raw in text.splitlines():
        if not raw.strip():
            continue
        indent = len(raw) - len(raw.lstrip())
        line = raw.strip()
        # Path-valued lines: compare the label only.  A token counts
        # as a path when it starts like one (/, \\, ..) or ends in a
        # file extension — NOT merely containing '/', which would
        # also swallow unit strings like '326.797 px/mm' and exempt
        # the resolution values from comparison.
        if ":" in line:
            val_toks = line.split(":", 1)[1].split()
            if any(t.startswith(("/", "\\", "..", "images/"))
                   or re.search(r"/[^/]+\.\w+$", t) for t in val_toks):
                line = line.split(":", 1)[0] + ":"
        toks = _NUM_RE.findall(line)
        # Collapse whitespace runs: the reference pads value columns
        # to the longest label in each table, so identical fields can
        # carry different internal spacing.
        label = re.sub(r"\s+", " ", _NUM_RE.sub("#", line))
        while stack and stack[-1][0] >= indent:
            stack.pop()
        key = tuple(s for _i, s in stack) + (label,)
        stack.append((indent, label))
        nums = [(float(t), _ulp(t), _is_int(t)) for t in toks]
        entries.setdefault(key, []).append(nums)
    return entries


def _match(key, patterns):
    flat = " / ".join(key)
    return any(p in flat for p in patterns)


def compare_reports(ours: str, golden: str, volatile=(), golden_only=(),
                    ours_only=(), rtol: float = 0.0, loose=()):
    """Diff two reports; returns a list of difference strings (empty =
    numerically identical within printed precision).

    volatile: substrings of keys excluded from comparison entirely
    (timestamps, versions, timings).  golden_only / ours_only:
    substrings of keys allowed to exist on one side only.  rtol: extra
    relative slack on top of the printed-precision ulp tolerance (for
    statistics that are legitimately solver-path-sensitive).  loose:
    iterable of (key-substring, rtol) pairs applying a larger relative
    tolerance to specific keys (e.g. display-only sensor constants the
    reference derives from calibration state we do not replicate).
    """
    a = parse_report(ours)
    b = parse_report(golden)
    diffs = []
    for key in set(a) | set(b):
        if _match(key, volatile):
            continue
        flat = " / ".join(key)
        if key not in b:
            if not _match(key, ours_only):
                diffs.append(f"ours-only key: {flat}")
            continue
        if key not in a:
            if not _match(key, golden_only):
                diffs.append(f"golden-only key: {flat}")
            continue
        la, lb = a[key], b[key]
        if len(la) != len(lb):
            diffs.append(
                f"{flat}: {len(la)} occurrences vs {len(lb)}")
            continue
        for occ, (na, nb) in enumerate(zip(la, lb)):
            if len(na) != len(nb):
                diffs.append(
                    f"{flat} (occurrence {occ}): {len(na)} numbers "
                    f"vs {len(nb)}")
                continue
            rtol_k = rtol
            for pat, r in loose:
                if pat in flat:
                    rtol_k = max(rtol_k, r)
            for (va, ua, ia), (vb, ub, ib) in zip(na, nb):
                if ia and ib:
                    if va != vb:
                        diffs.append(
                            f"{flat} (occurrence {occ}): {va:g} != "
                            f"{vb:g} (integer)")
                    continue
                tol = 1.6 * max(ua, ub) + rtol_k * abs(vb)
                if abs(va - vb) > tol:
                    diffs.append(
                        f"{flat} (occurrence {occ}): {va:g} vs "
                        f"{vb:g} (tol {tol:g})")
    return sorted(diffs)
