"""Run-everything integration harness (ref code/demo/runalldemos.m;
counterpart of dbat_tpu/pipeline/run_all.py).

Usage: python -m dbat_tpu_torch.pipeline.run_all [--out DIR] [--fast]
                                                 [--device cuda|cpu]

Runs every demo pipeline against the shipped reference data (under
`demos.REFERENCE_DATA`) on `--device` (default the card), writes
DBAT-style reports into DIR, and prints a one-line verdict per demo
with the expected golden value.  Exits 1 when any demo fails.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import sys
import tempfile
import time

from ..device import resolve_device
from ..io.report import write_report
from . import demos
from .script import run_script


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=osp.join(tempfile.gettempdir(),
                                              "dbat_tpu_torch_demos"))
    ap.add_argument("--fast", action="store_true",
                    help="skip the large roma network")
    ap.add_argument("--device", default="cuda",
                    help="where the bundles run (default the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    os.makedirs(args.out, exist_ok=True)
    results = []

    def record(name, sigma0, expected, ok, project=None, info=None):
        status = "OK" if (ok and abs(sigma0 - expected) < 1e-3) else "FAIL"
        results.append((name, status, sigma0, expected))
        print(f"{name:28s} {status}  sigma0={sigma0:.6g} "
              f"(expected {expected})", flush=True)
        if project is not None and info is not None:
            write_report(project, info,
                         osp.join(args.out, f"{name}-report.txt"))

    def script(*parts):
        return osp.join(demos.REFERENCE_DATA, "script", *parts)

    t0 = time.time()
    for model, exp in ((3, 1.6148), (-1, 1.62168), (2, 1.68901),
                       (4, 1.61247), (5, 1.6148)):
        r, ok, it, s0, info = demos.camcal(model=model, device=device)
        record(f"camcal-model{model}", s0, exp, ok, r, info)

    for lab, exp in (("s1", 1.0419), ("s2", 0.984904), ("s3", 0.965375),
                     ("s4", 1.07447)):
        r, ok, it, s0, info = demos.prague_sxb(lab, device=device)
        record(f"sxb-{lab}", s0, exp, ok, r, info)

    for use, exp in ((False, 1.07447), (True, 1.06942)):
        r, ok, it, s0, info = demos.sxb_prior_eo(use, device=device)
        record(f"sxb-prior-eo-{use}", s0, exp, ok)

    r, ok, it, s0, info = demos.ps_postproc(stats_dir=args.out,
                                            device=device)
    record("sxb-psz", s0, 0.710294, ok, r, info)

    sr = run_script(script("camcaldemo", "camcaldemo.xml"),
                    output_dir=osp.join(args.out, "script-camcal"),
                    device=device)
    record("script-camcal", sr.sigma0, 1.6148, sr.ok)

    sr = run_script(script("sxb", "sxb.xml"),
                    output_dir=osp.join(args.out, "script-sxb"),
                    device=device)
    record("script-sxb", sr.sigma0, 1.1786, sr.ok)

    if not args.fast:
        sr = run_script(script("romabundledemo", "romabundledemo.xml"),
                        output_dir=osp.join(args.out, "script-roma"),
                        device=device)
        record("script-roma", sr.sigma0, 0.582769, sr.ok)

    n_fail = sum(1 for _, s, _, _ in results if s != "OK")
    print(f"\n{len(results)} demos, {n_fail} failures, "
          f"{time.time()-t0:.0f}s. Reports in {args.out}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
