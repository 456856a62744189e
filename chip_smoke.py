#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dbat_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printing its elapsed seconds as it ends:
  1. device report (nvidia-smi name and power limit, torch and CUDA);
  2. build of the CUDA kernels (one nvcc per source, all started
     together, one library each) with ptxas's report;
  3. the C5-shape network of bench.py (239 cameras, 17,993 points,
     196,715 observations, 8 self-calibrated IO parameters) and its
     SchurOps in float32 on the card; the roma watchdog network (353
     cameras, 26,321 points, 90,561 observations, fixed IO: nb = 6) and
     its SchurOps in float32 and float64; the C5 network with fixed IO
     written as a PhotoScan .psz (write_psz, a local->global
     similarity) and read back (load_psz, psz_to_pm, from_pm), and its
     SchurOps in float32 (nb = 6);
  4. kernel checks: every kernel on the inputs the main paths give it
     (C5 f32; roma f32 and f64, the watchdog's and the polish's shapes;
     C5 f64, the covariance's; the loaded .psz, C5 f32 at nb 6; a small
     network in f64), against its plain PyTorch version, with
     its device time with the L2 flushed (held against its HBM bound)
     and in a burst of launches (operands warm in L2), the time of one
     call with the wrapper's host work, the host microseconds per call,
     bounds and a library yardstick;
  5. small references: a small network solved on the card (kernels) and
     on the CPU (plain versions) by fused_gna, and by bundle() with LM
     on the Schur backend, must agree;
  6. the C5 main path: fused_gna to the noise floor (bench.py's gate),
     then 10 fixed iterations;
  7. repeatability: the C5 fixed run 5 more times; the final x must be
     bitwise equal across the runs (every f32 sum runs in a fixed
     order);
  8. the roma watchdog: bundle(lm, f32, schur) cold and twice warm on
     fresh networks, bench.py's gate (ok and sigma0 < 1.05) on each;
  9. the f64 polish: an f32 bundle() asked for a relative criterion f32
     cannot certify, so the f64 polish runs on the card; its outcome is
     held to the JAX package's on the same network (POLISH_EXPECT);
 10. the posterior covariance at the C5 shape: an f32 bundle() to the
     noise floor, then on a fresh Covariance (extraction in f64 on the
     card) factorize, cio, ceo, ciof, cop over every point
     cold and warm, posterior_std, significance and the correlation
     lists; every posterior block finite and every estimated variance
     positive; cop bitwise equal on a second fresh Covariance; copf's
     diagonal blocks equal to cop's (COPF_REL_TOL); the posterior std
     within STD_REL_TOL of an f64 extraction of the same solution in
     the world frame; the DBAT result file written (write_report);
 11. the DBAT script runner at the C5 shape: the C5 network written as a
     script folder (camera file, image table, 196,715 image points,
     control points, prior EO table; write_script_folder of
     tests/port_script_folder.py) and run by
     run_script on the card (C5_SCRIPT_OPS: ray-count check, loaded IO
     and EO, the self-calibration, forward intersection, the f64
     bundle, then the report and the IO, EO and residual files), with
     each stage's time; gates: ok and sigma0 < 1.05, every file
     written, every EO variance finite and positive, the script's
     project equal to the same network built in memory except in
     SCRIPT_ONLY_FIELDS, the in-memory bundle(gna, float64, auto) with
     the same iterations and sigma0 and x within 1e-12 relative, and
     the report equal to the in-memory one outside VOLATILE_REPORT_KEYS
     (compare_reports);
 12. the PhotoModeler and PhotoScan input at the C5 shape: (a) the .psz
     of phase 3 held to tests/test_psz_fullscale.py's gates (camera,
     point and mark counts, fixed IO, every EO estimated, reprojection
     residuals at the loaded values: median < 0.25 px, max < 10 px),
     then bundle(gna, float32, schur, max_iter=6, conv_tol=1.02
     sqrt(dof), abs_term) on the card: ok and sigma0 < 1.05, both
     kernels launched in f32; (b) the C5 network as a PhotoModeler text
     export (write_pm_export of tests/port_pm_export.py), load_pm,
     from_pm, the 8-parameter self-calibration, bundle(gna, float64,
     auto) on the card: ok and sigma0 < 1.05, both kernels launched in
     f64; (c) ps_postproc (with ray and angle filtering) and camcal on
     small networks, card against CPU: the same iterations, sigma0 and
     x within 1e-9 relative; (d) the host's native helpers built
     (have_native) and equal to their numpy formulas (NATIVE_TOL);
 13. the feature front-end at DBAT's camcal shape (CAMCAL_FEATURES: 21
     images of 2272 x 1704 px, 99 points seen by all of them, 2,079
     observations): the
     network rendered, written as 8-bit gray PNGs with every filter type
     beside tests/test_script_features.py's <features> script for this
     camera (tests/port_features.py) and read back by load_images (no
     matplotlib), each stage timed; detect, describe and match twice on
     the card, bit for bit equal; the card against the CPU on the first
     FEATURES_CPU_IMAGES images (valid masks equal, xy within 1e-3 px,
     descriptors within 1e-5, at most 0.5% of the matches different);
     then run_script(backend="schur") on the card: load_images, detect,
     describe, match, tracks, pose-graph initialisation, two screens,
     two f64 bundles, the report.  Gates: tests/test_features.py's
     detection accuracy, tracks > 0.7 of the points,
     tests/test_script_features.py's script gates (ok, n_op > 0.6 and
     n_obs > 0.5 of the truth, sigma0 < 1.0), both kernels launched in
     f64 and, on the last bundle's inputs (f64, nb 6, every camera pair
     sharing its points), timed and held against their plain versions;
     each bundle run again by bundle() on the CPU from the same start:
     the same ok and iterations, sigma0 and the final x within 1e-9
     relative.  No plots are drawn here (tests/test_torch_plotting.py
     holds them on the CPU);
 14. the mesh at the C5 shape: the point-partitioned backend
     (parallel/sharded.py) as MESH_SHARDS shards on the one card (its
     cost on one card, not scaling): (a) one f64 assembly and solve at
     x0 against the unsharded SchurOps (g, the step and the matvec
     within MESH_STEP_TOL), every kernel call of it, shard by shard,
     against its plain version (REL_TOL, f64); (b) every kernel call
     of one f32 assembly and solve, shard by shard, against its plain
     version (REL_TOL), the largest shard's calls timed against their
     bounds; (c) fused_gna on the shards to the noise floor (bench.py's
     gate), then 10 fixed iterations from phase 6's start on 1 and on 8
     shards (8 within MESH_RN_TOL of 1, the 8-shard run bitwise equal on
     a second run; the gap to phase 6's unsharded run and the time per
     iteration against phase 7's are measured) and from x0 on 8 shards
     against the unsharded ops, run before (c) (within MESH_RN_TOL:
     scripts/sharded_tpu_bench.py's gate); (d) bundle(gna, float64, mesh=) against bundle(gna,
     float64, schur) on the card (the same iterations, sigma0 within
     1e-9 relative, x within 1e-8), and the COP dealt over the shards
     (cop(mesh=)) against cop() on one device (every variance within
     1e-6 relative).
Phase 5 also holds the small network's f64 covariance on the card to
the CPU's (COV_SMALL_TOL), f64 PCG on the card to the direct solve, and
a DBAT script on the small network (POSEGRAPH_SCRIPT_OPS: pose-graph
initialisation, outlier screen, bundle) run from one folder on the card
and on the CPU to 1e-9 in sigma0 and x.
Phases 6, 8, 9, 10, 11, 12, 13 and 14 each zero the launch counts just
before and read them just after; every kernel must have launched in
each (in f64 in 9; in 10 both in the bundle and in the covariance after
it; in 11 in f64, both in the bundle and in the output files'
covariances; in 12 in f32 in (a) and in f64 in (b); in 13 in f64; in
14 in (c)'s sharded runs and bundle(mesh=), the "sharded" path).

Exits nonzero, printing no result, without a CUDA card or when any
phase fails.  The last three lines are the kernels JSON, the card's
name and power limit, and {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

T0 = time.perf_counter()
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
#: H100 SXM peak outside the tensor cores (NVIDIA's data sheet)
FLOP_PER_S = {"float32": 67e12, "float64": 34e12}
SMALL = dict(n_img=12, n_pt=400, rays_per_pt=(3, 9), n_obs_target=2000,
             n_ctrl=4, noise_px=0.1, ip_std_px=0.1,
             est_io_cols=("cc", "px", "py", "K1", "K2", "K3", "P1", "P2"),
             seed=5)
#: kernel vs plain, max |diff| / max |plain|: f32 sums in another order
#: (kernel B adds up to ~2,400 terms per output), f64 likewise.
REL_TOL = {"float32": 1e-5, "float64": 1e-12}
#: The polish phase's call and the outcome the JAX package gives for it
#: on the same network (scripts/jax_polish_reference.py: dbat_tpu's
#: bundle() on the CPU, eager): the ROMA_RING network, LM in f32 asked
#: for a relative 1e-6, stops on the f32 floor-stall rule after 6
#: iterations; the 2-step f64 polish runs 3 (TOO_MANY_ITERS, accepted
#: because the f32 solve was OK).  Under jit, XLA's CPU build of the
#: f32 Schur solve fails to factor at lambda <= 87.9 on this network
#: and the run ends TOO_MANY_ITERS; eager, it behaves as the JAX
#: package's TPU record of this network (2 watchdog iterations, sigma0
#: 0.9912, BENCH_r05.json) and as the port.
POLISH_CALL = dict(damping="lm", dtype="float32", backend="schur",
                   max_iter=40, conv_tol=1e-6, abs_term=False)
POLISH_EXPECT = dict(ok=True, code=0, iters=6, polish_iters=3,
                     sigma0_prepolish=0.9907043526656706,
                     sigma0=0.9906293873032684)
#: Small network, f64 covariance card vs CPU: max |diff| / max |CPU| of
#: each extraction (sums in another order, amplified by S's condition).
COV_SMALL_TOL = 1e-9
#: C5, f64 extraction: copf's diagonal 3x3 blocks against cop's, over
#: each block's largest entry (copf scatters W and multiplies by V^-1
#: after the sum, cop folds V^-1 into each ray first).
COPF_REL_TOL = 1e-8
#: The host's native helpers against their numpy formulas, over each
#: result's largest entry (sums in another order).
NATIVE_TOL = 1e-12
#: The filter of ps_postproc card vs CPU (phase 12 (c)), on
#: tests/port_pm_export.py's SMALL_PSZ.
PSZ_FILTER = dict(min_rays=4, min_angle=10.0)
#: C5: posterior std of every estimated parameter from the f32 bundle's
#: f64 extraction, in the solve's centred frame, against an
#: f64 extraction of the same solution in the world frame, relative:
#: f64 rounding amplified by the scaled S's condition (~1e7-1e8).
STD_REL_TOL = 1e-6


#: Phase 14: the C5 network as this many shards on the one card.
MESH_SHARDS = 8
#: One f64 assembly and solve, sharded against unsharded: max |diff| /
#: max |unsharded| of g, the step and the matvec (the rtols of
#: tests/test_multichip.py).
MESH_STEP_TOL = {"g": 1e-10, "p": 1e-7, "matvec": 1e-8}
#: 10 fixed f32 iterations on the mesh against phase 6's unsharded run:
#: the final ||r_w||, relative (the gate of scripts/sharded_tpu_bench.py).
MESH_RN_TOL = 5e-4


def log(msg):
    print(msg, flush=True)


def phase_done(name, t_start, card):
    log(f"[phase {name}] {time.perf_counter() - t_start:.2f} s "
        f"(total {time.perf_counter() - T0:.2f} s) on {card}")


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def net(kw, seed_perturb):
    from dbat_tpu_torch.core.serial import build_serial
    from dbat_tpu_torch.pipeline.synthetic import make_ring_network, perturb

    s = make_ring_network(**kw)
    perturb(s, eo_pos=0.02, eo_ang=0.004, op_pos=0.02, seed=seed_perturb)
    return s, build_serial(s)


def capture_inputs(ops):
    """Run one assembly and solve at x0 and record what each kernel
    call receives: {fb name: (A, B, fb)} and {"pair_bucket": (Y, fb)}."""
    seen = {}
    names = ("_fb_u", "_fb_v", "_fb_w", "_fb_y", "_fb_pair")
    originals = {nm: getattr(ops, nm) for nm in names}
    plan = ops._pair_plan

    class RecFB:
        def __init__(self, nm, fb):
            self.nm, self.fb = nm, fb
            self.d_out, self.g, self.table = fb.d_out, fb.g, fb.table

        def __call__(self, A, B):
            seen.setdefault(self.nm, (A, B, self.fb))
            return self.fb(A, B)

    def rec_plan(Yf, fb):
        seen.setdefault("pair_bucket", (Yf, fb.fb))
        return plan(Yf, fb)

    for nm in names:
        setattr(ops, nm, RecFB(nm, originals[nm]))
    ops._pair_plan = rec_plan
    try:
        x0 = ops.x0().to(ops.dtype)
        U, V, Wb, gc, gp, rw = ops._assemble_impl(x0)
        ops._solve_impl(U, V, Wb, -ops.join_x(gc, gp), 0.0)
    finally:
        for nm in names:
            setattr(ops, nm, originals[nm])
        ops._pair_plan = plan
    return seen


def library_call(nm, A, B, nb):
    """One PyTorch call computing the same flat block product (torch.bmm
    on block views); a yardstick only, the port never calls it."""
    import torch

    n = A.shape[0]
    if nm == "_fb_u":
        a = A.view(n, 2, nb)
        return lambda: torch.bmm(a.transpose(1, 2), a)
    if nm == "_fb_v":
        b = A.view(n, 2, 3)
        return lambda: torch.bmm(b.transpose(1, 2), b)
    if nm == "_fb_w":
        a, b = A.view(n, 2, nb), B.view(n, 2, 3)
        return lambda: torch.bmm(a.transpose(1, 2), b)
    if nm == "_fb_y":
        a, b = A.view(n, nb, 3), B.view(n, 3, 3)
        return lambda: torch.bmm(a, b)
    a = A.view(n, nb, 3)
    return lambda: torch.bmm(a, a.transpose(1, 2))


def nbytes(*tensors):
    """Bytes of the distinct tensors (an operand passed twice counts
    once)."""
    seen = {}
    for t in tensors:
        seen[t.data_ptr()] = t.numel() * t.element_size()
    return sum(seen.values())


def capture_shard_inputs(ops):
    """capture_inputs for sharded ops (parallel/sharded.py): one dict per
    owned shard, in shard order.  The shards share their FlatBilinear
    objects and call each once per shard, in shard order."""
    seen = [{} for _ in ops.shards]
    names = ("_fb_u", "_fb_v", "_fb_w", "_fb_y", "_fb_pair")
    originals = {nm: getattr(ops, nm) for nm in names}
    plans = [sh.pair_plan for sh in ops.shards]

    class RecFB:
        def __init__(self, nm, fb):
            self.nm, self.fb, self.calls = nm, fb, 0
            self.d_out, self.g, self.table = fb.d_out, fb.g, fb.table

        def __call__(self, A, B):
            seen[self.calls].setdefault(self.nm, (A, B, self.fb))
            self.calls += 1
            return self.fb(A, B)

    def rec_plan(k, plan):
        def call(Yf, fb):
            seen[k].setdefault("pair_bucket", (Yf, fb.fb))
            return plan(Yf, fb)
        return call

    for nm in names:
        setattr(ops, nm, RecFB(nm, originals[nm]))
    for k, sh in enumerate(ops.shards):
        sh.pair_plan = rec_plan(k, plans[k])
    try:
        x0 = ops.x0().to(ops.dtype)
        U, V, Wb, gc, gp, rw = ops._assemble_impl(x0)
        ops._solve_impl(U, V, Wb, -ops.join_x(gc, gp), 0.0)
    finally:
        for nm in names:
            setattr(ops, nm, originals[nm])
        for sh, plan in zip(ops.shards, plans):
            sh.pair_plan = plan
    return seen


def check_kernels(ops, dtype_name, timed):
    """Every kernel against its plain version on the inputs of one
    assembly + solve of `ops`.  Returns per-kernel rows; raises when a
    kernel disagrees beyond REL_TOL."""
    return check_calls(capture_inputs(ops), ops._pair_plan, ops.n_cb,
                       dtype_name, timed)


def check_calls(seen, plan, nb, dtype_name, timed, label=""):
    """Every kernel call in `seen` (capture_inputs) and kernel B on
    `plan`, against their plain versions; timed when `timed`."""
    import torch

    from dbat_tpu_torch.solve.kernels import (
        fused_bilinear, fused_bilinear_plain, pair_bucket_acc,
        pair_bucket_acc_plain,
    )
    from dbat_tpu_torch.timing import call_ms, cold_ms, device_ms

    tol = REL_TOL[dtype_name]
    rows = []
    for nm in ("_fb_u", "_fb_v", "_fb_w", "_fb_y", "_fb_pair"):
        A, B, fb = seen[nm]
        tab = fb.table(A.device)

        def kern():
            return fused_bilinear(A, B, tab, fb.d_out, fb.g)

        def plain():
            return fused_bilinear_plain(A, B, tab, fb.d_out, fb.g)

        k, p = kern(), plain()
        torch.cuda.synchronize()
        err = float((k - p).abs().max())
        rel = err / max(float(p.abs().max()), 1e-300)
        row = {"kernel": "fused_bilinear", "call": nm, "dtype": dtype_name,
               "nb": nb, "rows": A.shape[0],
               "d_a": A.shape[1], "d_b": B.shape[1], "d_out": fb.d_out,
               "g": fb.g, "max_abs_err": err, "rel_err": rel}
        if timed:
            lib = library_call(nm, A, B, nb)
            lib_err = float((lib().reshape(p.shape) - p).abs().max()) \
                / max(float(p.abs().max()), 1e-300)
            b = nbytes(A, B, tab) + p.numel() * p.element_size()
            ops_n = (2 * fb.g - 1) * A.shape[0] * fb.d_out
            warm_ms, host_us = device_ms(kern)
            row.update(ms=cold_ms(kern), warm_ms=warm_ms,
                       call_ms=call_ms(kern), host_us=host_us,
                       plain_ms=cold_ms(plain), library_ms=cold_ms(lib),
                       library_err=lib_err, bytes=b, flops=ops_n)
        rows.append(row)
        log(f"  {label}fused_bilinear{nm[3:]:>6} {dtype_name} "
            f"rows={A.shape[0]} d_a={A.shape[1]} d_b={B.shape[1]} "
            f"d_out={fb.d_out} g={fb.g}: "
            f"max abs err {err:.3e}, rel {rel:.3e} (tol rel {tol:g})"
            + (f" | kernel {row['ms']:.4f} ms device L2 flushed, "
               f"{row['warm_ms']:.4f} ms in a burst, {row['call_ms']:.4f} "
               f"ms one call (wrapper included), host {row['host_us']:.1f} "
               f"us/call; plain {row['plain_ms']:.4f} ms, bmm "
               f"{row['library_ms']:.4f} ms (bmm rel err "
               f"{row['library_err']:.2e})" if timed else ""))
        if not rel <= tol:
            raise RuntimeError(
                f"fused_bilinear {nm}: rel err {rel:.3e} > {tol}")

    Yf, fb = seen["pair_bucket"]
    tab = fb.table(Yf.device)
    args = (Yf, plan.i1, plan.i2, plan.row_ptr, tab, fb.d_out, fb.g, plan.cap)

    def kern():
        return pair_bucket_acc(*args, plan.chunk_ptr)

    def plain():  # the same function; the partition only schedules warps
        return pair_bucket_acc_plain(*args)

    k, p = kern(), plain()
    if not torch.equal(k, kern()):
        raise RuntimeError("pair_bucket_acc: two launches differ")
    torch.cuda.synchronize()
    err = float((k - p).abs().max())
    rel = err / max(float(p.abs().max()), 1e-300)
    row = {"kernel": "pair_bucket_acc", "call": "_pair_acc",
           "dtype": dtype_name, "nb": nb, "chunks": plan.n_chunks,
           "pairs": plan.n_pairs, "padded_pairs": plan.n_rows * plan.cap,
           "bucket_rows": plan.n_rows, "camera_pairs": plan.n_campair,
           "d_y": Yf.shape[1], "d_out": fb.d_out, "g": fb.g,
           "max_abs_err": err, "rel_err": rel}
    if timed:
        b = nbytes(Yf, plan.i1, plan.i2, plan.row_ptr, tab) \
            + p.numel() * p.element_size()
        warm_ms, host_us = device_ms(kern)
        row.update(ms=cold_ms(kern), warm_ms=warm_ms, call_ms=call_ms(kern),
                   host_us=host_us, plain_ms=cold_ms(plain, reps=3),
                   library_ms=None, bytes=b,
                   flops=2 * fb.g * plan.n_pairs * fb.d_out)
    rows.append(row)
    # Logical count, not measured traffic: the kernel skips pad pairs and
    # copies each row's 16-byte-aligned window.
    gathered = 2 * plan.n_pairs * Yf.shape[1] * Yf.element_size()
    log(f"  {label}pair_bucket_acc {dtype_name} pairs={plan.n_pairs} rows="
        f"{plan.n_rows} camera pairs={plan.n_campair} chunks="
        f"{plan.n_chunks} d_out={fb.d_out}, bitwise repeatable: "
        f"max abs err {err:.3e}, rel {rel:.3e} (tol rel {tol:g})"
        + (f" | kernel {row['ms']:.4f} ms device L2 flushed, "
           f"{row['warm_ms']:.4f} ms in a burst, {row['call_ms']:.4f} ms "
           f"one call (wrapper included), host {row['host_us']:.1f} us/call; "
           f"plain {row['plain_ms']:.4f} ms" if timed else "")
        + f"; Y rows gathered (logical count, 2 per pair): "
        f"{gathered / 1e6:.1f} MB "
        f"(Y is {Yf.numel() * Yf.element_size() / 1e6:.1f} MB)")
    if not rel <= tol:
        raise RuntimeError(f"pair_bucket_acc: rel err {rel:.3e} > {tol}")
    return rows


def bound_ms(row):
    t_bytes = row["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = row["flops"] / FLOP_PER_S[row["dtype"]] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def log_rows(rows, label, card):
    """Each timed kernel call against its bound, one line each."""
    log(f"kernel times against their bounds, {label}, on {card}:")
    for r in rows:
        b, by = bound_ms(r)
        lib = r["library_ms"]
        log(f"  {r['kernel']}/{r['call']} {r['dtype']} nb={r['nb']}: "
            f"{r['ms']:.4f} ms device L2 flushed ({r['warm_ms']:.4f} ms in "
            f"a burst, {r['call_ms']:.4f} ms one call, "
            f"host {r['host_us']:.1f} us/call; plain {r['plain_ms']:.4f} "
            f"ms; library {'none' if lib is None else f'{lib:.4f} ms'}) "
            f"vs bound {b:.4f} ms ({by}; {r['bytes'] / 1e6:.1f} MB, "
            f"{r['flops'] / 1e9:.3f} GFLOP): {r['ms'] / b:.2f}x"
            + (" (BELOW the bound: its count is wrong)" if r["ms"] < b
               else ""))


def reset_counts():
    from dbat_tpu_torch.solve.kernels import KERNELS

    for k in KERNELS:
        k.reset_counts()


def read_counts(dtype=None):
    """{kernel name: launches} since the last reset_counts(), all dtypes
    or one."""
    from dbat_tpu_torch.solve.kernels import KERNELS

    return {k.name: k.launches if dtype is None
            else k.launches_by_dtype.get(dtype, 0) for k in KERNELS}


def estimated_variances(blocks, xmap):
    """Diagonals of (n, k, k) posterior blocks at estimated parameters."""
    import numpy as np

    return np.einsum("nii->ni", blocks)[np.asarray(xmap) >= 0]


def std_gap(std_a, std_b):
    """{io/eo/op: (max, median) of |a / b - 1|} over the parameters b
    estimates; raises when a and b estimate different parameters."""
    import numpy as np

    out = {}
    for nm, a, b in zip(("io", "eo", "op"), std_a, std_b):
        est = np.isfinite(b)
        if not np.array_equal(np.isfinite(a), est):
            raise RuntimeError(f"{nm} std: estimated parameters differ")
        r = np.abs(a[est] / b[est] - 1)
        out[nm] = (float(r.max()), float(np.median(r)))
    return out


def covariance_phase(floor, card, launches):
    """Phase 10: bundle() at the C5 shape in f32, then the posterior
    covariance (extracted in f64 on the card), its statistics and the
    result file.  Raises on a failed gate; returns the numbers it
    printed."""
    import tempfile

    import numpy as np
    import torch

    from dbat_tpu_torch.io.report import write_report
    from dbat_tpu_torch.pipeline.synthetic import C5_RING
    from dbat_tpu_torch.solve.bundle import BundleInfo, bundle
    from dbat_tpu_torch.solve.covariance import Covariance
    from dbat_tpu_torch.solve.quality import (
        high_correlations, high_eo_correlations, high_io_correlations_cross,
        high_point_correlations, point_correlations, significance,
    )
    from dbat_tpu_torch.solve.schur import SchurOps

    def timed(fn):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t1

    sc, _ = net(C5_RING, 18)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    (_p, ok, iters, sigma0, info), bundle_s = timed(lambda: bundle(
        sc, damping="gna", dtype="float32", backend="schur", max_iter=20,
        conv_tol=floor, abs_term=True, device="cuda"))
    launches["covariance bundle"] = read_counts()
    log(f"covariance phase on {card}: bundle(gna, f32, schur, conv_tol="
        f"floor, abs_term) at the C5 shape: ok {ok}, code {info.code}, "
        f"{iters} iterations, sigma0 {sigma0!r}, polish_iters "
        f"{info.polish_iters}, {bundle_s:.3f} s; launches "
        f"{launches['covariance bundle']}")
    if not ok:
        raise RuntimeError("covariance phase: the C5 bundle() failed")

    reset_counts()
    cov, init_s = timed(lambda: Covariance(sc, info))
    _, fact_s = timed(cov.factorize)
    (cio, ceo, (ciof, io_entries)), cam_s = timed(
        lambda: (cov.cio(), cov.ceo(), cov.ciof()))
    cop, cop_cold = timed(cov.cop)
    cop_w, cop_warm = timed(cov.cop)
    std, std_s = timed(cov.posterior_std)
    spec = info.spec
    sig = significance(sc, spec, cio)
    corr = {"io": len(high_correlations(cio)),
            "eo": len(high_eo_correlations(ceo, sc.eo_block)),
            "io cross": len(high_io_correlations_cross(ciof, io_entries)),
            "op values": len(high_point_correlations(cop))}
    max_pt_corr = float(np.abs(point_correlations(cop)).max())
    launches["covariance"] = read_counts()
    f64_launches = read_counts(torch.float64)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  Covariance (f64 extraction: the f32 ops rebuilt in f64 on the "
        f"card) {init_s:.3f} s; factorize cold {fact_s:.3f} s (jitter rung "
        f"{cov.jitter}); cio + ceo + ciof {cam_s:.3f} s; cop over "
        f"{sc.n_op} points cold {cop_cold:.3f} s, warm {cop_warm:.3f} s "
        f"(same instance); posterior_std {std_s:.3f} s; peak CUDA memory "
        f"{peak_gb:.3f} GB; launches {launches['covariance']}, of them f64 "
        f"{f64_launches}")
    log(f"  significance K p-values (image 0) {sig['K'][0]}, P {sig['P'][0]}"
        f"; correlations above 0.95: {corr}; largest point correlation "
        f"{max_pt_corr:.4f}; IO std {std[0][0]}")

    blocks = {"cio": (cio, spec.io_x), "ceo": (ceo, spec.eo_x),
              "cop": (cop, spec.op_x)}
    bad = {nm: int((~np.isfinite(b)).sum()) for nm, (b, _) in blocks.items()}
    var_min = {nm: float(estimated_variances(b, xm).min())
               for nm, (b, xm) in blocks.items()}
    n_var = sum(estimated_variances(b, xm).size
                for b, xm in blocks.values())
    log(f"  {n_var} estimated variances; non-finite entries {bad}; "
        f"smallest estimated variance {var_min}")
    if any(bad.values()) or not all(v > 0 for v in var_min.values()):
        raise RuntimeError("covariance: non-finite blocks or a variance <= 0")
    if not np.array_equal(cop, cop_w):
        raise RuntimeError("covariance: a warm cop() differs from the cold")

    cop2, cop2_s = timed(lambda: Covariance(sc, info).cop())
    log(f"  a second fresh Covariance: build + factorize + cop {cop2_s:.3f} "
        f"s, cop bitwise equal: {np.array_equal(cop, cop2)}")
    if not np.array_equal(cop, cop2):
        raise RuntimeError("covariance: cop() does not repeat bit for bit")

    pts = np.linspace(0, sc.n_op - 1, 200).astype(np.int64)
    F, copf_s = timed(lambda: cov.copf(pts=pts))
    copf_err = max(
        float(np.abs(F[3 * a:3 * a + 3, 3 * a:3 * a + 3] - cop[j]).max()
              / np.abs(cop[j]).max())
        for a, j in enumerate(pts) if np.abs(cop[j]).max() > 0)
    log(f"  copf over 200 points ({copf_s:.3f} s): diagonal blocks vs cop, "
        f"max |diff| / block max {copf_err:.3e} (tol {COPF_REL_TOL:g})")
    if not copf_err <= COPF_REL_TOL:
        raise RuntimeError("covariance: copf blocks differ from cop's")

    # The same solution through an f64 SchurOps built on the network in
    # the world frame (x serialized from the project bundle() returned),
    # against the extraction in the solve's centred frame.
    ops64 = SchurOps(sc, spec, dtype=torch.float64, device="cuda")
    cov64 = Covariance(sc, BundleInfo(ops=ops64, spec=spec, sigma0=sigma0))
    std64, std64_s = timed(cov64.posterior_std)
    gap64 = std_gap(std, std64)
    log(f"  f64 extraction in the world frame ({std64_s:.3f} s, jitter rung "
        f"{cov64.jitter}) vs the centred one: (max, median) relative std "
        f"difference {gap64} (tol {STD_REL_TOL:g})")
    del ops64, cov64
    if not all(v[0] <= STD_REL_TOL for v in gap64.values()):
        raise RuntimeError("covariance: the f64 extraction depends on the "
                           "frame")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "c5-dbatreport.txt")
        _, report_s = timed(lambda: write_report(sc, info, path))
        lines = open(path).read().splitlines() \
            if os.path.exists(path) else []
    s0_line = [ln for ln in lines if ln.strip().startswith("Sigma0:")]
    log(f"  write_report: {len(lines)} lines in {report_s:.3f} s; "
        f"{s0_line[0].strip() if s0_line else 'no sigma0 line'}")
    if not (s0_line and float(s0_line[0].split(":")[1])
            == float(f"{info.sigma0:.5g}")):
        raise RuntimeError("covariance: the report's sigma0 line is wrong")
    missing = [nm for key in ("covariance bundle", "covariance")
               for nm, c in launches[key].items() if c <= 0]
    if missing:
        raise RuntimeError(f"covariance phase: kernels not launched: "
                           f"{missing}")
    return {"build_s": init_s, "factorize_s": fact_s, "cop_cold_s": cop_cold,
            "cop_warm_s": cop_warm, "report_s": report_s,
            "jitter": cov.jitter, "peak_gb": peak_gb}


def mesh_phase(card, launches, s, spec, ops, floor, x0_t, n_fixed, rn_fixed,
               unsharded_ms):
    """Phase 14: the point-partitioned backend (parallel/sharded.py) at
    the C5 shape as MESH_SHARDS shards on the one card.  Raises on a
    failed gate; returns the numbers it printed and the timed kernel
    rows of the largest shard."""
    import numpy as np
    import torch

    from dbat_tpu_torch.parallel.mesh import make_mesh
    from dbat_tpu_torch.parallel.sharded import ShardedSchurOps
    from dbat_tpu_torch.pipeline.synthetic import C5_RING
    from dbat_tpu_torch.solve.bundle import bundle
    from dbat_tpu_torch.solve.covariance import Covariance
    from dbat_tpu_torch.solve.fused import fused_gna
    from dbat_tpu_torch.solve.schur import SchurOps

    def timed(fn):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t1

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    mesh = make_mesh(["cuda:0"] * MESH_SHARDS)
    out = {}
    # (a) One f64 assembly and solve at x0 against the unsharded ops.
    sh64, out["ops_f64_s"] = timed(lambda: ShardedSchurOps(
        s, spec, mesh=mesh, dtype=torch.float64))
    one64 = SchurOps(s, spec, dtype=torch.float64, device="cuda")
    x0 = one64.x0()
    st0, st1 = one64.normal(x0), sh64.normal(x0)
    (p0, f0), (p1, f1) = st0.solve(-st0.g), st1.solve(-st1.g)
    errs = {"g": rel(st1.g, st0.g), "p": rel(p1, p0),
            "matvec": rel(st1.matvec(p0), st0.matvec(p0))}
    out["step_f64_rel"] = errs
    log(f"mesh phase on {card}: C5 as {MESH_SHARDS} shards on cuda:0 (S_pt "
        f"{sh64.S_pt}, S_obs {sh64.S_obs}, pairs per shard "
        f"{[sh.pair_plan.n_pairs for sh in sh64.shards]}); "
        f"ShardedSchurOps f64 built in {out['ops_f64_s']:.3f} s")
    log(f"  (a) one f64 step at x0 against the unsharded SchurOps, max "
        f"|diff| / max |unsharded|: {errs} (tol {MESH_STEP_TOL}); "
        f"factorization failed: unsharded {f0}, sharded {f1}")
    if f0 or f1 or any(errs[k] > MESH_STEP_TOL[k] for k in errs):
        raise RuntimeError("mesh phase (a): the sharded step is off the "
                           "unsharded one")
    del one64, st0, st1, p0, p1
    # Every kernel call of one f64 assembly and solve, shard by shard,
    # against its plain version (bundle(mesh=) in (d) runs f64), untimed.
    log("  (a) the kernels at the shard shapes, f64:")
    for k, calls in enumerate(capture_shard_inputs(sh64)):
        check_calls(calls, sh64.shards[k].pair_plan, sh64.n_cb, "float64",
                    timed=False, label=f"shard {k}: ")
    del sh64

    # (b) Every kernel call of one f32 assembly and solve, shard by shard,
    # against its plain version; the largest shard's calls timed.
    sh32, out["ops_f32_s"] = timed(lambda: ShardedSchurOps(
        s, spec, mesh=mesh, dtype=torch.float32))
    seen = capture_shard_inputs(sh32)
    big = max(range(len(sh32.shards)),
              key=lambda k: sh32.shards[k].pair_plan.n_pairs)
    log(f"  (b) the kernels at the shard shapes, f32 (ShardedSchurOps f32 "
        f"built in {out['ops_f32_s']:.3f} s; shard {big} has the most "
        f"pairs and is timed):")
    rows = []
    for k, calls in enumerate(seen):
        r = check_calls(calls, sh32.shards[k].pair_plan, sh32.n_cb,
                        "float32", timed=k == big, label=f"shard {k}: ")
        if k == big:
            rows = r
    del seen

    def fixed_run(o, start):
        r, sec = timed(lambda: fused_gna(o, start, max_iter=n_fixed,
                                         conv_tol=0.0, stall_tol=-1.0))
        return dict(x=r.x, iters=r.iters,
                    rn=float(np.sqrt(r.final_rw @ r.final_rw)),
                    ms_per_iter=1e3 * sec / r.iters,
                    alphas=r.damping["alphas"],
                    host_syncs=r.damping["host_syncs"])

    # The unsharded fixed run from x0, the reference of a sharded one
    # below: outside the path's launch counts.
    x0_unsharded = fixed_run(ops, ops.x0())

    # (c) The fused loops: the phase's main path starts here.
    reset_counts()
    res, ttc_s = timed(lambda: fused_gna(sh32, sh32.x0(), max_iter=20,
                                         conv_tol=floor, abs_term=True))
    rn_ttc = float(np.sqrt(res.final_rw @ res.final_rw))
    out["ttc"] = dict(code=res.code, iters=res.iters, rn=rn_ttc, s=ttc_s)
    log(f"  (c) fused_gna on {MESH_SHARDS} shards, f32, to the noise floor: "
        f"code {res.code}, {res.iters} iterations, ||r_w|| {rn_ttc:.4f} <= "
        f"floor {floor:.4f}: {rn_ttc <= floor}; {ttc_s:.3f} s")
    if not (res.code == 0 and rn_ttc <= floor):
        raise RuntimeError("mesh phase (c): fused_gna on the mesh did not "
                           "reach the noise floor")
    one32 = ShardedSchurOps(s, spec, mesh=make_mesh(["cuda:0"]),
                            dtype=torch.float32)

    # From phase 6's start: 1 shard and 8 shards, and 8 again.  The
    # first iterations on fresh ops run slower: one untimed iteration on
    # the 1-shard ops first (the 8-shard ops ran in (b) and above).
    fused_gna(one32, x0_t, max_iter=1, conv_tol=0.0, stall_tol=-1.0)
    runs = {nm: fixed_run(o, x0_t) for nm, o in (
        ("1 shard", one32), ("8 shards", sh32), ("8 shards again", sh32))}
    same = np.array_equal(runs["8 shards"]["x"], runs["8 shards again"]["x"])
    shard_rel = abs(runs["8 shards"]["rn"] / runs["1 shard"]["rn"] - 1)
    # From x0, the start of scripts/sharded_tpu_bench.py: 8 shards
    # against the unsharded run above.
    runs["x0: unsharded"] = x0_unsharded
    runs["x0: 8 shards"] = fixed_run(sh32, ops.x0())
    x0_rel = abs(runs["x0: 8 shards"]["rn"] / runs["x0: unsharded"]["rn"]
                 - 1)
    for nm, v in runs.items():
        v.pop("x")
        v["overhead_vs_phase7"] = v["ms_per_iter"] / unsharded_ms
    out["fixed"] = runs
    out["fixed_gaps"] = dict(
        shards_8_vs_1=shard_rel, x0_sharded_vs_unsharded=x0_rel,
        phase6_start_vs_unsharded=abs(runs["8 shards"]["rn"] / rn_fixed - 1),
        bitwise=same,
        x0_overhead=runs["x0: 8 shards"]["ms_per_iter"]
        / runs["x0: unsharded"]["ms_per_iter"])
    log(f"  (c) {n_fixed} fixed f32 iterations (||r_w||, ms per iteration, "
        f"overhead against phase 7's unsharded median {unsharded_ms:.2f} "
        f"ms, line-search steps, host syncs): "
        + "; ".join(f"{nm}: {v['rn']!r}, {v['ms_per_iter']:.2f} ms = "
                    f"{v['overhead_vs_phase7']:.3f}x, alphas {v['alphas']}, "
                    f"syncs {v['host_syncs']}" for nm, v in runs.items()))
    log(f"  (c) gaps: {out['fixed_gaps']} (gates: 8 shards vs 1 shard from "
        f"phase 6's start and 8 shards vs unsharded from x0 within "
        f"{MESH_RN_TOL:g}, the 8-shard run bitwise equal on a second run; "
        f"phase 6's start vs phase 6's unsharded ||r_w|| {rn_fixed!r} is "
        f"measured, not gated: the sharded solve's fixed 1e-3 Cholesky "
        f"jitter damps the steps that far from the optimum)")
    if not (same and shard_rel <= MESH_RN_TOL and x0_rel <= MESH_RN_TOL):
        raise RuntimeError("mesh phase (c): the fixed runs failed a gate")

    # (d) bundle(mesh=) in f64 against the unsharded bundle, then the
    # COP over the shards against the unsharded COP.
    s_m, _ = net(C5_RING, 18)
    (_p, ok_m, it_m, s0_m, info_m), bundle_m_s = timed(lambda: bundle(
        s_m, damping="gna", dtype="float64", mesh=mesh))
    launches["sharded"] = read_counts()
    s_1, _ = net(C5_RING, 18)
    (_p, ok_1, it_1, s0_1, info_1), bundle_1_s = timed(lambda: bundle(
        s_1, damping="gna", dtype="float64", backend="schur", device="cuda"))
    x_rel = float(np.abs(info_m.final_x - info_1.final_x).max()
                  / np.abs(info_1.final_x).max())
    out["bundle"] = dict(ok=ok_m, iters=it_m, sigma0=s0_m, s=bundle_m_s,
                         unsharded_iters=it_1, unsharded_sigma0=s0_1,
                         unsharded_s=bundle_1_s, x_rel=x_rel)
    log(f"  (d) bundle(gna, f64, mesh={MESH_SHARDS} shards): ok {ok_m}, "
        f"{it_m} iterations, sigma0 {s0_m!r}, {bundle_m_s:.3f} s; "
        f"bundle(gna, f64, schur) on one device: ok {ok_1}, {it_1} "
        f"iterations, sigma0 {s0_1!r}, {bundle_1_s:.3f} s; max |dx| / max "
        f"|x| {x_rel:.3e} (tol 1e-8)")
    if not (ok_m and ok_1 and it_m == it_1
            and abs(s0_m / s0_1 - 1) <= 1e-9 and x_rel <= 1e-8):
        raise RuntimeError("mesh phase (d): bundle(mesh=) is off the "
                           "unsharded bundle")
    est = np.asarray(info_1.spec.op_x) >= 0
    d_m, cop_m_s = timed(lambda: np.einsum(
        "nii->ni", Covariance(s_m, info_m).cop(mesh=mesh)))
    d_1, cop_1_s = timed(lambda: np.einsum(
        "nii->ni", Covariance(s_1, info_1).cop()))
    cov_rel = float(np.max(np.abs(d_m[est] / d_1[est] - 1)))
    out["cop"] = dict(rel=cov_rel, s=cop_m_s, unsharded_s=cop_1_s)
    log(f"  (d) COP over the shards (Covariance, factorize and cop(mesh=), "
        f"{cop_m_s:.3f} s) against cop() on one device ({cop_1_s:.3f} s): "
        f"max relative variance gap {cov_rel:.3e} (tol 1e-6)")
    if not cov_rel <= 1e-6:
        raise RuntimeError("mesh phase (d): the sharded COP is off")

    # (e) Launches of the phase's main path: the sharded runs of (c)
    # and bundle(mesh=).
    log(f"  (e) launches in (c)'s sharded runs and bundle(mesh=): "
        f"{launches['sharded']}")
    missing = [nm for nm, c in launches["sharded"].items() if c <= 0]
    if missing:
        raise RuntimeError(f"mesh phase: kernels not launched: {missing}")
    out["rows"] = rows
    return out


def roma_net():
    from dbat_tpu_torch.pipeline.synthetic import ROMA_RING

    return net(ROMA_RING, 24)


#: The fields in which a script's project may differ from the network it
#: was written from: names, labels, paths and the prior EO table's
#: values (initial values only; prior_eo_use stays all False).
SCRIPT_ONLY_FIELDS = ("prior_eo_val", "prior_eo_std", "op_labels",
                      "img_names", "img_labels", "title", "file_name",
                      "cpt_file", "eo_file")
#: Report keys that change from run to run or with the input's paths:
#: the computation UUID, the package version, the time stamp and
#: execution times, and the input file names.
VOLATILE_REPORT_KEYS = ("Computation UUID", "version", "Last Bundle Run",
                        "Execution times", "Input file name",
                        "Ctrl pt file", "EO file")


def script_phase(card, launches):
    """Phase 11: the C5 network (C5_RING, perturbed with seed 18) written
    as a DBAT script folder (C5_SCRIPT_OPS) and run by run_script on the
    card; held against the same network built and solved in memory by
    bundle(gna, float64, auto) on the card.  Raises on a failed gate;
    returns the stage times and what the comparison found."""
    import tempfile

    import numpy as np
    import torch
    from port_script_folder import C5_SCRIPT_OPS, as_text_carries, \
        image_major, read_eo_file, write_script_folder

    import dbat_tpu_torch.pipeline.script as script_mod
    from dbat_tpu_torch.core.compare import compare_projects
    from dbat_tpu_torch.geometry.initvals import forward_intersect
    from dbat_tpu_torch.io.report import write_report
    from dbat_tpu_torch.io.report_compare import compare_reports
    from dbat_tpu_torch.pipeline.synthetic import C5_RING
    from dbat_tpu_torch.solve.bundle import bundle

    # The script's project just before its bundle, and the launches of
    # the bundle apart from those of the output files' covariances.
    seen = {}
    real_bundle = script_mod.bundle

    def bundle_spy(project, **kwargs):
        seen["start"] = project.copy()
        reset_counts()
        out = real_bundle(project, **kwargs)
        seen["launches"] = read_counts()
        seen["f64"] = read_counts(torch.float64)
        reset_counts()
        return out

    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        xml = write_script_folder(image_major(net(C5_RING, 18)[0]), tmp,
                                  C5_SCRIPT_OPS)
        write_s = time.perf_counter() - t1
        script_mod.bundle = bundle_spy
        try:
            r = script_mod.run_script(xml, device="cuda")
        finally:
            script_mod.bundle = real_bundle
        launches["script bundle"] = seen["launches"]
        launches["script outputs"] = read_counts()
        out_f64 = read_counts(torch.float64)
        written = {os.path.basename(f): os.path.getsize(f)
                   for f in r.outputs}
        _labels, eo_rows = read_eo_file(os.path.join(tmp, "result",
                                                     "eo.txt"))
        std_eo = eo_rows[:, 8:]
        script_report = open(os.path.join(tmp, "result", "report.txt")).read()

        # The same network in memory, with the values the folder carries.
        t1 = time.perf_counter()
        m = as_text_carries(image_major(net(C5_RING, 18)[0]))
        m.set_cam_vals_loaded()
        for name in ("cc", "pp", "K", "P"):
            m.set_cam_est(name)
        forward_intersect(m, "all", skip_prior=True)
        mem_setup_s = time.perf_counter() - t1
        diffs = compare_projects(seen["start"], m, rtol=0, atol=0)
        fields = sorted({d.split(":")[0] for d in diffs})
        t1 = time.perf_counter()
        _p, ok_m, it_m, s0_m, info_m = bundle(
            m, damping="gna", dtype=torch.float64, backend="auto",
            device="cuda")
        mem_bundle_s = time.perf_counter() - t1
        write_report(m, info_m, os.path.join(tmp, "memory-report.txt"))
        report_diffs = compare_reports(
            script_report, open(os.path.join(tmp, "memory-report.txt")).read(),
            volatile=VOLATILE_REPORT_KEYS)

    xs, xm = np.asarray(r.info.final_x), np.asarray(info_m.final_x)
    x_rel = float(np.abs(xs - xm).max() / np.abs(xm).max())
    bitwise = bool(np.array_equal(xs, xm))
    times = {"write folder": write_s, **r.times,
             "memory setup": mem_setup_s, "memory bundle": mem_bundle_s}
    log(f"script phase on {card}: n_img {r.project.n_img}, n_op "
        f"{r.project.n_op}, n_obs {r.project.n_obs}; run_script on the "
        f"card: ok {r.ok}, code {r.info.code}, {r.iters} iterations, "
        f"sigma0 {r.sigma0!r}, backend {type(r.info.ops).__name__} nb "
        f"{getattr(r.info.ops, 'n_cb', None)}; stage seconds "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    log(f"  launches: bundle {seen['launches']} (f64 {seen['f64']}), "
        f"report + EO covariances {launches['script outputs']} (f64 "
        f"{out_f64}); files {written}")
    log(f"  in memory: ok {ok_m}, code {info_m.code}, {it_m} iterations, "
        f"sigma0 {s0_m!r}; projects before the bundles differ in {fields} "
        f"(allowed: {list(SCRIPT_ONLY_FIELDS)}); final x bitwise equal "
        f"{bitwise}, max |diff| / max |x| {x_rel:.3e} (tol 1e-12)")
    log(f"  EO file: {std_eo.size} std, smallest {std_eo.min():.3e}; "
        f"report vs the in-memory report: {len(report_diffs)} differences "
        f"outside {list(VOLATILE_REPORT_KEYS)}"
        + "".join(f"\n    {d}" for d in report_diffs[:20]))
    if not (r.ok and r.sigma0 < 1.05):
        raise RuntimeError("script: the bundle failed bench.py's gate")
    if len(written) != 4 or min(written.values()) == 0:
        raise RuntimeError(f"script: output files missing: {written}")
    if not (np.all(np.isfinite(std_eo)) and np.all(std_eo > 0)):
        raise RuntimeError("script: an EO variance is not finite and > 0")
    if not set(fields) <= set(SCRIPT_ONLY_FIELDS):
        raise RuntimeError(f"script: the projects differ in {fields}")
    if not (ok_m and it_m == r.iters and abs(s0_m / r.sigma0 - 1) <= 1e-12
            and x_rel <= 1e-12):
        raise RuntimeError("script: off the in-memory bundle()")
    if report_diffs:
        raise RuntimeError("script: the report differs from the in-memory "
                           "one")
    missing = [f"{nm} in {key}" for key, c in (("the bundle", seen["f64"]),
                                               ("the outputs", out_f64))
               for nm, n in c.items() if n <= 0]
    if missing:
        raise RuntimeError(f"script: kernels not launched in f64: {missing}")
    return {"times": times, "bitwise": bitwise, "x_rel": x_rel,
            "fields": fields}


def c5_fixed_io():
    """tests/test_psz_fullscale.py's network: C5_RING with fixed IO."""
    from dbat_tpu_torch.pipeline.synthetic import C5_RING

    return {k: v for k, v in C5_RING.items() if k != "est_io_cols"}


def load_c5_psz():
    """The C5 network with fixed IO written as a .psz and read back
    through load_psz, psz_to_pm and from_pm (distortion model 3, which
    the network was made under).  The tie points' accuracy is written as
    the network's 0.1 px (the JAX test writes write_psz's default of 1
    px, under which the loaded values already sit ten times below the
    noise floor), so the bundle's sigma0 gate tests a solve.  Returns
    (network, PszProject, loaded project, {stage: host seconds})."""
    import tempfile

    from port_pm_export import similarity

    from dbat_tpu_torch.core.project import from_pm
    from dbat_tpu_torch.io.psz import load_psz, psz_to_pm, write_psz
    from dbat_tpu_torch.pipeline.synthetic import C5_RING, make_ring_network

    times = {}

    def timed(name, fn):
        t1 = time.perf_counter()
        out = fn()
        times[name] = time.perf_counter() - t1
        return out

    s = timed("psz network", lambda: make_ring_network(**c5_fixed_io()))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "c5_synthetic.psz")
        timed("write_psz", lambda: write_psz(
            path, s, tie_acc_px=C5_RING["ip_std_px"], L2G=similarity()))
        times["psz MB"] = os.path.getsize(path) / 1e6
        psz = timed("load_psz", lambda: load_psz(path))
    r = timed("psz_to_pm + from_pm", lambda: from_pm(psz_to_pm(psz)))
    r.dist_model = 3
    return s, psz, r, times


def input_phase(card, launches, c5_psz):
    """Phase 12: the PhotoModeler and PhotoScan input at the C5 shape
    ((a) the .psz loaded in phase 3, (b) a PM export), the demos card vs
    CPU on small networks (c), the native helpers (d).  Raises on a
    failed gate; returns the stage times and the numbers it checked."""
    import tempfile

    import numpy as np
    import torch
    from port_pm_export import SMALL_PSZ, camcal_network, numpy_native, \
        similarity, write_camcal_folder, write_pm_export

    from dbat_tpu_torch.core.project import from_pm
    from dbat_tpu_torch.core.serial import build_serial
    from dbat_tpu_torch.geometry.quality import reprojection_residuals_px
    from dbat_tpu_torch.io import native
    from dbat_tpu_torch.io.pm import load_pm
    from dbat_tpu_torch.io.psz import write_psz
    from dbat_tpu_torch.pipeline.demos import camcal, ps_postproc
    from dbat_tpu_torch.pipeline.synthetic import C5_RING, make_ring_network
    from dbat_tpu_torch.solve.bundle import bundle

    s, psz, r, times = c5_psz
    by_dtype = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t1
        return out

    # (a) The .psz: tests/test_psz_fullscale.py's gates, then the bundle.
    counts = (len(psz.camera_ids), len(psz.obj_pts),
              len(psz.obj_marks) + len(psz.ctrl_marks))
    spec = timed("psz build_serial", lambda: build_serial(r))
    res = timed("psz residuals", lambda: reprojection_residuals_px(r))
    dof = 2 * r.n_obs - spec.n_x
    log(f"input phase on {card}: (a) the C5 .psz ({times['psz MB']:.1f} MB): "
        f"cameras, tie points, marks {counts} (network {s.n_img}, "
        f"{s.n_op - 8}, {s.n_obs}); n_io {spec.n_io}, n_eo {spec.n_eo}, "
        f"n_x {spec.n_x}; reprojection residuals at the loaded values "
        f"median {np.median(res):.4f} px, max {res.max():.4f} px (gates "
        f"0.25, 10)")
    if counts != (s.n_img, s.n_op - 8, s.n_obs):
        raise RuntimeError(f"input: the .psz lost cameras, points or marks: "
                           f"{counts}")
    if not (spec.n_io == 0 and spec.n_eo == 6 * r.n_img and len(res)
            == s.n_obs and np.median(res) < 0.25 and res.max() < 10.0):
        raise RuntimeError("input: the loaded .psz fails the JAX test's "
                           "gates")
    reset_counts()
    (_p, ok_a, it_a, s0_a, info_a) = timed("psz bundle", lambda: bundle(
        r, damping="gna", dtype=torch.float32, backend="schur", max_iter=6,
        conv_tol=1.02 * np.sqrt(dof), abs_term=True, device="cuda"))
    launch_a = read_counts()
    by_dtype["float32"] = read_counts(torch.float32)
    log(f"  bundle(gna, f32, schur, max_iter 6, conv_tol 1.02 floor, "
        f"abs_term) on the card: ok {ok_a}, code {info_a.code}, {it_a} "
        f"iterations, sigma0 {s0_a!r}, nb {info_a.ops.n_cb}, "
        f"{times['psz bundle']:.3f} s; launches {launch_a}, of them f32 "
        f"{by_dtype['float32']}")
    if not (ok_a and s0_a < 1.05 and info_a.ops.n_cb == 6):
        raise RuntimeError("input: the .psz bundle failed its gate")

    # (b) The C5 network as a PhotoModeler text export, self-calibrating.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "c5-pmexport.txt")
        pm_net = timed("pm network", lambda: make_ring_network(**C5_RING))
        timed("write_pm_export", lambda: write_pm_export(path, pm_net))
        times["pm MB"] = os.path.getsize(path) / 1e6
        prob = timed("load_pm", lambda: load_pm(path))
    m = timed("from_pm", lambda: from_pm(prob))
    m.dist_model = 3
    m.set_cam_est("cc", "px", "py", "K1", "K2", "K3", "P1", "P2")
    if (m.n_img, m.n_op, m.n_obs) != (pm_net.n_img, pm_net.n_op,
                                      pm_net.n_obs):
        raise RuntimeError("input: the PM export lost images, points or "
                           "marks")
    reset_counts()
    (_p, ok_b, it_b, s0_b, info_b) = timed("pm bundle", lambda: bundle(
        m, damping="gna", dtype=torch.float64, backend="auto",
        device="cuda"))
    launch_b = read_counts()
    by_dtype["float64"] = read_counts(torch.float64)
    log(f"  (b) the C5 PM export ({times['pm MB']:.1f} MB): bundle(gna, "
        f"f64, auto) on the card with cc px py K1 K2 K3 P1 P2: ok {ok_b}, "
        f"code {info_b.code}, {it_b} iterations, sigma0 {s0_b!r}, backend "
        f"{type(info_b.ops).__name__} nb {getattr(info_b.ops, 'n_cb', None)}"
        f", {times['pm bundle']:.3f} s; launches {launch_b}, of them f64 "
        f"{by_dtype['float64']}")
    if not (ok_b and s0_b < 1.05):
        raise RuntimeError("input: the PM export's bundle failed its gate")
    launches["input"] = {k: launch_a[k] + launch_b[k] for k in launch_a}
    missing = [f"{nm} in {dt}" for dt, c in by_dtype.items()
               for nm, n in c.items() if n <= 0]
    if missing:
        raise RuntimeError(f"input: kernels not launched: {missing}")

    # (c) The demos on small networks, card against CPU.
    demo_err = {}
    with tempfile.TemporaryDirectory() as tmp:
        small = os.path.join(tmp, "small.psz")
        write_psz(small, make_ring_network(**SMALL_PSZ), L2G=similarity())
        data_dir = os.path.join(tmp, "camcal")
        prob_path = write_camcal_folder(data_dir, camcal_network())
        demos = {
            "ps_postproc": lambda dev: ps_postproc(
                file_name=small, stats_dir=tmp, device=dev, **PSZ_FILTER),
            "camcal": lambda dev: camcal(prob=load_pm(prob_path),
                                         data_dir=data_dir, device=dev)}
        for name, run in demos.items():
            out = {dev: run(dev) for dev in ("cuda", "cpu")}
            (_pc, ok_c, it_c, s0_c, ic), (_pp, ok_h, it_h, s0_h, ih) = (
                out["cuda"], out["cpu"])
            xc, xh = np.asarray(ic.final_x), np.asarray(ih.final_x)
            demo_err[name] = (abs(s0_c / s0_h - 1),
                              float(np.abs(xc - xh).max()
                                    / np.abs(xh).max()))
            log(f"  (c) {name} on small networks: card (ok, iters, sigma0) "
                f"({ok_c}, {it_c}, {s0_c!r}), CPU ({ok_h}, {it_h}, "
                f"{s0_h!r}); relative sigma0 and x differences "
                f"{demo_err[name]} (tol 1e-9)")
            if not (ok_c and ok_h and it_c == it_h
                    and max(demo_err[name]) <= 1e-9):
                raise RuntimeError(f"input: {name} card and CPU disagree")

    # (d) The host's native helpers.
    t1 = time.perf_counter()
    have = native.have_native()
    rng = np.random.default_rng(12)
    k, nblk, n = 40, 30, 3
    A = rng.standard_normal((k, k))
    A = A @ A.T
    B = rng.standard_normal((k, nblk * n))
    M3 = rng.standard_normal((5000, 3, 3)) + 3 * np.eye(3)
    Vinv = np.linalg.inv(M3[:nblk])
    Y = rng.standard_normal((k, 3 * nblk))
    want = numpy_native(A, B, n, M3, Vinv, Y, 0.8)
    got = {"diag_block_outer": native.diag_block_outer(A, B, n),
           "batch_inv3": native.batch_inv3(M3),
           "icpc_blocks": native.icpc_blocks(Vinv, Y, 0.8)}
    native_err = {nm: float(np.abs(got[nm] - want[nm]).max()
                            / np.abs(want[nm]).max()) for nm in want}
    rows = rng.standard_normal((2000, 4)) * 10.0 ** rng.integers(-3, 6,
                                                               (2000, 4))
    with tempfile.TemporaryDirectory() as tmp:
        tbl = os.path.join(tmp, "table.txt")
        with open(tbl, "w") as fh:
            fh.write("# x,y,z,w\n")
            fh.writelines(",".join(repr(float(v)) for v in row) + "\n"
                          for row in rows)
        parsed = native.parse_numeric_table(tbl, 4)
        table_equal = bool(np.array_equal(parsed, rows) and np.array_equal(
            parsed, np.atleast_2d(np.genfromtxt(tbl, delimiter=","))))
    times["native"] = time.perf_counter() - t1
    log(f"  (d) native helpers: have_native {have}; relative differences "
        f"from the numpy formulas {native_err} (tol {NATIVE_TOL:g}); "
        f"parse_numeric_table equal to the written rows and to genfromtxt: "
        f"{table_equal}; {times['native']:.3f} s")
    if not (have and table_equal
            and all(v <= NATIVE_TOL for v in native_err.values())):
        raise RuntimeError("input: the native helpers are missing or wrong")
    log(f"  stage seconds on the host of {card}: "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items()
                    if not k.endswith("MB")))
    return {"times": times, "psz": (ok_a, it_a, s0_a),
            "pm": (ok_b, it_b, s0_b), "demo_err": demo_err,
            "native_err": native_err, "by_dtype": by_dtype}


#: DBAT's camcal network (REAL_CAMCAL.md: 21 Olympus C4040Z images of
#: 2272 x 1704 px of one sheet of targets, 2,074 marks, ~99 an image).
#: make_ring_network's default camera (sensor 7.3 x 5.4 mm, 2272 x 1704
#: px, focal 7 mm) is that camera; 99 points each seen by all 21 images
#: give 2,079 observations.  (A ring whose points each see a run of a
#: few images, as the C5 networks do, leaves image pairs without a
#: common point, whose false matches merge unrelated tracks.)  No
#: distortion, no noise: the rendered targets carry the truth, and the
#: detector's localisation is what the gates measure.
CAMCAL_FEATURES = dict(n_img=21, n_pt=99, rays_per_pt=21, n_ctrl=0,
                       noise_px=0.0, ip_std_px=0.1, K=(0.0, 0.0, 0.0),
                       P=(0.0, 0.0), seed=3)
#: The features phase holds the card against the CPU on the first images
#: of the batch (each image is detected and described on its own, each
#: pair matched on its own), to keep the CPU's share of the phase short.
FEATURES_CPU_IMAGES = 6


def features_phase(card, launches):
    """Phase 13: the feature front-end at DBAT's camcal shape.  The
    network is rendered (render_network_images, seed 4), written as 8-bit
    gray PNGs (every PNG filter type) beside tests/test_script_features.py's
    DBAT script for this camera (port_features), and read back by
    load_images; detect, describe and match run twice on the card (bit for
    bit equal) and are held against the CPU; then run_script runs the
    script (the <features> input, pose-graph initialisation, two screens,
    two f64 bundles on the Schur backend, the report) on the card.  Gates:
    tests/test_features.py's detection accuracy, tracks > 0.7 of the
    points, tests/test_script_features.py's script gates, both kernels
    launched in f64 and held against their plain versions on the last
    bundle's inputs, and each bundle against the same bundle() call on
    the CPU from the same start (ok and iterations equal, sigma0 and final
    x within 1e-9 relative).  Raises on a failed gate; returns the stage
    times, the numbers it checked and the kernel rows."""
    import tempfile

    import numpy as np
    import torch
    from port_features import card_vs_cpu, detection_stats, \
        features_script, same_matches, to_gray8, write_features_folder

    import dbat_tpu_torch.pipeline.script as script_mod
    from dbat_tpu_torch.features import build_tracks, describe, \
        detect_blobs, match_all_pairs
    from dbat_tpu_torch.features.pipeline import load_images
    from dbat_tpu_torch.features.render import render_network_images
    from dbat_tpu_torch.io.native import have_native
    from dbat_tpu_torch.pipeline.synthetic import make_ring_network

    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t1
        return out

    reset_counts()
    gt = timed("network", lambda: make_ring_network(**CAMCAL_FEATURES))
    images = timed("render", lambda: render_network_images(gt, seed=4))
    W, H = (int(v) for v in gt.sensor_im_size[0])
    script = features_script(gt.sensor_ss_size[0], (W, H), gt.io[0, 0])
    max_kp = 256  # the script's
    # Each bundle's start, arguments and result; the last one's operator.
    bundles, starts, last = [], [], {}
    real_bundle = script_mod.bundle

    def bundle_spy(project, **kwargs):
        starts.append((project.copy(), kwargs))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = real_bundle(project, **kwargs)
        torch.cuda.synchronize()
        bundles.append({"s": time.perf_counter() - t1, "ok": out[1],
                        "iters": out[2], "sigma0": out[3],
                        "n_op": project.n_op, "n_obs": project.n_obs})
        last["x"] = np.asarray(out[4].final_x)
        last["ops"] = out[4].ops
        return out

    with tempfile.TemporaryDirectory() as tmp:
        xml = timed("PNG write", lambda: write_features_folder(
            images, tmp, script))
        png_mb = sum(os.path.getsize(os.path.join(tmp, f))
                     for f in os.listdir(tmp) if f.endswith(".png")) / 1e6
        paths = [os.path.join(tmp, f"img{i:02d}.png")
                 for i in range(gt.n_img)]
        imgs = timed("load_images", lambda: load_images(paths))
        exact = np.array_equal(imgs, np.divide(
            to_gray8(images, float(images.min()), float(images.max())),
            255, dtype=np.float32))
        on_card = timed("upload", lambda: torch.from_numpy(imgs).cuda())
        runs = []
        for k in range(2):
            det = timed(f"detect {k + 1}", lambda: detect_blobs(
                on_card, max_kp=max_kp, device="cuda"))
            desc = timed(f"describe {k + 1}", lambda: describe(
                on_card, det[0], det[2], device="cuda"))
            m = timed(f"match {k + 1}", lambda: match_all_pairs(
                desc, det[2], device="cuda"))
            runs.append(([t.cpu().numpy() for t in (*det, desc)], m))
        bitwise = (all(np.array_equal(a, b)
                       for a, b in zip(runs[0][0], runs[1][0]))
                   and same_matches(runs[0][1], runs[1][1]))
        (xy, _score, valid, _desc), matches = runs[0]
        found, total, errs = detection_stats(gt, xy, valid)
        tracks = timed("tracks", lambda: build_tracks(matches, gt.n_img,
                                                      max_kp))
        del on_card
        gap = timed("card vs CPU", lambda: card_vs_cpu(
            imgs[:FEATURES_CPU_IMAGES], "cuda", max_kp))
        script_mod.bundle = bundle_spy
        try:
            r = timed("run_script", lambda: script_mod.run_script(
                xml, backend="schur", device="cuda"))
        finally:
            script_mod.bundle = real_bundle
        report = os.path.join(tmp, "features-report.txt")
        report_lines = (len(open(report).read().splitlines())
                        if os.path.exists(report) else 0)
    launches["features"] = read_counts()
    f64 = read_counts(torch.float64)
    # Last bundle's kernels against their plain versions at this layout
    # (every camera pair sharing its points), then each bundle on the CPU.
    nb = last["ops"].n_cb
    rows = check_kernels(last["ops"], "float64", timed=True)
    del last["ops"]
    cpu_x = None
    for k, (start, kwargs) in enumerate(starts):
        _p, ok_c, it_c, s0_c, info_c = timed(
            f"bundle {k + 1} on the CPU",
            lambda: real_bundle(start, **{**kwargs, "device": "cpu"}))
        bundles[k]["cpu"] = (ok_c, it_c, s0_c)
        cpu_x = np.asarray(info_c.final_x)
    x_rel = float(np.abs(last["x"] - cpu_x).max() / np.abs(cpu_x).max())
    try:
        import matplotlib  # noqa: F401
        plots = "matplotlib is installed, but"
    except ImportError:
        plots = "matplotlib is not installed here, so"
    n_pairs = gt.n_img * (gt.n_img - 1) // 2
    log(f"features phase on {card}: camcal shape, {gt.n_img} images of "
        f"{W} x {H} px, {gt.n_op} points, {gt.n_obs} observations; PNGs "
        f"{png_mb:.1f} MB; load_images (native unfilter: {have_native()}) "
        f"equal to the written samples: {exact}; stage seconds "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    log(f"  detection (card): {int(valid.sum())} keypoints, {found} of "
        f"{total} isolated in-border targets within 1 px (gate > 0.9), "
        f"error median {np.median(errs):.4f} px (< 0.15), mean "
        f"{errs.mean():.4f} px (< 0.3); "
        f"{sum(len(v[0]) for v in matches.values())} matches over {len(matches)} of {n_pairs} pairs; {len(tracks)} "
        f"tracks (gate > {0.7 * gt.n_op:.1f}); detect, describe and match "
        f"twice on the card bit for bit equal: {bitwise}")
    log(f"  card vs CPU on the first {FEATURES_CPU_IMAGES} images, each "
        f"stage fed the CPU's inputs: valid masks equal {gap['valid_equal']}, "
        f"max |xy diff| {gap['xy_err']:.3e} px (tol 1e-3), max |descriptor "
        f"diff| {gap['desc_err']:.3e} (tol 1e-5), matches {gap['n_matches']}, "
        f"in one set only {gap['n_differ']} (tol 0.5%)")
    log(f"  run_script(backend=schur) on the card: ok {r.ok}, sigma0 "
        f"{r.sigma0!r}, n_op {r.project.n_op} (gate > {0.6 * gt.n_op:.1f}), "
        f"n_obs {r.project.n_obs} (gate > {0.5 * gt.n_obs:.1f}); bundles "
        f"{bundles} (\"cpu\": the same call on the CPU, ok, iterations, "
        f"sigma0; tol 1e-9 relative); last bundle's final x card vs CPU, "
        f"max |diff| / max |x| {x_rel:.3e} (tol 1e-9); report "
        f"{report_lines} lines; script stage seconds "
        + ", ".join(f"{k} {v:.3f}" for k, v in r.times.items()))
    log(f"  launches in this phase {launches['features']} (f64 {f64}); "
        f"{plots} the phase draws no plots (tests/test_torch_plotting.py "
        f"holds them against the JAX package on the CPU)")
    if not exact:
        raise RuntimeError("features: load_images differs from the PNGs")
    if not (found > 0.9 * total and np.median(errs) < 0.15
            and errs.mean() < 0.3):
        raise RuntimeError("features: detection accuracy gate failed")
    if not len(tracks) > 0.7 * gt.n_op:
        raise RuntimeError("features: too few tracks")
    if not bitwise:
        raise RuntimeError("features: the front-end does not repeat bit "
                           "for bit on the card")
    if not (gap["valid_equal"] and gap["xy_err"] <= 1e-3
            and gap["desc_err"] <= 1e-5
            and gap["n_differ"] <= 0.005 * gap["n_matches"]):
        raise RuntimeError("features: card and CPU disagree")
    if not (r.ok and r.project.n_op > 0.6 * gt.n_op
            and r.project.n_obs > 0.5 * gt.n_obs and r.sigma0 < 1.0
            and len(bundles) == 2 and report_lines > 0):
        raise RuntimeError("features: the script failed its gates")
    for b in bundles:
        ok_c, it_c, s0_c = b["cpu"]
        if not (ok_c and it_c == b["iters"]
                and abs(b["sigma0"] / s0_c - 1) <= 1e-9):
            raise RuntimeError("features: a bundle is off its CPU run")
    if not x_rel <= 1e-9:
        raise RuntimeError("features: the final x is off the CPU's")
    missing = [nm for nm, n in f64.items() if n <= 0]
    if missing:
        raise RuntimeError(f"features: kernels not launched in f64: "
                           f"{missing}")
    return {"times": times, "script_times": r.times, "bundles": bundles,
            "detection": (found, total, float(np.median(errs)),
                          float(errs.mean())),
            "tracks": len(tracks), "card_vs_cpu": gap, "x_rel": x_rel,
            "nb": nb, "rows": rows}


def main():
    import tempfile

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [root, os.path.join(root, "tests")]
    from port_script_folder import POSEGRAPH_SCRIPT_OPS, image_major, \
        write_script_folder

    from dbat_tpu_torch import build
    from dbat_tpu_torch.core.serial import build_serial
    from dbat_tpu_torch.solve.bundle import BundleInfo, bundle
    from dbat_tpu_torch.solve.covariance import Covariance
    from dbat_tpu_torch.solve.fused import fused_gna
    from dbat_tpu_torch.solve.kernels import KERNELS
    from dbat_tpu_torch.pipeline.script import run_script
    from dbat_tpu_torch.pipeline.synthetic import C5_RING
    from dbat_tpu_torch.solve.schur import SchurOps

    # 1. Device report --------------------------------------------------
    t = time.perf_counter()
    card = smi()
    log(f"nvidia-smi: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    phase_done("device", t, card)

    # 2. Build -------------------------------------------------------------
    t = time.perf_counter()
    info = build.build_info()
    log(f"kernel libraries {', '.join(p.name for p in info.paths)}: "
        f"compiled={info.compiled} in "
        f"{info.seconds:.2f} s on the host of {card}")
    for line in build.ptxas_report(info.log):
        log(f"  ptxas: {line}")
    phase_done("build", t, card)

    # 3. C5-shape and roma-shape problems on the card ----------------------
    t = time.perf_counter()
    s, spec = net(C5_RING, 18)
    ops = SchurOps(s, spec, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    dof = ops.n_res - ops.n_x
    floor = float(np.sqrt(dof))
    rows_per_cp = np.diff(ops._pair_plan.row_ptr.cpu().numpy())
    chunk_rows = np.diff(ops._pair_plan.row_ptr.cpu().numpy()[
        ops._pair_plan.chunk_ptr.cpu().numpy()])
    log(f"C5 shape: n_img={s.n_img} n_pt={s.n_op} n_obs={ops.n_obs} "
        f"n_x={ops.n_x} n_c={ops.n_c} nb={ops.n_cb} pairs={ops.n_pairs} "
        f"camera pairs={ops.n_campair} bucket rows="
        f"{ops._pair_plan.n_rows} (per camera pair: median "
        f"{np.median(rows_per_cp):g}, max {rows_per_cp.max()}) pad ratio "
        f"{ops._pair_plan.pad_ratio:.4f}; kernel B chunks "
        f"{len(chunk_rows)} of {chunk_rows.mean():.1f} bucket rows on "
        f"average, at most {chunk_rows.max()}")
    t1 = time.perf_counter()
    r, r_spec = roma_net()
    roma_net_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    roma32 = SchurOps(r, r_spec, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    roma_ops_s = time.perf_counter() - t1
    roma64 = SchurOps(r, r_spec, dtype=torch.float64, device="cuda")
    roma_floor = float(np.sqrt(2 * r.n_obs - r_spec.n_x))
    log(f"roma shape: n_img={r.n_img} n_pt={r.n_op} n_obs={roma32.n_obs} "
        f"(mean {r.n_obs / r.n_op:.2f} rays a point) n_x={roma32.n_x} "
        f"n_c={roma32.n_c} nb={roma32.n_cb} pairs={roma32.n_pairs} camera "
        f"pairs={roma32.n_campair} dof={2 * r.n_obs - r_spec.n_x}; "
        f"kernel B chunks f32 {roma32._pair_plan.n_chunks}, f64 "
        f"{roma64._pair_plan.n_chunks}; network {roma_net_s:.2f} s, "
        f"f32 SchurOps {roma_ops_s:.2f} s on the host of {card}")
    if roma32.n_cb != 6:
        raise RuntimeError(f"roma network: nb {roma32.n_cb}, expected 6")
    c5_psz = load_c5_psz()
    psz_r = c5_psz[2]
    psz_ops = SchurOps(psz_r, build_serial(psz_r), dtype=torch.float32,
                       device="cuda")
    log(f"C5 .psz (fixed IO): n_img={psz_r.n_img} n_pt={psz_r.n_op} "
        f"n_obs={psz_ops.n_obs} n_x={psz_ops.n_x} nb={psz_ops.n_cb} "
        f"pairs={psz_ops.n_pairs} camera pairs={psz_ops.n_campair}; "
        f"kernel B chunks {psz_ops._pair_plan.n_chunks}; host seconds "
        + ", ".join(f"{k} {v:.3f}" for k, v in c5_psz[3].items()
                    if not k.endswith("MB")) + f" on the host of {card}")
    if psz_ops.n_cb != 6:
        raise RuntimeError(f".psz network: nb {psz_ops.n_cb}, expected 6")
    phase_done("setup", t, card)

    # 4. Kernel checks ------------------------------------------------------
    t = time.perf_counter()
    log(f"kernel checks on {card} (device ms L2 flushed: CUDA events "
        f"around one launch queued behind an L2 flush and a sleep, median "
        f"of 10, every operand read from HBM, held against the HBM bound; "
        f"plain and library times the same way; in a burst: per launch of "
        f"back-to-back launches queued behind a sleep, median of bursts, "
        f"operands warm in L2 as on the main path, where the stage before "
        f"has just written them; one call: events around a single call on "
        f"an idle device, wrapper included):")
    rows = check_kernels(ops, "float32", timed=True)
    roma_rows = {"float32": check_kernels(roma32, "float32", timed=True),
                 "float64": check_kernels(roma64, "float64", timed=True)}
    del roma64
    # The covariance extracts in f64: both kernels at the C5 shape in f64.
    c5_64 = SchurOps(s, spec, dtype=torch.float64, device="cuda")
    c5_64_rows = check_kernels(c5_64, "float64", timed=True)
    del c5_64
    # The loaded .psz: both kernels at the C5 shape with fixed IO, f32.
    psz_rows = check_kernels(psz_ops, "float32", timed=True)
    del psz_ops
    s_small, spec_small = net(SMALL, 6)
    ops_small = SchurOps(s_small, spec_small, dtype=torch.float64,
                         device="cuda")
    check_kernels(ops_small, "float64", timed=False)
    phase_done("kernel checks", t, card)

    # 5. Small network: card (kernels) vs CPU (plain versions), f64 ------
    t = time.perf_counter()
    ops_cpu = SchurOps(s_small, spec_small, dtype=torch.float64,
                       device="cpu")
    x0s = ops_cpu.x0().numpy()
    r_gpu = fused_gna(ops_small, x0s, max_iter=20)
    r_cpu = fused_gna(ops_cpu, x0s, max_iter=20)
    dx = float(np.abs(r_gpu.x - r_cpu.x).max())
    log(f"small f64 fused_gna on {card}: card code {r_gpu.code} iters "
        f"{r_gpu.iters} ||r_w|| {r_gpu.res_norms[-1]!r}; CPU code "
        f"{r_cpu.code} iters {r_cpu.iters} ||r_w|| "
        f"{r_cpu.res_norms[-1]!r}; max |dx| {dx:.3e}")
    if (r_gpu.code != 0 or r_gpu.code != r_cpu.code
            or r_gpu.iters != r_cpu.iters
            or abs(r_gpu.res_norms[-1] / r_cpu.res_norms[-1] - 1) > 1e-8
            or not np.all(np.isfinite(r_gpu.x))):
        raise RuntimeError("small network: card and CPU disagree")
    # bundle() with LM on the Schur backend.  conv_tol 1e-4 keeps the
    # last accepted LM step's decrease far above f64 rounding, so the
    # card's and the CPU's sum orders cannot decide the iteration count.
    small, small_info = {}, {}
    for where in ("cuda", "cpu"):
        sb, _ = net(SMALL, 6)
        _p, ok_b, it_b, s0_b, info_b = bundle(
            sb, damping="lm", backend="schur", conv_tol=1e-4, device=where)
        small[where] = (ok_b, info_b.code, it_b, s0_b)
        small_info[where] = info_b
        if where == "cuda":
            small_info["net"] = sb
    log(f"small f64 bundle(lm, schur) on {card}: card (ok, code, iters, "
        f"sigma0) {small['cuda']}, CPU {small['cpu']}")
    if (not small["cuda"][0] or small["cuda"][:3] != small["cpu"][:3]
            or abs(small["cuda"][3] / small["cpu"][3] - 1) > 1e-8):
        raise RuntimeError("small bundle(): card and CPU disagree")
    # The f64 posterior covariance of the card's bundle, extracted on the
    # card and on the CPU at the same x and sigma0.
    info_s = small_info["cuda"]
    cov_card = Covariance(small_info["net"], info_s)
    cov_cpu = Covariance(small_info["net"], BundleInfo(
        ops=SchurOps(small_info["net"], info_s.spec, dtype=torch.float64,
                     device="cpu"),
        spec=info_s.spec, sigma0=info_s.sigma0, final_x=info_s.final_x))
    cov_err = {}
    for name in ("cio", "ceo", "cop"):
        a, b = getattr(cov_card, name)(), getattr(cov_cpu, name)()
        cov_err[name] = float(np.abs(a - b).max() / np.abs(b).max())
    log(f"small f64 covariance on {card}: card vs CPU, max |diff| / max "
        f"|CPU| {cov_err} (tol {COV_SMALL_TOL:g}); jitter rung card "
        f"{cov_card.jitter}, CPU {cov_cpu.jitter}")
    if not all(v <= COV_SMALL_TOL for v in cov_err.values()):
        raise RuntimeError("small covariance: card and CPU disagree")
    # f64 PCG against the direct (explicit-S) solve, on the card.
    U, V, Wb, gc, gp, _rw = ops_small._assemble_impl(ops_small.x0())
    g = ops_small.join_x(gc, gp)
    p_direct, _L = ops_small._solve_impl(U, V, Wb, -g, 0.0)
    p_pcg, (pcg_iters, pcg_rel) = ops_small._solve_pcg_impl(
        U, V, Wb, -g, 0.0, tol=1e-12, maxiter=2000)
    pcg_err = float((p_pcg - p_direct).abs().max()
                    / p_direct.abs().max())
    log(f"small f64 pcg_solve on {card}: {pcg_iters} iterations, relative "
        f"residual {pcg_rel:.3e}; max |p_pcg - p_direct| / max |p_direct| "
        f"{pcg_err:.3e} (tol 1e-6)")
    if not (pcg_rel < 1e-10 and pcg_err <= 1e-6):
        raise RuntimeError("small pcg_solve: off the direct solve")
    # A DBAT script on the small network, one folder, card and CPU.
    with tempfile.TemporaryDirectory() as tmp:
        xml = write_script_folder(image_major(net(SMALL, 6)[0]), tmp,
                                  POSEGRAPH_SCRIPT_OPS)
        runs = {where: run_script(xml, device=where,
                                  output_dir=os.path.join(tmp, where))
                for where in ("cuda", "cpu")}
    sc_card, sc_cpu = runs["cuda"], runs["cpu"]
    sx_card = np.asarray(sc_card.info.final_x)
    sx_cpu = np.asarray(sc_cpu.info.final_x)
    sx_err = float(np.abs(sx_card - sx_cpu).max() / np.abs(sx_cpu).max())
    log(f"small DBAT script (pose_graph_init, prune_by_reprojection, "
        f"bundle) on {card}: card (ok, iters, sigma0) ({sc_card.ok}, "
        f"{sc_card.iters}, {sc_card.sigma0!r}), CPU ({sc_cpu.ok}, "
        f"{sc_cpu.iters}, {sc_cpu.sigma0!r}); max |x_card - x_cpu| / max "
        f"|x_cpu| {sx_err:.3e} (tol 1e-9); files {len(sc_card.outputs)}")
    if not (sc_card.ok and sc_cpu.ok and sc_card.iters == sc_cpu.iters
            and abs(sc_card.sigma0 / sc_cpu.sigma0 - 1) <= 1e-9
            and sx_err <= 1e-9 and len(sc_card.outputs) == 4):
        raise RuntimeError("small DBAT script: card and CPU disagree")
    phase_done("small reference", t, card)

    # 6. Main path ----------------------------------------------------------
    t = time.perf_counter()
    x0 = ops.x0()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t1 = time.perf_counter()
    res = fused_gna(ops, x0, max_iter=20, conv_tol=floor, abs_term=True)
    cold_ttc = time.perf_counter() - t1
    warm_ttc = float("inf")
    for _ in range(2):
        t1 = time.perf_counter()
        res_w = fused_gna(ops, x0, max_iter=20, conv_tol=floor,
                          abs_term=True)
        warm_ttc = min(warm_ttc, time.perf_counter() - t1)
    n_fixed = 10
    rng = np.random.default_rng(99)
    x0_t = x0.cpu().numpy() + 0.05 * rng.standard_normal(ops.n_x)
    t1 = time.perf_counter()
    res_t = fused_gna(ops, x0_t, max_iter=n_fixed, conv_tol=0.0,
                      stall_tol=-1.0)
    fixed_s = time.perf_counter() - t1
    launches = {"c5": read_counts()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rn_ttc = float(np.sqrt(res.final_rw @ res.final_rw))
    rn_fixed = float(np.sqrt(res_t.final_rw @ res_t.final_rw))
    sigma0 = rn_fixed / floor
    log(f"main path on {card}:")
    log(f"  time to convergence: code {res.code}, {res.iters} iterations, "
        f"||r_w|| {rn_ttc:.4f} <= floor {floor:.4f}: {rn_ttc <= floor}; "
        f"cold {cold_ttc:.3f} s, warm {warm_ttc:.3f} s (warm iters "
        f"{res_w.iters}); host syncs {res.damping['host_syncs']}")
    log(f"  fixed run: {res_t.iters} iterations (code {res_t.code}) in "
        f"{fixed_s:.3f} s = {res_t.iters / fixed_s:.3f} iters/s, sigma0 "
        f"{sigma0:.5f}; host syncs {res_t.damping['host_syncs']}")
    log(f"  launches on the main path: {launches['c5']}; peak CUDA memory "
        f"{peak_gb:.3f} GB")
    phase_done("main path", t, card)
    if not (res.code == 0 and rn_ttc <= floor):
        raise RuntimeError("main path did not converge to the noise floor")
    if not sigma0 < 1.05:
        raise RuntimeError(f"fixed run left the noise floor: sigma0 {sigma0}")
    if not (np.all(np.isfinite(res.x)) and res.x.shape == (ops.n_x,)):
        raise RuntimeError("main path returned a non-finite or misshapen x")
    missing = [nm for nm, c in launches["c5"].items() if c <= 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the main path: {missing}")

    # 7. Repeatability ------------------------------------------------------
    t = time.perf_counter()
    xs, rates, sigmas = [torch.as_tensor(res_t.x)], [], []
    for _ in range(5):
        t1 = time.perf_counter()
        rr = fused_gna(ops, x0_t, max_iter=n_fixed, conv_tol=0.0,
                       stall_tol=-1.0)
        rates.append(rr.iters / (time.perf_counter() - t1))
        sigmas.append(float(np.sqrt(rr.final_rw @ rr.final_rw)) / floor)
        xs.append(torch.as_tensor(rr.x))
    same = all(torch.equal(xs[0], x) for x in xs[1:])
    med = float(np.median(rates))
    log(f"repeatability on {card}: 5 C5 fixed runs of {n_fixed} iterations "
        f"after the main path's: final x bitwise equal to the main path's "
        f"in every run: {same}; sigma0 "
        f"{', '.join(f'{v:.6f}' for v in sigmas)}; iters/s "
        f"{', '.join(f'{v:.2f}' for v in rates)} (median {med:.2f}, "
        f"spread (max - min) / median {(max(rates) - min(rates)) / med:.3f})")
    phase_done("repeatability", t, card)
    if not same:
        raise RuntimeError("the C5 fixed run does not repeat bit for bit")

    # 8. Roma watchdog ------------------------------------------------------
    t = time.perf_counter()
    del roma32
    reset_counts()
    roma_runs = []
    for _ in range(3):
        rn, _ = roma_net()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _p, ok_r, it_r, s0_r, info_r = bundle(
            rn, damping="lm", dtype=torch.float32, backend="schur",
            max_iter=40, conv_tol=1.02 * roma_floor, abs_term=True,
            device="cuda")
        torch.cuda.synchronize()
        roma_runs.append((time.perf_counter() - t1, ok_r, it_r, s0_r,
                          info_r.code, info_r.damping["host_syncs"],
                          info_r.ops.n_cb, info_r.time))
    launches["roma"] = read_counts()
    cold = roma_runs[0]
    warm = min(roma_runs[1:])
    log(f"roma watchdog on {card}: bundle(lm, f32, schur, max_iter=40, "
        f"conv_tol=1.02 floor, abs_term) on fresh networks; (seconds, ok, "
        f"iters, sigma0, code, host syncs, nb, seconds in the solver "
        f"(info.time; the rest is setup and the f64 evaluation)) per run: "
        f"{roma_runs}")
    log(f"  cold {cold[0]:.3f} s (first roma run in the process, after the "
        f"C5 phases), warm {warm[0]:.3f} s; iters {cold[2]}/"
        f"{roma_runs[1][2]}/{roma_runs[2][2]}; sigma0 {cold[3]:.5f}; "
        f"launches in this phase {launches['roma']}")
    phase_done("roma watchdog", t, card)
    for run in roma_runs:
        if not (run[1] and run[3] < 1.05 and run[6] == 6):
            raise RuntimeError(f"roma watchdog run failed bench.py's gate: "
                               f"{run}")
    missing = [nm for nm, c in launches["roma"].items() if c <= 0]
    if missing:
        raise RuntimeError(f"kernels not launched at nb 6: {missing}")

    # 9. f64 polish on the card ---------------------------------------------
    t = time.perf_counter()
    rp, _ = roma_net()
    reset_counts()
    t1 = time.perf_counter()
    _p, ok_p, it_p, s0_p, info_p = bundle(rp, device="cuda", **POLISH_CALL)
    torch.cuda.synchronize()
    polish_s = time.perf_counter() - t1
    launches["polish"] = read_counts()
    f64_launches = read_counts(torch.float64)
    log(f"polish on {card}: bundle({POLISH_CALL}) on the roma network in "
        f"{polish_s:.3f} s: ok {ok_p}, code {info_p.code}, chip_code "
        f"{info_p.chip_code}, f32 iters {it_p}, floor_stall "
        f"{info_p.damping.get('floor_stall')}, sigma0_prepolish "
        f"{info_p.sigma0_prepolish!r}, polish_iters {info_p.polish_iters}, "
        f"sigma0 {s0_p!r}; launches {launches['polish']}, of them f64 "
        f"{f64_launches}; the JAX package on the CPU: {POLISH_EXPECT}")
    phase_done("polish", t, card)
    if info_p.sigma0_prepolish is None:
        raise RuntimeError("the f64 polish did not run")
    if (ok_p, info_p.code) != (POLISH_EXPECT["ok"], POLISH_EXPECT["code"]):
        raise RuntimeError(f"polish outcome (ok {ok_p}, code {info_p.code})"
                           f" differs from the JAX package's")
    # f32 solutions at the floor differ in sigma0_prepolish by ~1e-5
    # relative; sigma0 is polished in f64 at a stationary point.
    if not (abs(info_p.sigma0_prepolish / POLISH_EXPECT["sigma0_prepolish"]
                - 1) < 1e-4
            and abs(s0_p / POLISH_EXPECT["sigma0"] - 1) < 1e-6):
        raise RuntimeError("polish: sigma0 off the JAX package's value")
    missing = [nm for nm, c in f64_launches.items() if c <= 0]
    if missing:
        raise RuntimeError(f"kernels not launched in f64 by the polish: "
                           f"{missing}")

    # 10. Posterior covariance at the C5 shape --------------------------------
    t = time.perf_counter()
    cov_out = covariance_phase(floor, card, launches)
    phase_done("covariance", t, card)

    # 11. The DBAT script runner at the C5 shape ------------------------------
    t = time.perf_counter()
    script_out = script_phase(card, launches)
    phase_done("script", t, card)

    # 12. The PhotoModeler and PhotoScan input at the C5 shape -------------
    t = time.perf_counter()
    input_out = input_phase(card, launches, c5_psz)
    phase_done("input", t, card)

    # 13. The feature front-end at DBAT's camcal shape ----------------------
    t = time.perf_counter()
    features_out = features_phase(card, launches)
    phase_done("features", t, card)

    # 14. The mesh at the C5 shape: 8 shards on the one card ---------------
    t = time.perf_counter()
    mesh_out = mesh_phase(card, launches, s, spec, ops, floor, x0_t,
                          n_fixed, rn_fixed, 1e3 / med)
    phase_done("mesh", t, card)

    # Kernel summary: device times per C5 outer iteration (the five
    # kernel-A calls and the one kernel-B call of one assembly + S
    # build, f32), launches summed over every path in launches_by_path.
    by_kernel = {}
    for row in rows:
        by_kernel.setdefault(row["kernel"], []).append(row)
    out = []
    for k in KERNELS:
        rs = by_kernel[k.name]
        t_bytes = sum(row["bytes"] for row in rs) / HBM_BYTES_PER_S * 1e3
        t_ops = sum(row["flops"] for row in rs) / FLOP_PER_S["float32"] * 1e3
        lib = [row["library_ms"] for row in rs]
        out.append({
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces,
            "launches": sum(c[k.name] for c in launches.values()),
            "launches_by_path": {p: c[k.name] for p, c in launches.items()},
            "input_launches_by_dtype": {
                dt: c[k.name] for dt, c in input_out["by_dtype"].items()},
            "max_abs_err": max(row["max_abs_err"] for row in rs),
            "ms": sum(row["ms"] for row in rs),
            "warm_ms": sum(row["warm_ms"] for row in rs),
            "call_ms": sum(row["call_ms"] for row in rs),
            "host_us": sum(row["host_us"] for row in rs),
            "plain_ms": sum(row["plain_ms"] for row in rs),
            "bound_ms": sum(bound_ms(row)[0] for row in rs),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None if None in lib else sum(lib),
        })
    log_rows(rows, "C5 f32 (one assembly + solve)", card)
    log_rows(roma_rows["float32"], "roma f32, nb 6 (one assembly + solve)",
             card)
    log_rows(roma_rows["float64"], "roma f64, the polish's shapes (one "
             "assembly + solve)", card)
    log_rows(c5_64_rows, "C5 f64, the covariance's shapes (one assembly + "
             "solve)", card)
    log_rows(psz_rows, "C5 f32, nb 6, the loaded .psz (one assembly + "
             "solve)", card)
    log_rows(features_out.pop("rows"), f"camcal features f64, nb "
             f"{features_out['nb']}, the script's last bundle (one assembly "
             f"+ solve)", card)
    log_rows(mesh_out.pop("rows"), f"C5 f32, {MESH_SHARDS} shards, largest "
             f"shard (one assembly + solve)", card)
    log(f"covariance at the C5 shape, f32, on {card}: {cov_out}")
    log(f"DBAT script at the C5 shape, f64, on {card}: {script_out}")
    log(f"PhotoModeler and PhotoScan input at the C5 shape on {card}: "
        f"{input_out}")
    log(f"feature front-end at the camcal shape on {card}: {features_out}")
    log(f"mesh at the C5 shape, {MESH_SHARDS} shards on one card (overhead, "
        f"not scaling) on {card}: {mesh_out}")
    log(f"total {time.perf_counter() - T0:.2f} s on {card}")
    print(json.dumps({"kernels": out}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
