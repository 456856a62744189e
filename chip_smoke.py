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
     its SchurOps in float32 and float64;
  4. kernel checks: every kernel on the inputs the main paths give it
     (C5 f32; roma f32 and f64, the watchdog's and the polish's shapes;
     a small network in f64), against its plain PyTorch version, with
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
     held to the JAX package's on the same network (POLISH_EXPECT).
Phases 6, 8 and 9 each zero the launch counts just before and read them
just after; every kernel must have launched in each (in f64 in 9).

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


def check_kernels(ops, dtype_name, timed):
    """Every kernel against its plain version on the inputs of one
    assembly + solve of `ops`.  Returns per-kernel rows; raises when a
    kernel disagrees beyond REL_TOL."""
    import torch

    from dbat_tpu_torch.solve.kernels import (
        fused_bilinear, fused_bilinear_plain, pair_bucket_acc,
        pair_bucket_acc_plain,
    )
    from dbat_tpu_torch.timing import call_ms, cold_ms, device_ms

    tol = REL_TOL[dtype_name]
    seen = capture_inputs(ops)
    nb = ops.n_cb
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
        log(f"  fused_bilinear{nm[3:]:>6} {dtype_name} rows={A.shape[0]} "
            f"d_a={A.shape[1]} d_b={B.shape[1]} d_out={fb.d_out} g={fb.g}: "
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
    plan = ops._pair_plan
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
    log(f"  pair_bucket_acc {dtype_name} pairs={plan.n_pairs} rows="
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


def roma_net():
    from dbat_tpu_torch.pipeline.synthetic import ROMA_RING

    return net(ROMA_RING, 24)


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dbat_tpu_torch import build
    from dbat_tpu_torch.solve.bundle import bundle
    from dbat_tpu_torch.solve.fused import fused_gna
    from dbat_tpu_torch.solve.kernels import KERNELS
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
    small = {}
    for where in ("cuda", "cpu"):
        sb, _ = net(SMALL, 6)
        _p, ok_b, it_b, s0_b, info_b = bundle(
            sb, damping="lm", backend="schur", conv_tol=1e-4, device=where)
        small[where] = (ok_b, info_b.code, it_b, s0_b)
    log(f"small f64 bundle(lm, schur) on {card}: card (ok, code, iters, "
        f"sigma0) {small['cuda']}, CPU {small['cpu']}")
    if (not small["cuda"][0] or small["cuda"][:3] != small["cpu"][:3]
            or abs(small["cuda"][3] / small["cpu"][3] - 1) > 1e-8):
        raise RuntimeError("small bundle(): card and CPU disagree")
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

    # Kernel summary: device times per C5 outer iteration (the five
    # kernel-A calls and the one kernel-B call of one assembly + S
    # build, f32), launches summed over the three driven paths.
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
    log(f"total {time.perf_counter() - T0:.2f} s on {card}")
    print(json.dumps({"kernels": out}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
