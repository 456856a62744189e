#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dbat_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printing its elapsed seconds as it ends:
  1. device report (nvidia-smi name and power limit, torch and CUDA);
  2. build of the CUDA kernels (one nvcc call) with ptxas's report;
  3. the C5-shape network of bench.py (239 cameras, 17,993 points,
     196,715 observations, 8 self-calibrated IO parameters) and its
     SchurOps in float32 on the card;
  4. kernel checks: every kernel on the inputs the main path gives it
     at the C5 shape (f32) and on a small network (f64), against its
     plain PyTorch version, with times, bounds and a library yardstick;
  5. a small network solved on the card (kernels) and on the CPU
     (plain versions) must agree;
  6. the main path: fused_gna to the noise floor (bench.py's gate),
     then 10 fixed iterations; launch counts are zeroed just before
     and read just after, and every kernel must have launched.

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
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SMALL = dict(n_img=12, n_pt=400, rays_per_pt=(3, 9), n_obs_target=2000,
             n_ctrl=4, noise_px=0.1, ip_std_px=0.1,
             est_io_cols=("cc", "px", "py", "K1", "K2", "K3", "P1", "P2"),
             seed=5)
#: kernel vs plain, max |diff| / max |plain|: f32 sums in another order
#: (kernel B adds up to ~2,400 terms per output), f64 likewise.
REL_TOL = {"float32": 1e-5, "float64": 1e-12}


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


def time_ms(fn, reps=20):
    """Median milliseconds of `fn` over `reps` runs, CUDA events."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    times.sort()
    return times[len(times) // 2]


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
        row = {"kernel": "fused_bilinear", "call": nm, "rows": A.shape[0],
               "d_a": A.shape[1], "d_b": B.shape[1], "d_out": fb.d_out,
               "g": fb.g, "max_abs_err": err, "rel_err": rel}
        if timed:
            lib = library_call(nm, A, B, nb)
            lib_err = float((lib().reshape(p.shape) - p).abs().max()) \
                / max(float(p.abs().max()), 1e-300)
            b = nbytes(A, B, tab) + p.numel() * p.element_size()
            ops_n = (2 * fb.g - 1) * A.shape[0] * fb.d_out
            row.update(ms=time_ms(kern), plain_ms=time_ms(plain),
                       library_ms=time_ms(lib), library_err=lib_err,
                       bytes=b, flops=ops_n)
        rows.append(row)
        log(f"  fused_bilinear{nm[3:]:>6} {dtype_name} rows={A.shape[0]} "
            f"d_a={A.shape[1]} d_b={B.shape[1]} d_out={fb.d_out} g={fb.g}: "
            f"max abs err {err:.3e}, rel {rel:.3e} (tol rel {tol:g})"
            + (f" | kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} "
               f"ms, bmm {row['library_ms']:.4f} ms (bmm rel err "
               f"{row['library_err']:.2e})" if timed else ""))
        if not rel <= tol:
            raise RuntimeError(
                f"fused_bilinear {nm}: rel err {rel:.3e} > {tol}")

    Yf, fb = seen["pair_bucket"]
    plan = ops._pair_plan
    tab = fb.table(Yf.device)
    args = (Yf, plan.i1, plan.i2, plan.row_ptr, tab, fb.d_out, fb.g, plan.cap)

    def kern():
        return pair_bucket_acc(*args)

    def plain():
        return pair_bucket_acc_plain(*args)

    k, p = kern(), plain()
    torch.cuda.synchronize()
    err = float((k - p).abs().max())
    rel = err / max(float(p.abs().max()), 1e-300)
    row = {"kernel": "pair_bucket_acc", "call": "_pair_acc",
           "pairs": plan.n_pairs, "padded_pairs": plan.n_rows * plan.cap,
           "bucket_rows": plan.n_rows, "camera_pairs": plan.n_campair,
           "d_y": Yf.shape[1], "d_out": fb.d_out, "g": fb.g,
           "max_abs_err": err, "rel_err": rel}
    if timed:
        b = nbytes(Yf, plan.i1, plan.i2, plan.row_ptr, tab) \
            + p.numel() * p.element_size()
        row.update(ms=time_ms(kern), plain_ms=time_ms(plain, reps=5),
                   library_ms=None, bytes=b,
                   flops=2 * fb.g * plan.n_pairs * fb.d_out)
    rows.append(row)
    log(f"  pair_bucket_acc {dtype_name} pairs={plan.n_pairs} rows="
        f"{plan.n_rows} camera pairs={plan.n_campair} d_out={fb.d_out}: "
        f"max abs err {err:.3e}, rel {rel:.3e} (tol rel {tol:g})"
        + (f" | kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms"
           if timed else ""))
    if not rel <= tol:
        raise RuntimeError(f"pair_bucket_acc: rel err {rel:.3e} > {tol}")
    return rows


def bound_ms(row):
    t_bytes = row["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = row["flops"] / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dbat_tpu_torch import build
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
    log(f"kernels library {info.path.name}: compiled={info.compiled} in "
        f"{info.seconds:.2f} s on the host of {card}")
    for line in build.ptxas_report(info.log):
        log(f"  ptxas: {line}")
    phase_done("build", t, card)

    # 3. C5-shape problem on the card --------------------------------------
    t = time.perf_counter()
    s, spec = net(C5_RING, 18)
    ops = SchurOps(s, spec, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    dof = ops.n_res - ops.n_x
    floor = float(np.sqrt(dof))
    rows_per_cp = np.diff(ops._pair_plan.row_ptr.cpu().numpy())
    log(f"C5 shape: n_img={s.n_img} n_pt={s.n_op} n_obs={ops.n_obs} "
        f"n_x={ops.n_x} n_c={ops.n_c} nb={ops.n_cb} pairs={ops.n_pairs} "
        f"camera pairs={ops.n_campair} bucket rows="
        f"{ops._pair_plan.n_rows} (per camera pair: median "
        f"{np.median(rows_per_cp):g}, max {rows_per_cp.max()}) pad ratio "
        f"{ops._pair_plan.pad_ratio:.4f}")
    phase_done("setup", t, card)

    # 4. Kernel checks ------------------------------------------------------
    t = time.perf_counter()
    log(f"kernel checks on {card}:")
    rows = check_kernels(ops, "float32", timed=True)
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
    log(f"small f64 on {card}: card code {r_gpu.code} iters "
        f"{r_gpu.iters} ||r_w|| {r_gpu.res_norms[-1]!r}; CPU code "
        f"{r_cpu.code} iters {r_cpu.iters} ||r_w|| "
        f"{r_cpu.res_norms[-1]!r}; max |dx| {dx:.3e}")
    if (r_gpu.code != 0 or r_gpu.code != r_cpu.code
            or r_gpu.iters != r_cpu.iters
            or abs(r_gpu.res_norms[-1] / r_cpu.res_norms[-1] - 1) > 1e-8
            or not np.all(np.isfinite(r_gpu.x))):
        raise RuntimeError("small network: card and CPU disagree")
    phase_done("small reference", t, card)

    # 6. Main path ----------------------------------------------------------
    t = time.perf_counter()
    x0 = ops.x0()
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS:
        k.launches = 0
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
    launches = {k.name: k.launches for k in KERNELS}
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
    log(f"  launches on the main path: {launches}; peak CUDA memory "
        f"{peak_gb:.3f} GB")
    phase_done("main path", t, card)
    if not (res.code == 0 and rn_ttc <= floor):
        raise RuntimeError("main path did not converge to the noise floor")
    if not sigma0 < 1.05:
        raise RuntimeError(f"fixed run left the noise floor: sigma0 {sigma0}")
    if not (np.all(np.isfinite(res.x)) and res.x.shape == (ops.n_x,)):
        raise RuntimeError("main path returned a non-finite or misshapen x")
    missing = [nm for nm, c in launches.items() if c <= 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the main path: {missing}")

    # Kernel summary (per outer iteration: the five kernel-A calls and
    # the one kernel-B call of one assembly + S build).
    by_kernel = {}
    for r in rows:
        by_kernel.setdefault(r["kernel"], []).append(r)
    out = []
    for k in KERNELS:
        rs = by_kernel[k.name]
        b_ms = [bound_ms(r) for r in rs]
        t_bytes = sum(r["bytes"] for r in rs) / HBM_BYTES_PER_S * 1e3
        t_ops = sum(r["flops"] for r in rs) / F32_FLOP_PER_S * 1e3
        lib = [r["library_ms"] for r in rs]
        out.append({
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[k.name],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(b for b, _ in b_ms),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None if None in lib else sum(lib),
        })
    log(f"kernel times against their bounds on {card}:")
    for r in rows:
        b, by = bound_ms(r)
        log(f"  {r['kernel']}/{r['call']}: {r['ms']:.4f} ms vs bound "
            f"{b:.4f} ms ({by}; {r['bytes'] / 1e6:.1f} MB, "
            f"{r['flops'] / 1e9:.3f} GFLOP)")
    log(f"total {time.perf_counter() - T0:.2f} s on {card}")
    print(json.dumps({"kernels": out}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
