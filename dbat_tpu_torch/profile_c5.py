"""Where the time goes on the C5-shape main path, on one CUDA card.

    python -m dbat_tpu_torch.profile_c5

Builds the C5-shape network of bench.py and chip_smoke.py
(pipeline/synthetic.py C5_RING) and prints, beside the card's name and
power limit:

  1. host wall time of each stage of one outer iteration (assembly,
     reduced solve, matvec, one line-search residual), each ended by a
     device synchronize, median of 5;
  2. the 10-iteration fixed run of chip_smoke.py in float32 and in
     float64: residual norm per iteration, step lengths, sigma0;
  3. a torch.profiler trace of a 3-iteration fixed run: device time by
     kernel name and the device's idle share of the wall time.

Needs a CUDA card; raises without one.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch

from .core.serial import build_serial
from .pipeline.synthetic import C5_RING, make_ring_network, perturb
from .solve.fused import fused_gna
from .solve.schur import SchurOps


def _median_wall(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)[reps // 2] * 1e3


def stage_times(ops, x):
    U, V, Wb, gc, gp, rw = ops._assemble_impl(x)
    g = ops.join_x(gc, gp)
    p, _ = ops._solve_impl(U, V, Wb, -g, 0.0)
    from .solve.smallblas import inv3x3

    Vinv = inv3x3(V)
    stages = {
        "assemble (Jacobians, U V W, gradients)":
            lambda: ops._assemble_impl(x),
        "solve (S build, Cholesky, refinement, back-substitution)":
            lambda: ops._solve_impl(U, V, Wb, -g, 0.0),
        "  of which S build (_schur_S)":
            lambda: ops._schur_S(U, Vinv, Wb, 0.0),
        "matvec": lambda: ops._matvec_impl(U, V, Wb, p),
        "one line-search residual": lambda: ops.weighted_residual(x + p),
    }
    return {k: _median_wall(f) for k, f in stages.items()}


def device_profile(ops, x0_t):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = fused_gna(ops, x0_t, max_iter=3, conv_tol=0.0, stall_tol=-1.0)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        # Device-side events only (kernels, copies, memsets): the host
        # operators that launched them carry the same time again.
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(e, "self_cuda_time_total", 0.0)
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    return res, wall * 1e3, rows


def main():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    s = make_ring_network(**C5_RING)
    perturb(s, eo_pos=0.02, eo_ang=0.004, op_pos=0.02, seed=18)
    spec = build_serial(s)
    ops = SchurOps(s, spec, dtype=torch.float32, device="cuda")
    x0 = ops.x0()
    floor = float(np.sqrt(ops.n_res - ops.n_x))
    fused_gna(ops, x0, max_iter=20, conv_tol=floor, abs_term=True)  # warm

    print(f"stage wall times, one outer iteration at x0 ({card}):")
    for k, v in stage_times(ops, x0).items():
        print(f"  {v:9.3f} ms  {k}", flush=True)

    rng = np.random.default_rng(99)
    x0_t = x0.cpu().numpy() + 0.05 * rng.standard_normal(ops.n_x)
    for dt in (torch.float32, torch.float64):
        o = ops if dt == torch.float32 else SchurOps(s, spec, dtype=dt,
                                                     device="cuda")
        t0 = time.perf_counter()
        r = fused_gna(o, x0_t, max_iter=10, conv_tol=0.0, stall_tol=-1.0)
        sec = time.perf_counter() - t0
        rn = float(np.linalg.norm(r.final_rw))
        print(f"fixed run {str(dt)[6:]} ({card}): {r.iters} iterations in "
              f"{sec:.3f} s, sigma0 {rn / floor:.5f}; ||r_w|| per "
              f"iteration {[round(v, 3) for v in r.res_norms]}; alphas "
              f"{r.damping['alphas']}", flush=True)

    res, wall_ms, rows = device_profile(ops, x0_t)
    busy = sum(r[0] for r in rows)
    n_launch = sum(r[1] for r in rows)
    print(f"torch.profiler, fixed run of {res.iters} iterations ({card}): "
          f"wall {wall_ms:.1f} ms, " + (
              f"device busy {busy:.1f} ms, idle share "
              f"{1 - busy / wall_ms:.3f}, {n_launch} device ops "
              f"({n_launch / res.iters:.0f} per iteration)" if rows else
              "device time not measured (the trace holds no device event)"))
    for ms, count, name in rows[:25]:
        print(f"  {ms:9.3f} ms  x{count:<5d} {name[:90]}", flush=True)


if __name__ == "__main__":
    main()
