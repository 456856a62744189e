"""Device-resident damped loops (counterpart of dbat_tpu/solve/fused.py
`fused_gna` and `fused_lm`).

The JAX package runs each damped iteration inside one
`lax.while_loop`.  Here the loop is a Python loop over tensors that
stay on the device; the host reads back only the booleans that steer
it.

`fused_gna` keeps the JAX loop's semantics (ref
gauss_newton_armijo.m): relative or absolute termination, mu = 0.1,
alpha halving down to alpha_min, the f32 floor-stall rule, the
converged-at-the-floor rule for a failed line search, and the status
codes.  Host syncs per outer iteration: one for the termination tests,
one per line-search trial, and one per Cholesky jitter rung tried (f32).

`fused_lm` keeps the JAX loop's LM schedule (ref
levenberg_marquardt.m); host syncs per trial: one for its flags, plus
the jitter rungs.

Both return the count in `damping["host_syncs"]`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import np_dtype
from .solvers import (
    FLOOR_FACTOR, LINESEARCH_FAILED, OK, SINGULAR, STRUCT_RANK_DEFICIENT,
    SolveResult, TOO_MANY_ITERS,
)


def _buffer_cap(max_iter: int) -> int:
    """Length of the on-device residual-norm buffer: 66 covers every
    shipped configuration (<= 64 iterations), larger requests take the
    next power of two."""
    if max_iter + 2 <= 66:
        return 66
    cap = 128
    while cap < max_iter + 2:
        cap *= 2
    return cap


def _struct_rank_deficient(x0) -> SolveResult:
    return SolveResult(x=torch.as_tensor(x0).cpu().numpy(),
                       code=STRUCT_RANK_DEFICIENT, iters=0)


def fused_gna(ops, x0, max_iter: int = 20, conv_tol: float = 1e-6,
              abs_term: bool = False, mu: float = 0.1,
              alpha_min: float = 1e-9, stall_tol: float = None
              ) -> SolveResult:
    """Gauss-Newton-Armijo on `ops` (a SchurOps or a ShardedSchurOps),
    on its device.

    `stall_tol`: f32 floor-stall threshold (two consecutive iterations
    with relative residual decrease below it terminate OK).  Default:
    3e-5 for f32, disabled for f64.  A negative value disables it."""
    dtype, dev = ops.dtype, ops.device
    if stall_tol is None:
        stall_tol = 3e-5 if dtype == torch.float32 else -1.0

    # Structural check stays on host (pattern-only, one-time).
    if ops.structural_rank() < ops.n_x:
        return _struct_rank_deficient(x0)

    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    # Options as dtype scalars: every comparison rounds as on the JAX
    # path, which passes them in the working dtype.
    tol, mu_t, stall_t = scalar(conv_tol), scalar(mu), scalar(stall_tol)
    amin = float(scalar(alpha_min))
    stall_on = float(stall_t) > 0
    res_buf = torch.full((_buffer_cap(max_iter),), float("nan"),
                         dtype=dtype, device=dev)
    alphas = []
    syncs0 = ops.host_syncs
    syncs = 0

    x = torch.as_tensor(x0, device=dev).to(dtype)
    n, code, done = 0, OK, False
    prev_rn = scalar(torch.finfo(dtype).max)
    stall, sflag = 0, False
    while not done and code == OK:
        U, V, Wb, gc, gp, rw = ops._assemble_impl(x)
        g = ops.join_x(gc, gp)
        p, _L = ops._solve_impl(U, V, Wb, -g, 0.0)
        Np = ops._matvec_impl(U, V, Wb, p)
        rnorm = torch.sqrt(rw @ rw)
        res_buf[n] = rnorm
        jp_norm = torch.sqrt(torch.clamp(p @ Np, min=0.0))
        term_t = (rnorm <= tol) if abs_term else jp_norm <= tol * rnorm
        floor_t = (rnorm <= tol) if abs_term \
            else jp_norm <= FLOOR_FACTOR * tol * rnorm
        stalled_t = prev_rn - rnorm <= stall_t * prev_rn
        term, at_floor_ok, stalled = torch.stack(
            [term_t, floor_t, stalled_t]).tolist()
        syncs += 1
        stall = stall + 1 if stalled else 0
        term = term or stall >= 2

        alpha, r_ls = 0.0, None
        if not term:
            # Armijo: halve alpha until sufficient decrease or alpha_min.
            f0 = 0.5 * rnorm ** 2
            fp0 = g @ p
            a = 1.0
            while a >= amin:
                r = ops.weighted_residual(x + a * p)
                f = 0.5 * (r @ r)
                ok = bool(f < f0 + mu_t * a * fp0)
                syncs += 1
                if ok:
                    alpha, r_ls = a, r
                    break
                a = a / 2.0
        take = (not term) and alpha > 0.0
        x_new = x + alpha * p if take else x
        rw_out = r_ls if take else rw
        fail_ls = (not term) and alpha == 0.0
        # Converged at the numerical floor: a failed line search with
        # ||Jp|| within FLOOR_FACTOR of the relative threshold (plain
        # rnorm <= tol under the absolute criterion), or, with the f32
        # stall rule on, right after a sub-stall_tol accepted step.
        at_floor = fail_ls and (at_floor_ok or (stall >= 1 and stall_on))
        sflag = sflag or (stall >= 2) or (fail_ls and stall >= 1
                                          and stall_on)
        n_new = n + (0 if term else 1)
        if not (term or at_floor):
            alphas.append(alpha)
        fail_ls = fail_ls and not at_floor
        over = (not term) and (not at_floor) and n_new > max_iter
        code = (LINESEARCH_FAILED if fail_ls
                else TOO_MANY_ITERS if over else OK)
        done = term or at_floor
        x, n, prev_rn = x_new, n_new, rnorm

    res_np = res_buf.cpu().numpy()
    x_np = x.cpu().numpy()
    res = SolveResult(
        x=x_np,
        code=code,
        iters=n,
        res_norms=[float(v) for v in res_np if np.isfinite(v)],
        damping={"name": "gna", "alphas": alphas, "mu": mu,
                 "alpha_min": alpha_min, "floor_stall": bool(sflag),
                 "host_syncs": syncs + ops.host_syncs - syncs0},
        final_rw=rw_out.cpu().numpy(),
    )
    if res.code == TOO_MANY_ITERS:
        # The TOO_MANY_ITERS exit appends the residual at the final
        # accepted x, which the buffer (written at iteration entry)
        # does not hold.
        res.res_norms.append(float(np.linalg.norm(res.final_rw)))
    res.trace = [x_np]
    return res


def fused_lm(ops, x0, max_iter: int = 20, conv_tol: float = 1e-6,
             abs_term: bool = False, lambda0: float = -1e-10,
             lambda_min: float = -1e-10, stall_tol: float = None
             ) -> SolveResult:
    """Classic lambda-version Levenberg-Marquardt on `ops` (a SchurOps or
    a ShardedSchurOps), on its device.

    Same damping schedule and status codes as
    solvers.levenberg_marquardt: negative lambda0/lambda_min auto-scale
    by trace(J'J)/n, lambda/10 on an accepted step (0 below lambda_min),
    lambda*10 on a rejected one (lambda_min after a rejected lambda = 0
    step), termination at an accepted step when the previous accepted
    step left lambda at 0 (the host loop's prev_lambda gate) and the
    criterion holds.  A failed factorization boosts lambda to at least
    1e-12 trace/n without spending an iteration, and reports SINGULAR
    when an 11th consecutive one fails.  Lambda arithmetic runs in the
    working dtype, as on the JAX loop."""
    if ops.structural_rank() < ops.n_x:
        return _struct_rank_deficient(x0)
    dtype, dev = ops.dtype, ops.device
    nd = np_dtype(dtype).type  # host scalars of the working dtype
    if stall_tol is None:
        stall_tol = 3e-5 if dtype == torch.float32 else -1.0

    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    tol, stall_t = scalar(conv_tol), scalar(stall_tol)
    syncs0 = ops.host_syncs
    syncs = 0

    x = torch.as_tensor(x0, device=dev).to(dtype)
    U, V, Wb, gc, gp, rw = ops._assemble_impl(x)
    tr = nd(ops._trace_diag(U, V))
    syncs += 1
    n_x = nd(ops.n_x)
    lam0 = abs(nd(lambda0)) * tr / n_x if lambda0 < 0 else nd(lambda0)
    lmin = abs(nd(lambda_min)) * tr / n_x if lambda_min < 0 \
        else nd(lambda_min)
    # The boost target when a solve fails.
    lpos = max(lmin, nd(1e-12) * tr / nd(max(ops.n_x, 1)))
    lam = lam0 if lam0 >= lmin else nd(0.0)
    f = 0.5 * (rw @ rw)
    # pal: lambda after the most recent ACCEPTED step, the host loop's
    # prev_lambda; -1 (never 0, like the host's None) until one is.
    pal = nd(-1.0)
    prev_rn = scalar(torch.finfo(dtype).max)
    n, code, boosts, stall, sflag, done = 0, OK, 0, 0, False, False
    res_norms, lambdas = [], []
    while not done and code == OK:
        g = ops.join_x(gc, gp)
        p, _L = ops._solve_impl(U, V, Wb, -g, float(lam))
        rnorm = torch.sqrt(2.0 * f)
        x_t = x + p
        rw_t = ops.weighted_residual(x_t)
        ft = 0.5 * (rw_t @ rw_t)
        jp_norm = torch.sqrt(torch.clamp(
            p @ ops._matvec_impl(U, V, Wb, p), min=0.0))
        rn_t = torch.sqrt(2.0 * ft)

        def crit(rn):
            return (rn <= tol) if abs_term else (jp_norm <= tol * rn)

        # One read for every flag of this trial: the criterion at the
        # point the trial leaves, accepted or not.
        failed, better, crit_t, crit_x, stalled_t = torch.stack([
            ~torch.isfinite(p).all(), ft < f, crit(rn_t), crit(rnorm),
            prev_rn - rn_t <= stall_t * prev_rn]).tolist()
        syncs += 1
        accept = (not failed) and better
        boosts = boosts + 1 if failed else 0
        if failed:
            lam_new = max(lam * nd(10.0), lpos)
        else:
            res_norms.append(rnorm)
            lambdas.append(float(lam))
            if accept:
                lam_new = lam / nd(10.0)
                if lam_new < lmin:
                    lam_new = nd(0.0)
            else:
                lam_new = lmin if lam == 0.0 else lam * nd(10.0)
        n_new = n + (0 if failed else 1)

        # Reassemble only on accepted steps.
        if accept:
            x, f = x_t, ft
            U, V, Wb, gc, gp, rw = ops._assemble_impl(x)
        # Termination (solvers.levenberg_marquardt): the criterion is
        # checked after an ACCEPTED step, gated on the previous accepted
        # step having left lambda at 0 (pal), at the new point.  The
        # host's inner loop also exits on iteration exhaustion without
        # an accept and runs the same check: without that arm an f32
        # run at the optimum whose lambda-0 trial rounds to no
        # improvement would burn max_iter and return TOO_MANY_ITERS
        # where the host loop returns OK.
        exhausted = (not failed) and n_new > max_iter
        term = (accept or exhausted) and pal == 0.0 \
            and (crit_t if accept else crit_x)
        if accept:
            pal = lam_new
            stall = stall + 1 if stalled_t else 0
            prev_rn = rn_t
        stall_term = stall >= 2
        term = term or stall_term
        sflag = sflag or stall_term
        over = (not term) and (not failed) and n_new > max_iter
        code = (SINGULAR if failed and boosts > 10
                else TOO_MANY_ITERS if over else OK)
        lam, n, done = lam_new, n_new, term

    x_np = x.cpu().numpy()
    res = SolveResult(
        x=x_np,
        code=code,
        iters=n,
        res_norms=[float(v) for v in torch.stack(res_norms).tolist()]
        if res_norms else [],
        damping={"name": "lm", "lambdas": lambdas, "lambda0": float(lam0),
                 "lambda_min": float(lmin), "floor_stall": bool(sflag),
                 "host_syncs": syncs + 1 + ops.host_syncs - syncs0},
        final_rw=rw.cpu().numpy(),
    )
    # solvers.levenberg_marquardt appends the residual at the final x
    # after its loop.
    res.res_norms.append(float(np.linalg.norm(res.final_rw)))
    res.trace = [x_np]
    return res
