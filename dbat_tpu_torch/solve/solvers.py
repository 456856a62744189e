"""Damped least-squares solvers: GM, GNA, LM, LMP (counterpart of
dbat_tpu/solve/solvers.py).

Same algorithmic contract as the reference's solver layer
(code/bundle/lsa/*.m): status codes 0 OK / -1 too many iterations /
-2 singular normal matrix / -3 line search failed / -4 structurally
rank-deficient Jacobian (gauss_newton_armijo.m:38-46); identical
damping schedules and termination semantics, so iteration counts are
comparable with DBAT.

The solvers never see a Jacobian: they consume a `normal(x)` operator
(normal_state.py, schur.py) and recover every J-dependent quantity from
it: ||J p||^2 = p'Np,  r'Jp = g'p.  x and the step stay tensors on the
ops' device; the host reads the scalars that steer the loop.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

OK = 0
TOO_MANY_ITERS = -1
SINGULAR = -2
LINESEARCH_FAILED = -3
STRUCT_RANK_DEFICIENT = -4

#: Linesearch failure with ||Jp|| within this factor of the
#: termination threshold counts as converged-at-the-numerical-floor.
FLOOR_FACTOR = 100.0


@dataclass
class SolveResult:
    x: np.ndarray
    code: int
    iters: int
    res_norms: list = field(default_factory=list)  # ||r_w|| per iteration
    trace: list = field(default_factory=list)  # successive x estimates
    damping: dict = field(default_factory=dict)
    final_rw: np.ndarray = None
    final_p: np.ndarray = None

    @property
    def ok(self) -> bool:
        return self.code == OK


def _norm(v) -> float:
    return float(torch.linalg.vector_norm(v))


def _host(v):
    return v.detach().cpu().numpy()


def _start(ops, x0):
    """x0 as a tensor of the ops' dtype on the ops' device."""
    return torch.as_tensor(x0, device=ops.device).to(ops.dtype)


def gauss_newton_armijo(
    ops,
    x0,
    max_iter: int = 20,
    term_fun=None,
    mu: float = 0.1,
    alpha_min: float = 1e-9,
    singular_test: bool = True,
    veto_fun=None,
    do_trace: bool = False,
    stall_tol: float = None,
) -> SolveResult:
    """Gauss-Newton with Armijo backtracking line search
    (code/bundle/lsa/gauss_newton_armijo.m).

    `stall_tol`: f32 floor-stall threshold (see below); default 3e-5
    for f32 ops, disabled for f64.  Negative disables."""
    x = _start(ops, x0)
    res = SolveResult(x=None, code=OK, iters=0)
    res.damping = {"name": "gna", "alphas": [], "mu": mu,
                   "alpha_min": alpha_min}
    res.trace.append(_host(x))

    # Structural-rank sanity check, iteration 0 only
    # (gauss_newton_armijo.m:130-142).
    if ops.structural_rank() < ops.n_x:
        res.code = STRUCT_RANK_DEFICIENT
        res.x = _host(x)
        return res

    n = 0
    p = None
    rw = None
    # f32 floor-stall rule: an f32 solve cannot certify DBAT's 1e-6
    # relative step criterion — the step norm plateaus at the f32
    # arithmetic floor while the residual stops moving.  Two
    # consecutive accepted iterations with relative residual decrease
    # < stall_tol terminate OK (the f32 analog of the FLOOR_FACTOR
    # rule; the f64 path never fires it).
    if stall_tol is None:
        stall_tol = 3e-5 if ops.dtype == torch.float32 else -1.0
    stall = 0
    while True:
        st = ops.normal(x)
        rw = st.rw
        rnorm = _norm(rw)
        res.res_norms.append(rnorm)
        if do_trace:
            print(f"GNA: iteration {n}, residual norm={rnorm:.6g}")

        p, failed = st.solve(-st.g)
        if failed and singular_test:
            res.code = SINGULAR
            break

        Jp_norm2 = float(p @ st.matvec(p))
        gp = float(st.g @ p)
        jp_norm = np.sqrt(max(Jp_norm2, 0.0))
        if term_fun(jp_norm, rnorm):
            break

        n += 1

        # Armijo backtracking (gauss_newton_armijo.m:249-291).
        f0 = 0.5 * rnorm ** 2
        fp0 = gp  # r'Jp
        alpha = 1.0
        accepted = False
        vetoed_any = False
        while alpha >= alpha_min:
            t = x + alpha * p
            rt = ops.weighted_residual(t)
            f = 0.5 * float(rt @ rt)
            red_ok = f < f0 + mu * alpha * fp0
            fail = bool(veto_fun(t)) if (red_ok and veto_fun is not None) \
                else False
            vetoed_any = vetoed_any or fail
            if red_ok and not fail:
                x = t
                rw = rt
                accepted = True
                break
            alpha /= 2.0
        if not accepted:
            alpha = 0.0

        if alpha == 0.0 and stall >= 1 and not vetoed_any:
            # f32 floor: the previous accepted step already decreased
            # the residual by < stall_tol and now no measurable descent
            # remains.  (A veto rejection is a genuine failure, not the
            # floor: it keeps the LINESEARCH_FAILED path.)
            res.res_norms.append(_norm(rw))
            res.damping["floor_stall"] = True
            break
        if alpha == 0.0 and term_fun(jp_norm / FLOOR_FACTOR, rnorm):
            # Converged at the numerical floor: no measurable descent
            # remains AND the step criterion is within FLOOR_FACTOR of
            # firing (DBAT's own camcal run terminates here with OK,
            # camcal-dbatreport.txt:41).
            break

        res.damping["alphas"].append(alpha)
        res.trace.append(_host(x))

        if alpha == 0.0:
            res.code = LINESEARCH_FAILED
            res.res_norms.append(res.res_norms[-1])
            break
        cur = _norm(rw)
        if rnorm - cur <= stall_tol * rnorm:
            stall += 1
            if stall >= 2:
                res.res_norms.append(cur)
                res.damping["floor_stall"] = True
                break  # OK: converged at the f32 floor
        else:
            stall = 0
        if n > max_iter:
            res.code = TOO_MANY_ITERS
            res.res_norms.append(_norm(rw))
            break

    res.x = _host(x)
    res.iters = n
    res.final_rw = _host(rw)
    res.final_p = _host(p) if p is not None else None
    return res


def gauss_markov(
    ops,
    x0,
    max_iter: int = 20,
    term_fun=None,
    singular_test: bool = True,
    do_trace: bool = False,
) -> SolveResult:
    """Classical undamped Gauss-Markov (code/bundle/lsa/gauss_markov.m)."""
    x = _start(ops, x0)
    res = SolveResult(x=None, code=OK, iters=0)
    res.damping = {"name": "gm"}
    res.trace.append(_host(x))
    n = 0
    p = None
    rw = None
    while True:
        st = ops.normal(x)
        rw = st.rw
        rnorm = _norm(rw)
        res.res_norms.append(rnorm)
        if do_trace:
            print(f"GM: iteration {n}, residual norm={rnorm:.6g}")
        p, failed = st.solve(-st.g)
        if failed and singular_test:
            res.code = SINGULAR
            break
        Jp_norm = float(torch.sqrt(torch.clamp(p @ st.matvec(p), min=0.0)))
        if term_fun(Jp_norm, rnorm):
            break
        n += 1
        x = x + p
        res.trace.append(_host(x))
        if n > max_iter:
            res.code = TOO_MANY_ITERS
            break
    res.x = _host(x)
    res.iters = n
    res.final_rw = _host(rw) if rw is not None else None
    res.final_p = _host(p) if p is not None else None
    return res


def levenberg_marquardt(
    ops,
    x0,
    max_iter: int = 20,
    term_fun=None,
    lambda0: float = -1e-10,
    lambda_min: float = -1e-10,
    veto_fun=None,
    do_trace: bool = False,
) -> SolveResult:
    """Classic lambda-version LM (code/bundle/lsa/levenberg_marquardt.m).

    Negative lambda0/lambda_min mean auto-scale by trace(J'J)/n
    (levenberg_marquardt.m:88-96)."""
    x = _start(ops, x0)
    res = SolveResult(x=None, code=OK, iters=0)
    res.trace.append(_host(x))

    st = ops.normal(x)
    rw = st.rw
    f = 0.5 * float(rw @ rw)
    tr = st.trace_diag()
    if lambda0 < 0:
        lambda0 = abs(lambda0) * tr / ops.n_x
    if lambda_min < 0:
        lambda_min = abs(lambda_min) * tr / ops.n_x
    lam = lambda0 if lambda0 >= lambda_min else 0.0
    lambdas = [lam]
    res.damping = {"name": "lm", "lambdas": lambdas, "lambda0": lambda0,
                   "lambda_min": lambda_min}

    if ops.structural_rank() < ops.n_x:
        res.code = STRUCT_RANK_DEFICIENT
        res.x = _host(x)
        return res

    n = 0
    p = None
    prev_lambda = None
    Jp_norm = np.inf
    boosts = 0
    while True:
        converged = False
        while n <= max_iter:
            p, failed = st.solve(-st.g, lam=lam)
            if failed:
                # A failed factorization is LM's own cue to damp
                # harder, not to abort: in f32 the camera system of a
                # large sparse-ray network can be indefinite at
                # roundoff until lambda lifts the spectrum.  Declare
                # SINGULAR only when boosting stops helping.
                boosts += 1
                if boosts > 10:
                    res.code = SINGULAR
                    break
                lam = max(lam * 10.0, lambda_min,
                          1e-12 * tr / max(ops.n_x, 1))
                continue
            boosts = 0
            res.res_norms.append(_norm(rw))
            lambdas.append(lam)
            if do_trace:
                print(f"LM: iteration {n}, residual norm="
                      f"{res.res_norms[-1]:.6g}, lambda={lam:.3g}")
            res.trace.append(_host(x))
            n += 1
            Jp_norm = float(torch.sqrt(torch.clamp(p @ st.matvec(p),
                                                   min=0.0)))
            t = x + p
            rt = ops.weighted_residual(t)
            ft = 0.5 * float(rt @ rt)
            fail = bool(veto_fun(t)) if (ft < f and veto_fun is not None) \
                else False
            if ft < f and not fail:
                x = t
                lam = lam / 10.0
                if lam < lambda_min:
                    lam = 0.0
                st = ops.normal(x)
                rw = st.rw
                f = 0.5 * float(rw @ rw)
                break
            else:
                lam = lambda_min if lam == 0.0 else lam * 10.0
        if res.code != OK:
            break
        if prev_lambda == 0.0 and term_fun(Jp_norm, _norm(rw)):
            converged = True
        prev_lambda = lam
        if converged:
            break
        if n > max_iter:
            res.code = TOO_MANY_ITERS
            break

    res.res_norms.append(_norm(rw))
    res.x = _host(x)
    res.iters = n
    res.final_rw = _host(rw)
    res.final_p = _host(p) if p is not None else None
    return res


def levenberg_marquardt_powell(
    ops,
    x0,
    max_iter: int = 20,
    term_fun=None,
    delta0: float = None,
    rho_bad: float = 0.25,
    rho_good: float = 0.75,
    veto_fun=None,
    do_trace: bool = False,
) -> SolveResult:
    """Trust-region LM with Powell dogleg
    (code/bundle/lsa/levenberg_marquardt_powell.m)."""
    x = _start(ops, x0)
    if delta0 is None:
        delta0 = _norm(x)  # bundle.m:325
    delta = delta0
    res = SolveResult(x=None, code=OK, iters=0)
    res.damping = {"name": "lmp", "deltas": [], "rhos": [], "steps": [],
                   "delta0": delta0, "rho_bad": rho_bad,
                   "rho_good": rho_good}
    res.trace.append(_host(x))

    if ops.structural_rank() < ops.n_x:
        res.code = STRUCT_RANK_DEFICIENT
        res.x = _host(x)
        return res

    st = ops.normal(x)
    rw = st.rw
    f = 0.5 * float(rw @ rw)
    n = 0
    p = None
    while True:
        res.res_norms.append(_norm(rw))

        p, p_gn, step, failed = _dogleg(st, delta)
        if failed:
            res.code = SINGULAR
            break
        res.damping["deltas"].append(delta)
        res.damping["steps"].append(step)

        Jp_gn = float(torch.sqrt(torch.clamp(p_gn @ st.matvec(p_gn),
                                             min=0.0)))
        Jp_norm2 = float(p @ st.matvec(p))
        if step == 0 and term_fun(Jp_gn, res.res_norms[-1]):
            break

        t = x + p
        rt = ops.weighted_residual(t)
        ft = 0.5 * float(rt @ rt)
        veto = bool(veto_fun(t)) if veto_fun is not None else False

        predicted = -float(st.g @ p) - 0.5 * Jp_norm2
        actual = f - ft
        rho = actual / predicted if predicted != 0 else -np.inf
        res.damping["rhos"].append(rho)
        if do_trace:
            print(f"LMP: iteration {n}, residual norm="
                  f"{res.res_norms[-1]:.6g}, delta={delta:.3g}, "
                  f"step={step}, rho={rho:.2f}")

        if veto or rho <= rho_bad:
            delta = delta / 2.0
            pgn_norm = _norm(p_gn)
            if delta > pgn_norm:
                delta = delta / 2.0 ** np.ceil(np.log2(delta / pgn_norm))
        else:
            x = t
            st = ops.normal(x)
            rw = st.rw
            f = 0.5 * float(rw @ rw)
            if rho >= rho_good:
                delta = delta * 2.0

        res.trace.append(_host(x))
        n += 1
        if n > max_iter:
            res.code = TOO_MANY_ITERS
            break

    res.x = _host(x)
    res.iters = n
    res.final_rw = _host(rw)
    res.final_p = _host(p) if p is not None else None
    return res


def _dogleg(st, delta):
    """Powell dogleg (levenberg_marquardt_powell.m dogleg): returns
    (p, p_gn, step, failed); step 0=GN, 1=interpolated, 2=Cauchy.

    The reference computes in column-scaled coordinates; algebraically
    the GN point, the Cauchy point lambda* = g'g/(g'Ng), and the trust
    region are all expressed on the unscaled system here."""
    g = st.g
    p_gn, failed = st.solve(-g)
    if failed:
        return None, None, -1, True
    if _norm(p_gn) <= delta:
        return p_gn, p_gn, 0, False

    gng = float(g @ st.matvec(g))
    lambda_star = float(g @ g) / gng
    cp = -lambda_star * g
    cp_norm = _norm(cp)
    if cp_norm > delta:
        p = -g / _norm(g) * delta
        return p, p_gn, 2, False

    diff = p_gn - cp
    A = float(diff @ diff)
    B = float(2.0 * cp @ diff)
    C = float(cp @ cp) - delta ** 2
    k = (-B + np.sqrt(B * B - 4 * A * C)) / (2 * A)
    p = cp + k * diff
    return p, p_gn, 1, False
