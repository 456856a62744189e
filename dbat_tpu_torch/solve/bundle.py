"""Top-level bundle adjustment entry point (counterpart of
dbat_tpu/solve/bundle.py; ref code/bundle/bundle.m).

Usage:
    project, ok, iters, sigma0, info = bundle(project, damping="gna")

Damping options mirror the reference: 'none'/'gm', 'gna' (default),
'lm', 'lmp'.  Termination: relative angle criterion
||Jp|| <= tol*||r|| by default, absolute ||r|| <= tol with
`abs_term=True` (bundle.m:177-192).  The chirality veto is the
depth-positivity guard the reference wires but never shipped
(bundle.m:168-172).

Everything runs on one device, the card by default (`device=`): the
solve, the f64 polish after an f32 solve and the f64 re-evaluation of
the final residual.  The JAX package runs those two f64 steps on the
host CPU because a TPU has no f64; the card has, so they stay on it and
run the f64 instances of both kernels.  The point-partitioned mesh
backend of the JAX package is not ported.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.paramtypes import param_names
from ..core.serial import build_serial, deserialize, serialize
from ..device import as_dtype, resolve_device
from ..models.residuals import make_obs_residual_fn
from ..models.rotation import world_to_cam_matrix
from . import solvers
from .forensics import numerical_rank_analysis
from .fused import fused_gna, fused_lm
from .ops import BundleOps
from .schur import SchurOps


@dataclass
class BundleInfo:
    """Iteration/diagnostic info (the reference's E struct)."""

    damping: dict = field(default_factory=dict)
    res_norms: list = field(default_factory=list)
    trace: np.ndarray = None  # (n_x, n_iter+1)
    code: int = 0
    used_iters: int = 0
    time: float = 0.0
    sigma0: float = np.nan
    num_obs: int = 0
    num_params: int = 0
    redundancy: int = 0
    param_types: list = field(default_factory=list)
    weakness: dict = field(default_factory=dict)
    ops: object = None
    spec: object = None
    final_factorized: object = None  # cached covariance factorization
    sigmas: np.ndarray = None
    final_x: np.ndarray = None  # converged x in the ops frame
    center_offset: np.ndarray = None  # world -> ops frame translation
    sigma0_prepolish: float = None  # f64-evaluated sigma0 before polish
    polish_iters: int = 0  # f64 Gauss-Newton polish steps used
    chip_code: int = None  # raw f32 status before an accepted polish


def chirality_veto(ops):
    """Depth-positivity veto: reject a trial point if any observed
    object point has non-positive depth in its camera.

    The reference requests this via vetoFun=@chirality (bundle.m:168)
    but ships no implementation; this is built on the pointdepth
    primitive (code/photogrammetry/pointdepth.m)."""

    def veto(x):
        io, eo, op = ops.params_of_x(x)
        C = eo[ops.obs_img, 0:3]
        M = world_to_cam_matrix(eo[ops.obs_img, 3:6])
        depth = (M @ (op[ops.obs_pt] - C).unsqueeze(-1))[:, 2, 0]
        # Depth is negative in front of the camera for this convention
        # (projection uses -f); veto when any depth is >= 0.
        return bool((depth >= 0).any())

    return veto


def bundle(
    project,
    damping: str = "gna",
    max_iter: int = 20,
    conv_tol: float = 1e-6,
    abs_term: bool = False,
    singular_test: bool = True,
    veto: bool = False,
    pm_dof: bool = False,
    trace: bool = False,
    dtype=torch.float64,
    backend: str = "auto",
    fused="auto",
    center=None,
    polish=None,
    device=None,
):
    """Run the damped bundle adjustment on a Project.

    Returns (project, ok, iters, sigma0, info).  `project` is updated
    in place with converged values and posterior residuals
    (`project.post`).

    `backend`: "dense" (explicit N), "schur" (reduced camera system) or
    "auto": dense while n_x <= 2000, Schur beyond.

    `fused`: route the iteration through the device loops of fused.py
    instead of the host loops of solvers.py.  Default "auto": fused
    whenever it applies (f32 Schur backend, GNA or LM damping, no veto
    or trace).

    Termination note: an f32 OK can come from the floor-stall rule (two
    consecutive iterations with relative residual decrease < 3e-5) when
    the requested conv_tol was never certified; info.damping
    ["floor_stall"] tells the two apart, and the f64 polish then
    re-certifies the criterion where it accepts.

    `center`: translate the network to its centroid for the solve and
    back afterwards.  Default: on for f32 (survey-grade coordinates lose
    ~0.1 m to f32 rounding otherwise; the residual model is
    translation-invariant).  info.final_x lives in the centered frame;
    info.center_offset maps back to world.

    `polish`: f64 Gauss-Newton iterations after an f32 solve (default
    2 for f32 unless the absolute criterion was certified outright, 0
    for f64), on the same device.  info.sigma0_prepolish is the f64
    sigma0 of the raw f32 solution.

    `device`: where every step runs; default the CUDA card (raises
    without one, see device.py)."""
    dtype = as_dtype(dtype)
    device = resolve_device(device)
    if center is None:
        center = dtype == torch.float32
    offset = None
    if center:
        rows = []
        good_op = np.isfinite(project.op).all(axis=1)
        if good_op.any():
            rows.append(project.op[good_op])
        good_eo = np.isfinite(project.eo[:, 0:3]).all(axis=1)
        if good_eo.any():
            rows.append(project.eo[good_eo, 0:3])
        if rows:
            offset = np.concatenate(rows, axis=0).mean(axis=0)
    args = (project, damping, max_iter, conv_tol, abs_term, singular_test,
            veto, pm_dof, trace, dtype, backend, fused, polish, device)
    if offset is None:
        return _bundle_impl(*args)
    _shift_network(project, -offset)
    try:
        out = _bundle_impl(*args)
        out[4].center_offset = offset
        return out
    finally:
        _shift_network(project, offset)


def _shift_network(p, d):
    """Translate OP/EO positions and their priors by d (NaN-safe,
    copy-on-write: loader-produced arrays may be read-only views)."""
    d6 = np.concatenate([d, np.zeros(3)])
    p.op = p.op + d
    p.eo = p.eo + d6
    if p.prior_op_val is not None:
        p.prior_op_val = p.prior_op_val + d
    if p.prior_eo_val is not None:
        p.prior_eo_val = p.prior_eo_val + d6


def _final_eval_f64(project, spec, device):
    """Re-evaluate the converged residual vector in f64 on `device`.

    An f32 solve carries ~1e-4-relative evaluation noise in the
    statistic sigma0 even when the parameters are converged (the
    residual is a tiny difference of large projections).  sigma0 is a
    minimum in the parameters, so evaluating once at the f32 solution
    in f64 removes the evaluation noise while the parameter error only
    enters quadratically.

    Returns (rw, r_unw) as numpy arrays in the residual-vector order."""
    p = project
    model = int(np.unique(np.atleast_1d(p.dist_model))[0])
    res_fn = make_obs_residual_fn(model, p.nK, p.nP)
    obs_img = np.asarray(p.obs_img, np.int64)
    obs_pt = np.asarray(p.obs_pt, np.int64)
    px_obs = np.asarray(p.sensor_px_size[:, 0], np.float64)[obs_img]
    w_ip = 1.0 / (np.asarray(p.ip_std_px, np.float64) * px_obs[:, None])
    io = np.asarray(p.io, np.float64)
    eo = np.asarray(p.eo, np.float64)
    op = np.asarray(p.op, np.float64)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=device)

    oi, op_i = t(obs_img), t(obs_pt)
    r_ip = res_fn(t(io)[oi], t(eo)[oi], t(op)[op_i],
                  t(np.asarray(p.ip_px, np.float64)), t(px_obs)
                  ).cpu().numpy()
    x = serialize(spec, io, eo, op)

    def prior(vals, stds, src, obs_x):
        vals = np.asarray(vals, np.float64).reshape(-1)
        stds = np.asarray(stds, np.float64).reshape(-1)
        return np.asarray(obs_x), vals[src], 1.0 / stds[src]

    pio = prior(p.prior_io_val, p.prior_io_std, spec.io_obs_src,
                spec.io_obs_x)
    peo = prior(p.prior_eo_val, p.prior_eo_std, spec.eo_obs_src,
                spec.eo_obs_x)
    pop = prior(p.prior_op_val, p.prior_op_std, spec.op_obs_src,
                spec.op_obs_x)
    prior_x = np.concatenate([pio[0], peo[0], pop[0]]).astype(np.int64)
    prior_val = np.concatenate([pio[1], peo[1], pop[1]])
    prior_w = np.concatenate([pio[2], peo[2], pop[2]])
    r_pr = x[prior_x] - prior_val

    r_unw = np.concatenate([r_ip.reshape(-1), r_pr])
    rw = np.concatenate([(r_ip * w_ip).reshape(-1), r_pr * prior_w])
    return rw, r_unw


def _set_params(project, spec, ops, x):
    """Write x (numpy, in the ops' frame) into the project's arrays."""
    io, eo, op = deserialize(spec, torch.as_tensor(x, device=ops.device),
                             ops.base_io, ops.base_eo, ops.base_op)
    project.io = io.cpu().numpy()
    project.eo = eo.cpu().numpy()
    project.op = op.cpu().numpy()


def _bundle_impl(project, damping, max_iter, conv_tol, abs_term,
                 singular_test, veto, pm_dof, trace, dtype, backend, fused,
                 polish, device):
    damping = damping.lower()
    if damping not in ("none", "gm", "gna", "lm", "lmp"):
        raise ValueError(f"Unknown damping {damping!r}")
    f32 = dtype == torch.float32

    # Est/prior consistency (bundle.m:137-154).
    for est, use, nm in (
        (project.est_io, project.prior_io_use, "IO"),
        (project.est_eo, project.prior_eo_use, "EO"),
        (project.est_op, project.prior_op_use, "OP"),
    ):
        bad = use & ~est
        if bad.any():
            warnings.warn(
                f"Some {nm} parameters are set to both fixed and observed; "
                f"setting to fixed.")
            use[bad] = False

    spec = build_serial(project)
    if backend == "auto":
        # Dense N is exact and fastest while n_x^2 stays small; the
        # Schur reduced camera system wins beyond that.
        backend = "dense" if spec.n_x <= 2000 else "schur"
    if fused == "auto":
        fused = (f32 and backend == "schur" and damping in ("gna", "lm")
                 and not veto and not trace)
    if backend == "dense":
        ops = BundleOps(project, spec, dtype=dtype, device=device)
    elif backend == "schur":
        ops = SchurOps(project, spec, dtype=dtype, device=device)
    else:
        raise ValueError(f"Unknown backend {backend!r}")
    x0 = ops.x0()

    if bool(torch.isnan(x0).any()):
        # NaN-poisoned initial values (cleareo/clearop) flow through on
        # purpose: the structural-rank check (run before any numerics)
        # identifies the uninitializable parameters.
        warnings.warn("Initial values contain NaN (uninitialized EO/OP?)")

    if abs_term:
        def term_fun(jp, r):
            return r <= conv_tol
    else:
        def term_fun(jp, r):
            return jp <= conv_tol * r

    veto_fun = chirality_veto(ops) if veto else None

    t0 = time.time()
    if fused:
        if damping not in ("gna", "lm"):
            raise ValueError("fused solver supports GNA and LM only")
        if veto:
            raise ValueError(
                "fused solver does not implement the chirality veto; "
                "use fused=False (host loop) with veto=True")
        if not isinstance(ops, SchurOps):
            raise ValueError("fused solver requires the schur backend")
        run = fused_lm if damping == "lm" else fused_gna
        res = run(ops, x0, max_iter=max_iter, conv_tol=conv_tol,
                  abs_term=abs_term)
    elif damping in ("none", "gm"):
        res = solvers.gauss_markov(
            ops, x0, max_iter=max_iter, term_fun=term_fun,
            singular_test=singular_test, do_trace=trace)
    elif damping == "gna":
        res = solvers.gauss_newton_armijo(
            ops, x0, max_iter=max_iter, term_fun=term_fun,
            mu=0.1, alpha_min=1e-9, singular_test=singular_test,
            veto_fun=veto_fun, do_trace=trace)
    elif damping == "lm":
        res = solvers.levenberg_marquardt(
            ops, x0, max_iter=max_iter, term_fun=term_fun,
            lambda0=-1e-10, lambda_min=-1e-10, veto_fun=veto_fun,
            do_trace=trace)
    else:
        res = solvers.levenberg_marquardt_powell(
            ops, x0, max_iter=max_iter, term_fun=term_fun,
            rho_bad=0.25, rho_good=0.75, veto_fun=veto_fun, do_trace=trace)
    elapsed = time.time() - t0

    info = BundleInfo(
        damping=res.damping,
        res_norms=res.res_norms,
        trace=np.stack(res.trace, axis=1) if res.trace else None,
        code=res.code,
        used_iters=res.iters,
        time=elapsed,
        ops=ops,
        spec=spec,
        param_types=param_names(project, spec),
    )

    ok = res.code == solvers.OK
    info.final_x = np.asarray(res.x)

    # f64 polish.  Runs when the f32 solve converged OR stalled at the
    # f32 noise floor (line-search failure / iteration cap near the
    # optimum are the expected f32 endgames); a polish that converges by
    # the same criterion makes the overall run OK.  When the f32 solve
    # certified the ABSOLUTE criterion outright (no floor stall), the
    # requested tolerance is met in a scale-meaningful metric and the
    # polish is skipped by default (polish=N forces it).
    certified_abs = (res.code == solvers.OK and abs_term
                     and not res.damping.get("floor_stall", False))
    if polish is None:
        polish = 2 if f32 and not certified_abs else 0
    can_polish = (
        polish > 0 and f32 and res.x is not None
        and res.code in (solvers.OK, solvers.TOO_MANY_ITERS,
                         solvers.LINESEARCH_FAILED)
    )
    if ok or can_polish:
        saved = project.io, project.eo, project.op
        _set_params(project, spec, ops, res.x)
    # pm_dof extra dof term (used for both the pre-polish and the final
    # sigma0 so the two statistics are comparable).
    extra = 0
    if pm_dof:
        vis_pt = np.zeros(project.n_op, bool)
        vis_pt[project.obs_pt] = True
        vis_img = np.zeros(project.n_img, bool)
        vis_img[project.obs_img] = True
        extra = int((~project.est_op[vis_pt]).sum()) + int(
            (~project.est_eo[vis_img][:, :6]).sum())

    if can_polish:
        rw_pre, _ = _final_eval_f64(project, spec, ops.device)
        dof_pre = ops.n_res + extra - ops.n_x
        if dof_pre > 0:
            info.sigma0_prepolish = float(np.sqrt(rw_pre @ rw_pre / dof_pre))
        cls = BundleOps if spec.n_x <= 2000 else SchurOps
        ops64 = cls(project, spec, dtype=torch.float64, device=ops.device)
        res_p = solvers.gauss_newton_armijo(
            ops64, ops64.x0(), max_iter=polish, term_fun=term_fun,
            mu=0.1, alpha_min=1e-9, singular_test=False)
        accept = res_p.x is not None and (
            res_p.code == solvers.OK
            or (ok and res_p.code == solvers.TOO_MANY_ITERS))
        if accept:
            _set_params(project, spec, ops64, res_p.x)
            info.polish_iters = res_p.iters
            # Diagnostics (covariance) must factorize at the point the
            # report describes: the polished solution, in the same
            # centered frame and serialization as res.x.
            info.final_x = np.asarray(res_p.x)
            if res_p.code == solvers.OK and res.code != solvers.OK:
                # The polish rescued a stalled f32 solve: the run is OK
                # overall; the raw f32 status stays in chip_code.
                info.chip_code = res.code
                info.code = solvers.OK
            ok = ok or res_p.code == solvers.OK
        elif not ok:
            project.io, project.eo, project.op = saved

    x = torch.as_tensor(res.x, device=ops.device)
    # Weakness forensics (bundle.m:370-446).
    info.weakness = {"structural": None, "numerical": None}
    if res.code == solvers.STRUCT_RANK_DEFICIENT:
        unmatched = ops.unmatched_columns()
        info.weakness["structural"] = {
            "rank": ops.n_x - len(unmatched),
            "deficiency": len(unmatched),
            "suspected_params": unmatched,
        }
    if res.code == solvers.SINGULAR:
        info.weakness["numerical"] = numerical_rank_analysis(ops, x)

    # sigma0 (bundle.m:464-491): sqrt(r'Wr/dof).
    rw = res.final_rw
    r_unw64 = None
    if ok and f32:
        # f32 solve: evaluate the final statistic in f64.
        rw, r_unw64 = _final_eval_f64(project, spec, ops.device)
    dof = ops.n_res + extra - ops.n_x if rw is not None else 0
    sigma0 = float(np.sqrt(rw @ rw / dof)) if rw is not None and dof > 0 \
        else np.nan

    info.sigma0 = sigma0
    info.num_obs = ops.n_res if rw is not None else 0
    info.num_params = ops.n_x
    info.redundancy = dof
    info.sigmas = sigma0 * np.asarray(project.ip_sigmas)

    # Posterior residual scatter-back (bundle.m:448-462), in px for IP.
    r_unw = r_unw64 if r_unw64 is not None \
        else ops.residuals(x.to(ops.dtype)).cpu().numpy()
    n2 = 2 * ops.n_obs
    ip_res_mm = r_unw[:n2].reshape(-1, 2)
    px = ops.px_obs.cpu().numpy()
    project.post = {
        "ip_res_px": ip_res_mm / px[:, None],
        "prior_res": r_unw[n2:],
        "sigma0": sigma0,
        "sigmas": info.sigmas,
    }

    return project, ok, res.iters, sigma0, info
