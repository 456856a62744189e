"""Port parity: the host-loop solvers of dbat_tpu_torch (GNA, GM, LM,
LMP) against dbat_tpu's on the same network, f64, on the dense and the
Schur backend.

Same status code and iteration count, residual norms within 1e-8
relative, x within 1e-8 of its largest entry: the same arithmetic with
sums in another order.  The tolerance conv_tol = 1e-4 puts every
termination test far from the f64 floor: on this network the step
criterion reads ~1e-5 one iteration before it fires and ~1e-1 the one
before, and an LM acceptance there decreases the objective by ~1e-10
relative, not by a rounding-level amount (at conv_tol = 1e-6 LM's last
acceptance decreases it by less than eps and either package may refuse
it)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dbat_tpu.core.serial import build_serial as jbuild_serial
from dbat_tpu.pipeline.synthetic import make_ring_network as jmake
from dbat_tpu.pipeline.synthetic import perturb as jperturb
from dbat_tpu.solve import solvers as jsolvers
from dbat_tpu.solve.ops import BundleOps as JBundleOps
from dbat_tpu.solve.schur import SchurOps as JSchurOps
from dbat_tpu_torch.core.project import Project, project_from_arrays
from dbat_tpu_torch.core.serial import build_serial
from dbat_tpu_torch.solve import solvers
from dbat_tpu_torch.solve.fused import fused_gna
from dbat_tpu_torch.solve.ops import BundleOps
from dbat_tpu_torch.solve.schur import SchurOps

NET = dict(n_img=10, n_pt=150, rays_per_pt=(3, 6), n_ctrl=6, noise_px=0.1,
           ip_std_px=0.1, seed=3)
TOL = 1e-4
NAMES = {"gna": "gauss_newton_armijo", "gm": "gauss_markov",
         "lm": "levenberg_marquardt", "lmp": "levenberg_marquardt_powell"}


def _pair(backend, **kw):
    j = jmake(**{**NET, **kw})
    jperturb(j, eo_pos=0.01, eo_ang=0.002, op_pos=0.01, seed=4)
    t = project_from_arrays({f.name: getattr(j, f.name)
                             for f in dataclasses.fields(Project)})
    jcls, tcls = ((JBundleOps, BundleOps) if backend == "dense"
                  else (JSchurOps, SchurOps))
    return (jcls(j, jbuild_serial(j), dtype=jnp.float64),
            tcls(t, build_serial(t), dtype=torch.float64, device="cpu"))


def _term(jp, r):
    return jp <= TOL * r


def _agree(rj, rt, rtol=1e-8):
    assert rt.code == rj.code
    assert rt.iters == rj.iters
    assert len(rt.res_norms) == len(rj.res_norms)
    np.testing.assert_allclose(rt.res_norms, rj.res_norms, rtol=rtol)
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x, xj, rtol=0,
                               atol=rtol * np.abs(xj).max())


@pytest.mark.parametrize("backend", ["dense", "schur"])
@pytest.mark.parametrize("name", ["gna", "gm", "lm", "lmp"])
def test_host_solver_matches_jax(name, backend):
    jops, tops = _pair(backend)
    x0 = np.asarray(jops.x0())
    rj = getattr(jsolvers, NAMES[name])(jops, x0, max_iter=20,
                                        term_fun=_term)
    rt = getattr(solvers, NAMES[name])(tops, x0, max_iter=20,
                                       term_fun=_term)
    assert rt.code == solvers.OK
    _agree(rj, rt)
    if name == "lm":
        np.testing.assert_allclose(rt.damping["lambdas"],
                                   rj.damping["lambdas"], rtol=1e-12)
    if name == "lmp":
        assert rt.damping["steps"] == rj.damping["steps"]
    if name == "gna":
        assert rt.damping["alphas"] == rj.damping["alphas"]


def test_host_solvers_too_many_iters_match_jax():
    """An unreachable tolerance: every solver runs out of iterations
    (LMP keeps shrinking its trust region) the same way."""
    jops, tops = _pair("schur")
    x0 = np.asarray(jops.x0())
    for name in ("gna", "gm", "lm", "lmp"):
        rj = getattr(jsolvers, NAMES[name])(
            jops, x0, max_iter=2, term_fun=lambda jp, r: False)
        rt = getattr(solvers, NAMES[name])(
            tops, x0, max_iter=2, term_fun=lambda jp, r: False)
        assert rt.code == solvers.TOO_MANY_ITERS, name
        _agree(rj, rt)


def test_host_gna_matches_fused_gna():
    _jops, tops = _pair("schur")
    x0 = tops.x0()
    rh = solvers.gauss_newton_armijo(tops, x0, max_iter=20, term_fun=_term)
    rf = fused_gna(tops, x0, max_iter=20, conv_tol=TOL)
    assert rh.code == rf.code == solvers.OK
    assert rh.iters == rf.iters
    assert rh.damping["alphas"] == rf.damping["alphas"]
    np.testing.assert_allclose(rf.res_norms, rh.res_norms, rtol=1e-10)
    np.testing.assert_allclose(rf.x, rh.x, rtol=0,
                               atol=1e-10 * np.abs(rh.x).max())


@pytest.mark.parametrize("lam", [0.0, 0.3])
def test_dense_and_schur_steps_agree(lam):
    """The two backends solve the same normal equations."""
    _, dense = _pair("dense")
    _, schur = _pair("schur")
    x = dense.x0()
    sd, ss = dense.normal(x), schur.normal(x)
    np.testing.assert_allclose(ss.g.numpy(), sd.g.numpy(), rtol=0,
                               atol=1e-12 * sd.g.abs().max().item())
    pd, fd = sd.solve(-sd.g, lam)
    ps, fs = ss.solve(-ss.g, lam)
    assert not fd and not fs
    np.testing.assert_allclose(ps.numpy(), pd.numpy(), rtol=0,
                               atol=1e-9 * pd.abs().max().item())
    assert ss.trace_diag() == pytest.approx(sd.trace_diag(), rel=1e-12)
    np.testing.assert_allclose(ss.diag().numpy(), sd.diag().numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(ss.matvec(pd).numpy(), sd.matvec(pd).numpy(),
                               rtol=0,
                               atol=1e-10 * sd.matvec(pd).abs().max().item())


# -- the scripted robustness cases of tests/test_solver_robustness.py ------

class _ScriptedState:
    """Normal-equation state whose solve fails for scripted lambdas."""

    def __init__(self, ops, x):
        self.ops = ops
        self.rw = ops.A @ x - ops.b
        self.g = ops.A.T @ self.rw

    def solve(self, rhs, lam=0.0):
        self.ops.lambdas_seen.append(float(lam))
        fail = (len(self.ops.lambdas_seen) <= self.ops.fail_first_n
                or float(lam) < self.ops.fail_below)
        if fail:
            self.ops.n_failed += 1
            return torch.full_like(rhs, float("nan")), True
        N = self.ops.A.T @ self.ops.A + lam * torch.eye(
            self.ops.n_x, dtype=torch.float64)
        return torch.linalg.solve(N, rhs), False

    def matvec(self, p):
        return self.ops.A.T @ (self.ops.A @ p)

    def trace_diag(self):
        return float(torch.trace(self.ops.A.T @ self.ops.A))


class _ScriptedOps:
    """Tiny linear least-squares problem whose factorizations fail below
    `fail_below` or for the first `fail_first_n` solves, mimicking an
    f32 Cholesky breakdown until lambda lifts the spectrum."""

    device = torch.device("cpu")
    dtype = torch.float64

    def __init__(self, fail_below=0.0, fail_first_n=0, n=6, seed=0):
        rng = np.random.default_rng(seed)
        self.n_x = n
        self.A = torch.as_tensor(rng.standard_normal((2 * n, n)))
        self.b = torch.as_tensor(rng.standard_normal(2 * n))
        self.fail_below = fail_below
        self.fail_first_n = fail_first_n
        self.lambdas_seen = []
        self.n_failed = 0

    def normal(self, x):
        return _ScriptedState(self, x)

    def weighted_residual(self, x):
        return self.A @ x - self.b

    def structural_rank(self):
        return self.n_x


def test_lm_boosts_lambda_past_failed_factorizations():
    ops = _ScriptedOps(fail_first_n=3)
    res = solvers.levenberg_marquardt(
        ops, np.zeros(ops.n_x), max_iter=40,
        term_fun=lambda jp, rn: jp <= 1e-8 * max(rn, 1e-30))
    # As in the JAX package's test: on an exactly linear toy the accept
    # test ft < f can livelock at the optimum, so TOO_MANY_ITERS is
    # allowed; the retries are the point.
    assert res.code in (solvers.OK, solvers.TOO_MANY_ITERS)
    assert ops.n_failed == 3
    assert len(ops.lambdas_seen) > 3
    x_ref, *_ = np.linalg.lstsq(ops.A.numpy(), ops.b.numpy(), rcond=None)
    np.testing.assert_allclose(res.x, x_ref, atol=1e-6)


def test_lm_reports_singular_when_boosting_cannot_help():
    ops = _ScriptedOps(fail_below=np.inf)
    res = solvers.levenberg_marquardt(
        ops, np.zeros(ops.n_x), max_iter=40, term_fun=lambda jp, rn: False)
    assert res.code == solvers.SINGULAR
    assert ops.n_failed == 11  # 10 boosts + the final attempt
