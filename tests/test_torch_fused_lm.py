"""Port parity: fused_lm of dbat_tpu_torch against dbat_tpu's fused_lm,
and the port's host-loop LM against its fused_lm.

* f64: the same code, iterations and lambda schedule; residual norms
  and x within 1e-8 relative (conv_tol 1e-4 keeps the last accepted
  step's decrease far above the f64 rounding level, test_torch_solvers);
* f32 with bench.py's absolute criterion on tests/test_lm_parity.py's
  networks and seeds: the same code and iterations, sigma0 within 1e-4
  (the tolerances of test_torch_fused.py: f32 sums in another order
  move the final residual in its 5th digit);
* the host-vs-fused regimes of tests/test_lm_parity.py, run through the
  port's bundle(): an easy f64 solve, an f32 absolute tolerance, and an
  f32 relative tolerance that f32 cannot certify (both loops must fail
  the same way), compared as that test compares them."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dbat_tpu.core.serial import build_serial as jbuild_serial
from dbat_tpu.pipeline.synthetic import make_ring_network as jmake
from dbat_tpu.pipeline.synthetic import perturb as jperturb
from dbat_tpu.solve.fused import fused_lm as jfused_lm
from dbat_tpu.solve.schur import SchurOps as JSchurOps
from dbat_tpu_torch.core.project import Project, project_from_arrays
from dbat_tpu_torch.core.serial import build_serial
from dbat_tpu_torch.solve import solvers
from dbat_tpu_torch.solve.bundle import bundle
from dbat_tpu_torch.solve.fused import fused_lm
from dbat_tpu_torch.solve.schur import SchurOps

SELFCAL = dict(n_img=12, n_pt=400, rays_per_pt=(3, 9), n_obs_target=2000,
               n_ctrl=4, noise_px=0.1,
               est_io_cols=("cc", "px", "py", "K1", "K2", "K3", "P1", "P2"),
               seed=5)


def _lm_parity_net(seed):
    """tests/test_lm_parity.py's network for `seed`, in the JAX package."""
    s = jmake(n_img=10, n_pt=150, rays_per_pt=(3, 6), n_ctrl=6,
              noise_px=0.1, ip_std_px=0.1, seed=seed)
    jperturb(s, eo_pos=0.01, eo_ang=0.002, op_pos=0.01, seed=seed + 1)
    return s


def _port(j):
    return project_from_arrays({f.name: getattr(j, f.name)
                                for f in dataclasses.fields(Project)})


def _ops(j, jdt, tdt):
    t = _port(j)
    return (JSchurOps(j, jbuild_serial(j), dtype=jdt),
            SchurOps(t, build_serial(t), dtype=tdt, device="cpu"))


def test_fused_lm_matches_jax_f64():
    j = jmake(**SELFCAL)
    jperturb(j, eo_pos=0.02, eo_ang=0.004, op_pos=0.02, seed=6)
    jops, tops = _ops(j, jnp.float64, torch.float64)
    x0 = np.asarray(jops.x0())
    rj = jfused_lm(jops, x0, max_iter=20, conv_tol=1e-4)
    rt = fused_lm(tops, x0, max_iter=20, conv_tol=1e-4)
    assert rt.code == rj.code == solvers.OK
    assert rt.iters == rj.iters
    np.testing.assert_allclose(rt.damping["lambdas"], rj.damping["lambdas"],
                               rtol=1e-12)
    for key in ("lambda0", "lambda_min"):
        assert rt.damping[key] == pytest.approx(rj.damping[key], rel=1e-12)
    assert rt.damping["floor_stall"] == rj.damping["floor_stall"]
    np.testing.assert_allclose(rt.res_norms, rj.res_norms, rtol=1e-8)
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x, xj, rtol=0, atol=1e-8 * np.abs(xj).max())
    assert rt.damping["host_syncs"] >= rt.iters


def test_fused_lm_too_many_iters_matches_jax_f64():
    j = _lm_parity_net(7)
    jops, tops = _ops(j, jnp.float64, torch.float64)
    rng = np.random.default_rng(2)
    x0 = np.asarray(jops.x0()) + 0.02 * rng.standard_normal(jops.n_x)
    rj = jfused_lm(jops, x0, max_iter=3, conv_tol=0.0)
    rt = fused_lm(tops, x0, max_iter=3, conv_tol=0.0)
    assert rt.code == rj.code == solvers.TOO_MANY_ITERS
    assert rt.iters == rj.iters == 4
    np.testing.assert_allclose(rt.res_norms, rj.res_norms, rtol=1e-8)


@pytest.mark.parametrize("seed", [3, 11])
def test_fused_lm_matches_jax_f32_absterm(seed):
    j = _lm_parity_net(seed)
    jops, tops = _ops(j, jnp.float32, torch.float32)
    floor = float(np.sqrt(tops.n_res - tops.n_x))
    x0 = np.asarray(jops.x0())
    rj = jfused_lm(jops, x0, max_iter=40, conv_tol=1.02 * floor,
                   abs_term=True)
    rt = fused_lm(tops, x0, max_iter=40, conv_tol=1.02 * floor,
                  abs_term=True)
    assert rt.code == rj.code == solvers.OK and rt.x.dtype == np.float32
    assert rt.iters == rj.iters
    assert rt.damping["floor_stall"] == rj.damping["floor_stall"]
    nj, nt = (float(np.linalg.norm(r.final_rw)) for r in (rj, rt))
    assert nt == pytest.approx(nj, rel=1e-4)


def _host_and_fused(seed, **kw):
    """bundle() on the port with the host loop and with fused_lm, on
    tests/test_lm_parity.py's network for `seed`."""
    runs = {}
    for fused in (False, True):
        s = _port(_lm_parity_net(seed))
        _p, ok, iters, sigma0, info = bundle(
            s, damping="lm", backend="schur", fused=fused, device="cpu",
            **kw)
        runs[fused] = (ok, iters, info.code, sigma0, info)
    return runs


@pytest.mark.parametrize("seed", [3, 11])
def test_host_vs_fused_lm_absterm_f32(seed):
    s = _lm_parity_net(seed)
    floor = float(np.sqrt(2 * s.n_obs - jbuild_serial(s).n_x))
    runs = _host_and_fused(seed, dtype=torch.float32, abs_term=True,
                           conv_tol=1.02 * floor, max_iter=40)
    assert runs[True][0]
    assert runs[False][:3] == runs[True][:3]
    assert round(runs[False][3], 4) == round(runs[True][3], 4)


def test_host_vs_fused_lm_uncertifiable_reltol_f32():
    runs = _host_and_fused(3, dtype=torch.float32, polish=0)
    assert runs[False][:3] == runs[True][:3]


def test_host_vs_fused_lm_f64():
    runs = _host_and_fused(7, dtype=torch.float64)
    assert runs[False][:3] == runs[True][:3]
    assert runs[True][0]
    assert round(runs[False][3], 10) == round(runs[True][3], 10)


@pytest.mark.parametrize("fail_first", [3, 100])
def test_failed_factorizations_boost_lambda_like_the_host_loop(fail_first):
    """A factorization that fails (the all-NaN factor _solve_impl returns
    after the last f32 jitter rung) boosts lambda without spending an
    iteration, in fused_lm as in the host loop; an 11th failure in a row
    is SINGULAR."""
    results = []
    for run in ("host", "fused"):
        t = _port(_lm_parity_net(7))
        ops = SchurOps(t, build_serial(t), dtype=torch.float64, device="cpu")
        solve, calls = ops._solve_impl, []

        def failing(U, V, Wb, rhs, lam, solve=solve, calls=calls):
            calls.append(lam)
            p, L = solve(U, V, Wb, rhs, lam)
            if len(calls) <= fail_first:
                return torch.full_like(p, np.nan), torch.full_like(L, np.nan)
            return p, L

        ops._solve_impl = failing
        if run == "host":
            r = solvers.levenberg_marquardt(
                ops, ops.x0(), max_iter=20,
                term_fun=lambda jp, rn: jp <= 1e-4 * rn)
            lambdas = r.damping["lambdas"][1:]
        else:
            r = fused_lm(ops, ops.x0(), max_iter=20, conv_tol=1e-4)
            lambdas = r.damping["lambdas"]
        results.append((r.code, r.iters, lambdas, len(calls),
                        r.damping["lambda0"]))
    assert results[0] == results[1]
    code, iters, lambdas, n_calls, lambda0 = results[1]
    if fail_first == 3:
        assert code == solvers.OK and iters > 0
        assert lambdas[0] == pytest.approx(1e3 * lambda0, rel=1e-12)
    else:
        assert (code, iters, n_calls) == (solvers.SINGULAR, 0, 11)
