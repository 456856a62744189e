"""Port parity: the Schur reduced-camera system of dbat_tpu_torch against
dbat_tpu's SchurOps on a small irregular self-calibration ring network
(and one with camera and point priors), f64 on both sides.

Assembly outputs, the reduced matrix S, the solve step and the matvec
agree at rtol 1e-9 of each quantity's largest entry: the same
arithmetic with sums in another order.  The solve amplifies that by
the condition of the scaled S: 2e6 on the plain network, 1.1e8 with the
soft point priors (eps * cond = 2.5e-8), where the step is held to
1e-7."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dbat_tpu.core.serial import build_serial as jbuild_serial
from dbat_tpu.pipeline.synthetic import make_ring_network as jmake
from dbat_tpu.pipeline.synthetic import perturb as jperturb
from dbat_tpu.solve.schur import SchurOps as JSchurOps
from dbat_tpu.solve.schur import _build_pairs as jbuild_pairs
from dbat_tpu.solve.smallblas import inv3x3 as jinv3x3
from dbat_tpu_torch.core.project import Project, project_from_arrays
from dbat_tpu_torch.core.serial import build_serial
from dbat_tpu_torch.pipeline.synthetic import make_ring_network, perturb
from dbat_tpu_torch.solve.schur import SchurOps, _build_pairs
from dbat_tpu_torch.solve.smallblas import inv3x3

NET = dict(n_img=12, n_pt=400, rays_per_pt=(3, 9), n_obs_target=2200,
           n_ctrl=4, noise_px=0.1,
           est_io_cols=("cc", "px", "py", "K1", "K2", "K3", "P1", "P2"),
           seed=5)


def _with_priors(s):
    """Prior observations on some camera positions and on the control
    points (made estimable), so every prior scatter path runs."""
    s.prior_eo_use[:3, :3] = True
    s.prior_eo_std[:3, :3] = 0.05
    s.est_op[: 4] = True
    s.prior_op_use[: 4] = True
    s.prior_op_std[: 4] = 0.01
    return s


def _pair(priors):
    """The same network in both packages: built by the JAX package and
    carried into the port field by field."""
    j = jmake(**NET)
    jperturb(j, seed=6)
    if priors:
        _with_priors(j)
    t = project_from_arrays({f.name: getattr(j, f.name)
                             for f in dataclasses.fields(Project)})
    jops = JSchurOps(j, jbuild_serial(j), dtype=jnp.float64)
    tops = SchurOps(t, build_serial(t), dtype=torch.float64, device="cpu")
    return jops, tops


def _close(port, ref, rtol=1e-9):
    ref = np.asarray(ref)
    port = port.numpy() if torch.is_tensor(port) else np.asarray(port)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


def test_build_pairs_matches_jax():
    rng = np.random.default_rng(1)
    obs_pt = rng.integers(0, 40, 300).astype(np.int32)
    for a, b in zip(_build_pairs(obs_pt), jbuild_pairs(obs_pt)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("priors", [False, True])
def test_assembly_S_and_step_match_jax(priors):
    jops, tops = _pair(priors)
    assert (tops.n_c, tops.n_cb, tops.n_campair) == (
        jops.n_c, jops.n_cb, jops.n_campair)
    x0 = np.asarray(jops.x0())
    jout = jops._assemble_impl(jnp.asarray(x0))
    tout = tops._assemble_impl(torch.as_tensor(x0))
    for name, t, j in zip(("U", "V", "Wb", "gc", "gp", "rw"), tout, jout):
        _close(t, j)

    U, V, Wb, gc, gp, _rw = tout
    jU, jV, jWb, jgc, jgp, _ = jout
    Vinv = inv3x3(V)
    S = tops._schur_S(U, Vinv, Wb, 0.0)
    jS = jops._schur_S(jU, jinv3x3(jV), jWb, 0.0)
    _close(S, jS)
    np.testing.assert_allclose(S.numpy(), S.numpy().T, rtol=0,
                               atol=1e-12 * np.abs(S.numpy()).max())

    g = tops.join_x(gc, gp)
    jg = jops.join_x(jgc, jgp)
    p, L = tops._solve_impl(U, V, Wb, -g, 0.0)
    jp, _ = jops._solve_impl(jU, jV, jWb, -jg, jnp.asarray(0.0))
    assert not torch.isnan(L).any()
    _close(p, jp, 1e-7 if priors else 1e-9)
    _close(tops._matvec_impl(U, V, Wb, p),
           jops._matvec_impl(jU, jV, jWb, jnp.asarray(p.numpy())))
    # The step solves the normal equations: N p = -g.
    _close(tops._matvec_impl(U, V, Wb, p), -g, rtol=1e-7)


def test_split_join_and_residuals_match_jax():
    jops, tops = _pair(False)
    rng = np.random.default_rng(2)
    x = rng.normal(size=tops.n_x)
    vc, P = tops.split_x(torch.as_tensor(x))
    jvc, jP = jops.split_x(jnp.asarray(x))
    _close(vc, jvc, 0)
    _close(P, jP, 0)
    np.testing.assert_array_equal(tops.join_x(vc, P).numpy(), x)
    x0 = np.asarray(jops.x0())
    _close(tops.weighted_residual(torch.as_tensor(x0)),
           jops.weighted_residual(jnp.asarray(x0)), 1e-12)
    _close(tops.residuals(torch.as_tensor(x0)),
           jops.residuals(jnp.asarray(x0)), 1e-12)
    assert tops.structural_rank() == jops.structural_rank() == tops.n_x


def test_f32_solve_step_as_close_to_f64_as_jax_f32():
    """The f32 path (trace floor on V, jitter ladder, refinement) keeps
    the JAX package's own f32 accuracy: its step is no farther from the
    f64 step than twice the JAX f32 step's distance (1.9% of the
    largest entry on this network: f32 S loses digits to
    cancellation, and the outer iteration corrects the rest)."""
    t = make_ring_network(**NET)
    perturb(t, seed=6)
    j = jmake(**NET)
    jperturb(j, seed=6)
    spec = build_serial(t)
    steps = {}
    for name, dt in (("f64", torch.float64), ("f32", torch.float32)):
        o = SchurOps(t, spec, dtype=dt, device="cpu")
        U, V, Wb, gc, gp, _ = o._assemble_impl(o.x0())
        p, L = o._solve_impl(U, V, Wb, -o.join_x(gc, gp), 0.0)
        assert p.dtype == dt and not torch.isnan(L).any()
        steps[name] = p.double().numpy()
    jo = JSchurOps(j, jbuild_serial(j), dtype=jnp.float32)
    jU, jV, jWb, jgc, jgp, _ = jo._assemble_impl(jo.x0())
    jp32 = np.asarray(jo._solve_impl(jU, jV, jWb, -jo.join_x(jgc, jgp),
                                     jnp.asarray(0.0, jnp.float32))[0],
                      np.float64)
    scale = np.abs(steps["f64"]).max()
    err_port = np.abs(steps["f32"] - steps["f64"]).max() / scale
    err_jax = np.abs(jp32 - steps["f64"]).max() / scale
    assert err_port <= 2 * err_jax, (err_port, err_jax)

