"""Port parity on the networks where the JAX package's SchurOps takes
its two one-device plans, f64 on the CPU.  The port takes its general
path on every network (kernel B's pair plan and the camera SegScatters);
it must give the JAX package's numbers all the same.

  * the packed per-point S fill-in (`_packed_R`): uniform ray count R,
    2 <= R <= 12; and the broadcast `_gather_pt` (`_obs_uniform_R`), for
    any uniform R;
  * the windowed scatter (`_img_block6`): fixed IO with every EO
    estimated, U and S built as (6, 6) windows.

Networks: make_ring_network at R in {2, 6, 12}, each self-calibrated
(nb 14) and with fixed IO (nb 6); a uniform network with R = 14 (only
the broadcast applies); an irregular fixed-IO network (only the windows
apply).  The JAX package selects the plans expected of each.
_assemble_impl's six outputs, _schur_S and the matvec lie within 1e-12
of the largest entry of the JAX package's (the bound of
test_torch_bundle.py's test_fixed_io_network_matches_jax_block6: both
packages sum in other orders); the step within 1e-12 where the scaled
camera system is well conditioned, else within kappa * 1e-15, at most
1e-9.

Also: the mesh paths on such a network equal the one-device ops (1e-12);
PCG matches the direct solve; an f32 fused_gna reaches the noise floor
on a uniform network; the posterior covariance (cio, ceo, cop) matches
the JAX package's on both plans (1e-9, as test_torch_covariance.py); an
f32 bundle() whose f64 polish the JAX package runs on both plans ends as
the JAX package's does."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dbat_tpu.core.serial import build_serial as jbuild_serial
from dbat_tpu.pipeline.synthetic import make_ring_network as jmake
from dbat_tpu.pipeline.synthetic import perturb as jperturb
from dbat_tpu.solve.bundle import bundle as jbundle
from dbat_tpu.solve.covariance import Covariance as JCovariance
from dbat_tpu.solve.schur import SchurOps as JSchurOps
from dbat_tpu.solve.smallblas import inv3x3 as jinv3x3
from dbat_tpu_torch.core.serial import build_serial
from dbat_tpu_torch.parallel.mesh import make_mesh
from dbat_tpu_torch.parallel.sharded import ShardedSchurOps
from dbat_tpu_torch.solve.bundle import BundleInfo, bundle
from dbat_tpu_torch.solve.covariance import Covariance
from dbat_tpu_torch.solve.fused import fused_gna
from dbat_tpu_torch.solve.schur import SchurOps
from dbat_tpu_torch.solve.smallblas import inv3x3
from port_shared import one_thread, port_project  # noqa: F401

SELFCAL_IO = ("cc", "px", "py", "K1", "K2", "K3", "P1", "P2")
BASE = dict(n_img=16, n_pt=120, n_ctrl=20, noise_px=0.1, ip_std_px=0.1,
            seed=3)
#: name -> (make_ring_network arguments, the JAX package's expected
#: (_obs_uniform_R, _packed_R, _img_block6))
NETS = {
    **{f"R{R}-selfcal": (dict(BASE, rays_per_pt=R, est_io_cols=SELFCAL_IO),
                         (R, R, False)) for R in (2, 6, 12)},
    **{f"R{R}-fixed-io": (dict(BASE, rays_per_pt=R), (R, R, True))
       for R in (2, 6, 12)},
    "R14-selfcal": (dict(BASE, rays_per_pt=14, est_io_cols=SELFCAL_IO),
                    (14, None, False)),
    "irregular-fixed-io": (dict(BASE, rays_per_pt=(3, 6),
                                n_obs_target=500), (None, None, True)),
}
REL = 1e-12


def _jnet(kw):
    j = jmake(**kw)
    jperturb(j, eo_pos=0.01, eo_ang=0.002, op_pos=0.01, seed=4)
    return j


def _close(a, b, rtol=REL):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=0,
                               atol=rtol * np.abs(b).max())


@pytest.fixture(scope="module", params=list(NETS))
def pair(request):
    """(name, JAX SchurOps, port SchurOps, JAX outputs) on one network;
    the outputs: the six of _assemble_impl at x0, S, the step, the
    matvec of a random vector, and that vector."""
    kw, _expect = NETS[request.param]
    j = _jnet(kw)
    t = port_project(j)
    jops = JSchurOps(j, jbuild_serial(j), dtype=jnp.float64)
    tops = SchurOps(t, build_serial(t), dtype=torch.float64, device="cpu")
    x0 = jnp.asarray(jops.x0())
    U, V, Wb, gc, gp, rw = jops._assemble_impl(x0)
    S = jops._schur_S(U, jinv3x3(V), Wb, 0.0)
    p, _L = jops._solve_impl(U, V, Wb, -jops.join_x(gc, gp),
                             jnp.asarray(0.0))
    v = np.random.default_rng(11).normal(size=jops.n_x)
    mv = jops._matvec_impl(U, V, Wb, jnp.asarray(v))
    jout = dict(assembly=(U, V, Wb, gc, gp, rw), S=S, p=p, mv=mv, v=v,
                x0=np.asarray(x0))
    return request.param, jops, tops, jout


def _general(ops):
    """True when the port's ops took the general path: kernel B's pair
    plan and the camera SegScatters."""
    return (ops._pair_plan is not None) == bool(ops.n_pairs) and all(
        hasattr(ops, nm) for nm in ("_cam_scatter", "_u_scatter",
                                    "_s_scatter"))


def test_jax_takes_its_plans_and_the_port_the_general_path(pair):
    name, jops, tops, _ = pair
    assert (jops._obs_uniform_R, jops._packed_R,
            bool(jops._img_block6)) == NETS[name][1]
    # The JAX packed plan builds no kernel B plan.
    assert (jops._pair_plan is None) and (jops.pair_i1f is None) == (
        jops._packed_R is not None)
    assert _general(tops)


def _port_assembly(tops, jout):
    return tops._assemble_impl(torch.as_tensor(jout["x0"]))


def test_assembly_matches_jax(pair):
    _name, _jops, tops, jout = pair
    for a, b in zip(_port_assembly(tops, jout), jout["assembly"]):
        _close(a, b)


def test_schur_s_matches_jax(pair):
    _name, _jops, tops, jout = pair
    U, V, Wb, _gc, _gp, _rw = _port_assembly(tops, jout)
    _close(tops._schur_S(U, inv3x3(V), Wb, 0.0), jout["S"])


def test_step_matches_jax(pair):
    """The step within 1e-12 where the Jacobi-scaled camera system's
    condition kappa is at most 1e4 (the fixed-IO networks of R >= 6 and
    the irregular one, as the network of test_fixed_io_network_matches_
    jax_block6); above it within kappa * 1e-15, at most 1e-9: the step
    carries S's rounding times kappa, and the JAX package's own step
    moves by up to 1.6e-10 between its plans on the self-calibrated
    networks here (the same network with its observations permuted,
    which turns both plans off).  kappa is printed (pytest -s)."""
    _name, _jops, tops, jout = pair
    U, V, Wb, gc, gp, _rw = _port_assembly(tops, jout)
    p, L = tops._solve_impl(U, V, Wb, -tops.join_x(gc, gp), 0.0)
    assert not torch.isnan(L).any()
    S = np.asarray(jout["S"])
    d = np.sqrt(np.diag(S))
    kappa = np.linalg.cond(S / np.outer(d, d))
    rtol = REL if kappa <= 1e4 else min(kappa * 1e-15, 1e-9)
    print(f"{_name}: kappa {kappa:.3e}, step bound {rtol:.1e}")
    _close(p, jout["p"], rtol=rtol)


def test_matvec_matches_jax(pair):
    _name, _jops, tops, jout = pair
    U, V, Wb, _gc, _gp, _rw = _port_assembly(tops, jout)
    _close(tops._matvec_impl(U, V, Wb, torch.as_tensor(jout["v"])),
           jout["mv"])


def _port_net(name):
    return port_project(_jnet(NETS[name][0]))


@pytest.mark.parametrize("kind", ["legacy", "sharded"])
def test_mesh_paths_keep_the_general_plans(kind):
    """On a network where the JAX package takes both plans on one
    device, the mesh paths (where it takes neither) give the one-device
    ops' g, step and matvec (1e-12)."""
    t = _port_net("R6-fixed-io")
    spec = build_serial(t)
    mesh = make_mesh(["cpu"] * 2)
    one = SchurOps(t, spec, dtype=torch.float64, device="cpu")
    assert _general(one)
    if kind == "legacy":
        ops = SchurOps(t, spec, dtype=torch.float64, device="cpu",
                       mesh=mesh, pair_chunk=512)
    else:
        ops = ShardedSchurOps(t, spec, mesh=mesh, dtype=torch.float64)
    x0 = one.x0()
    outs = []
    for o in (one, ops):
        st = o.normal(x0)
        p, failed = st.solve(-st.g)
        assert not failed
        outs.append((st.g, p, st.matvec(p)))
    for a, b in zip(outs[1], outs[0]):
        _close(a.cpu(), b)


@pytest.mark.parametrize("name", ["R6-selfcal", "R12-fixed-io"])
def test_pcg_on_the_plans_matches_the_direct_solve(name):
    """PCG on networks of the JAX package's plans gives the direct step."""
    t = _port_net(name)
    ops = SchurOps(t, build_serial(t), dtype=torch.float64, device="cpu")
    U, V, Wb, gc, gp, _rw = ops._assemble_impl(ops.x0())
    g = ops.join_x(gc, gp)
    p, _L = ops._solve_impl(U, V, Wb, -g, 0.0)
    q, (_it, rel) = ops._solve_pcg_impl(U, V, Wb, -g, 0.0, tol=1e-12,
                                        maxiter=2000)
    assert rel < 1e-10
    _close(q, p, rtol=1e-6)


def test_f32_fused_gna_reaches_the_floor_on_a_uniform_network():
    """f32 on a network of the packed plan (R = 6, self-calibrated; the
    port's general path): fused_gna from the perturbed start ends at the
    noise floor, the f64 minimum of the same network (||r_w|| of the f32
    x, evaluated in f64, within 1e-5 relative; this network's noise puts
    that minimum 0.4% above sqrt(dof)), with sigma0 < 1.05 (bench.py's
    gate)."""
    kw = dict(BASE, n_pt=300, rays_per_pt=6, est_io_cols=SELFCAL_IO)
    t = port_project(_jnet(kw))
    spec = build_serial(t)
    rn, rn64 = {}, {}
    ops64 = None
    for dtype in (torch.float64, torch.float32):
        ops = SchurOps(t, spec, dtype=dtype, device="cpu")
        ops64 = ops64 or ops
        assert _general(ops)
        floor = float(np.sqrt(ops.n_res - ops.n_x))
        res = fused_gna(ops, ops.x0(), max_iter=20,
                        **({} if dtype == torch.float64 else
                           dict(conv_tol=floor, abs_term=True)))
        assert res.code == 0 and np.all(np.isfinite(res.x))
        rn[dtype] = float(np.sqrt(res.final_rw @ res.final_rw))
        rn64[dtype] = float(torch.linalg.norm(ops64.weighted_residual(
            torch.as_tensor(np.asarray(res.x, np.float64)))))
    assert rn64[torch.float32] == pytest.approx(rn[torch.float64], rel=1e-5)
    assert rn[torch.float32] / floor < 1.05


@pytest.fixture(scope="module")
def both_plans_solved():
    """The R = 6 fixed-IO network (packed plan and windows) solved by the
    JAX package's f64 bundle() on the Schur backend."""
    j = _jnet(NETS["R6-fixed-io"][0])
    t = port_project(j)
    pj, ok, _it, _s0, ij = jbundle(j, backend="schur")
    assert ok
    return t, pj, ij


@pytest.mark.parametrize("name", ["cio", "ceo", "cop"])
def test_covariance_on_the_plans_matches_jax(both_plans_solved, name):
    t, pj, ij = both_plans_solved
    spec = build_serial(t)
    ops = SchurOps(t, spec, dtype=torch.float64, device="cpu")
    assert _general(ops)
    cov = Covariance(t, BundleInfo(ops=ops, spec=spec, sigma0=ij.sigma0,
                                   final_x=np.asarray(ij.final_x)))
    ref = np.asarray(getattr(JCovariance(pj, ij), name)())
    got = getattr(cov, name)()
    np.testing.assert_allclose(got, ref, rtol=1e-9,
                               atol=1e-12 * np.abs(ref).max())


def test_f64_polish_on_the_plans_ends_as_jax():
    """An f32 bundle() asked for a relative criterion: the f64 polish
    rebuilds the ops in f64 (the JAX package's on both plans, the port's
    on its general path) and decides the outcome, as in the JAX
    package."""
    kw = dict(BASE, n_pt=300, rays_per_pt=6)
    j = _jnet(kw)
    t = port_project(j)
    out_j = jbundle(j, damping="gna", dtype=jnp.float32, backend="schur")
    out_t = bundle(t, damping="gna", dtype=torch.float32, backend="schur",
                   device="cpu")
    ij, it = out_j[4], out_t[4]
    assert _general(it.ops)
    assert (out_t[1], out_t[2], it.code) == (out_j[1], out_j[2], ij.code)
    assert it.polish_iters == ij.polish_iters
    if ij.sigma0_prepolish is not None:
        assert it.sigma0_prepolish == pytest.approx(ij.sigma0_prepolish,
                                                    rel=1e-4)
    assert out_t[3] == pytest.approx(out_j[3], rel=1e-8)
