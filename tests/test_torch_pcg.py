"""Port parity: the matrix-free PCG solve of the reduced camera system
(dbat_tpu_torch/solve/pcg.py) on the CPU, f64.

Mirrors tests/test_pcg.py: the matvec against the explicit S (1e-9),
PCG against the direct solve, undamped and damped (1e-6 relative, 1e-8
of the largest entry).  Adds the JAX package's pcg_solve on the same
system: over a fixed budget of 25 iterations the same iterates (1e-9 of
the largest entry); run to convergence, where CG's rounding drift moves
the stopping iteration by a few, the two solutions as close as to the
direct solve.  And the solve with every sum in the card's fixed order.
The mesh case of tests/test_pcg.py: a PCG Gauss-Newton step on the
legacy mesh SchurOps (8 CPU shards, pair_chunk 256) against the direct
solve on one device and against the JAX package's jitted step on its 8
virtual devices (1e-5 relative, 1e-6 of the largest entry)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dbat_tpu.core.serial import build_serial as jbuild_serial
from dbat_tpu.pipeline.synthetic import make_ring_network as jmake
from dbat_tpu.pipeline.synthetic import perturb as jperturb
from dbat_tpu.solve.pcg import pcg_solve as jpcg_solve
from dbat_tpu.solve.schur import SchurOps as JSchurOps
from dbat_tpu.solve.smallblas import inv3x3 as jinv3x3
from dbat_tpu_torch.core.project import Project, project_from_arrays
from dbat_tpu_torch.core.serial import build_serial
from dbat_tpu_torch.solve.pcg import pcg_solve, schur_matvec
from dbat_tpu_torch.solve.schur import SchurOps
from dbat_tpu_torch.solve.segsum import SegScatter, SegSum
from dbat_tpu_torch.solve.smallblas import inv3x3
from port_shared import one_thread  # noqa: F401


def _net(selfcal=False, fixed_eo=False):
    """The JAX test's network (and the same network in the port)."""
    s = jmake(n_img=12, n_pt=90, rays_per_pt=4, n_ctrl=8, noise_px=0.1,
              seed=11)
    if selfcal:
        s.est_io[:, :3] = True
    if fixed_eo:
        s.est_eo[0, 3:] = False
    jperturb(s, eo_pos=0.02, eo_ang=0.004, op_pos=0.02, seed=12)
    return s, project_from_arrays({f.name: getattr(s, f.name)
                                   for f in dataclasses.fields(Project)})


def _ops(selfcal=False, fixed_eo=False):
    _j, t = _net(selfcal, fixed_eo)
    ops = SchurOps(t, build_serial(t), dtype=torch.float64, device="cpu")
    U, V, Wb, gc, gp, _rw = ops._assemble_impl(ops.x0())
    return ops, U, V, Wb, ops.join_x(gc, gp)


@pytest.fixture(scope="module")
def jax_systems():
    """{selfcal: (JAX ops, their assembly at x0, port ops, theirs)},
    built once: the JAX assembly is jitted (the JAX test's call)."""
    out = {}
    for selfcal in (False, True):
        j, t = _net(selfcal)
        jops = JSchurOps(j, jbuild_serial(j), dtype=jnp.float64)
        ops = SchurOps(t, build_serial(t), dtype=torch.float64, device="cpu")
        x0 = np.asarray(jops.x0())
        out[selfcal] = (jops, jops._assemble(jnp.asarray(x0)), ops,
                        ops._assemble_impl(torch.tensor(x0)))
    return out


@pytest.mark.parametrize("selfcal", [False, True])
def test_matvec_matches_explicit_S(selfcal):
    ops, U, V, Wb, _g = _ops(selfcal)
    Vinv = inv3x3(V)
    S = ops._schur_S(U, Vinv, Wb, 0.0)
    p = torch.as_tensor(np.random.default_rng(0).standard_normal(ops.n_c))
    got = schur_matvec(ops, U, Vinv, Wb, p, 0.0)
    np.testing.assert_allclose(got.numpy(), (S @ p).numpy(), rtol=1e-9,
                               atol=1e-9)


@pytest.mark.parametrize("selfcal,fixed_eo,lam", [
    (False, False, 0.0), (True, False, 0.0), (False, False, 3.7),
    (True, True, 0.0)])
def test_pcg_matches_direct_solve(selfcal, fixed_eo, lam):
    ops, U, V, Wb, g = _ops(selfcal, fixed_eo)
    p_direct, _L = ops._solve_impl(U, V, Wb, -g, lam)
    p_pcg, (iters, rel) = ops._solve_pcg_impl(U, V, Wb, -g, lam,
                                              tol=1e-12, maxiter=2000)
    if lam == 0.0:
        assert rel < 1e-10
    assert 0 < iters < 2000
    scale = np.abs(p_direct.numpy()).max()
    np.testing.assert_allclose(p_pcg.numpy(), p_direct.numpy(), rtol=1e-6,
                               atol=1e-8 * scale)


@pytest.mark.parametrize("selfcal,lam", [(False, 0.0), (True, 0.0),
                                         (True, 3.7)])
def test_pcg_solve_matches_jax(jax_systems, selfcal, lam):
    jops, (jU, jV, jWb, jgc, _jgp, _), ops, (U, V, Wb, gc, _gp, _) = \
        jax_systems[selfcal]
    jargs = (jops, jU, jinv3x3(jV), jWb, -jgc, jnp.asarray(lam))
    args = (ops, U, inv3x3(V), Wb, -gc, lam)
    # A fixed budget of 25 iterations: the same iterates.
    jx, jk, jrel = jpcg_solve(*jargs, tol=0.0, maxiter=25)
    x, k, rel = pcg_solve(*args, tol=0.0, maxiter=25)
    assert k == int(jk) == 25
    assert rel == pytest.approx(float(jrel), rel=1e-9)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0,
                               atol=1e-9 * np.abs(np.asarray(jx)).max())
    # To convergence: on the self-calibrating system CG's rounding
    # drift moves the stopping iteration (72 against 74 undamped), so
    # the solutions are held to each other as to the direct solve.
    jx, jk, jrel = jpcg_solve(*jargs, tol=1e-10, maxiter=500)
    x, k, rel = pcg_solve(*args, tol=1e-10, maxiter=500)
    assert rel < 1e-10 and float(jrel) < 1e-10
    assert abs(k - int(jk)) <= max(2, int(jk) // 20)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-6,
                               atol=1e-8 * np.abs(np.asarray(jx)).max())


def test_pcg_in_the_cards_order_matches_direct(monkeypatch):
    """Every segment sum and camera scatter in the CUDA order (no
    atomics), run on the CPU."""
    monkeypatch.setattr(SegSum, "__call__", SegSum.ordered)
    monkeypatch.setattr(SegScatter, "add_into", SegScatter.add_ordered)
    ops, U, V, Wb, g = _ops(True, True)
    p_direct, _L = ops._solve_impl(U, V, Wb, -g, 0.0)
    p_pcg, (_iters, rel) = ops._solve_pcg_impl(U, V, Wb, -g, 0.0,
                                               tol=1e-12, maxiter=2000)
    assert rel < 1e-10
    scale = np.abs(p_direct.numpy()).max()
    np.testing.assert_allclose(p_pcg.numpy(), p_direct.numpy(), rtol=1e-6,
                               atol=1e-8 * scale)


@pytest.mark.parametrize("ref", ["direct_unsharded", "jax_mesh"])
def test_pcg_on_device_mesh(ref):
    """A full PCG GN step over the 8-shard obs mesh."""
    import jax

    from dbat_tpu.parallel.mesh import make_mesh as jmake_mesh
    from dbat_tpu_torch.parallel.mesh import make_mesh

    j = jmake(n_img=8, n_pt=64, rays_per_pt=4, n_ctrl=8, noise_px=0.1,
              seed=7)
    jperturb(j, eo_pos=0.01, eo_ang=0.002, op_pos=0.01, seed=8)
    t = project_from_arrays({f.name: getattr(j, f.name)
                             for f in dataclasses.fields(Project)})
    spec = build_serial(t)
    ops = SchurOps(t, spec, device="cpu", mesh=make_mesh(["cpu"] * 8),
                   pair_chunk=256)
    x0 = ops.x0()
    U, V, Wb, gc, gp, _rw = ops._assemble_impl(x0)
    p, (iters, rel) = ops._solve_pcg_impl(U, V, Wb, -ops.join_x(gc, gp), 0.0)
    assert 0 < iters < 500 and rel <= 1e-10
    if ref == "jax_mesh":
        jops = JSchurOps(j, jbuild_serial(j), dtype=jnp.float64,
                         mesh=jmake_mesh(jax.devices()[:8]), pair_chunk=256)

        @jax.jit
        def gn_step_pcg(x):
            U, V, Wb, gc, gp, _rw = jops._assemble_impl(x)
            g = jops.join_x(gc, gp)
            return jops._solve_pcg_impl(U, V, Wb, -g,
                                        jnp.asarray(0.0, jops.dtype))[0]

        p_ref = np.asarray(gn_step_pcg(jnp.asarray(x0.numpy())))
    else:
        ops_ref = SchurOps(t, spec, device="cpu")
        U, V, Wb, gc, gp, _rw = ops_ref._assemble_impl(x0)
        p_ref = ops_ref._solve_impl(U, V, Wb, -ops_ref.join_x(gc, gp),
                                    0.0)[0].numpy()
    scale = np.max(np.abs(p_ref))
    np.testing.assert_allclose(p.numpy(), p_ref, rtol=1e-5,
                               atol=1e-6 * scale)
