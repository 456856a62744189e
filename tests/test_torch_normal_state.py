"""Port parity: the normal-equation states of dbat_tpu_torch against
dbat_tpu's, f64, and the card's fixed-order sums run on the CPU.

* the dense `_normal` (N, g, rw) and DenseNormalState, on a network
  with self-calibrated shared IO and with prior observations;
* SchurNormalState's diag, trace_diag, matvec and solve(lam);
* SegSum.ordered / SegScatter.ordered (the order used for CUDA tensors,
  with no atomics) against a plain numpy scatter, and the whole Schur
  assembly and S build run through that order against the JAX package.

Every quantity is held at 1e-12 of its largest entry (sums in another
order); a solve with lam > 0 too: the damping bounds the scaled
system's condition.  An undamped solve amplifies the assembly's
rounding by the condition of the scaled system (~2e6 here,
test_torch_schur.py) and is held at 1e-9, the Schur one with the soft
point priors (condition ~1e8) at 1e-7."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dbat_tpu.core.serial import build_serial as jbuild_serial
from dbat_tpu.pipeline.synthetic import make_ring_network as jmake
from dbat_tpu.pipeline.synthetic import perturb as jperturb
from dbat_tpu.solve.ops import BundleOps as JBundleOps
from dbat_tpu.solve.schur import SchurOps as JSchurOps
from dbat_tpu.solve.smallblas import inv3x3 as jinv3x3
from dbat_tpu_torch.core.project import Project, project_from_arrays
from dbat_tpu_torch.core.serial import build_serial
from dbat_tpu_torch.solve.ops import BundleOps
from dbat_tpu_torch.solve.schur import SchurOps
from dbat_tpu_torch.solve.segsum import SegScatter, SegSum
from dbat_tpu_torch.solve.smallblas import inv3x3

NET = dict(n_img=12, n_pt=300, rays_per_pt=(3, 9), n_obs_target=1700,
           n_ctrl=4, noise_px=0.1,
           est_io_cols=("cc", "px", "py", "K1", "K2", "K3", "P1", "P2"),
           seed=5)


def _project(priors):
    j = jmake(**NET)
    jperturb(j, seed=6)
    if priors:
        j.prior_eo_use[:3, :3] = True
        j.prior_eo_std[:3, :3] = 0.05
        j.est_op[:4] = True
        j.prior_op_use[:4] = True
        j.prior_op_std[:4] = 0.01
    t = project_from_arrays({f.name: getattr(j, f.name)
                             for f in dataclasses.fields(Project)})
    return j, t


def _close(port, ref, rtol=1e-12):
    ref = np.asarray(ref)
    port = port.numpy() if torch.is_tensor(port) else np.asarray(port)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


@pytest.mark.parametrize("priors", [False, True])
def test_dense_normal_matches_jax(priors):
    j, t = _project(priors)
    jops = JBundleOps(j, jbuild_serial(j), dtype=jnp.float64)
    tops = BundleOps(t, build_serial(t), dtype=torch.float64, device="cpu")
    x0 = np.asarray(jops.x0())
    for port, ref in zip(tops._normal(torch.as_tensor(x0)),
                         jops._normal(jnp.asarray(x0))):
        _close(port, ref)
    sj, st = jops.normal(jnp.asarray(x0)), tops.normal(x0)
    _close(st.diag(), sj.diag())
    assert st.trace_diag() == pytest.approx(sj.trace_diag(), rel=1e-12)
    _close(st.matvec(st.g), sj.matvec(sj.g))
    for lam in (0.0, 0.05 * st.trace_diag() / tops.n_x):
        p, failed = st.solve(-st.g, lam)
        jp, jfailed = sj.solve(-sj.g, lam)
        assert not failed and not jfailed
        _close(p, jp, 1e-12 if lam else 1e-9)


def test_dense_solve_reports_a_singular_system():
    """A datum-free network (no control point, no prior): N has a 7-fold
    null space; the scaled factor's tiny pivot marks it singular."""
    j, t = _project(False)
    for p in (j, t):
        p.is_ctrl[:] = False
        p.est_op[:] = True
        p.prior_op_use[:] = False
    jops = JBundleOps(j, jbuild_serial(j), dtype=jnp.float64)
    tops = BundleOps(t, build_serial(t), dtype=torch.float64, device="cpu")
    x0 = np.asarray(jops.x0())
    st, sj = tops.normal(x0), jops.normal(jnp.asarray(x0))
    assert st.solve(-st.g)[1] is sj.solve(-sj.g)[1] is True


@pytest.mark.parametrize("priors", [False, True])
def test_schur_normal_state_matches_jax(priors):
    j, t = _project(priors)
    jops = JSchurOps(j, jbuild_serial(j), dtype=jnp.float64)
    tops = SchurOps(t, build_serial(t), dtype=torch.float64, device="cpu")
    x0 = np.asarray(jops.x0())
    sj, st = jops.normal(jnp.asarray(x0)), tops.normal(x0)
    _close(st.g, sj.g)
    _close(st.rw, sj.rw)
    _close(st.diag(), sj.diag())
    assert st.trace_diag() == pytest.approx(sj.trace_diag(), rel=1e-12)
    _close(st.matvec(st.g), sj.matvec(sj.g))
    lam = 0.05 * st.trace_diag() / tops.n_x
    p, failed = st.solve(-st.g, lam)
    jp, jfailed = sj.solve(-sj.g, lam)
    assert not failed and not jfailed
    _close(p, jp)
    p0, _ = st.solve(-st.g)
    _close(p0, sj.solve(-sj.g)[0], 1e-9 if not priors else 1e-7)


# -- the card's fixed-order sums, on the CPU --------------------------------

@pytest.mark.parametrize("kind", ["uniform", "ragged", "long", "empty"])
def test_segsum_ordered_matches_numpy(kind):
    rng = np.random.default_rng(8)
    if kind == "uniform":
        ids, n_seg = np.repeat(np.arange(40), 5), 40
    elif kind == "ragged":
        ids, n_seg = rng.integers(0, 30, 700), 30
    elif kind == "long":  # segments of up to ~1000 items: three levels
        ids, n_seg = np.minimum(rng.geometric(0.3, 3000) - 1, 12), 13
    else:  # segments without items, one item, or none at all
        ids, n_seg = np.sort(rng.integers(0, 25, 300)) * 2, 50
    data = rng.normal(size=(len(ids), 3))
    ref = np.zeros((n_seg, 3))
    np.add.at(ref, ids, data)
    seg = SegSum(ids, n_seg, cap=8)
    for out in (seg.ordered(torch.as_tensor(data)),
                seg.sequential(torch.as_tensor(data)),
                seg(torch.as_tensor(data))):
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12,
                                   atol=1e-12)
    if kind == "long":
        assert len(seg._levels) >= 2


def test_segscatter_ordered_matches_numpy():
    """Targets hit once, targets hit by hundreds of sources, and
    sources read more than once (src), onto a nonzero output."""
    rng = np.random.default_rng(9)
    n_src, n_out = 500, 60
    targets = np.concatenate([rng.integers(0, 5, 900),
                              rng.permutation(np.arange(5, n_out))])
    src = rng.integers(0, n_src, len(targets))
    data = rng.normal(size=n_src)
    out0 = rng.normal(size=n_out)
    ref = out0.copy()
    np.add.at(ref, targets, -2.0 * data[src])
    plan = SegScatter(targets, src=src, n_src=n_src)
    assert len(np.unique(plan.targets.numpy())) == len(plan.targets)
    for add in (plan.add_ordered, plan.add_sequential, plan.add_into):
        got = add(torch.tensor(out0), torch.as_tensor(data), alpha=-2.0)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)


def test_schur_assembly_in_the_cards_order_matches_jax(monkeypatch):
    """The Schur assembly and S build with every sum in the CUDA order
    (SegSum.ordered, SegScatter without index_add_), on the CPU."""
    monkeypatch.setattr(SegSum, "__call__", SegSum.ordered)
    monkeypatch.setattr(SegScatter, "add_into", SegScatter.add_ordered)
    j, t = _project(True)
    jops = JSchurOps(j, jbuild_serial(j), dtype=jnp.float64)
    tops = SchurOps(t, build_serial(t), dtype=torch.float64, device="cpu")
    x0 = np.asarray(jops.x0())
    tout = tops._assemble_impl(torch.as_tensor(x0))
    jout = jops._assemble_impl(jnp.asarray(x0))
    for port, ref in zip(tout, jout):
        _close(port, ref)
    U, V, Wb = tout[:3]
    jU, jV, jWb = jout[:3]
    _close(tops._schur_S(U, inv3x3(V), Wb, 0.0),
           jops._schur_S(jU, jinv3x3(jV), jWb, 0.0))
    _, dense = _project(True)
    dops = BundleOps(dense, build_serial(dense), dtype=torch.float64,
                     device="cpu")
    jd = JBundleOps(j, jbuild_serial(j), dtype=jnp.float64)
    for port, ref in zip(dops._normal(torch.as_tensor(x0)),
                         jd._normal(jnp.asarray(x0))):
        _close(port, ref)
