"""Port parity: the posterior covariance of dbat_tpu_torch against
dbat_tpu's, f64 on the CPU.

Both packages' Covariance get the same x and sigma0 (the JAX package's
bundle() result, carried into a port BundleInfo) on the same
self-calibrating ring network, with the rotation of image 0 fixed so
the fixed-column paths run.  Schur branch: cio, ceo, cio_full,
ceo_full, ciof, ceof (and their entry lists, equal), copf, cop at chunk
37 (a short last chunk) and at the default chunk, and posterior_std, at
rtol 1e-9 and atol 1e-12 of the largest entry.  The port's dense branch
against its Schur branch at the JAX package's own 1e-6
(tests/test_covariance.py).  The card's fixed-order Ncp scatter, run on
the CPU, against the sequential one; the whole extraction in the card's
order against the JAX package.  The extraction of an f32 bundle() runs
in f64 in the solve's centred frame and matches an f64 extraction in
the world frame (1e-8; atol 1e-10 of the largest entry for the ceo
blocks); on that network the JAX package's own extraction in f32 ops
is off its f64 extraction by more than 1e-2, which is why the port
extracts in f64.  Torch runs on one thread here (port_shared.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dbat_tpu.core.serial import build_serial as jbuild_serial
from dbat_tpu.pipeline.synthetic import make_ring_network as jmake
from dbat_tpu.pipeline.synthetic import perturb as jperturb
from dbat_tpu.solve.bundle import BundleInfo as JBundleInfo
from dbat_tpu.solve.bundle import _shift_network as jshift
from dbat_tpu.solve.covariance import Covariance as JCovariance
from dbat_tpu.solve.schur import SchurOps as JSchurOps
from dbat_tpu_torch.core.serial import build_serial
from dbat_tpu_torch.pipeline.synthetic import make_ring_network, perturb
from dbat_tpu_torch.solve.bundle import BundleInfo, bundle
from dbat_tpu_torch.solve.covariance import Covariance
from dbat_tpu_torch.solve.ops import BundleOps
from dbat_tpu_torch.solve.schur import SchurOps
from dbat_tpu_torch.solve.segsum import SegScatter, SegSum
from port_shared import NET, jax_solved, one_thread  # noqa: F401

#: the f32 bundle's network: NET with every EO parameter free
F32_PERTURB = dict(eo_pos=0.02, eo_ang=0.004, op_pos=0.02, seed=18)


@pytest.fixture(scope="module")
def solved():
    t, pj, ij = jax_solved()
    return pj, ij, t, build_serial(t)


def _port_cov(solved, cls=SchurOps):
    _pj, ij, t, spec = solved
    ops = cls(t, spec, dtype=torch.float64, device="cpu")
    info = BundleInfo(ops=ops, spec=spec, sigma0=ij.sigma0,
                      final_x=np.asarray(ij.final_x))
    return Covariance(t, info)


@pytest.fixture(scope="module")
def covs(solved):
    pj, ij = solved[:2]
    return _port_cov(solved), JCovariance(pj, ij)


def _close(port, ref, rtol=1e-9, atol=1e-12):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    assert np.array_equal(np.isnan(port), np.isnan(ref))
    scale = np.nanmax(np.abs(ref))
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol * scale,
                               equal_nan=True)


@pytest.mark.parametrize("name", ["cio", "ceo", "cio_full", "ceo_full"])
def test_camera_blocks_match_jax(covs, name):
    ct, cj = covs
    _close(getattr(ct, name)(), getattr(cj, name)())


@pytest.mark.parametrize("name", ["ciof", "ceof"])
def test_leading_blocks_and_entries_match_jax(covs, name):
    ct, cj = covs
    (C, entries), (Cj, entries_j) = getattr(ct, name)(), getattr(cj, name)()
    assert np.array_equal(entries, entries_j)
    _close(C, Cj)


def test_copf_matches_jax(covs):
    ct, cj = covs
    pts = np.arange(0, 300, 7)  # control points 0..3 fixed: 0 is in
    _close(ct.copf(pts), cj.copf(pts))
    _close(ct.copf(), cj.copf())
    with pytest.raises(ValueError):
        ct.copf(max_params=30)


@pytest.mark.parametrize("chunk", [37, 4096])
def test_cop_matches_jax(covs, chunk):
    ct, cj = covs
    _close(ct.cop(chunk=chunk), cj.cop(chunk=chunk))


def test_posterior_std_matches_jax(covs):
    ct, cj = covs
    for port, ref in zip(ct.posterior_std(), cj.posterior_std()):
        _close(port, ref)
    assert ct.jitter == 0.0


def test_dense_branch_matches_schur(solved, covs):
    """The dense N^-1 branch against the Schur branch, as the JAX
    package's own test does (tests/test_covariance.py:38-79)."""
    cs = covs[0]
    cd = _port_cov(solved, BundleOps)
    for name in ("cio", "ceo"):
        _close(getattr(cd, name)(), getattr(cs, name)(), 1e-6)
    _close(cd.cop(), cs.cop(chunk=37), 1e-6)
    pts = np.array([0, 3, 17, 40])
    Cd = cd.copf(pts)
    _close(cs.copf(pts), Cd, 1e-6)
    cop = cd.cop()
    for a, j in enumerate(pts):
        _close(Cd[3 * a:3 * a + 3, 3 * a:3 * a + 3], cop[j], 1e-8, 1e-14)
    with pytest.raises(ValueError):
        cd.copf(max_params=30)


def test_ncp_scatter_in_the_cards_order(covs):
    """Each chunk's SegScatter in the CUDA order (no atomics), run on
    the CPU, against the sequential index_add_ order."""
    ct = covs[0]
    ct.cop(chunk=37)
    _chunk, Wv, plans = ct._cop_plan_cache
    n_c = ct.ops.n_c
    for lo, hi, plan in plans:
        out = torch.zeros(n_c * (hi - lo) * 3, dtype=torch.float64)
        seq = plan.add_sequential(out.clone(), Wv)
        ordered = plan.add_ordered(out.clone(), Wv)
        _close(ordered.numpy(), seq.numpy(), 1e-13, 1e-15)
        # shared IO columns: targets hit by several rays
        assert plan._many is not None


def test_extraction_in_the_cards_order_matches_jax(solved, covs,
                                                   monkeypatch):
    monkeypatch.setattr(SegSum, "__call__", SegSum.ordered)
    monkeypatch.setattr(SegScatter, "add_into", SegScatter.add_ordered)
    cj = covs[1]
    ct = _port_cov(solved)
    _close(ct.cop(chunk=37), cj.cop(chunk=37))
    pts = np.arange(0, 300, 7)
    _close(ct.copf(pts), cj.copf(pts))
    _close(ct.cio(), cj.cio())


@pytest.fixture(scope="module")
def f32_solved():
    """The port's f32 bundle() (centred network) of NET, every EO
    parameter free: (result project, sigma0, info)."""
    t = make_ring_network(**NET)
    perturb(t, **F32_PERTURB)
    _p, ok, _it, s0, info = bundle(t, dtype="float32", backend="schur",
                                   device="cpu")
    assert ok and info.center_offset is not None
    return t, s0, info


def test_float32_bundle_extracts_in_float64(f32_solved):
    """An f32 bundle(): the extraction runs in f64 in the solve's frame
    and agrees with an f64 extraction of the same solution in the world
    frame (the model is translation invariant)."""
    t, s0, info = f32_solved
    cov = Covariance(t, info)
    assert cov.ops.dtype == torch.float64 and cov.ops is not info.ops
    world = BundleInfo(ops=SchurOps(t, info.spec, device="cpu"),
                       spec=info.spec, sigma0=s0)
    ref = Covariance(t, world)  # x serialized from the world-frame project
    for got, want in zip(cov.posterior_std(), ref.posterior_std()):
        _close(got, want, 1e-8)
    # Entries near zero carry the rounding of the block's largest.
    _close(cov.ceo(), ref.ceo(), 1e-8, 1e-10)


def test_jax_float32_extraction_is_off(f32_solved):
    """Why the port extracts in f64: the JAX package's own Covariance on
    its f32 SchurOps and on its f64 SchurOps, at the same solution (the
    f32 bundle's final_x, in its centred frame; rounded to f32 for the
    f32 ops).  Its f64 std equal the port's to 1e-6 (the two assemblies
    sum in different orders, and with every EO free the scaled S has
    eigenvalues down to ~4e-7, which amplify that rounding to ~2e-8);
    its f32 std are off them by more than 1e-2 (f32 rounds the scaled
    S by ~1e-5)."""
    t, s0, info = f32_solved
    j = jmake(**NET)
    jperturb(j, **F32_PERTURB)
    jshift(j, -info.center_offset)  # structure and priors; x is final_x
    spec = jbuild_serial(j)
    x = np.asarray(info.final_x, np.float64)
    std = {}
    for dt, xd in ((jnp.float64, x), (jnp.float32, x.astype(np.float32))):
        ji = JBundleInfo(ops=JSchurOps(j, spec, dtype=dt), spec=spec,
                         sigma0=s0, final_x=xd)
        std[dt] = [np.asarray(a) for a in JCovariance(j, ji).posterior_std()]
    port = Covariance(t, info).posterior_std()
    for got, want in zip(port, std[jnp.float64]):
        _close(got, want, 1e-6)
    worst = max(np.nanmax(np.abs(a / b - 1))
                for a, b in zip(std[jnp.float32], std[jnp.float64]))
    print(f"JAX f32 std against f64 std: max relative difference "
          f"{float(worst)!r}")
    assert worst > 1e-2
