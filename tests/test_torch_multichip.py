"""Port parity: the mesh backends (dbat_tpu_torch/parallel/) on 8 CPU
shards, f64, against the port on one device and against the JAX
package's own mesh backends on tests/conftest.py's 8 virtual devices,
with the same input from a numpy seed.

Mirrors every case of tests/test_multichip.py at its sizes and
tolerances:
  * ShardedSchurOps (the point-partitioned backend that bundle(mesh=)
    uses): g within 1e-10, the step within 1e-7 relative and the
    matvec within 1e-8, of the unsharded SchurOps and of the JAX
    package's ShardedSchurOps; the host partition's plans equal to the
    JAX package's _bucket_plan output;
  * SchurOps(mesh=, pair_chunk=256), the legacy mesh path: g, the step
    and the matvec as above, the residuals within 1e-12, with the
    observations held only as the shards' slices;
  * bundle(mesh=) against bundle(backend="schur") on one device and
    against the JAX package's bundle(mesh=): sigma0 within 1e-9
    relative, the parameters and the posterior residuals within 1e-8;
  * fused_gna on sharded ops to the noise floor;
  * the mid-scale network (64 cameras, 4,096 points, ~24k
    observations, 5 self-calibrated IO parameters) through bundle,
    covariance and report against the JAX package's mesh run (sigma0
    1e-8, parameters 1e-7, cio/ceo 1e-6 relative, the COP variances
    1e-6 relative), and the COP loop over the shards against its
    unsharded loop;
  * covariance and report on the mesh results (1e-8 relative).
Against the port on one device the comparisons are the JAX tests' own
(assert_allclose with their rtol and atol).  Against the JAX package,
whose sums run in XLA's order, each vector is held to the same rtol
times its largest entry, as tests/test_torch_schur.py does: g's
entries come out of cancelling sums, and rounding differences of
~1e-14 of the largest entry exceed 1e-10 of a small entry.
Also: the shard sums in the card's order (SegSum levels, no
index_add_) on the CPU, and a device that disagrees with the mesh."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from dbat_tpu.core.serial import build_serial as jbuild_serial
from dbat_tpu.io.report import write_report as jwrite_report
from dbat_tpu.parallel.mesh import make_mesh as jmake_mesh
from dbat_tpu.parallel.sharded import ShardedSchurOps as JShardedSchurOps
from dbat_tpu.parallel.sharded import _bucket_plan as jbucket_plan
from dbat_tpu.pipeline.synthetic import make_ring_network as jmake
from dbat_tpu.pipeline.synthetic import perturb as jperturb
from dbat_tpu.solve.bundle import bundle as jbundle
from dbat_tpu.solve.covariance import Covariance as JCovariance
from dbat_tpu.solve.fused import fused_gna as jfused_gna
from dbat_tpu.solve.schur import SchurOps as JSchurOps
from dbat_tpu_torch.core.serial import build_serial
from dbat_tpu_torch.io.report import write_report
from dbat_tpu_torch.parallel.mesh import make_mesh, shard_bounds
from dbat_tpu_torch.parallel.obs_mesh import OBS_ARRAYS, ObsMeshSchurOps
from dbat_tpu_torch.parallel.sharded import ShardedSchurOps
from dbat_tpu_torch.solve.bundle import bundle
from dbat_tpu_torch.solve.covariance import Covariance
from dbat_tpu_torch.solve.fused import fused_gna
from dbat_tpu_torch.solve.schur import SchurOps
from dbat_tpu_torch.solve.segsum import SegScatter, SegSum
from port_shared import one_thread, port_project  # noqa: F401

IRREGULAR = dict(n_img=12, n_pt=64, rays_per_pt=(3, 8), n_obs_target=320,
                 n_ctrl=4, noise_px=0.05, est_io_cols=("cc", "px", "py"),
                 seed=7)
UNIFORM = dict(n_img=12, n_pt=64, rays_per_pt=4, noise_px=0.05, seed=7)
BUNDLE = dict(n_img=12, n_pt=96, rays_per_pt=(3, 8), n_obs_target=500,
              n_ctrl=4, noise_px=0.05, est_io_cols=("cc",), seed=11)
MIDSCALE = dict(n_img=64, n_pt=4096, rays_per_pt=(3, 16),
                n_obs_target=24000, n_ctrl=6, noise_px=0.05,
                est_io_cols=("cc", "px", "py", "K1", "K2"), seed=29)


def cpu_mesh():
    return make_mesh(["cpu"] * 8)


def _jnet(kw, perturbed=False):
    j = jmake(**kw)
    if perturbed:
        jperturb(j, eo_pos=0.02, eo_ang=0.005, op_pos=0.02)
    return j


def _np(v):
    return v.numpy() if torch.is_tensor(v) else np.asarray(v)


def test_eight_shards_beside_eight_virtual_devices():
    mesh = cpu_mesh()
    assert len(jax.devices()) == 8
    assert mesh.n_shards == 8 and mesh.shape == {"obs": 8}
    assert mesh.axis_names == ("obs",) and mesh.owned == tuple(range(8))
    assert mesh.device == torch.device("cpu") and mesh.group is None


def test_make_mesh_without_devices_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(["cuda:0"] * 2)


@pytest.fixture(scope="module")
def irregular():
    """The JAX test's irregular self-calibrating network in both
    packages: (port ops unsharded, port sharded, JAX sharded, x0)."""
    j = _jnet(IRREGULAR)
    t = port_project(j)
    spec = build_serial(t)
    return (SchurOps(t, spec, device="cpu"),
            ShardedSchurOps(t, spec, mesh=cpu_mesh()),
            JShardedSchurOps(j, jbuild_serial(j), mesh=jmake_mesh()),
            np.asarray(JSchurOps(j, jbuild_serial(j)).x0()))


def test_partition_plans_match_jax(irregular):
    """The host partition (padded constants, the vectorised SegSum bucket
    plans and the pair lists of each shard) equals the JAX package's
    _bucket_plan output, shard by shard."""
    _ops, ops, jops, _x0 = irregular
    assert (ops.S_pt, ops.S_obs, ops.n_sh) == (jops.S_pt, jops.S_obs, 8)
    jconst = {nm: np.asarray(getattr(jops, "c_" + nm)) for nm in (
        "img", "lpt", "ip", "w", "px", "gx_pt", "rs_pt", "gx_img",
        "rs_img", "i1", "i2")}
    for k, sh in enumerate(ops.shards):
        for nm in ("img", "lpt", "ip", "w", "px"):
            np.testing.assert_array_equal(_np(getattr(sh, nm)),
                                          jconst[nm][k], err_msg=nm)
        np.testing.assert_array_equal(_np(sh.xidx),
                                      np.asarray(jops.op_xidx)[k])
        for seg, gx, rs, pad_seg in ((sh.seg_pt, "gx_pt", "rs_pt", ops.S_pt),
                                     (sh.seg_img, "gx_img", "rs_img",
                                      ops.base_eo.shape[0])):
            n = seg.gidx.shape[0]
            np.testing.assert_array_equal(_np(seg.gidx), jconst[gx][k][:n])
            np.testing.assert_array_equal(_np(seg.row_seg), jconst[rs][k][:n])
            # The JAX stack pads with all-pad rows into the dump segment.
            assert np.all(jconst[gx][k][n:] == ops.S_obs)
            assert np.all(jconst[rs][k][n:] == pad_seg)
        # Kernel B's plan holds the shard's pairs in the JAX order; its
        # per-camera-pair padding indexes S_obs (outside Y).
        plan = sh.pair_plan
        i1, i2 = _np(plan.i1), _np(plan.i2)
        real = i1 < ops.S_obs
        m = plan.n_pairs
        np.testing.assert_array_equal(i1[real], jconst["i1"][k][:m])
        np.testing.assert_array_equal(i2[real], jconst["i2"][k][:m])
        assert np.all(jconst["i1"][k][m:] == ops.S_obs)
    # The stand-alone plan function too, on a ragged id list.
    ids = np.sort(np.random.default_rng(3).integers(0, 9, 300))
    gidx, row_seg = jbucket_plan(ids, 9, 300, 16)
    seg = SegSum(ids, 9, 16, src=np.arange(300), n_src=300)
    np.testing.assert_array_equal(_np(seg.gidx), gidx)
    np.testing.assert_array_equal(_np(seg.row_seg), row_seg)


def _close(port, ref, rtol, atol, jax_ref):
    """The JAX tests' assert_allclose; against the JAX package, rtol of
    the reference's largest entry (module docstring)."""
    port, ref = _np(port), _np(ref)
    if jax_ref:
        assert port.shape == ref.shape
        atol, rtol = max(atol, rtol * np.abs(ref).max()), 0.0
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)


def _step(ops, x0):
    jax_ops = isinstance(ops, (JSchurOps, JShardedSchurOps))
    st = ops.normal(jnp.asarray(x0) if jax_ops else torch.as_tensor(x0))
    p, failed = st.solve(-st.g)
    assert not failed
    return st, p


@pytest.mark.parametrize("ref", ["unsharded", "jax_sharded"])
def test_sharded_schur_matches(irregular, ref):
    ops0, ops1, jops, x0 = irregular
    jax_ref = ref == "jax_sharded"
    st1, p1 = _step(ops1, x0)
    st0, p0 = _step(jops if jax_ref else ops0, x0)
    _close(st1.g, st0.g, 1e-10, 1e-10, jax_ref)
    _close(p1, p0, 1e-7, 1e-10, jax_ref)
    mv0 = st0.matvec(p0)
    mv1 = st1.matvec(torch.as_tensor(_np(p0)))
    _close(mv1, mv0, 1e-8, 1e-10, jax_ref)
    # The padded residual vectors: same length and norm.
    assert st1.rw.shape == np.asarray(jops.weighted_residual(
        jnp.asarray(x0))).shape
    assert float(st1.rw @ st1.rw) == pytest.approx(
        float(st0.rw @ st0.rw), rel=1e-12)


def test_sharded_sums_in_the_cards_order(irregular, monkeypatch):
    """Every segment sum and scatter in the CUDA order (SegSum levels,
    no index_add_), run on the CPU: the same step."""
    ops0, _ops1, _jops, x0 = irregular
    monkeypatch.setattr(SegSum, "__call__", SegSum.ordered)
    monkeypatch.setattr(SegScatter, "add_into", SegScatter.add_ordered)
    j = _jnet(IRREGULAR)
    t = port_project(j)
    ops = ShardedSchurOps(t, build_serial(t), mesh=cpu_mesh())
    st1, p1 = _step(ops, x0)
    st0, p0 = _step(ops0, x0)
    np.testing.assert_allclose(_np(st1.g), _np(st0.g), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(_np(p1), _np(p0), rtol=1e-7, atol=1e-10)


@pytest.mark.parametrize("ref", ["unsharded", "jax_mesh"])
def test_legacy_mesh_schur_matches(ref):
    j = _jnet(UNIFORM)
    t = port_project(j)
    spec = build_serial(t)
    x0 = np.asarray(JSchurOps(j, jbuild_serial(j)).x0())
    ops1 = SchurOps(t, spec, device="cpu", mesh=cpu_mesh(), pair_chunk=256)
    # The observations live only as the shards' contiguous slices, and
    # each pair chunk is cut over the shards.
    assert isinstance(ops1, ObsMeshSchurOps)
    assert all(getattr(ops1, nm) is None for nm in OBS_ARRAYS)
    cut = shard_bounds(ops1.n_obs, 8)
    for k, sh in enumerate(ops1.shards):
        np.testing.assert_array_equal(
            sh.obs_pt.numpy(), np.asarray(t.obs_pt)[cut[k]:cut[k + 1]])
    assert len(ops1._chunks) == -(-ops1.n_pairs // 256)
    assert all(len(c) == 8 for c in ops1._chunks)
    ref_ops = (JSchurOps(j, jbuild_serial(j), mesh=jmake_mesh(),
                         pair_chunk=256) if ref == "jax_mesh"
               else SchurOps(t, spec, device="cpu"))
    st1, p1 = _step(ops1, x0)
    st0, p0 = _step(ref_ops, x0)
    assert [w.shape[0] for w in st1.Wb] == list(np.diff(cut))
    _close(st1.g, st0.g, 1e-10, 1e-10, ref == "jax_mesh")
    _close(p1, p0, 1e-7, 1e-10, ref == "jax_mesh")
    def on_ref(v):
        return jnp.asarray(v) if ref == "jax_mesh" else torch.as_tensor(v)

    pv = _np(p0)
    _close(st1.matvec(torch.as_tensor(pv)), st0.matvec(on_ref(pv)), 1e-8,
           1e-10, ref == "jax_mesh")
    for fn in ("weighted_residual", "residuals"):
        _close(getattr(ops1, fn)(torch.as_tensor(x0)),
               getattr(ref_ops, fn)(on_ref(x0)), 1e-12, 1e-14,
               ref == "jax_mesh")


@pytest.fixture(scope="module")
def bundles():
    """BUNDLE solved four ways: the port on one device and on 8 shards,
    the JAX package on one device and on its 8 virtual devices."""
    out = {}
    for name, run in (
            ("port_1", lambda j: bundle(port_project(j), damping="gna",
                                        backend="schur", device="cpu")),
            ("port_8", lambda j: bundle(port_project(j), damping="gna",
                                        mesh=cpu_mesh())),
            ("jax_1", lambda j: jbundle(j, damping="gna", backend="schur")),
            ("jax_8", lambda j: jbundle(j, damping="gna",
                                        mesh=jmake_mesh()))):
        out[name] = run(_jnet(BUNDLE, perturbed=True))
        assert out[name][1], name
    return out


@pytest.mark.parametrize("ref", ["port_1", "jax_8"])
def test_sharded_full_bundle_matches(bundles, ref):
    r8, _ok8, it8, sig8, info8 = bundles["port_8"]
    r1, _ok1, it1, sig1, _info1 = bundles[ref]
    assert it8 == it1
    assert sig8 == pytest.approx(sig1, rel=1e-9)
    for nm in ("op", "eo", "io"):
        np.testing.assert_allclose(getattr(r8, nm), getattr(r1, nm),
                                   atol=1e-8)
    # The posterior residuals: de-padded, in the project's observation
    # order.
    np.testing.assert_allclose(r8.post["ip_res_px"], r1.post["ip_res_px"],
                               atol=1e-8)
    assert isinstance(info8.ops, ShardedSchurOps)
    assert info8.polish_iters == 0 and info8.center_offset is None


@pytest.mark.parametrize("ref", ["port_1", "jax_8"])
def test_sharded_covariance_and_report(bundles, ref, tmp_path):
    """Covariance (through the unsharded delegate, cop through the
    shards) and the report on the mesh results."""
    r8, _ok8, _it8, _sig8, info8 = bundles["port_8"]
    r1, _ok1, _it1, _sig1, info1 = bundles[ref]
    c8 = Covariance(r8, info8)
    assert isinstance(c8.ops, SchurOps) and c8.ops.mesh is None
    c1 = (JCovariance(r1, info1) if ref == "jax_8"
          else Covariance(r1, info1))
    for nm in ("cio", "ceo", "cop"):
        np.testing.assert_allclose(getattr(c8, nm)(), getattr(c1, nm)(),
                                   rtol=1e-8, atol=1e-12, err_msg=nm)
    path = tmp_path / "mesh-report.txt"
    stats = write_report(r8, info8, str(path), damping="gna")
    assert stats is not None and path.read_text().count("\n") > 100
    if ref == "jax_8":
        jpath = tmp_path / "jax-mesh-report.txt"
        jwrite_report(r1, info1, str(jpath), damping="gna")
        assert path.read_text().count("\n") == \
            jpath.read_text().count("\n")


@pytest.mark.parametrize("ref", ["noise_floor", "jax_sharded"])
def test_sharded_fused_bundle(ref):
    """fused_gna on sharded ops (the bench path) to the noise floor."""
    j = _jnet(dict(BUNDLE, seed=13), perturbed=True)
    t = port_project(j)
    ops = ShardedSchurOps(t, build_serial(t), mesh=cpu_mesh())
    dof = ops.n_res - ops.n_x
    res = fused_gna(ops, ops.x0(), max_iter=20,
                    conv_tol=float(np.sqrt(dof)), abs_term=True)
    assert res.code == 0
    assert np.sqrt(res.final_rw @ res.final_rw) <= np.sqrt(dof)
    if ref == "jax_sharded":
        jops = JShardedSchurOps(j, jbuild_serial(j), mesh=jmake_mesh(),
                                dtype=jnp.float64)
        jres = jfused_gna(jops, jops.x0(), max_iter=20,
                          conv_tol=float(np.sqrt(dof)), abs_term=True)
        assert (res.code, res.iters) == (jres.code, jres.iters)
        np.testing.assert_allclose(res.x, np.asarray(jres.x), rtol=0,
                                   atol=1e-8)
        np.testing.assert_allclose(res.res_norms, jres.res_norms,
                                   rtol=1e-9)


@pytest.fixture(scope="module")
def midscale():
    """MIDSCALE solved by the port on 8 shards and by the JAX package on
    its 8 virtual devices (its own test holds that to one device)."""
    out = {}
    for name, run in (
            ("port_8", lambda j: bundle(port_project(j), damping="gna",
                                        mesh=cpu_mesh())),
            ("jax_8", lambda j: jbundle(j, damping="gna",
                                        mesh=jmake_mesh()))):
        out[name] = run(_jnet(MIDSCALE, perturbed=True))
        assert out[name][1], name
    return out


@pytest.mark.parametrize("ref", ["jax_8", "port_unsharded_cop"])
def test_sharded_midscale_bundle_covariance_report(midscale, ref, tmp_path):
    """The mid-scale network: every shard gets an uneven point bucket
    and the shard sums carry a 389-column reduced system.  Against the
    JAX package's mesh run, and the COP chunk loop over the shards
    against the same extraction's unsharded loop."""
    r8, _ok8, it8, sig8, info8 = midscale["port_8"]
    c8 = Covariance(r8, info8)
    if ref == "jax_8":
        r1, _ok1, it1, sig1, info1 = midscale[ref]
        assert it8 == it1
        assert sig8 == pytest.approx(sig1, rel=1e-8)
        for nm in ("op", "eo", "io"):
            np.testing.assert_allclose(getattr(r8, nm), getattr(r1, nm),
                                       atol=1e-7)
        c1 = JCovariance(r1, info1)
        np.testing.assert_allclose(c8.cio(), c1.cio(), rtol=1e-6,
                                   atol=1e-10)
        np.testing.assert_allclose(c8.ceo(), c1.ceo(), rtol=1e-6,
                                   atol=1e-10)
        ref_cop = c1.cop()
    else:
        one = Covariance(r8, dataclasses.replace(
            info8, ops=info8.ops.covariance_ops()))
        ref_cop = one.cop()
        path = tmp_path / "mid-report.txt"
        assert write_report(r8, info8, str(path), damping="gna") is not None
        assert path.read_text().count("\n") > 100
    np.testing.assert_allclose(np.einsum("nii->ni", c8.cop()),
                               np.einsum("nii->ni", ref_cop), rtol=1e-6,
                               atol=1e-12)


def test_bundle_device_must_be_the_meshs():
    t = port_project(_jnet(BUNDLE))
    with pytest.raises(ValueError, match="reducing device"):
        bundle(t, mesh=cpu_mesh(), device="meta")
    with pytest.raises(ValueError, match="reducing device"):
        ShardedSchurOps(t, build_serial(t), mesh=cpu_mesh(), device="meta")


@pytest.mark.parametrize("edit", ["no_datum", "one_ray"])
def test_weak_networks_on_the_mesh_like_one_device(edit):
    """A datum-free network (SINGULAR, numerical forensics through the
    unsharded delegate) and a one-ray point (structurally rank
    deficient) report on the mesh as on one device."""
    def change(p):
        if edit == "no_datum":
            p.is_ctrl[:] = False
            p.est_op[:] = True
            p.prior_op_use[:] = False
        else:
            drop = np.flatnonzero(p.obs_pt == 20)[1:]
            keep = np.setdiff1d(np.arange(p.n_obs), drop)
            for name in ("obs_img", "obs_pt", "ip_px", "ip_std_px",
                         "ip_id"):
                setattr(p, name, getattr(p, name)[keep])
        return p

    out = {}
    for name, kw in (("one", dict(backend="schur", device="cpu")),
                     ("mesh", dict(mesh=cpu_mesh()))):
        t = change(port_project(_jnet(BUNDLE, perturbed=True)))
        out[name] = bundle(t, damping="gna", **kw)[4]
    one, mesh = out["one"], out["mesh"]
    assert mesh.code == one.code != 0
    key = "numerical" if edit == "no_datum" else "structural"
    wo, wm = one.weakness[key], mesh.weakness[key]
    assert (wm["rank"], wm["deficiency"]) == (wo["rank"], wo["deficiency"])
    assert wm["deficiency"] > 0
    if edit == "no_datum":
        np.testing.assert_array_equal(wm["weak_points"], wo["weak_points"])
