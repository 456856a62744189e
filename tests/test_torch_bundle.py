"""Port parity: bundle() of dbat_tpu_torch against dbat_tpu's bundle() on
the same small ring networks (the port with device="cpu").

Compared: ok, code, iterations, sigma0, center_offset, the final x and
the posterior residuals in project.post.  f64: sigma0 within 1e-8
relative, x and residuals within 1e-8 of their largest entry.  f32:
the same code and iterations, sigma0 within 1e-4 relative (f32 sums in
another order move the final residual in its 5th digit,
test_torch_fused.py), x within 1e-4 of its largest entry and the
posterior residuals within 5e-3 of theirs (two f32 solutions at the
floor differ in x by up to ~1e-5 of its scale, which moves residuals of
~0.1 px by ~1e-3 of the largest).  conv_tol
1e-4 keeps the host LM's last acceptance far above the f64 rounding
level (test_torch_solvers.py).

Also: the f64 polish after an f32 solve (sigma0_prepolish,
polish_iters, code, chip_code), the chirality veto on the host loop, a
fixed-IO network (nb = 6: U, V, W, S and the step within 1e-12 against
the JAX package's 6-wide image-block path), and the two failure
reports: a datum-free network (SINGULAR, numerical rank analysis) and a
point seen by one ray (STRUCT_RANK_DEFICIENT, the unmatched column)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dbat_tpu.core.serial import build_serial as jbuild_serial
from dbat_tpu.pipeline.synthetic import make_ring_network as jmake
from dbat_tpu.pipeline.synthetic import perturb as jperturb
from dbat_tpu.solve.bundle import bundle as jbundle
from dbat_tpu.solve.schur import SchurOps as JSchurOps
from dbat_tpu.solve.smallblas import inv3x3 as jinv3x3
from dbat_tpu_torch.core.project import Project, project_from_arrays
from dbat_tpu_torch.core.serial import build_serial
from dbat_tpu_torch.solve import solvers
from dbat_tpu_torch.solve.bundle import bundle
from dbat_tpu_torch.solve.schur import SchurOps
from dbat_tpu_torch.solve.smallblas import inv3x3

NET = dict(n_img=10, n_pt=150, rays_per_pt=(3, 6), n_ctrl=6, noise_px=0.1,
           ip_std_px=0.1, seed=3)
SELFCAL = dict(n_img=12, n_pt=300, rays_per_pt=(3, 9), n_obs_target=1700,
               n_ctrl=4, noise_px=0.1,
               est_io_cols=("cc", "px", "py", "K1", "K2", "K3", "P1", "P2"),
               seed=5)


def _jnet(kw=NET, edit=None):
    j = jmake(**kw)
    jperturb(j, eo_pos=0.01, eo_ang=0.002, op_pos=0.01, seed=4)
    if edit is not None:
        edit(j)
    return j


def _port(j):
    return project_from_arrays({f.name: getattr(j, f.name)
                                for f in dataclasses.fields(Project)})


def _both(kw=NET, edit=None, **opts):
    """The same network through both packages' bundle()."""
    j = _jnet(kw, edit)
    t = _port(j)
    jdt = {torch.float32: jnp.float32}.get(opts.get("dtype"), jnp.float64)
    out_j = jbundle(j, **{**opts, "dtype": jdt})
    out_t = bundle(t, device="cpu", **opts)
    return out_j, out_t


def _agree(out_j, out_t, f32=False):
    pj, okj, itj, s0j, ij = out_j
    pt, okt, itt, s0t, it = out_t
    assert (okt, itt, it.code, it.chip_code) == (okj, itj, ij.code,
                                                 ij.chip_code)
    rtol = 1e-4 if f32 else 1e-8
    res_tol = 5e-3 if f32 else 1e-8
    assert s0t == pytest.approx(s0j, rel=rtol)
    if ij.center_offset is None:
        assert it.center_offset is None
    else:
        np.testing.assert_allclose(it.center_offset, ij.center_offset,
                                   rtol=1e-15)
    for a, b in ((it.final_x, ij.final_x), (pt.op, pj.op), (pt.eo, pj.eo)):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=rtol * np.abs(b).max())
    for key in ("ip_res_px", "prior_res"):
        b = pj.post[key]
        assert pt.post[key].shape == b.shape
        if b.size:
            np.testing.assert_allclose(pt.post[key], b, rtol=0,
                                       atol=res_tol * np.abs(b).max())
    assert pt.post["sigma0"] == s0t
    np.testing.assert_allclose(pt.post["sigmas"], pj.post["sigmas"],
                               rtol=rtol)
    assert it.param_types == ij.param_types
    assert (it.num_obs, it.num_params, it.redundancy) == (
        ij.num_obs, ij.num_params, ij.redundancy)


def test_bundle_f64_gna_auto_dense():
    out_j, out_t = _both(damping="gna", conv_tol=1e-4)
    assert type(out_t[4].ops).__name__ == "BundleOps"
    assert out_t[1] and out_t[4].trace.shape[1] == out_t[2] + 1
    _agree(out_j, out_t)


@pytest.mark.parametrize("damping", ["lm", "gm", "lmp"])
def test_bundle_f64_schur_matches_jax(damping):
    out_j, out_t = _both(damping=damping, backend="schur", conv_tol=1e-4)
    assert isinstance(out_t[4].ops, SchurOps) and out_t[1]
    _agree(out_j, out_t)


def test_bundle_f32_lm_absterm_fused_matches_jax():
    """bench.py's roma watchdog call at a small size: f32 LM on the Schur
    backend goes through fused_lm; the certified absolute criterion
    skips the polish; the network is centered."""
    j = _jnet()
    floor = float(np.sqrt(2 * j.n_obs - jbuild_serial(j).n_x))
    out_j, out_t = _both(damping="lm", dtype=torch.float32, backend="schur",
                         max_iter=40, conv_tol=1.02 * floor, abs_term=True)
    info = out_t[4]
    assert "host_syncs" in info.damping  # fused_lm, not the host loop
    assert info.polish_iters == 0 and info.sigma0_prepolish is None
    assert info.center_offset is not None
    assert out_t[1] and out_t[3] < 1.05
    _agree(out_j, out_t, f32=True)


def test_bundle_f32_gna_reltol_polishes_like_jax():
    """A relative tolerance f32 cannot certify: the f64 polish runs
    after the fused f32 solve and decides the code."""
    out_j, out_t = _both(kw=SELFCAL, damping="gna", dtype=torch.float32,
                         backend="schur")
    ij, it = out_j[4], out_t[4]
    assert it.sigma0_prepolish is not None and it.polish_iters > 0
    assert it.polish_iters == ij.polish_iters
    assert it.sigma0_prepolish == pytest.approx(ij.sigma0_prepolish,
                                                rel=1e-4)
    _agree(out_j, out_t, f32=True)
    # The polished sigma0 is an f64 statistic at an f64-polished x.
    assert out_t[3] == pytest.approx(out_j[3], rel=1e-8)


def test_bundle_veto_runs_the_host_loop():
    out_j, out_t = _both(damping="gna", veto=True, conv_tol=1e-4)
    assert "host_syncs" not in out_t[4].damping
    _agree(out_j, out_t)


def test_bundle_leaves_read_only_inputs_and_restores_the_frame():
    """Centering is copy-on-write: read-only loader arrays are not
    written, and the network returns to the world frame."""
    t = _port(_jnet())
    for a in (t.op, t.eo, t.prior_op_val, t.prior_eo_val):
        a.setflags(write=False)
    op0 = t.op.copy()
    _p, ok, _it, _s0, info = bundle(t, damping="lm", dtype=torch.float32,
                                    backend="schur", device="cpu")
    assert info.center_offset is not None
    assert np.abs(t.op - op0).max() < 0.05  # converged, in world frame
    assert np.abs(t.op.mean(0) - op0.mean(0)).max() < 0.01


def _fixed_io_pair():
    j = _jnet()
    t = _port(j)
    jops = JSchurOps(j, jbuild_serial(j), dtype=jnp.float64)
    tops = SchurOps(t, build_serial(t), dtype=torch.float64, device="cpu")
    return jops, tops


def test_fixed_io_network_matches_jax_block6():
    jops, tops = _fixed_io_pair()
    assert tops.n_cb == 6 and jops._img_block6
    x0 = np.asarray(jops.x0())
    tout = tops._assemble_impl(torch.as_tensor(x0))
    jout = jops._assemble_impl(jnp.asarray(x0))

    def close(a, b, rtol=1e-12):
        b = np.asarray(b)
        np.testing.assert_allclose(np.asarray(a), b, rtol=0,
                                   atol=rtol * np.abs(b).max())

    for a, b in zip(tout, jout):
        close(a, b)
    U, V, Wb, gc, gp, _ = tout
    jU, jV, jWb, jgc, jgp, _ = jout
    close(tops._schur_S(U, inv3x3(V), Wb, 0.0),
          jops._schur_S(jU, jinv3x3(jV), jWb, 0.0))
    p, _ = tops._solve_impl(U, V, Wb, -tops.join_x(gc, gp), 0.0)
    jp, _ = jops._solve_impl(jU, jV, jWb, -jops.join_x(jgc, jgp),
                             jnp.asarray(0.0))
    close(p, jp)


def _no_datum(p):
    p.is_ctrl[:] = False
    p.est_op[:] = True
    p.prior_op_use[:] = False


@pytest.mark.parametrize("backend", ["dense", "schur"])
def test_datum_free_network_is_singular_like_jax(backend):
    out_j, out_t = _both(edit=_no_datum, damping="gna", backend=backend)
    assert out_t[4].code == out_j[4].code == solvers.SINGULAR
    wj = out_j[4].weakness["numerical"]
    wt = out_t[4].weakness["numerical"]
    assert (wt["rank"], wt["deficiency"]) == (wj["rank"], wj["deficiency"])
    assert wt["deficiency"] > 0
    assert len(wt["suspected_params"]) == len(wj["suspected_params"])
    assert out_t[4].weakness["structural"] is None


def _one_ray(p):
    """Keep only the first observation of point 20 (not a control
    point): its three coordinates cannot be determined."""
    assert not p.is_ctrl[20]
    drop = np.flatnonzero(p.obs_pt == 20)[1:]
    keep = np.setdiff1d(np.arange(p.n_obs), drop)
    for name in ("obs_img", "obs_pt", "ip_px", "ip_std_px", "ip_id"):
        setattr(p, name, getattr(p, name)[keep])


def test_one_ray_point_is_structurally_rank_deficient_like_jax():
    out_j, out_t = _both(edit=_one_ray, damping="gna")
    assert out_t[4].code == out_j[4].code == solvers.STRUCT_RANK_DEFICIENT
    wj = out_j[4].weakness["structural"]
    wt = out_t[4].weakness["structural"]
    assert (wt["rank"], wt["deficiency"]) == (wj["rank"], wj["deficiency"])
    np.testing.assert_array_equal(wt["suspected_params"],
                                  wj["suspected_params"])
    assert out_t[1] is False and np.isnan(out_t[3]) == np.isnan(out_j[3])
