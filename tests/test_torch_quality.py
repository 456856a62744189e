"""Port parity: the numpy statistics and geometry of dbat_tpu_torch
(solve/quality.py, geometry/quality.py, geometry/initvals.py) against
dbat_tpu's modules on the same inputs.

The port's modules are copies of the JAX package's numpy code, so
every result is held at 1e-12 of its largest entry (in practice equal).
Inputs: a self-calibrating ring network (the same arrays in both
packages), random covariance blocks made from a seed, and residuals
made from a seed.  Also: `resect` and `forward_intersect` recover the
cameras and points of a noise-free ring network whose points are all
known, in both packages alike."""

import dataclasses

import numpy as np
import pytest

from dbat_tpu.core.serial import build_serial as jbuild_serial
from dbat_tpu.geometry import initvals as jinit
from dbat_tpu.geometry import quality as jgq
from dbat_tpu.pipeline.synthetic import make_ring_network as jmake
from dbat_tpu.pipeline.synthetic import perturb as jperturb
from dbat_tpu.solve import quality as jsq
from dbat_tpu_torch.core.project import Project, project_from_arrays
from dbat_tpu_torch.core.serial import build_serial
from dbat_tpu_torch.geometry import initvals as tinit
from dbat_tpu_torch.geometry import quality as tgq
from dbat_tpu_torch.solve import quality as tsq

NET = dict(n_img=10, n_pt=120, rays_per_pt=(2, 7), n_obs_target=600,
           n_ctrl=4, noise_px=0.2,
           est_io_cols=("cc", "px", "py", "as", "K1", "K2", "K3", "P1",
                        "P2"),
           seed=7)


def _pair(edit=None, **kw):
    j = jmake(**{**NET, **kw})
    if edit is not None:
        edit(j)
    t = project_from_arrays({f.name: getattr(j, f.name)
                             for f in dataclasses.fields(Project)})
    return j, t


def _same(port, ref, tol=1e-12):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    assert np.array_equal(np.isnan(port), np.isnan(ref))
    scale = max(np.nanmax(np.abs(ref)), 1e-300) if ref.size else 1.0
    np.testing.assert_allclose(port, ref, rtol=0, atol=tol * scale,
                               equal_nan=True)


def _same_pairs(port, ref):
    """Lists of (index..., corr) tuples: indices equal, corr close."""
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        assert a[:-1] == b[:-1]
        assert a[-1] == pytest.approx(b[-1], rel=1e-12)


def _blocks(n, k, seed, corr=0.9):
    """(n, k, k) SPD blocks with strongly correlated neighbours."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, k, k))
    A[:, :, 1:] += corr * 3 * A[:, :, :-1]
    return np.einsum("nij,nkj->nik", A, A) * rng.uniform(0.1, 10, n)[
        :, None, None]


# -- solve/quality.py ---------------------------------------------------------

def test_correlation_scans_match_jax():
    cio = _blocks(6, 10, 1)
    ceo = _blocks(6, 6, 2)
    cop = _blocks(50, 3, 3, corr=2.0)
    cop[7] = 0.0  # a fixed point: zero block, zeroed correlations
    _same(tsq.corr_from_cov(cio[0]), jsq.corr_from_cov(cio[0]))
    for thr in (0.5, 0.95):
        _same_pairs(tsq.high_correlations(cio, thr),
                    jsq.high_correlations(cio, thr))
        eo_block = np.repeat(np.array([1, 1, 2, 3, 3, 4])[:, None], 6, 1)
        _same_pairs(tsq.high_eo_correlations(ceo, eo_block, thr),
                    jsq.high_eo_correlations(ceo, eo_block, thr))
        entries = np.stack([np.arange(10) // 5, np.arange(10) % 5], 1)
        _same_pairs(tsq.high_io_correlations_cross(cio[0], entries, thr),
                    jsq.high_io_correlations_cross(cio[0], entries, thr))
        assert np.array_equal(tsq.high_point_correlations(cop, thr),
                              jsq.high_point_correlations(cop, thr))
    assert tsq.high_correlations(cio, 0.5)
    _same(tsq.point_correlations(cop), jsq.point_correlations(cop))


def test_significance_matches_jax():
    j, t = _pair()
    j.io[:, 5:10] = t.io[:, 5:10] = [2e-4, -3e-6, 1e-8, 4e-5, -2e-5]
    j.io[:, 3] = t.io[:, 3] = 1e-4
    cio = _blocks(j.n_img, j.NC, 4) * 1e-9
    got = tsq.significance(t, build_serial(t), cio)
    ref = jsq.significance(j, jbuild_serial(j), cio)
    assert set(got) == set(ref) == {"K", "KC", "P", "B"}
    for k in ref:
        _same(got[k], ref[k])
    assert np.isfinite(got["KC"][0]).all()


def test_residual_stats_match_jax():
    j, t = _pair()
    res = np.random.default_rng(5).normal(scale=0.3, size=(j.n_obs, 2))
    j.post = {"ip_res_px": res}
    t.post = {"ip_res_px": res.copy()}
    got, ref = tsq.residual_stats(t), jsq.residual_stats(j)
    assert set(got) == set(ref)
    for k in ref:
        if k == "mark_max":
            assert got[k][1:] == ref[k][1:]
            assert got[k][0] == pytest.approx(ref[k][0], rel=1e-12)
        else:
            _same(got[k], ref[k])


# -- geometry/quality.py and geometry/initvals.py ----------------------------

def test_network_quality_matches_jax():
    j, t = _pair()
    jperturb(j, seed=2)
    t.eo, t.op = j.eo.copy(), j.op.copy()
    _same(tgq.point_angles(t), jgq.point_angles(j))
    _same(tgq.ray_counts(t), jgq.ray_counts(j))
    _same(tgq.reprojection_residuals_px(t), jgq.reprojection_residuals_px(j))
    cams = np.array([0, 3, 4])
    for kw in ({}, {"convex_hull": True}, {"union": True},
               {"union": True, "convex_hull": True}, {"cams": cams}):
        _same(tgq.coverage(t, **kw), jgq.coverage(j, **kw))
    for kw in ({}, {"union": True}, {"cams": cams}):
        _same(tgq.radial_coverage(t, **kw), jgq.radial_coverage(j, **kw))


@pytest.mark.parametrize("model", [1, 2, 3, 4, 5, -1])
def test_ideal_projection_matches_jax(model):
    def edit(p):
        p.dist_model = model
        p.io[:, 3:5] = [2e-3, -1e-3]  # aspect and skew
        p.io[:, 5:10] = [3e-3, -1e-5, 2e-7, 1e-4, -5e-5]

    j, t = _pair(edit)
    _same(tinit.ideal_proj_obs(t), jinit.ideal_proj_obs(j))
    _same(tinit.undistort_obs(t), jinit.undistort_obs(j))


def test_resection_and_intersection_recover_the_network():
    """Every point known: each camera is resected from the exact points
    and the points are re-intersected from the recovered cameras."""
    def edit(p):
        p.prior_op_val = p.op.copy()
        p.is_ctrl[:] = True

    # square pixels (aspect 0): undistort_obs neglects the affine terms
    j, t = _pair(edit, noise_px=0.0, est_io_cols=(), sensor=(7.2, 5.4))
    eo_true, op_true = t.eo.copy(), t.op.copy()
    assert tgq.reprojection_residuals_px(t).max() < 1e-9
    for p in (j, t):
        p.eo = np.full_like(p.eo, np.nan)
    cp = t.op_id
    rms_t, fail_t = tinit.resect(t, "all", cp, 1, 0, cp)
    rms_j, fail_j = jinit.resect(j, "all", cp, 1, 0, cp)
    assert not fail_t and not fail_j
    _same(rms_t, rms_j)
    _same(t.eo, j.eo)
    np.testing.assert_allclose(t.eo, eo_true, rtol=0, atol=1e-7)
    for p in (j, t):
        p.op = np.zeros_like(p.op)
    done_t, res_t = tinit.forward_intersect(t, "all")
    done_j, res_j = jinit.forward_intersect(j, "all")
    assert np.array_equal(done_t, done_j)
    _same(res_t, res_j)
    _same(t.op, j.op)
    many = tgq.ray_counts(t) >= 2
    np.testing.assert_allclose(t.op[many], op_true[many], rtol=0, atol=1e-7)
