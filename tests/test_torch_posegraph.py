"""Port parity: relative orientation, alignment and the pose-graph
initialisation of dbat_tpu_torch (geometry/essential.py, align.py,
posegraph.py) against dbat_tpu's on the same inputs.

The port's modules are copies of the JAX package's numpy code, so the
building blocks are held exactly equal: the 5-point candidates, the
chirality vote, RANSAC with seeded generators (the same samples: the
generators end in the same state), the observation pairs of the port's
solve/schur.py that posegraph reads, the view graph, the rotation
averaging and both centre recoveries.  init_from_pose_graph, which
also runs each package's own forward intersection, is held to 1e-9 of
the largest EO and OP entry."""

import numpy as np
import pytest

from dbat_tpu.geometry import align as jal
from dbat_tpu.geometry import essential as jes
from dbat_tpu.geometry import posegraph as jpg
from dbat_tpu.pipeline.synthetic import make_ring_network as jmake
from dbat_tpu.solve.schur import _build_pairs as jbuild_pairs
from dbat_tpu_torch.core.compare import compare_projects
from dbat_tpu_torch.geometry import align as tal
from dbat_tpu_torch.geometry import essential as tes
from dbat_tpu_torch.geometry import posegraph as tpg
from dbat_tpu_torch.models.rotation import w2c_from_angles_np
from dbat_tpu_torch.solve.schur import _build_pairs as tbuild_pairs
from port_shared import port_project


def _two_view(seed, n, noise=0.0, outliers=0):
    rng = np.random.default_rng(seed)
    R = w2c_from_angles_np(rng.uniform(-0.3, 0.3, 3))[0]
    t = rng.uniform(-1, 1, 3)
    t /= np.linalg.norm(t)
    X = rng.uniform(-1, 1, (3, n)) + np.array([[0], [0], [4.0]])
    x1 = X[:2] / X[2]
    Xc2 = R @ X + t[:, None]
    x2 = Xc2[:2] / Xc2[2]
    if noise:
        x1 = x1 + rng.normal(0, noise, x1.shape)
        x2 = x2 + rng.normal(0, noise, x2.shape)
    x2[:, :outliers] += rng.uniform(0.1, 0.3, (2, outliers))
    return x1, x2


def _equal_lists(a, b):
    assert len(a) == len(b)
    for u, v in zip(a, b):
        if isinstance(v, tuple):
            _equal_lists(u, v)
        else:
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_five_point_and_cameras(seed):
    x1, x2 = _two_view(seed, 5)
    cands = tes.essential_5pt(x1, x2)
    assert cands
    _equal_lists(cands, jes.essential_5pt(x1, x2))
    x1, x2 = _two_view(seed, 40)
    E = cands[0]
    _equal_lists(tes.cams_from_e(E), jes.cams_from_e(E))
    best, all_ = tes.cams_from_e(E, x1, x2)
    rbest, rall = jes.cams_from_e(E, x1, x2)
    _equal_lists(best, rbest)
    _equal_lists(all_, rall)


def test_five_point_needs_five_points():
    x1, x2 = _two_view(0, 4)
    for mod in (tes, jes):
        with pytest.raises(ValueError, match="at least 5"):
            mod.essential_5pt(x1, x2)


@pytest.mark.parametrize("seed,noise,outliers,iters,thr", [
    (13, 0.0, 8, 100, 1e-8), (5, 1e-4, 0, 50, 1e-7),
    (6, 1e-3, 12, 200, 1e-5)])
def test_ransac_draws_the_same_samples(seed, noise, outliers, iters, thr):
    x1, x2 = _two_view(seed, 60, noise, outliers)
    rt, rj = np.random.default_rng(seed), np.random.default_rng(seed)
    Et, inl_t = tes.essential_ransac(x1, x2, threshold=thr, iters=iters,
                                     rng=rt)
    Ej, inl_j = jes.essential_ransac(x1, x2, threshold=thr, iters=iters,
                                     rng=rj)
    np.testing.assert_array_equal(Et, Ej)
    np.testing.assert_array_equal(inl_t, inl_j)
    assert rt.bit_generator.state == rj.bit_generator.state
    assert inl_t[outliers:].sum() >= 0.9 * (60 - outliers)


def test_observation_pairs_match_jax():
    rng = np.random.default_rng(2)
    for obs_pt in (rng.integers(0, 50, 400).astype(np.int32),
                   jmake(n_img=10, n_pt=60, rays_per_pt=(2, 8),
                         n_obs_target=300, seed=3).obs_pt):
        got, ref = tbuild_pairs(obs_pt), jbuild_pairs(obs_pt)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])


@pytest.fixture(scope="module")
def ring():
    return jmake(n_img=10, n_pt=120, rays_per_pt=5, n_ctrl=4,
                 noise_px=0.0, seed=7)


def test_view_graph_rotations_and_centres(ring):
    j, t = ring.copy(), port_project(ring)
    edges = tpg.build_view_graph(t, min_shared=10, ransac_iters=60)
    ref = jpg.build_view_graph(j, min_shared=10, ransac_iters=60)
    assert len(edges) >= t.n_img
    _equal_lists([e[2:4] for e in edges], [e[2:4] for e in ref])
    assert [e[:2] + e[4:] for e in edges] == [e[:2] + e[4:] for e in ref]
    Rg = tpg.average_rotations(t.n_img, edges)
    np.testing.assert_array_equal(Rg, jpg.average_rotations(j.n_img, ref))
    np.testing.assert_array_equal(tpg.recover_centers(t.n_img, edges, Rg),
                                  jpg.recover_centers(j.n_img, ref, Rg))
    _equal_lists(tpg.recover_centers_structure(t, Rg),
                 jpg.recover_centers_structure(j, Rg))


def test_disconnected_view_graph_raises(ring):
    edges = tpg.build_view_graph(port_project(ring), min_shared=10,
                                 ransac_iters=60)
    cut = [e for e in edges if 4 not in e[:2]]
    for mod in (tpg, jpg):
        with pytest.raises(ValueError, match="disconnected"):
            mod.average_rotations(10, cut)


@pytest.mark.parametrize("seed", [None, 5])
def test_init_from_pose_graph(seed):
    j = jmake(n_img=10, n_pt=120, rays_per_pt=5, n_ctrl=4, noise_px=0.05,
              ip_std_px=0.05, seed=7)
    j.eo[:, 0:6] = 0.0
    j.op[j.est_op.all(axis=1)] = 0.0
    t = port_project(j)

    def rng():
        return None if seed is None else np.random.default_rng(seed)

    got = tpg.init_from_pose_graph(t, min_shared=10, ransac_iters=80,
                                   rng=rng())
    ref = jpg.init_from_pose_graph(j, min_shared=10, ransac_iters=80,
                                   rng=rng())
    assert got["aligned_to_ctrl"] and got["behind"] == 0
    for key in ("edges", "n_edges", "behind", "aligned_to_ctrl"):
        assert got[key] == ref[key], key
    for a, b in ((t.eo, j.eo), (t.op, j.op)):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-9 * np.abs(b).max())


@pytest.mark.parametrize("scale", [False, True])
def test_rigid_align(scale):
    rng = np.random.default_rng(4)
    X = rng.standard_normal((3, 30))
    Y = 1.7 * w2c_from_angles_np(np.array([0.3, -0.2, 0.5]))[0] @ X \
        + rng.standard_normal((3, 1))
    _equal_lists(tal.rigid_align(X, Y, scale=scale),
                 jal.rigid_align(X, Y, scale=scale))
    for mod in (tal, jal):
        with pytest.raises(ValueError, match="same size"):
            mod.rigid_align(X, Y[:, :5])


def test_transform_network_and_align_to_camera(ring):
    j, t = ring.copy(), port_project(ring)
    j.eo[2] = t.eo[2] = np.nan  # a camera without values is skipped
    T = np.eye(4)
    T[:3, :3] = 1.3 * w2c_from_angles_np(np.array([0.3, -0.2, 0.5]))[0]
    T[:3, 3] = [5.0, -2.0, 1.0]
    tal.transform_network(t, T)
    jal.transform_network(j, T)
    assert compare_projects(t, j, rtol=0, atol=0) == []
    tal.align_to_camera(t, 3)
    jal.align_to_camera(j, 3)
    assert compare_projects(t, j, rtol=0, atol=0) == []
    np.testing.assert_allclose(t.eo[3], 0.0, atol=1e-12)
