"""Port parity: the PhotoModeler input of dbat_tpu_torch (io/pm.py
load_pm, core/project.py from_pm, Project.params/set_params) against
dbat_tpu's, and the JAX-free PM export writer of port_pm_export.py
against the JAX test's own.

Inputs: ring networks made from a seed and written once as a PM text
export; the feature-block file of test_pmtables.py; the C5 network
(C5_RING) as a PM export, loaded and serialized by both packages (no
bundle at that size on the CPU).  Held exactly: every PmProject and
Project field, and every SerialSpec field."""

import numpy as np
import pytest
import torch

from dbat_tpu.core.project import from_pm as jfrom_pm
from dbat_tpu.core.serial import build_serial as jbuild_serial
from dbat_tpu.io.pm import load_pm as jload_pm
from dbat_tpu_torch.core.project import Params, from_pm
from dbat_tpu_torch.core.serial import build_serial
from dbat_tpu_torch.io.pm import load_pm
from dbat_tpu_torch.pipeline.synthetic import C5_RING, make_ring_network
from port_pm_export import write_pm_export
from port_shared import same_data

RING = dict(n_img=10, n_pt=200, rays_per_pt=(3, 8), n_obs_target=1000,
            n_ctrl=6, noise_px=0.1, seed=11)

FEATURES = (
    "title\n"
    "0.001 10\n"
    "0.1 0.1\n"
    "7 3.6 -2.4 0 0 0 0 0 0 0\n"
    "0 0 0 0 0 0 0 0 0 0\n"
    "1 im1.jpg\n"
    "1 0 0 10 0 0 0\n"
    "1 0 0 0 0 0 0\n"
    "\n"
    "1 7 0 0 0 0 0 0 0 0 0\n"
    "1 0 0 0 0 0 0 0 0 0\n"
    "\n"
    "1001 0 0 0 0.01 0.01 0.01\n"
    "\n"
    "1 1 2 3 0 0 0\n"
    "\n"
    "1 1001 100.0 200.0 0.1 0.1\n"
    "\n"
    "2 2 1001 1\n"
    "5 1 1001\n"
    "\n"
    "1 2\n"
    "1 5\n"
    "\n"
)


@pytest.fixture(scope="module")
def ring_export(tmp_path_factory):
    path = tmp_path_factory.mktemp("pm") / "ring-pmexport.txt"
    write_pm_export(str(path), make_ring_network(**RING))
    return str(path)


def test_load_pm_ring_export_matches_jax(ring_export):
    a, b = load_pm(ring_export), jload_pm(ring_export)
    same_data(a, b, "PmProject")
    assert len(a.images) == RING["n_img"]


@pytest.mark.parametrize("skip_features", [False, True])
def test_load_pm_feature_blocks_match_jax(tmp_path, skip_features):
    path = tmp_path / "feat.txt"
    path.write_text(FEATURES)
    a = load_pm(str(path), skip_features=skip_features)
    same_data(a, jload_pm(str(path), skip_features=skip_features),
              "PmProject")
    if skip_features:
        assert a.features == {} and a.feat_vis.shape == (0, 2)
    else:
        assert a.features[2].tolist() == [1001, 1]
        assert a.feat_vis.tolist() == [[1, 2], [1, 5]]


@pytest.mark.parametrize("individual_cameras", [False, True])
def test_from_pm_matches_jax(ring_export, individual_cameras):
    t = from_pm(load_pm(ring_export), individual_cameras=individual_cameras)
    j = jfrom_pm(jload_pm(ring_export),
                 individual_cameras=individual_cameras)
    same_data(t, j, "Project")
    # The sign conventions of prob2dbatstruct.m: py and K, P negated.
    prob = load_pm(ring_export)
    assert t.io[0, 2] == -prob.def_cam[2]
    np.testing.assert_array_equal(t.io[0, 5:], -prob.def_cam[5:10])


def test_from_pm_prior_camera_positions_and_labels(ring_export):
    """The optional prior camera table and label map (the PSZ path)."""
    def prob_of(load):
        p = load(ring_export)
        p.prior_cam_pos = np.array([[2, 1.0, 2.0, 3.0, 0.1, 0.1, 0.2],
                                    [5, 4.0, 5.0, 6.0, 0.3, 0.3, 0.3]])
        p.op_labels_by_id = {1: "cp-one", 3: "cp-three"}
        return p

    t, j = from_pm(prob_of(load_pm)), jfrom_pm(prob_of(jload_pm))
    same_data(t, j, "Project")
    assert t.prior_eo_use[:, :3].sum() == 6 and t.op_labels[0] == "cp-one"


def test_params_round_trip_on_an_explicit_device(ring_export):
    t = from_pm(load_pm(ring_export))
    j = jfrom_pm(jload_pm(ring_export))
    p = t.params(device="cpu")
    assert isinstance(p, Params) and p.io.device.type == "cpu"
    assert p.eo.dtype == torch.float64
    jp = j.params()
    for name in ("io", "eo", "op"):
        np.testing.assert_array_equal(getattr(p, name).numpy(),
                                      np.asarray(getattr(jp, name)))
    q = Params(io=p.io * 2, eo=p.eo + 1, op=p.op - 1)
    t.set_params(q)
    j.set_params(type(jp)(io=jp.io * 2, eo=jp.eo + 1, op=jp.op - 1))
    for name in ("io", "eo", "op"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))


def test_c5_pm_round_trip_matches_jax(tmp_path):
    """The C5 network as a PM export (196,715 marks): load_pm, from_pm
    and build_serial in both packages, field for field."""
    s = make_ring_network(**C5_RING)
    path = str(tmp_path / "c5-pmexport.txt")
    write_pm_export(path, s)
    t, j = from_pm(load_pm(path)), jfrom_pm(jload_pm(path))
    assert (t.n_img, t.n_op, t.n_obs) == (s.n_img, s.n_op, s.n_obs)
    for r in (t, j):
        r.dist_model = 3
        r.est_io[:, [0, 1, 2, 5, 6, 7, 8, 9]] = True
    same_data(t, j, "Project")
    ts, js = build_serial(t), jbuild_serial(j)
    same_data(ts, js, "SerialSpec")
    assert ts.n_x == 8 + 6 * s.n_img + 3 * int((~s.is_ctrl).sum())


def test_pm_export_writer_is_the_jax_tests_writer(tmp_path):
    from test_pm_fullscale import write_pm_export as jwrite_pm_export

    s = make_ring_network(**{**RING, "est_io_cols": ("cc", "K1")})
    a, b = tmp_path / "port.txt", tmp_path / "jax.txt"
    write_pm_export(str(a), s)
    jwrite_pm_export(str(b), s)
    assert a.read_bytes() == b.read_bytes()

