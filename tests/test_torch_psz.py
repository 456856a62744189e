"""Port parity: the PhotoScan input of dbat_tpu_torch (io/psz.py
write_psz, load_psz, psz_to_pm; pipeline/demos.py ps_postproc with
device="cpu") against dbat_tpu's.

A 12-image ring network made from a seed is written as a .psz by both
packages, without and with a local->global similarity (L2G): every
archive member (doc.xml, points0.ply, the projection PLYs) is held
byte-equal.  load_psz is held exactly, and psz_to_pm exactly but for
the images' angles, which the port decomposes with numpy
(decompose_w2c_np) where the JAX package calls its jnp function: to
1e-15 rad.  ps_postproc runs on one .psz in both packages, without
and with ray/angle filtering and with stats_dir: ok and iterations
equal, sigma0 and the final x to 1e-9 relative, the statistics files
equal line for line but for their execution time stamp."""

import zipfile

import numpy as np
import pytest

from dbat_tpu.io import psz as jpsz
from dbat_tpu.pipeline import demos as jdemos
from dbat_tpu_torch.io import psz as tpsz
from dbat_tpu_torch.pipeline import demos as tdemos
from dbat_tpu_torch.pipeline.synthetic import make_ring_network
from port_pm_export import SMALL_PSZ as RING, similarity
from port_shared import one_thread, same_data  # noqa: F401

@pytest.fixture(scope="module")
def psz_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("psz") / "ring.psz"
    tpsz.write_psz(str(path), make_ring_network(**RING), L2G=similarity())
    return str(path)


@pytest.mark.parametrize("with_l2g", [False, True])
def test_write_psz_is_byte_equal(tmp_path, with_l2g):
    s = make_ring_network(**RING)
    L2G = similarity() if with_l2g else None
    a, b = tmp_path / "port.psz", tmp_path / "jax.psz"
    tpsz.write_psz(str(a), s, L2G=L2G)
    jpsz.write_psz(str(b), s, L2G=L2G)
    za, zb = zipfile.ZipFile(a), zipfile.ZipFile(b)
    assert za.namelist() == zb.namelist()
    assert len(za.namelist()) == 2 + RING["n_img"]
    for name in zb.namelist():
        assert za.read(name) == zb.read(name), name


@pytest.mark.parametrize("use_semilocal", [False, True])
def test_load_psz_and_psz_to_pm_match_jax(psz_path, use_semilocal):
    a, b = tpsz.load_psz(psz_path), jpsz.load_psz(psz_path)
    same_data(a, b, "PszProject")
    pa = tpsz.psz_to_pm(a, use_semilocal=use_semilocal)
    pb = jpsz.psz_to_pm(b, use_semilocal=use_semilocal)
    ang_a = np.stack([im.outer[3:] for im in pa.images]) * np.pi / 180
    ang_b = np.stack([im.outer[3:] for im in pb.images]) * np.pi / 180
    assert np.abs(ang_a - ang_b).max() <= 1e-15
    for ia, ib in zip(pa.images, pb.images):
        ia.outer[3:] = ib.outer[3:]
    same_data(pa, pb, "PmProject")
    assert len(pa.images) == RING["n_img"]
    assert len(pa.mark_pts) == RING["n_obs_target"]


def test_load_psz_reads_the_written_network(psz_path):
    s = make_ring_network(**RING)
    psz = tpsz.load_psz(psz_path)
    assert len(psz.camera_ids) == s.n_img
    assert len(psz.obj_pts) == s.n_op - RING["n_ctrl"]
    assert len(psz.obj_marks) + len(psz.ctrl_marks) == s.n_obs
    np.testing.assert_allclose(psz.L2G, similarity(), atol=1e-12)
    assert psz.camera.is_adjusted


@pytest.mark.parametrize("filt", [dict(), dict(min_rays=4, min_angle=10.0)],
                         ids=["unfiltered", "filtered"])
def test_ps_postproc_matches_jax(psz_path, tmp_path, filt):
    dirs = {k: tmp_path / k for k in ("port", "jax")}
    for d in dirs.values():
        d.mkdir()
    rt = tdemos.ps_postproc(file_name=psz_path, stats_dir=str(dirs["port"]),
                            device="cpu", **filt)
    rj = jdemos.ps_postproc(file_name=psz_path, stats_dir=str(dirs["jax"]),
                            **filt)
    (pt, ok_t, it_t, s0_t, info_t), (pj, ok_j, it_j, s0_j, info_j) = rt, rj
    assert (ok_t, it_t) == (ok_j, it_j)
    assert ok_t
    assert abs(s0_t / s0_j - 1) <= 1e-9
    xt, xj = np.asarray(info_t.final_x), np.asarray(info_j.final_x)
    assert np.abs(xt - xj).max() <= 1e-9 * np.abs(xj).max()
    assert pt.n_op == pj.n_op and pt.n_obs == pj.n_obs
    if filt:
        assert pt.n_op < make_ring_network(**RING).n_op
    names = sorted(p.name for p in dirs["jax"].iterdir())
    assert names == ["ring-psstats-postfilt.txt", "ring-psstats-prefilt.txt"]
    assert sorted(p.name for p in dirs["port"].iterdir()) == names
    for name in names:
        a, b = ((dirs[k] / name).read_text().splitlines()
                for k in ("port", "jax"))
        assert len(a) == len(b), name
        for la, lb in zip(a, b):
            if lb.startswith("Execution time stamp:"):
                continue
            assert la == lb, name
