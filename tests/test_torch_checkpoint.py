"""Port parity: checkpoints of dbat_tpu_torch (core/checkpoint.py) and
dbat_tpu share one .npz layout, and a traced port bundle replays.

A ring network made from a seed is saved by each package and loaded by
the other: every Project field comes back exactly.  A traced f64
bundle (device="cpu") runs in both packages on the same network:
apply_iteration at every recorded iteration matches the JAX package's
on its own trace to 1e-9 of the largest value, the last iteration
gives the bundle's result exactly, and resume_x is the trace column."""

import numpy as np
import pytest

from dbat_tpu.core import checkpoint as jckpt
from dbat_tpu.solve.bundle import bundle as jbundle
from dbat_tpu_torch.core import checkpoint as tckpt
from dbat_tpu_torch.pipeline.synthetic import make_ring_network, perturb
from dbat_tpu_torch.solve.bundle import bundle
from port_shared import one_thread, port_project, same_data  # noqa: F401

NET = dict(n_img=8, n_pt=120, rays_per_pt=(3, 6), n_obs_target=600,
           n_ctrl=5, noise_px=0.1, est_io_cols=("cc", "px", "py"), seed=9)


def _network():
    s = make_ring_network(**NET)
    perturb(s, eo_pos=0.02, eo_ang=0.004, op_pos=0.02, seed=2)
    s.x0desc = "checkpoint test"
    return s


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_files_cross_packages(tmp_path, writer):
    s = _network()
    path = str(tmp_path / "p.npz")
    save, load = ((tckpt.save_project, jckpt.load_project) if writer == "port"
                  else (jckpt.save_project, tckpt.load_project))
    save(path, s)
    back = load(path)
    same_data(port_project(back), s, "Project")
    # The port's own round trip too.
    tckpt.save_project(str(tmp_path / "q.npz"), back)
    same_data(tckpt.load_project(str(tmp_path / "q.npz")), s, "Project")


def test_apply_iteration_replays_a_traced_port_bundle():
    start = _network()
    pt, ok_t, it_t, _s0, info_t = bundle(start.copy(), trace=True,
                                         device="cpu")
    pj, ok_j, it_j, _s0j, info_j = jbundle(start.copy(), trace=True)
    assert ok_t and (ok_t, it_t) == (ok_j, it_j)
    assert info_t.trace.shape == np.asarray(info_j.trace).shape
    for k in range(info_t.trace.shape[1]):
        a = tckpt.apply_iteration(start, info_t, k)
        b = jckpt.apply_iteration(start, info_j, k)
        for name in ("io", "eo", "op"):
            va, vb = getattr(a, name), getattr(b, name)
            assert va.dtype == vb.dtype == np.float64
            assert np.abs(va - vb).max() <= 1e-9 * np.abs(vb).max(), (k,
                                                                      name)
    last = tckpt.apply_iteration(start, info_t)
    for name in ("io", "eo", "op"):
        np.testing.assert_array_equal(getattr(last, name), getattr(pt, name))
    np.testing.assert_array_equal(tckpt.resume_x(info_t, 1),
                                  info_t.trace[:, 1])
    assert last is not start and start.eo is not last.eo
