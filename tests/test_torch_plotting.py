"""Port parity: the plotting layer of dbat_tpu_torch (plotting/plots.py)
against dbat_tpu's.

One small self-calibrating ring network (four control points, so the
network plots draw both markers), perturbed, is bundled with trace=True
by each package in f64 on the CPU; each package then draws every figure
from its own result.  Held: the data each figure draws (line and 3D
line data, bar rectangles, filled polygons, scatter offsets, axis
labels and titles) equal within DATA_TOL = 1e-10 of the largest value
of each array (1.4e-11 seen, in the image statistics' posterior std),
and each saved file larger than 5000 bytes; for the playback GIF, the
frame count and the iteration states it draws."""

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
from matplotlib.patches import Rectangle  # noqa: E402

from dbat_tpu import plotting as jplot  # noqa: E402
from dbat_tpu.pipeline.synthetic import make_ring_network as jmake
from dbat_tpu.pipeline.synthetic import perturb as jperturb
from dbat_tpu.solve.bundle import bundle as jbundle
from dbat_tpu_torch import plotting as tplot
from dbat_tpu_torch.plotting import plots as tplots
from dbat_tpu_torch.solve.bundle import bundle as tbundle
from port_shared import port_project
from port_shared import one_thread  # noqa: F401

NET = dict(n_img=8, n_pt=60, rays_per_pt=(3, 6), n_ctrl=4, noise_px=0.1,
           ip_std_px=0.1, est_io_cols=("cc", "px", "py", "K1", "P1"),
           seed=9)
DATA_TOL = 1e-10


@pytest.fixture(scope="module")
def solved():
    j = jmake(**NET)
    jperturb(j, eo_pos=0.01, eo_ang=0.002, op_pos=0.01, seed=2)
    t = port_project(j)
    pj, okj, _it, _s0, ij = jbundle(j, damping="gna", trace=True)
    pt, okt, _it, _s0, it = tbundle(t, damping="gna", trace=True,
                                    dtype=torch.float64, device="cpu")
    assert okj and okt and ij.trace.shape == it.trace.shape
    assert ij.trace.shape[1] >= 3
    return (pj, ij), (pt, it)


def figure_data(fig):
    """Everything a figure draws, axis by axis, as a flat list."""
    out = []
    for ax in fig.axes:
        out.append((ax.get_title(), ax.get_xlabel(), ax.get_ylabel()))
        for ln in ax.get_lines():
            out.append(np.asarray(ln.get_data_3d() if hasattr(
                ln, "get_data_3d") else ln.get_xydata(), float))
        for p in ax.patches:
            out.append(np.array([p.get_x(), p.get_y(), p.get_width(),
                                 p.get_height()])
                       if isinstance(p, Rectangle)
                       else np.asarray(p.get_path().vertices, float))
        for c in ax.collections:
            out.append(np.asarray(c._offsets3d, float)
                       if hasattr(c, "_offsets3d")
                       else np.asarray(c.get_offsets(), float))
    return out


def same_figure(ft, fj):
    dt, dj = figure_data(ft), figure_data(fj)
    assert len(dt) == len(dj) and len(dj) > 1
    n_arrays = 0
    for a, b in zip(dt, dj):
        if isinstance(b, tuple):
            assert a == b
            continue
        n_arrays += 1
        assert a.shape == b.shape
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        scale = max(np.nanmax(np.abs(b), initial=0.0), 1e-300)
        np.testing.assert_allclose(a, b, rtol=0, atol=DATA_TOL * scale)
    assert n_arrays > 0


#: (name, call): each of the figures run_script's <plots> draws, and
#: the network plots' trace and align options
PLOTS = {
    "image": lambda m, p, i, f: m.plot_images(p, 1, save=f),
    "image_stats": lambda m, p, i, f: m.plot_image_stats(p, i, save=f),
    "op_stats": lambda m, p, i, f: m.plot_op_stats(p, i, max_op=40,
                                                   save=f),
    "coverage": lambda m, p, i, f: m.plot_coverage(p, convex_hull=True,
                                                   save=f),
    "params": lambda m, p, i, f: m.plot_params(p, i, save=f),
    "iteration_trace": lambda m, p, i, f: m.plot_network(
        p, i, iteration=-1, cam_size=0.2, save=f),
    "network_iteration_0_aligned": lambda m, p, i, f: m.plot_network(
        p, i, iteration=0, align=2, save=f),
}


@pytest.mark.parametrize("name", list(PLOTS))
def test_plot_matches_jax(solved, tmp_path, name):
    (pj, ij), (pt, it) = solved
    fj = PLOTS[name](jplot, pj, ij, tmp_path / "jax.png")
    ft = PLOTS[name](tplot, pt, it, tmp_path / "port.png")
    same_figure(ft, fj)
    assert (tmp_path / "port.png").stat().st_size > 5000


def test_network_playback_matches_jax(solved, tmp_path):
    (pj, ij), (pt, it) = solved
    n = tplot.plot_network_playback(pt, it, save=tmp_path / "net.gif")
    assert n == it.trace.shape[1]
    assert (tmp_path / "net.gif").stat().st_size > 5000
    from dbat_tpu.plotting import plots as jplots

    for k in range(n):
        for a, b in zip(tplots._iteration_state(pt, it, k),
                        jplots._iteration_state(pj, ij, k)):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=DATA_TOL * np.abs(b).max())
