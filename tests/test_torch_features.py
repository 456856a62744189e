"""Port parity: the feature front-end of dbat_tpu_torch (features/,
device="cpu") against dbat_tpu's, and the port's PNG reader against
matplotlib.

The JAX tests' network (tests/test_features.py): 10 images of 800x600
px, 80 coded targets, rendered with seed 4; each package renders, and
each JAX stage runs, once per module.  Every port stage takes the JAX
stage's inputs, so each comparison isolates one stage.

Tolerances (float32 on both sides, sums in another order):
  * detect (blobs and corners): valid masks equal; xy within 1e-4 px
    on valid slots (the 3x3 subpixel fit divides differences of
    neighbouring responses: 6.1e-5 px seen); scores within 1e-5
    relative (1e-6 seen);
  * refine_centroid: 1e-4 px (3.1e-5 seen);
  * the border median: equal to jnp.median bit for bit, even and odd
    counts;
  * describe: 1e-6 (9e-8 seen);
  * match_all_pairs and match_pair: the same pairs and slots,
    similarity within 1e-6;
  * build_tracks and project_from_tracks: equal;
  * network_from_images: equal counts and observation structure, ip_px
    within 1e-4 px;
  * load_images: bit for bit equal to matplotlib.image.imread and to
    the JAX package's load_images."""

import importlib

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.image as mpimg  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dbat_tpu.features.pipeline import load_images as jload_images  # noqa
from dbat_tpu.features.pipeline import network_from_images as jnetwork
from dbat_tpu.features.render import render_network_images as jrender
from dbat_tpu.features.tracks import build_tracks as jbuild_tracks
from dbat_tpu.features.tracks import project_from_tracks as jproject
from dbat_tpu.pipeline.synthetic import make_ring_network as jmake
from dbat_tpu_torch.features.pipeline import load_images, \
    network_from_images
from dbat_tpu_torch.features.render import render_network_images
from dbat_tpu_torch.features.tracks import build_tracks, \
    project_from_tracks
from dbat_tpu_torch.io.png import UnsupportedImage, read_png
from dbat_tpu_torch.pipeline.synthetic import make_ring_network
from port_features import JAX_TEST_NET, card_vs_cpu, detection_stats, \
    features_script, same_matches, write_png
from port_shared import port_project, same_data
from port_shared import one_thread  # noqa: F401

jdet, jdesc, jmatch = (importlib.import_module(f"dbat_tpu.features.{m}")
                       for m in ("detect", "describe", "match"))
tdet, tdesc, tmatch = (importlib.import_module(f"dbat_tpu_torch.features.{m}")
                       for m in ("detect", "describe", "match"))

NET = JAX_TEST_NET
MAX_KP = 256
XY_TOL = 1e-4
SCORE_RTOL = 1e-5
DESC_TOL = 1e-6
SIM_TOL = 1e-6


@pytest.fixture(scope="module")
def images():
    return jrender(jmake(**NET), seed=4)


@pytest.fixture(scope="module")
def jax_stages(images):
    """The JAX package's detect (blobs), describe and match, once."""
    xy, score, valid = (np.asarray(a) for a in
                        jdet.detect_blobs(images, max_kp=MAX_KP))
    desc = np.asarray(jdesc.describe(images, xy, valid))
    matches = jmatch.match_all_pairs(desc, valid)
    return {"xy": xy, "score": score, "valid": valid, "desc": desc,
            "matches": matches}


def test_render_equals_jax(images):
    np.testing.assert_array_equal(
        render_network_images(make_ring_network(**NET), seed=4), images)


def _same_detections(j, t):
    (xj, sj, vj), (xt, st, vt) = j, t
    np.testing.assert_array_equal(vt, vj)
    assert vj.any()
    np.testing.assert_allclose(xt[vj], xj[vj], rtol=0, atol=XY_TOL)
    np.testing.assert_allclose(st[vj], sj[vj], rtol=SCORE_RTOL, atol=0)
    np.testing.assert_array_equal(st[~vj], 0.0)


@pytest.mark.parametrize("kind", ["blobs", "corners"])
def test_detect_matches_jax(images, jax_stages, kind):
    if kind == "blobs":
        j = tuple(jax_stages[k] for k in ("xy", "score", "valid"))
    else:
        j = tuple(np.asarray(a) for a in
                  jdet.detect_corners(images, max_kp=MAX_KP))
    t = tuple(a.numpy() for a in getattr(tdet, f"detect_{kind}")(
        images, max_kp=MAX_KP, device="cpu"))
    assert t[0].dtype == np.float32 and t[2].dtype == bool
    _same_detections(j, t)


@pytest.mark.parametrize("radius", [12, 6])
def test_refine_centroid_matches_jax(images, jax_stages, radius):
    xy, valid = jax_stages["xy"], jax_stages["valid"]
    rj = jdet.refine_centroid(images, xy, valid, radius=radius)
    rt = tdet.refine_centroid(images, xy, valid, radius=radius,
                              device="cpu").numpy()
    np.testing.assert_allclose(rt, rj, rtol=0, atol=XY_TOL)
    assert np.abs(rt - xy)[valid].max() > 0.01  # it moved the points
    np.testing.assert_array_equal(rt[~valid], xy[~valid])


@pytest.mark.parametrize("count", [100, 52, 7])
def test_median_is_jnp_median(count):
    """An even count averages the two middle samples (jnp.median), where
    torch.median returns the lower one; 100 = 4 (2*12 + 1), the border of
    the default window."""
    rng = np.random.default_rng(count)
    s = rng.standard_normal((64, count)).astype(np.float32)
    got = tdet._median(torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.median(s, axis=1)))
    lower = torch.median(torch.from_numpy(s), dim=1).values.numpy()
    assert np.array_equal(got, lower) == (count % 2 == 1)


def test_peak_in_the_last_row_and_column():
    """Peaks of the response on the image's last row and column (border
    0): the 3x3 fit window is clamped into the image, as
    lax.dynamic_slice clamps it; and blobs at the image's edge through
    the whole detector."""
    rng = np.random.default_rng(7)
    R = rng.random((40, 50)).astype(np.float32)
    peaks = ((39, 49), (39, 20), (15, 49))
    for r, c in peaks:
        R[r, c] = 10.0 + r / 40
        R[r - 1, c] = 5.0 + c / 50
        R[r, c - 1] = 6.0
    j = tuple(np.asarray(a) for a in jdet._select_peaks(
        jnp.asarray(R), 8, 4, 0.15, 0))
    t = tuple(a[0].numpy() for a in tdet._select_peaks(
        torch.from_numpy(R)[None], 8, 4, 0.15, 0))
    _same_detections(j, t)
    assert j[2][:3].all()
    assert sorted(j[1][:3]) == sorted(R[r, c] for r, c in peaks)

    img = 0.01 * rng.standard_normal((2, 40, 50)).astype(np.float32)
    img[0, -1, -1] += 1.0
    img[1, -1, 20] += 1.0
    img[1, 15, -1] += 1.0
    j = tuple(np.asarray(a) for a in
              jdet.detect_blobs(img, max_kp=8, border=0))
    t = tuple(a.numpy() for a in
              tdet.detect_blobs(img, max_kp=8, border=0, device="cpu"))
    _same_detections(j, t)
    at_edge = (np.rint(j[0][..., 0]) >= 49) | (np.rint(j[0][..., 1]) >= 39)
    assert (at_edge & j[2]).sum() == 3


def test_describe_matches_jax(images, jax_stages):
    xy, valid = jax_stages["xy"], jax_stages["valid"]
    dt = tdesc.describe(images, xy, valid, device="cpu").numpy()
    np.testing.assert_allclose(dt, jax_stages["desc"], rtol=0,
                               atol=DESC_TOL)
    np.testing.assert_array_equal(dt[~valid], 0.0)


def test_match_all_pairs_matches_jax(jax_stages):
    desc, valid = jax_stages["desc"], jax_stages["valid"]
    assert same_matches(tmatch.match_all_pairs(desc, valid, device="cpu"),
                        jax_stages["matches"], SIM_TOL)
    assert len(jax_stages["matches"]) > 20
    pairs = np.array([[3, 1], [0, 9], [2, 5]])
    want = jmatch.match_all_pairs(desc, valid, pairs=pairs, ratio=0.8)
    assert len(want) > 0
    assert same_matches(
        tmatch.match_all_pairs(desc, valid, pairs=pairs, ratio=0.8,
                               device="cpu"), want, SIM_TOL)
    for i, j in ((0, 1), (4, 2)):
        got = tmatch.match_pair(desc[i], valid[i], desc[j], valid[j],
                                device="cpu")
        want = jmatch.match_pair(desc[i], valid[i], desc[j], valid[j])
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_tracks_and_project_equal_jax(jax_stages):
    m, xy = jax_stages["matches"], jax_stages["xy"]
    tt = build_tracks(m, NET["n_img"], MAX_KP, min_views=3)
    tj = jbuild_tracks(m, NET["n_img"], MAX_KP, min_views=3)
    assert len(tj) > 0.7 * NET["n_pt"]
    same_data(tt, tj)
    kw = dict(focal=7.0, sensor=(8.0, 6.0), im_size=(800, 600),
              ip_std_px=0.2, est_io_cols=("cc", "K1", 8))
    same_data(project_from_tracks(tt, xy, **kw),
              port_project(jproject(tj, xy, **kw)))


def test_detection_meets_the_jax_tests_gates(images):
    """tests/test_features.py's accuracy gates on the port's detections
    (port_features.detection_stats, which chip_smoke.py applies at the
    camcal shape)."""
    xy, _s, valid = (a.numpy() for a in tdet.detect_blobs(
        images, max_kp=MAX_KP, device="cpu"))
    found, total, errs = detection_stats(make_ring_network(**NET), xy,
                                         valid)
    assert found > 0.9 * total
    assert np.median(errs) < 0.15 and errs.mean() < 0.3


def test_shared_script_and_comparison():
    """port_features' script is tests/test_script_features.py's at its
    camera, and card_vs_cpu finds no gap between two CPU runs."""
    from test_script_features import SCRIPT

    assert features_script((8.0, 6.0), (800, 600), 7.0) == SCRIPT
    rng = np.random.default_rng(5)
    img = jrender(jmake(**{**NET, "n_img": 3}), seed=1)
    gap = card_vs_cpu(img + 0.001 * rng.standard_normal(img.shape,
                                                        np.float32),
                      "cpu", 64)
    assert gap == {"valid_equal": True, "xy_err": 0.0, "desc_err": 0.0,
                   "n_matches": gap["n_matches"], "n_differ": 0}
    assert gap["n_matches"] > 50


def test_network_from_images_matches_jax(images):
    pj, ej = jnetwork(images, focal=7.0, sensor=(8.0, 6.0), ip_std_px=0.1)
    pt, et = network_from_images(images, focal=7.0, sensor=(8.0, 6.0),
                                 ip_std_px=0.1, device="cpu")
    assert (pt.n_img, pt.n_op, pt.n_obs) == (pj.n_img, pj.n_op, pj.n_obs)
    assert pj.n_op > 0.7 * NET["n_pt"]
    np.testing.assert_array_equal(pt.obs_img, pj.obs_img)
    np.testing.assert_array_equal(pt.obs_pt, pj.obs_pt)
    np.testing.assert_allclose(pt.ip_px, pj.ip_px, rtol=0, atol=XY_TOL)
    np.testing.assert_array_equal(et["valid"], ej["valid"])
    assert set(et["times"]) == {"detect", "describe", "match", "tracks"}


def test_network_with_centroid_refinement_matches_jax(images):
    kw = dict(focal=7.0, sensor=(8.0, 6.0), refine_radius=6)
    pj, _ = jnetwork(images, **kw)
    pt, _ = network_from_images(images, device="cpu", **kw)
    assert (pt.n_op, pt.n_obs) == (pj.n_op, pj.n_obs)
    np.testing.assert_allclose(pt.ip_px, pj.ip_px, rtol=0, atol=XY_TOL)


# --- load_images: PNG without matplotlib ----------------------------------

#: (bit depth, samples per pixel): gray, gray + alpha, RGB, RGBA
FORMATS = [(d, c) for d in (8, 16) for c in (1, 2, 3, 4)]


@pytest.mark.parametrize("depth,ch", FORMATS,
                         ids=[f"{d}bit-{c}ch" for d, c in FORMATS])
def test_read_png_equals_imread_with_every_filter(tmp_path, depth, ch):
    rng = np.random.default_rng(depth * 10 + ch)
    shape = (23, 31) if ch == 1 else (23, 31, ch)
    px = rng.integers(0, 2 ** depth, shape)
    path = tmp_path / "x.png"
    write_png(path, px, depth=depth, filters=(0, 1, 2, 3, 4))
    got = read_png(path)
    want = mpimg.imread(path)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_load_images_equals_matplotlib_and_jax(tmp_path, images):
    """plt.imsave (8-bit RGBA, Pillow's adaptive filters) and Pillow's
    8- and 16-bit gray files."""
    from PIL import Image

    lo, hi = float(images.min()), float(images.max())
    paths = []
    for i in range(3):
        p = tmp_path / f"rgba{i}.png"
        plt.imsave(p, images[i], cmap="gray", vmin=lo, vmax=hi)
        paths.append(p)
    v = (images[3:6] - lo) / (hi - lo)
    for i, g in enumerate(v):
        for name, arr in (("g8", (g * 255).astype(np.uint8)),
                          ("g16", (g * 65535).astype(np.uint16))):
            p = tmp_path / f"{name}-{i}.png"
            Image.fromarray(arr).save(p)
            paths.append(p)
    for p in paths:
        np.testing.assert_array_equal(read_png(p), mpimg.imread(p))
    got = load_images(paths)
    assert got.shape == (len(paths), 600, 800) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jload_images(paths))


def test_other_formats_go_through_matplotlib(tmp_path, monkeypatch):
    from PIL import Image

    rng = np.random.default_rng(1)
    arr = rng.integers(0, 256, (12, 9, 3)).astype(np.uint8)
    p = tmp_path / "x.tif"
    Image.fromarray(arr).save(p)
    with pytest.raises(UnsupportedImage):
        read_png(p)
    np.testing.assert_array_equal(load_images([p]), jload_images([p]))
    monkeypatch.setitem(__import__("sys").modules, "matplotlib.image", None)
    with pytest.raises(ValueError, match="x.tif"):
        load_images([p])


def test_load_images_refuses_mixed_sizes(tmp_path):
    write_png(tmp_path / "a.png", np.zeros((4, 5), np.uint8))
    write_png(tmp_path / "b.png", np.zeros((5, 4), np.uint8))
    with pytest.raises(ValueError, match="differ in size"):
        load_images([tmp_path / "a.png", tmp_path / "b.png"])
