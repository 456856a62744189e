"""Port parity: the PhotoScan lens-calibration input of dbat_tpu_torch
(io/lnz.py load_lnz, lnz_to_project) against dbat_tpu's, and the CPU
bundle on the project it gives against the JAX package's bundle.

The .lnz is built here with numpy only: a planar 6x6 chessboard seen
by a ring of 6 cameras (the layout of tests/test_lnz.py make_lnz),
corners projected by the pinhole model, given 0.05 px of noise made
from a seed (so that sigma0 is set by the noise, not by rounding) and
written with 6 decimals.
Held: load_lnz exactly; lnz_to_project exactly but for the EO angles,
which the port decomposes with numpy (decompose_w2c_np) where the JAX
package calls its jnp function (1e-15 rad); the f64 bundle (camera
constant from 7.1 mm) with ok and iterations equal, sigma0 and the
final x to 1e-9 relative, and the focal recovered to 0.01 mm."""

import zipfile

import numpy as np
import pytest

from dbat_tpu.io import lnz as jlnz
from dbat_tpu.solve.bundle import bundle as jbundle
from dbat_tpu_torch.io import lnz as tlnz
from dbat_tpu_torch.pipeline.synthetic import _look_at_w2c_np
from dbat_tpu_torch.solve.bundle import bundle
from port_shared import one_thread, same_data  # noqa: F401


def make_lnz(path, n_img=6, grid=6, focal=7.0, im=(2000, 1500),
             sensor=(8.0, 6.0), noise_px=0.05, seed=2):
    """A synthetic .lnz: a planar target in [0,1]^2 viewed by a camera
    ring, camera-to-world transforms with PhotoScan's axis flip."""
    rng = np.random.default_rng(seed)
    xres, yres = im[0] / sensor[0], im[1] / sensor[1]
    px = 1.0 / yres
    pp = np.array([sensor[0] / 2, -sensor[1] / 2])
    g = np.linspace(0.0, 1.0, grid)
    gx, gy = np.meshgrid(g, g)
    targets = np.stack([gx.ravel(), gy.ravel()], axis=1)
    D = np.diag([1.0, -1.0, -1.0, 1.0])
    xml = ['<?xml version="1.0" encoding="UTF-8"?>', "<document>",
           "  <group>"]
    for i in range(n_img):
        a = 2 * np.pi * i / n_img
        C = np.array([0.5 + 1.5 * np.cos(a), 0.5 + 1.5 * np.sin(a), 2.5])
        M = _look_at_w2c_np(C[None], np.array([0.5, 0.5, 0.0]))[0]
        Pm = np.vstack([np.hstack([M, (-M @ C)[:, None]]), [0, 0, 0, 1.0]])
        T = np.linalg.inv(Pm) @ np.linalg.inv(D)
        xml.append("    <photo>")
        xml.append("      <transform>" + " ".join(
            f"{v:.17g}" for v in T.reshape(-1)) + "</transform>")
        xml.append(f'      <location path="img{i}.jpg"/>')
        xml.append("      <meta>")
        for k, v in (("width", im[0]), ("height", im[1]),
                     ("flength", focal), ("fplane_xres", xres),
                     ("fplane_yres", yres)):
            xml.append(f'        <property name="{k}" value="{v}"/>')
        xml.append("      </meta>")
        for ox, oy in targets:
            pc = M @ (np.array([ox, oy, 0.0]) - C)
            u_mm = -focal * pc[:2] / pc[2] + pp
            u = np.array([u_mm[0], -u_mm[1]]) / px \
                + rng.normal(0.0, noise_px, 2)
            xml.append(
                f'      <corner img_x="{u[0]:.6f}" img_y="{u[1]:.6f}" '
                f'obj_x="{ox}" obj_y="{oy}" valid="true"/>')
        xml.append("    </photo>")
    xml += ["  </group>", "</document>"]
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("doc.xml", "\n".join(xml))


@pytest.fixture(scope="module")
def lnz_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("lnz") / "cal.lnz"
    make_lnz(str(path))
    return str(path)


def test_load_lnz_matches_jax(lnz_path):
    t = tlnz.load_lnz(lnz_path)
    same_data(t, jlnz.load_lnz(lnz_path), "LnzProject")
    assert len(t.im_names) == 6 and t.ctrl_pts.shape == (36, 3)
    assert t.marks.shape == (6 * 36, 4)


@pytest.mark.parametrize("dist_model", [3, 1])
def test_lnz_to_project_matches_jax(lnz_path, dist_model):
    t = tlnz.lnz_to_project(tlnz.load_lnz(lnz_path), dist_model=dist_model)
    j = jlnz.lnz_to_project(jlnz.load_lnz(lnz_path), dist_model=dist_model)
    assert np.abs(t.eo[:, 3:] - j.eo[:, 3:]).max() <= 1e-15
    assert np.abs(t.prior_eo_val[:, 3:] - j.prior_eo_val[:, 3:]).max() \
        <= 1e-15
    t.eo[:, 3:] = j.eo[:, 3:]
    t.prior_eo_val[:, 3:] = j.prior_eo_val[:, 3:]
    same_data(t, j, "Project")
    # Every IO parameter but skew; aspect only where the model has it.
    assert t.est_io[0].tolist() == [True] * 3 + [dist_model == 3, False] \
        + [True] * 5


def test_lnz_bundle_matches_jax(lnz_path):
    runs = {}
    for name, mod, run in (("port", tlnz, lambda s: bundle(s, device="cpu")),
                           ("jax", jlnz, jbundle)):
        s = mod.lnz_to_project(mod.load_lnz(lnz_path))
        s.set_cam_est("not", "all")
        s.set_cam_est("cc")
        s.io[:, 0] = 7.1
        runs[name] = run(s)
    (rt, ok_t, it_t, s0_t, info_t), (rj, ok_j, it_j, s0_j, info_j) = (
        runs["port"], runs["jax"])
    assert ok_t and (ok_t, it_t) == (ok_j, it_j)
    assert abs(s0_t / s0_j - 1) <= 1e-9
    xt, xj = np.asarray(info_t.final_x), np.asarray(info_j.final_x)
    assert np.abs(xt - xj).max() <= 1e-9 * np.abs(xj).max()
    assert rt.io[0, 0] == pytest.approx(7.0, abs=0.01)  # 0.05 px of noise
