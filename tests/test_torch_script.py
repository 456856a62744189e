"""Port parity: the DBAT script runner of dbat_tpu_torch
(pipeline/script.py run_script, device="cpu") against dbat_tpu's on
the same script folder.

A 12-image self-calibrating ring network (24 of its 300 points are
control points, so every image sees enough of them to be resected) is
made from a seed, perturbed, and written once as a script folder by
port_script_folder.write_script_folder (camera file, image table, image
points, control points, prior EO table, all printed with %.17g).  Two
scripts run on it: spatial resection then forward intersection, and
pose-graph initialisation then the reprojection screen; each on the
dense and the Schur backend.  Both packages run the script with its
f64 bundle and write the report, IO, EO and residual files.

Held: ok and iterations equal; sigma0 to 1e-9 relative; the final x to
1e-8 of its largest entry; the EO file and the residual file
numerically to 1e-8 (each EO column relative to its largest entry;
the residual file's 6-digit numbers through compare_reports, which
adds the printed precision); the report through the port's
compare_reports with only the run-to-run keys excluded.  Also: the
ray-count check's error, the <features> input (the script of
tests/test_script_features.py on its rendered images), the <plots>
output, and the path macros."""

import os
import re

import numpy as np
import pytest

from dbat_tpu.pipeline import script as jscript
from dbat_tpu.pipeline.synthetic import make_ring_network as jmake
from dbat_tpu_torch.io.report_compare import compare_reports
from dbat_tpu_torch.pipeline import script as tscript
from dbat_tpu_torch.pipeline.synthetic import make_ring_network, perturb
from port_features import JAX_TEST_NET
from port_script_folder import POSEGRAPH_SCRIPT_OPS, image_major, \
    read_eo_file, write_script_folder
from port_shared import one_thread  # noqa: F401
from test_script_features import SCRIPT as FEATURES_SCRIPT

NET = dict(n_img=12, n_pt=300, rays_per_pt=(3, 9), n_obs_target=1500,
           n_ctrl=24, noise_px=0.1, ip_std_px=0.1,
           est_io_cols=("cc", "px", "py", "K1", "K2", "K3", "P1", "P2"),
           seed=5)
RESECTION_OPS = """\
    <operation min_rays="2">check_ray_count</operation>
    <operation><set_initial_values><io>loaded</io></set_initial_values>
      </operation>
    <operation><set_bundle_estimate_params><io><cc>true</cc><pp>true</pp>
      <K>true</K><P>true</P></io></set_bundle_estimate_params></operation>
    <operation>spatial_resection</operation>
    <operation>forward_intersection</operation>
    <operation>bundle_adjustment</operation>"""
OPS = {"resection": RESECTION_OPS, "pose graph": POSEGRAPH_SCRIPT_OPS}
#: <plots> of the <features> script: every kind, and one unknown kind
PLOT_KINDS = ("image", "image_stats", "op_stats", "coverage", "params",
              "iteration_trace", "no_such_plot")
#: Report keys that change from run to run.
VOLATILE = ("Computation UUID", "version", "Last Bundle Run",
            "Execution times")


def _network():
    s = make_ring_network(**NET)
    perturb(s, eo_pos=0.02, eo_ang=0.004, op_pos=0.02, seed=6)
    return image_major(s)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    base = tmp_path_factory.mktemp("scripts")
    return {name: write_script_folder(_network(), str(base / name), ops)
            for name, ops in OPS.items()}


@pytest.mark.parametrize("backend", ["dense", "schur"])
@pytest.mark.parametrize("init", list(OPS))
def test_script_matches_jax(folders, init, backend, tmp_path):
    xml = folders[init]
    rj = jscript.run_script(xml, backend=backend,
                            output_dir=str(tmp_path / "jax"))
    rt = tscript.run_script(xml, backend=backend, device="cpu",
                            output_dir=str(tmp_path / "port"))
    assert rt.ok and rj.ok and rt.iters == rj.iters
    assert rt.sigma0 == pytest.approx(rj.sigma0, rel=1e-9, abs=0)
    xt, xj = np.asarray(rt.info.final_x), np.asarray(rj.info.final_x)
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-8 * np.abs(xj).max())
    assert [os.path.relpath(p, tmp_path / "port") for p in rt.outputs] == \
        [os.path.relpath(p, tmp_path / "jax") for p in rj.outputs]
    assert set(rt.times) >= {"input", "bundle_adjustment", "report", "eo"}

    def read(side, name):
        return (tmp_path / side / name).read_text()

    labels_t, eo_t = read_eo_file(tmp_path / "port" / "eo.txt")
    labels_j, eo_j = read_eo_file(tmp_path / "jax" / "eo.txt")
    assert labels_t == labels_j and eo_t.shape == (NET["n_img"], 14)
    gap = np.abs(eo_t - eo_j) / np.abs(eo_j).max(axis=0)
    assert gap.max() <= 1e-8, gap.max(axis=0)
    assert np.all(eo_t[:, 8:] > 0)
    assert compare_reports(read("port", "residuals.txt"),
                           read("jax", "residuals.txt"), rtol=1e-8,
                           volatile=("UUID", "Generated by")) == []
    assert compare_reports(read("port", "report.txt"),
                           read("jax", "report.txt"),
                           volatile=VOLATILE) == []
    assert compare_reports(read("port", "camera.xml"),
                           read("jax", "camera.xml"), rtol=1e-8) == []


def _edited(folders, tmp_path, edits):
    """A copy of the resection script with each key of `edits` replaced
    by its value, in the same folder (its inputs resolve through
    $HERE)."""
    src = open(folders["resection"]).read()
    for old, new in edits.items():
        assert old in src
        src = src.replace(old, new)
    path = os.path.join(os.path.dirname(folders["resection"]),
                        f"edited-{tmp_path.name}.xml")
    with open(path, "wt") as fh:
        fh.write(src)
    return path


def test_ray_count_check_fails_like_jax(folders, tmp_path):
    xml = _edited(folders, tmp_path, {'min_rays="2"': 'min_rays="4"'})
    msgs = []
    for run, kw in ((tscript.run_script, {"device": "cpu"}),
                    (jscript.run_script, {})):
        with pytest.raises(ValueError, match="Ray count test failed") as e:
            run(xml, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.fixture(scope="module")
def features_folder(tmp_path_factory):
    """tests/test_script_features.py's folder: its 10 rendered images
    written by plt.imsave, the image table and its <features> script."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from dbat_tpu.features.render import render_network_images

    base = tmp_path_factory.mktemp("features")
    images = render_network_images(jmake(**JAX_TEST_NET), seed=4)
    lo, hi = float(images.min()), float(images.max())
    rows = []
    for i, img in enumerate(images):
        p = base / f"img{i:02d}.png"
        plt.imsave(str(p), img, cmap="gray", vmin=lo, vmax=hi)
        rows.append(f"{i + 1},{p}")
    (base / "images.txt").write_text("\n".join(rows) + "\n")
    plots = "".join(f"<plot>{k}</plot>" for k in PLOT_KINDS)
    (base / "script.xml").write_text(FEATURES_SCRIPT.replace(
        "</files>", f"</files>\n    <plots>{plots}</plots>"))
    return base


def test_features_script_matches_jax(features_folder, tmp_path):
    """The <features> input: load_images, detect, describe, match and
    tracks, then pose-graph init, two screens and two bundles; and the
    <plots> output with all six kinds (and one unknown kind, skipped by
    both): the same files, each plot a real figure.  sigma0 is held to
    1e-5 relative: the two front-ends' float32 subpixel positions differ
    by up to 6.1e-5 px (test_torch_features.py), which moves sigma0 by
    1.8e-6 relative."""
    xml = str(features_folder / "script.xml")
    rj = jscript.run_script(xml, output_dir=str(tmp_path / "jax"))
    rt = tscript.run_script(xml, output_dir=str(tmp_path / "port"),
                            device="cpu")
    assert rt.ok and rj.ok and rt.iters == rj.iters
    pt, pj = rt.project, rj.project
    assert (pt.n_img, pt.n_op, pt.n_obs) == (pj.n_img, pj.n_op, pj.n_obs)
    assert pt.n_op > 0.6 * JAX_TEST_NET["n_pt"]
    assert pt.img_labels == pj.img_labels and pt.img_names == pj.img_names
    np.testing.assert_array_equal(pt.img_ids, pj.img_ids)
    np.testing.assert_array_equal(pt.obs_pt, pj.obs_pt)
    assert rt.sigma0 == pytest.approx(rj.sigma0, rel=1e-5, abs=0)
    assert rt.sigma0 < 1.0
    names = [os.path.relpath(p, tmp_path / "port") for p in rt.outputs]
    assert names == [os.path.relpath(p, tmp_path / "jax")
                     for p in rj.outputs]
    assert names == ["features-report.txt"] + [
        f"plots/{k}.png" for k in PLOT_KINDS[:-1]]
    assert min(os.path.getsize(tmp_path / "port" / n)
               for n in names[1:]) > 5000
    assert set(rt.times) >= {"load_images", "detect", "describe", "match",
                             "tracks", "input", "pose_graph_init",
                             "bundle_adjustment", "report", "plots"}


def test_features_input_with_control_points_is_refused(folders, tmp_path):
    xml = _edited(folders, tmp_path, {
        '<image_pts><file format="im,id,x,y,sxy">image_pts.txt'
        '</file></image_pts>': '<features detector="blob"/>'})
    for run, kw in ((tscript.run_script, {"device": "cpu"}),
                    (jscript.run_script, {})):
        with pytest.raises(ValueError, match="no point ids"):
            run(xml, **kw)


def test_a_failing_plot_warns_and_the_script_goes_on(folders, tmp_path,
                                                    monkeypatch):
    from dbat_tpu_torch import plotting

    def broken(*_a, **_k):
        raise RuntimeError("no figure")

    monkeypatch.setattr(plotting, "plot_params", broken)
    xml = _edited(folders, tmp_path, {
        "</files>": "</files>\n    <plots><plot>params</plot>"
                    "<plot>coverage</plot></plots>"})
    with pytest.warns(UserWarning, match="plot params failed: no figure"):
        r = tscript.run_script(xml, device="cpu",
                               output_dir=str(tmp_path / "port"))
    assert r.ok and [os.path.basename(p) for p in r.outputs][-1:] == \
        ["coverage.png"]
    r = tscript.run_script(xml, device="cpu", write_outputs=False)
    assert r.ok and r.outputs == []


@pytest.mark.parametrize("drop", ["bundle", "files"])
def test_plots_without_a_bundle_or_a_folder_run_as_in_jax(folders, tmp_path,
                                                         drop):
    """<plots> acts only after a bundle, and only where the outputs have
    a folder; without either, both packages run the script and write
    nothing."""
    plots = "<plots><plot>image_stats</plot></plots>"
    if drop == "bundle":
        edits = {"<operation>bundle_adjustment</operation>": "",
                 "</files>": "</files>\n    " + plots}
    else:
        src = open(folders["resection"]).read()
        edits = {re.search(r"<files.*</files>", src, flags=re.S)[0]: plots}
    xml = _edited(folders, tmp_path, edits)
    rt = tscript.run_script(xml, device="cpu")
    rj = jscript.run_script(xml)
    assert (rt.ok, rt.iters, rt.outputs) == (rj.ok, rj.iters, rj.outputs)
    assert rt.ok is (None if drop == "bundle" else True)
    assert rt.outputs == []


@pytest.mark.parametrize("path,base", [
    ("$HERE/a.txt", ""), ("b/c.txt", "/base"), ("c.txt", ""),
    ("/abs/d.txt", "/base"), ("$HOME/e.txt", "/base"),
    ("$DBAT/data/f.txt", "/base")])
def test_path_macros(monkeypatch, tmp_path, path, base):
    monkeypatch.setattr(jscript, "DBAT_ROOT", str(tmp_path / "dbat"))
    monkeypatch.setenv(tscript.DBAT_ROOT_ENV, str(tmp_path / "dbat"))
    got = tscript._resolve(path, base, "/doc")
    assert got == jscript._resolve(path, base, "/doc")


def test_dbat_macro_needs_its_root(monkeypatch):
    monkeypatch.delenv(tscript.DBAT_ROOT_ENV, raising=False)
    with pytest.raises(ValueError, match=tscript.DBAT_ROOT_ENV):
        tscript._resolve("$DBAT/x.txt", "", "/doc")
