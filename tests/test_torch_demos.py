"""Port parity: the demo pipelines of dbat_tpu_torch (pipeline/demos.py,
device="cpu") against dbat_tpu's, and the run_all harness's accounting.

`REFERENCE_DATA` is pointed, in both modules, at a folder this test
writes in the shipped layout (dbat/pmexports, dbat/ref,
prague2016/sxb/{pmexports,ref,psprojects}) from 8-image ring networks
made from a seed, every point seen by every image (so that every image
can be resected from the control points):
  * camcal-pmexport.txt: no control table, control points numbered
    above 1000 (as in the shipped file), and camcal-fixed.txt;
    -1ray and -missing-obs variants with one point seen once and one
    image without marks;
  * {f-op0,w-op0,w-op1,wsmart}-no-orient PM exports with a control table, in a
    frame offset from the control files' (prague2016_pm.m shifts the
    files into it), the wsmart-with-orient export in the files' frame,
    fixed and weighted control files and fake-camera-positions.txt
    (label,x,y,z,std);
  * psprojects/sxb.psz written by write_psz (square pixels, as
    PhotoScan's).
Held for every demo: ok, code and iterations equal, sigma0 and the
final x to 1e-9 relative; the rank-deficient error demos: ok, code
and iterations equal (no-datum, 1ray), or the same error (missing-obs:
the unobserved image cannot be resected, so the forward intersection
finds its EO unset, in both packages).  run_all.main runs with the
demos and run_script stubbed: one line per demo, the FAIL count and
the exit code."""

import os

import numpy as np
import pytest

from dbat_tpu.pipeline import demos as jdemos
from dbat_tpu_torch.io.psz import write_psz
from dbat_tpu_torch.pipeline import demos as tdemos
from dbat_tpu_torch.pipeline import run_all
from dbat_tpu_torch.pipeline.synthetic import make_ring_network
from port_pm_export import CAMCAL_RING, camcal_network, \
    write_camcal_folder, write_cpt_file, write_pm_export
from port_shared import one_thread  # noqa: F401

NET = {k: v for k, v in CAMCAL_RING.items() if k != "seed"}
#: The no-orient exports' frame: the control files' minus this offset.
CP_OFFSET = np.array([100.0, -200.0, 5.0])


def _drop_obs(s, keep):
    for name in ("obs_img", "obs_pt", "ip_px", "ip_std_px", "ip_id"):
        setattr(s, name, getattr(s, name)[keep])
    return s


def write_reference_tree(root):
    dbat = os.path.join(root, "dbat")
    sxb = os.path.join(root, "prague2016", "sxb")
    for d in (os.path.join(sxb, "pmexports"), os.path.join(sxb, "ref"),
              os.path.join(sxb, "psprojects")):
        os.makedirs(d)

    # camcal: control points 1001..1008 known only from the cpt file.
    write_camcal_folder(dbat, camcal_network())
    one = camcal_network()
    rays = np.flatnonzero(one.obs_pt == 40)
    write_camcal_folder(dbat, _drop_obs(one, ~np.isin(np.arange(one.n_obs),
                                                      rays[1:])), "-1ray")
    miss = camcal_network()
    write_camcal_folder(dbat, _drop_obs(miss, miss.obs_img != 3),
                        "-missing-obs")

    # sxb: a fixed-IO network with a control table in the export.
    s = make_ring_network(**NET, seed=22)
    write_pm_export(os.path.join(sxb, "pmexports",
                                 "wsmart-with-orient-pmexport.txt"), s)
    write_cpt_file(os.path.join(sxb, "ref", "ctrlpts-fixed.txt"), s)
    write_cpt_file(os.path.join(sxb, "ref", "ctrlpts-weighted.txt"), s,
                   std=0.01)
    shifted = s.copy()
    shifted.op -= CP_OFFSET
    shifted.eo[:, :3] -= CP_OFFSET
    for stub in ("f-op0", "w-op0", "w-op1", "wsmart"):
        write_pm_export(os.path.join(sxb, "pmexports",
                                     f"{stub}-no-orient-pmexport.txt"),
                        shifted)
    rng = np.random.default_rng(23)
    with open(os.path.join(sxb, "ref", "fake-camera-positions.txt"),
              "w") as fh:
        for i in range(s.n_img):
            x, y, z = s.eo[i, :3] + rng.normal(0.0, 0.05, 3)
            fh.write(f"img{i:04d}.jpg,{x:.17g},{y:.17g},{z:.17g},0.05\n")
    write_psz(os.path.join(sxb, "psprojects", "sxb.psz"),
              make_ring_network(**{**NET, "rays_per_pt": (3, 8),
                                   "n_pt": 200}, sensor=(7.2, 5.4),
                                seed=24))


@pytest.fixture(scope="module")
def reference_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("reference_data"))
    write_reference_tree(root)
    return root


@pytest.fixture()
def both_rooted(reference_tree, monkeypatch):
    monkeypatch.setattr(tdemos, "REFERENCE_DATA", reference_tree)
    monkeypatch.setattr(jdemos, "REFERENCE_DATA", reference_tree)


def _same_run(rt, rj, deficient=False):
    (_pt, ok_t, it_t, s0_t, info_t), (_pj, ok_j, it_j, s0_j, info_j) = rt, rj
    assert (ok_t, info_t.code, it_t) == (ok_j, info_j.code, it_j)
    if deficient:
        assert not ok_t
        return
    assert ok_t
    assert abs(s0_t / s0_j - 1) <= 1e-9
    xt, xj = np.asarray(info_t.final_x), np.asarray(info_j.final_x)
    assert np.abs(xt - xj).max() <= 1e-9 * np.abs(xj).max()


@pytest.mark.parametrize("model", [3, -1])
def test_camcal_matches_jax(both_rooted, model):
    _same_run(tdemos.camcal(model=model, device="cpu"),
              jdemos.camcal(model=model))


def test_camcal_with_a_given_prob_and_folder(reference_tree):
    """prob= and data_dir= bypass REFERENCE_DATA (scripts/real_camcal.py's
    use)."""
    from dbat_tpu.io.pm import load_pm as jload_pm
    from dbat_tpu_torch.io.pm import load_pm

    data_dir = os.path.join(reference_tree, "dbat")
    path = os.path.join(data_dir, "pmexports", "camcal-pmexport.txt")
    _same_run(tdemos.camcal(prob=load_pm(path), data_dir=data_dir,
                            device="cpu"),
              jdemos.camcal(prob=jload_pm(path), data_dir=data_dir))


@pytest.mark.parametrize("which", ["1ray", "no-datum"])
def test_camcal_error_demo_matches_jax(both_rooted, which):
    _same_run(tdemos.camcal_error_demo(which, device="cpu"),
              jdemos.camcal_error_demo(which), deficient=True)


def test_camcal_error_demo_unobserved_image_fails_as_in_jax(both_rooted):
    for run in (lambda: tdemos.camcal_error_demo("missing-obs",
                                                 device="cpu"),
                lambda: jdemos.camcal_error_demo("missing-obs")):
        with pytest.raises(ValueError, match="Bad or uninitialized EO"):
            run()


@pytest.mark.parametrize("label", ["s1", "s2", "s3", "s4"])
def test_prague_sxb_matches_jax(both_rooted, label):
    _same_run(tdemos.prague_sxb(label, device="cpu"),
              jdemos.prague_sxb(label))


@pytest.mark.parametrize("use_prior_eo", [False, True])
def test_sxb_prior_eo_matches_jax(both_rooted, use_prior_eo):
    rt = tdemos.sxb_prior_eo(use_prior_eo, device="cpu")
    _same_run(rt, jdemos.sxb_prior_eo(use_prior_eo))
    assert rt[0].prior_eo_use.sum() == (24 if use_prior_eo else 0)


def test_ps_postproc_default_project_matches_jax(both_rooted):
    _same_run(tdemos.ps_postproc(device="cpu"), jdemos.ps_postproc())


class _Info:
    code = 0


def _stub_demos(monkeypatch, fail=()):
    """Demos and run_script that return their golden sigma0 (off by 0.1
    for the names in `fail`) and record the device they were given."""
    seen = []

    def demo(name, golden):
        def run(*args, device=None, **kw):
            seen.append((name, args, device))
            s0 = golden + (0.1 if name in fail else 0.0)
            return None, True, 3, s0, _Info()
        return run

    goldens = {"camcal": {3: 1.6148, -1: 1.62168, 2: 1.68901, 4: 1.61247,
                          5: 1.6148},
               "prague_sxb": {"s1": 1.0419, "s2": 0.984904, "s3": 0.965375,
                              "s4": 1.07447},
               "sxb_prior_eo": {False: 1.07447, True: 1.06942}}

    def keyed(name):
        def run(*args, model=None, device=None, **kw):
            key = model if name == "camcal" else args[0]
            return demo(f"{name}-{key}", goldens[name][key])(
                *args, device=device, **kw)
        return run

    for name in goldens:
        monkeypatch.setattr(tdemos, name, keyed(name))
    monkeypatch.setattr(tdemos, "ps_postproc", demo("sxb-psz", 0.710294))
    scripts = {"camcaldemo.xml": 1.6148, "sxb.xml": 1.1786,
               "romabundledemo.xml": 0.582769}

    class Sr:
        def __init__(self, s0):
            self.sigma0, self.ok = s0, True

    def run_script(path, output_dir=None, device=None):
        name = os.path.basename(path)
        seen.append((name, (), device))
        return Sr(scripts[name] + (0.1 if name in fail else 0.0))

    monkeypatch.setattr(run_all, "run_script", run_script)
    monkeypatch.setattr(run_all, "write_report", lambda *a: None)
    return seen


@pytest.mark.parametrize("case", ["all ok", "fast", "two fail"])
def test_run_all_counts_failures(monkeypatch, tmp_path, capsys, case):
    fail = ("camcal-4", "sxb.xml") if case == "two fail" else ()
    seen = _stub_demos(monkeypatch, fail=fail)
    argv = ["--out", str(tmp_path), "--device", "cpu"]
    rc = run_all.main(argv + (["--fast"] if case == "fast" else []))
    out = capsys.readouterr().out
    n = 14 if case == "fast" else 15
    assert len(seen) == n and {d.type for _, _, d in seen} == {"cpu"}
    lines = [ln for ln in out.splitlines() if " OK " in ln
             or " FAIL " in ln]
    assert len(lines) == n
    assert sum(" FAIL " in ln for ln in lines) == len(fail)
    assert f"{n} demos, {len(fail)} failures" in out
    assert rc == (1 if fail else 0)
    assert ("script-roma" in out) == (case != "fast")
