"""The port stands alone: no module of dbat_tpu_torch, and neither
chip_smoke.py nor the writers it imports (tests/port_script_folder.py,
tests/port_pm_export.py, tests/port_features.py), imports JAX or the JAX
package; the kernels
are built from plain-C-interface sources without PyTorch's extension
machinery; entry points never fall back to the CPU on their own."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "dbat_tpu_torch"


#: modules that must be among the files the import check reads
PORT_MODULES = ("solve/normal_state.py", "solve/forensics.py",
                "solve/bundle.py", "solve/solvers.py", "solve/fused.py",
                "solve/ops.py", "solve/schur.py", "solve/segsum.py",
                "solve/quality.py", "solve/pcg.py", "solve/covariance.py",
                "geometry/__init__.py", "geometry/initvals.py",
                "geometry/quality.py", "io/__init__.py", "io/report.py",
                "io/cpt.py", "io/tables.py", "io/eotable.py",
                "io/writers.py", "io/stats.py", "io/report_compare.py",
                "pipeline/camera_spec.py", "pipeline/project_build.py",
                "pipeline/script.py", "core/project.py", "core/compare.py",
                "geometry/align.py", "geometry/essential.py",
                "geometry/posegraph.py", "io/pm.py", "io/ply.py",
                "io/psz.py", "io/pmtables.py", "io/lnz.py", "io/native.py",
                "core/checkpoint.py", "pipeline/demos.py",
                "pipeline/run_all.py", "io/png.py", "features/__init__.py",
                "features/render.py", "features/detect.py",
                "features/describe.py", "features/match.py",
                "features/tracks.py", "features/pipeline.py",
                "plotting/__init__.py", "plotting/plots.py",
                "parallel/__init__.py", "parallel/mesh.py",
                "parallel/sharded.py", "parallel/distributed.py",
                "parallel/obs_mesh.py")


def _port_python_files():
    files = sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "port_script_folder.py",
        ROOT / "tests" / "port_pm_export.py",
        ROOT / "tests" / "port_features.py"]
    assert len(files) > 10
    return files


def test_import_check_covers_the_bundle_slice():
    files = set(_port_python_files())
    for mod in PORT_MODULES:
        assert PORT / mod in files, mod
    assert ROOT / "tests" / "port_pm_export.py" in files
    assert ROOT / "tests" / "port_features.py" in files


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_python_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "dbat_tpu"), (path, mod)


def test_parallel_modules_import_without_jax():
    """dbat_tpu_torch.parallel.* imports in a fresh interpreter with no
    JAX module loaded before or after."""
    code = ("import sys\n"
            "import dbat_tpu_torch.parallel\n"
            "import dbat_tpu_torch.parallel.mesh\n"
            "import dbat_tpu_torch.parallel.sharded\n"
            "import dbat_tpu_torch.parallel.distributed\n"
            "import dbat_tpu_torch.parallel.obs_mesh\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'dbat_tpu')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_kernels_need_no_torch_extension_build():
    for path in _port_python_files():
        assert "cpp_extension" not in path.read_text(), path
    sources = sorted((PORT / "csrc").glob("*.cu"))
    assert len(sources) == 2
    # The host helpers' C++ source, built by g++, not nvcc.
    for src in sources + [PORT / "csrc" / "dbat_native.cpp"]:
        text = src.read_text()
        assert "torch/" not in text and "ATen" not in text, src
        assert 'extern "C"' in text


def test_entry_point_without_device_raises_without_a_card(monkeypatch):
    from dbat_tpu_torch.core.serial import build_serial
    from dbat_tpu_torch.pipeline.synthetic import make_ring_network
    from dbat_tpu_torch.solve.schur import SchurOps

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = make_ring_network(n_img=6, n_pt=30, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SchurOps(t, build_serial(t))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SchurOps(t, build_serial(t), device="cuda")


def test_kernel_wrappers_take_the_plain_path_only_on_the_cpu():
    from dbat_tpu_torch.solve.kernels import fused_bilinear, pair_bucket_acc

    tab = torch.zeros((1, 1, 2), dtype=torch.int32, device="meta")
    a = torch.zeros((4, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_bilinear(a, a, tab, 1, 1)
    idx = torch.zeros(16, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pair_bucket_acc(a, idx, idx, idx[:2], tab, 1, 1, 16)
    with pytest.raises(ValueError, match="several devices"):
        fused_bilinear(torch.zeros(4, 2), a, tab, 1, 1)


def test_chip_smoke_alone_fails_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_bundle_without_device_raises_without_a_card(monkeypatch):
    """bundle() and the dense BundleOps default to the card too."""
    from dbat_tpu_torch.core.serial import build_serial
    from dbat_tpu_torch.pipeline.synthetic import make_ring_network
    from dbat_tpu_torch.solve.bundle import bundle
    from dbat_tpu_torch.solve.ops import BundleOps

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = make_ring_network(n_img=6, n_pt=30, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BundleOps(t, build_serial(t))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bundle(t)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bundle(t, dtype=torch.float32, backend="schur", device="cuda")


def test_run_script_without_device_raises_without_a_card(monkeypatch,
                                                         tmp_path):
    """run_script() runs its bundle on the card unless the caller asks
    for the CPU; it raises before it reads any input."""
    from dbat_tpu_torch.pipeline.script import run_script

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / "no-such-script.xml")
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_script(missing, **kw)
    with pytest.raises(FileNotFoundError):
        run_script(missing, device="cpu")


@pytest.mark.parametrize("demo", ["ps_postproc", "camcal"])
def test_demos_without_device_raise_before_reading_input(monkeypatch,
                                                        tmp_path, demo):
    """ps_postproc() and camcal() run their bundle on the card unless the
    caller asks for the CPU; without a card they raise before they read
    any input (the missing file would raise FileNotFoundError)."""
    from dbat_tpu_torch.pipeline import demos

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / "no-such-input")
    kw = ({"file_name": missing + ".psz"} if demo == "ps_postproc"
          else {"data_dir": missing})
    run = getattr(demos, demo)
    for dev in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run(**kw, **dev)
    with pytest.raises(FileNotFoundError):
        run(**kw, device="cpu")


def test_run_all_defaults_to_the_card(monkeypatch, tmp_path):
    from dbat_tpu_torch.pipeline import run_all

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_all.main(["--out", str(tmp_path)])


def _feature_calls():
    import numpy as np

    from dbat_tpu_torch.features import describe, detect_blobs, \
        detect_corners, match_all_pairs, match_pair, network_from_images
    from dbat_tpu_torch.features.detect import refine_centroid

    img = np.zeros((2, 30, 40), np.float32)
    xy = np.zeros((2, 4, 2), np.float32)
    valid = np.zeros((2, 4), bool)
    desc = np.zeros((2, 4, 196), np.float32)
    return {
        "detect_blobs": lambda **kw: detect_blobs(img, **kw),
        "detect_corners": lambda **kw: detect_corners(img, **kw),
        "refine_centroid": lambda **kw: refine_centroid(img, xy, valid,
                                                        **kw),
        "describe": lambda **kw: describe(img, xy, valid, **kw),
        "match_pair": lambda **kw: match_pair(desc[0], valid[0], desc[1],
                                              valid[1], **kw),
        "match_all_pairs": lambda **kw: match_all_pairs(desc, valid, **kw),
        "network_from_images": lambda **kw: network_from_images(
            img, focal=7.0, sensor=(8.0, 6.0), **kw),
    }


@pytest.mark.parametrize("name", ["detect_blobs", "detect_corners",
                                  "refine_centroid", "describe",
                                  "match_pair", "match_all_pairs",
                                  "network_from_images"])
def test_feature_entry_points_default_to_the_card(monkeypatch, name):
    """The feature front-end runs on the card unless the caller asks for
    the CPU; without a card it raises."""
    call = _feature_calls()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(**kw)
    call(device="cpu")
