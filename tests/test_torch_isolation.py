"""The port stands alone: no module of dbat_tpu_torch, and not
chip_smoke.py, imports JAX or the JAX package; the kernels are built
from plain-C-interface sources without PyTorch's extension machinery;
entry points never fall back to the CPU on their own."""

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
                "solve/ops.py", "solve/schur.py", "solve/segsum.py")


def _port_python_files():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    return files


def test_import_check_covers_the_bundle_slice():
    files = set(_port_python_files())
    for mod in PORT_MODULES:
        assert PORT / mod in files, mod


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


def test_kernels_need_no_torch_extension_build():
    for path in _port_python_files():
        assert "cpp_extension" not in path.read_text(), path
    sources = sorted((PORT / "csrc").glob("*.cu"))
    assert len(sources) == 2
    for src in sources:
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
