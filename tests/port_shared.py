"""What the port's parity tests share.

jax_solved(): the network that the covariance and report parity tests
(test_torch_covariance.py, test_torch_report.py) share, solved once per
process: a small self-calibrating ring network, the rotation of image 0
fixed (so the fixed-column paths of the covariance run), perturbed, and
solved by the JAX package's f64 bundle() on the Schur backend on the
CPU.

one_thread: an autouse module fixture (import it into a test module)
that runs the port's CPU work there on one thread.  Under pytest-xdist
every worker's default thread pool spans all cores, and the many small
operations of a port solve then wait on one another: several times
slower than on one thread when the cores are busy.

same_fields(): two objects of either package (dataclasses such as
CtrlPts, EoTable or CameraSpec) held equal field by field, exactly.
same_data(): the same, recursively through dataclasses, lists, tuples
and dicts (a PmProject with its PmImage list, a PszProject with its
PszCamera).

The DBAT script folder that the script tests run (write_script_folder
and its operations) lives in port_script_folder.py, which imports no
JAX, so that chip_smoke.py's script phases use the same writer."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from dbat_tpu.pipeline.synthetic import make_ring_network as jmake
from dbat_tpu.pipeline.synthetic import perturb as jperturb
from dbat_tpu.solve.bundle import bundle as jbundle
from dbat_tpu_torch.core.project import Project, project_from_arrays

NET = dict(n_img=12, n_pt=400, rays_per_pt=(3, 9), n_obs_target=2000,
           n_ctrl=4, noise_px=0.1,
           est_io_cols=("cc", "px", "py", "K1", "K2", "K3", "P1", "P2"),
           seed=5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def port_project(p):
    """A port Project with copies of the arrays of project p (either
    package's)."""
    return project_from_arrays({f.name: getattr(p, f.name)
                                for f in dataclasses.fields(Project)})


@functools.cache
def _solved():
    j = jmake(**NET)
    j.est_eo[0, 3:] = False
    jperturb(j, eo_pos=0.01, eo_ang=0.002, op_pos=0.01, seed=4)
    start = port_project(j)
    pj, ok, _it, _s0, ij = jbundle(j, backend="schur")
    assert ok
    return start, pj, ij


def jax_solved():
    """(start, pj, ij): a fresh port copy of the network before the
    solve, and the JAX package's result project and BundleInfo (shared:
    read them, do not change them)."""
    start, pj, ij = _solved()
    return port_project(start), pj, ij


def same_fields(a, b):
    """Assert dataclass objects a (port) and b (JAX package) equal field
    by field: arrays of the same shape, dtype kind and values (NaN equal
    to NaN), everything else by ==."""
    names = [f.name for f in dataclasses.fields(b)]
    assert [f.name for f in dataclasses.fields(a)] == names
    for name in names:
        va, vb = getattr(a, name), getattr(b, name)
        if isinstance(vb, np.ndarray):
            assert isinstance(va, np.ndarray), name
            assert va.shape == vb.shape, name
            assert va.dtype.kind == vb.dtype.kind, name
            np.testing.assert_array_equal(va, vb, err_msg=name)
        elif isinstance(vb, float) and np.isnan(vb):
            assert isinstance(va, float) and np.isnan(va), name
        else:
            assert va == vb, name


def same_data(a, b, where="value"):
    """Assert a (port) and b (JAX package) equal exactly, recursing
    through dataclasses (same field names), lists, tuples and dicts;
    arrays of the same shape, dtype kind and values (NaN equal to NaN);
    floats with NaN equal to NaN; everything else by ==."""
    if dataclasses.is_dataclass(b):
        names = [f.name for f in dataclasses.fields(b)]
        assert [f.name for f in dataclasses.fields(a)] == names, where
        for name in names:
            same_data(getattr(a, name), getattr(b, name), f"{where}.{name}")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray), where
        assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for k, (va, vb) in enumerate(zip(a, b)):
            same_data(va, vb, f"{where}[{k}]")
    elif isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b), where
        for k in b:
            same_data(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(b, float) and np.isnan(b):
        assert isinstance(a, float) and np.isnan(a), where
    else:
        assert type(a) is type(b) and a == b, where
