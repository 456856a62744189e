"""Port parity: the host's native helpers of dbat_tpu_torch (io/native.py
over csrc/dbat_native.cpp, built at first use with the host C++
compiler) against the numpy formulas of dbat_tpu/io/native.py and
against the JAX package's module on the same inputs.

Inputs are made from a seed.  Held: parse_numeric_table exactly (both
read the text with strtod; the numpy fallback with genfromtxt);
diag_block_outer, batch_inv3 and icpc_blocks to 1e-12 of the largest
entry (sums in another order, and the JAX package's library may be
built with other flags); the numpy fallback, taken where the library
cannot be built, equal to the JAX package's fallback exactly."""

import numpy as np
import pytest

from dbat_tpu.io import native as jnative
from dbat_tpu_torch.io import native as tnative
from port_pm_export import numpy_native

TOL = 1e-12


def _inputs():
    rng = np.random.default_rng(3)
    k, m, n = 7, 5, 3
    A = rng.standard_normal((k, k))
    A = A @ A.T
    B = rng.standard_normal((k, m * n))
    inv3 = rng.standard_normal((40, 3, 3)) + 3 * np.eye(3)
    Vinv = np.linalg.inv(inv3[:m])
    Y = rng.standard_normal((k, 3 * m))
    return A, B, n, inv3, Vinv, Y


def _close(a, b):
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= TOL * np.abs(b).max()


def _table(tmp_path):
    rng = np.random.default_rng(4)
    rows = rng.standard_normal((25, 4)) * 10.0 ** rng.integers(-3, 6,
                                                               (25, 4))
    path = tmp_path / "table.txt"
    with open(path, "w") as fh:
        fh.write("# id,x,y,z\n\n")
        for r in rows:
            fh.write(",".join(repr(float(v)) for v in r) + "\n")
    return str(path), rows


def test_the_library_builds_here():
    assert tnative.have_native()
    assert tnative._library_path().exists()


def test_parse_numeric_table_matches_numpy_and_jax(tmp_path):
    path, rows = _table(tmp_path)
    got = tnative.parse_numeric_table(path, 4)
    np.testing.assert_array_equal(got, rows)
    np.testing.assert_array_equal(got, jnative.parse_numeric_table(path, 4))
    np.testing.assert_array_equal(
        got, np.atleast_2d(np.genfromtxt(path, delimiter=",")))
    for mod in (tnative, jnative):  # a row wider than asked for
        with pytest.raises(ValueError, match="code -2"):
            mod.parse_numeric_table(path, 3)


@pytest.mark.parametrize("name", ["diag_block_outer", "batch_inv3",
                                  "icpc_blocks"])
def test_block_helpers_match_numpy_and_jax(name):
    A, B, n, inv3, Vinv, Y = _inputs()
    s2 = 0.7
    ref = numpy_native(A, B, n, inv3, Vinv, Y, s2)[name]
    args = {"diag_block_outer": (A, B, n), "batch_inv3": (inv3,),
            "icpc_blocks": (Vinv, Y, s2)}[name]
    got = getattr(tnative, name)(*args)
    _close(got, ref)
    _close(got, getattr(jnative, name)(*args))


def test_batch_inv3_raises_on_a_singular_block():
    A = np.stack([np.eye(3), np.zeros((3, 3))])
    with pytest.raises(np.linalg.LinAlgError, match="block 1"):
        tnative.batch_inv3(A)


def test_fallback_equals_the_jax_fallback(tmp_path, monkeypatch):
    """Without the library both modules give the same numpy results."""
    monkeypatch.setattr(tnative, "_load", lambda: None)
    monkeypatch.setattr(jnative, "_load", lambda: None)
    assert not tnative.have_native()
    A, B, n, inv3, Vinv, Y = _inputs()
    for name, args in (("diag_block_outer", (A, B, n)),
                       ("batch_inv3", (inv3,)),
                       ("icpc_blocks", (Vinv, Y, 0.7))):
        np.testing.assert_array_equal(getattr(tnative, name)(*args),
                                      getattr(jnative, name)(*args))
    path, rows = _table(tmp_path)
    np.testing.assert_array_equal(tnative.parse_numeric_table(path, 4),
                                  jnative.parse_numeric_table(path, 4))


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 8])
def test_png_unfilter_library_equals_the_python_loop(monkeypatch, bpp):
    """The PNG row unfilter (io/png.py's only native step): the library
    and its plain Python fallback give the same bytes for every filter
    type."""
    rng = np.random.default_rng(bpp)
    h, w = 29, 17
    raw = rng.integers(0, 256, (h, w * bpp)).astype(np.uint8)
    ftype = rng.integers(0, 5, h).astype(np.uint8)
    rows = np.concatenate([ftype[:, None], raw], axis=1)
    got = tnative.png_unfilter(rows, bpp)
    np.testing.assert_array_equal(got, tnative._png_unfilter_py(rows, bpp))
    monkeypatch.setattr(tnative, "_load", lambda: None)
    np.testing.assert_array_equal(tnative.png_unfilter(rows, bpp), got)
    rows[3, 0] = 5
    with pytest.raises(ValueError, match="row 3: unknown filter type 5"):
        tnative.png_unfilter(rows, bpp)


def test_png_reader_undoes_every_filter_with_and_without_library(
        tmp_path, monkeypatch):
    from port_features import write_png

    from dbat_tpu_torch.io.png import read_png

    rng = np.random.default_rng(11)
    px = rng.integers(0, 256, (21, 13, 3))
    write_png(tmp_path / "x.png", px, filters=(4, 3, 2, 1, 0))
    want = np.divide(px.astype(np.uint8), 255, dtype=np.float32)
    np.testing.assert_array_equal(read_png(tmp_path / "x.png"), want)
    monkeypatch.setattr(tnative, "_load", lambda: None)
    np.testing.assert_array_equal(read_png(tmp_path / "x.png"), want)
