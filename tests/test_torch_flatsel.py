"""Port parity: FlatBilinear (kernel A's plain version), SegSum and the
closed-form 3x3 kernels of dbat_tpu_torch.solve against dbat_tpu.solve.

f64 comparisons hold at rtol 1e-12 (same arithmetic, sums possibly in
another order); the f32 comparison with the Pallas kernel in interpret
mode is the JAX package's own test tolerance, atol 1e-6."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dbat_tpu.solve import flatsel as jfs
from dbat_tpu.solve import segsum as jseg
from dbat_tpu.solve import smallblas as jsb
from dbat_tpu.solve.pallas_kernels import fused_bilinear as jax_fused_bilinear
from dbat_tpu_torch.solve import flatsel as tfs
from dbat_tpu_torch.solve import segsum as tseg
from dbat_tpu_torch.solve import smallblas as tsb
from dbat_tpu_torch.solve.kernels import fused_bilinear_plain

# The four term shapes of tests/test_pallas.py.
SHAPES = [
    ("abt", (7, 3, 7), 21, 21, 49),
    ("ata", (2, 9), 18, 18, 81),
    ("atb", (2, 9, 3), 18, 6, 27),
    ("matmul", (7, 3, 3), 21, 9, 21),
]


def _fbs(kind, args, d_a, d_b, d_out):
    terms = {"abt": tfs.abt_terms, "ata": tfs.ata_terms,
             "atb": tfs.atb_terms, "matmul": tfs.matmul_terms}[kind](*args)
    jterms = {"abt": jfs.abt_terms, "ata": jfs.ata_terms,
              "atb": jfs.atb_terms, "matmul": jfs.matmul_terms}[kind](*args)
    np.testing.assert_array_equal(terms, jterms)
    return (tfs.FlatBilinear(d_a, d_b, terms, d_out),
            jfs.FlatBilinear(d_a, d_b, jterms, d_out))


@pytest.mark.parametrize("kind,args,d_a,d_b,d_out", SHAPES)
def test_flat_bilinear_matches_jax_f64(kind, args, d_a, d_b, d_out):
    rng = np.random.default_rng(3)
    tfb, jfb = _fbs(kind, args, d_a, d_b, d_out)
    A = rng.normal(size=(150, d_a))
    B = rng.normal(size=(150, d_b))
    ref = np.asarray(jfb(jnp.asarray(A), jnp.asarray(B)))
    out = tfb(torch.as_tensor(A), torch.as_tensor(B))
    assert out.dtype == torch.float64 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("kind,args,d_a,d_b,d_out", SHAPES)
def test_plain_kernel_a_matches_pallas_interpret(kind, args, d_a, d_b,
                                                 d_out):
    rng = np.random.default_rng(3)
    tfb, jfb = _fbs(kind, args, d_a, d_b, d_out)
    A = rng.normal(size=(150, d_a)).astype(np.float32)
    B = rng.normal(size=(150, d_b)).astype(np.float32)
    sL, sR = jfb.slot_major_sels()
    ref = jax_fused_bilinear(jnp.asarray(A), jnp.asarray(B), sL, sR, d_out,
                             jfb.g, tile=64, interpret=True)
    out = fused_bilinear_plain(torch.as_tensor(A), torch.as_tensor(B),
                               tfb.table("cpu"), d_out, tfb.g)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def test_flat_bilinear_rejects_bad_terms_and_widths():
    with pytest.raises(ValueError):
        tfs.FlatBilinear(4, 4, tfs.ata_terms(2, 3), 9)  # index >= d_a
    fb = tfs.FlatBilinear(6, 6, tfs.ata_terms(2, 3), 9)
    with pytest.raises(ValueError):
        fb(torch.zeros(3, 5, dtype=torch.float64),
           torch.zeros(3, 6, dtype=torch.float64))


@pytest.mark.parametrize("ids_kind", ["uniform", "ragged", "empty_segments"])
def test_segsum_matches_jax(ids_kind):
    rng = np.random.default_rng(7)
    if ids_kind == "uniform":
        ids, n_seg = np.repeat(np.arange(40), 5), 40
    elif ids_kind == "ragged":
        ids, n_seg = rng.integers(0, 30, 700), 30
    else:
        ids, n_seg = np.sort(rng.integers(0, 25, 300)) * 2, 50
    data = rng.normal(size=(len(ids), 5))
    t = tseg.SegSum(ids, n_seg, cap=16)
    j = jseg.SegSum(ids, n_seg, cap=16)
    assert t.mode == j.mode
    if t.mode == "bucket":
        np.testing.assert_array_equal(t.gidx.numpy(), np.asarray(j.gidx))
        np.testing.assert_array_equal(t.row_seg.numpy(),
                                      np.asarray(j.row_seg))
    out = t(torch.as_tensor(data)).numpy()
    np.testing.assert_allclose(out, np.asarray(j(jnp.asarray(data))),
                               rtol=1e-12, atol=1e-13)
    ref = np.zeros((n_seg, 5))
    np.add.at(ref, ids, data)
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-13)


def test_smallblas_matches_jax():
    rng = np.random.default_rng(11)
    M = rng.normal(size=(64, 3, 3))
    V = M @ np.swapaxes(M, 1, 2) + 0.1 * np.eye(3)
    for tf, jf in ((tsb.inv3x3, jsb.inv3x3), (tsb.chol3x3, jsb.chol3x3)):
        np.testing.assert_allclose(tf(torch.as_tensor(V)).numpy(),
                                   np.asarray(jf(jnp.asarray(V))),
                                   rtol=1e-12, atol=1e-14)
    L = tsb.chol3x3(torch.as_tensor(V)).numpy()
    np.testing.assert_allclose(L @ np.swapaxes(L, 1, 2), V, rtol=1e-12,
                               atol=1e-13)

