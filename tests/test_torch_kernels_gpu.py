"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Imports no JAX, so it runs where only PyTorch and the CUDA
toolkit are installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_kernels_gpu.py

(--noconftest: tests/conftest.py configures JAX.)  Without a card every
test skips itself.

Tolerances: kernel A sums its g <= 3 products in term order with
explicitly rounded operations, as the plain version does, so it agrees
to a few ulps of the largest output (f32 1e-6, f64 1e-13 on
unit-normal inputs).  Kernel
B sums up to 16 * (rows of a camera pair) * g products in another order
than the plain version's gather-sum-segment_sum (f32 2e-5, f64 1e-12);
in f32 it is held to the plain version evaluated in f64 on the same
inputs, because over the ~1,000 pairs of a long camera pair the f32
plain version's own rounding exceeds 2e-5."""

import numpy as np
import pytest
import torch

from dbat_tpu_torch.solve.flatsel import (
    FlatBilinear, abt_terms, ata_terms, atb_terms, matmul_terms,
)
from dbat_tpu_torch.solve.kernels import (
    PAIR_BUCKET_MAX_NB, PairBucketPlan, fused_bilinear, fused_bilinear_plain,
    pair_bucket_acc, pair_bucket_acc_plain,
)

SHAPES = [
    (abt_terms(7, 3, 7), 21, 21, 49),
    (ata_terms(2, 9), 18, 18, 81),
    (atb_terms(2, 9, 3), 18, 6, 27),
    (matmul_terms(7, 3, 3), 21, 9, 21),
    (abt_terms(14, 3, 14), 42, 42, 196),  # the C5 self-pair product
    # Rows of more than 256 output vectors (f32 nb = 17: 289 vectors of
    # one; f64 nb = 32: 512 of two) loop over vectors per thread.
    (abt_terms(17, 3, 17), 51, 51, 289),
    (abt_terms(32, 3, 32), 96, 96, 1024),
]
DTYPES = [(torch.float32, 1e-6, 2e-5), (torch.float64, 1e-13, 1e-12)]
#: 16 = 6 EO + 5 linear IO terms + K1..K3 + P1, P2, the widest camera
#: block of DBAT's models; 32 is the widest kernel B takes.
NBS = [7, 14, 16, PAIR_BUCKET_MAX_NB]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [5, 1001])  # under one tile; not a multiple
@pytest.mark.parametrize("dtype,tol_a,_tol_b", DTYPES)
@pytest.mark.parametrize("terms,d_a,d_b,d_out", SHAPES)
def test_kernel_a_matches_plain(terms, d_a, d_b, d_out, dtype, tol_a,
                                _tol_b, n):
    dev = _card()
    rng = np.random.default_rng(3)
    fb = FlatBilinear(d_a, d_b, terms, d_out)
    A = torch.as_tensor(rng.normal(size=(n, d_a)), dtype=dtype, device=dev)
    B = torch.as_tensor(rng.normal(size=(n, d_b)), dtype=dtype, device=dev)
    n0 = fused_bilinear.launches
    out = fb(A, B)
    torch.cuda.synchronize()
    assert fused_bilinear.launches == n0 + 1
    ref = fused_bilinear_plain(A, B, fb.table(dev), d_out, fb.g)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=0, atol=tol_a)
    if d_a == d_b:  # one array as both operands is loaded once: same bits
        assert torch.equal(fb(A, A), fb(A, A.clone()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol_a,_tol_b", DTYPES)
@pytest.mark.parametrize("terms,d_a,d_b,d_out", SHAPES)
def test_kernel_a_offset_operands(terms, d_a, d_b, d_out, dtype, tol_a,
                                  _tol_b):
    """Operands that are views t[1:] of contiguous tensors: their base
    pointers sit one row in, 16-byte aligned or not."""
    dev = _card()
    rng = np.random.default_rng(4)
    fb = FlatBilinear(d_a, d_b, terms, d_out)
    n = 777
    A = torch.as_tensor(rng.normal(size=(n + 1, d_a)), dtype=dtype,
                        device=dev)[1:]
    B = torch.as_tensor(rng.normal(size=(n + 1, d_b)), dtype=dtype,
                        device=dev)[1:]
    assert A.is_contiguous() and B.is_contiguous()
    out = fb(A, B)
    ref = fused_bilinear_plain(A, B, fb.table(dev), d_out, fb.g)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=0, atol=tol_a)


def _skewed_pairs(rng, n_obs, n_campair=40):
    """Camera pairs of very different lengths: one of 60 * 16 + 5 pairs
    (>= 60 bucket rows), four with none, the rest short."""
    sizes = rng.integers(1, 40, n_campair)
    sizes[[3, 17, 18, 39]] = 0
    sizes[25] = 60 * 16 + 5
    cp = np.repeat(np.arange(n_campair), sizes)
    i1 = rng.integers(0, n_obs, len(cp))
    i2 = rng.integers(0, n_obs, len(cp))
    return cp, i1, i2, n_campair


@pytest.mark.gpu
@pytest.mark.parametrize("nb", NBS)
@pytest.mark.parametrize("dtype,_tol_a,tol_b", DTYPES)
@pytest.mark.parametrize("cap", [8, 16])
def test_kernel_b_matches_plain(cap, dtype, _tol_a, tol_b, nb):
    dev = _card()
    rng = np.random.default_rng(5)
    n_obs = 401
    cp, i1, i2, n_campair = _skewed_pairs(rng, n_obs)
    i1[0] = i2[5] = n_obs - 1  # the last row of Y: no aligned window past it
    fb = FlatBilinear(nb * 3, nb * 3, abt_terms(nb, 3, nb), nb * nb)
    plan = PairBucketPlan(i1, i2, cp, n_campair, n_obs, cap=cap, device=dev,
                          nb=nb, dtype=dtype)
    warps = pair_bucket_acc.resident_warps(dev, dtype, nb, cap)
    assert warps >= torch.cuda.get_device_properties(dev).multi_processor_count
    assert plan.n_chunks == min(warps, n_campair) > 1
    Y = torch.as_tensor(rng.normal(size=(n_obs, nb * 3)), dtype=dtype,
                        device=dev)
    n0 = pair_bucket_acc.launches
    out = plan(Y, fb)
    again = plan(Y, fb)
    torch.cuda.synchronize()
    assert pair_bucket_acc.launches == n0 + 2
    assert torch.equal(out, again)  # bitwise repeatable
    Y64 = Y.double()
    ref = pair_bucket_acc_plain(Y64, plan.i1, plan.i2, plan.row_ptr,
                                fb.table(dev), fb.d_out, fb.g, plan.cap)
    rows = np.diff(plan.row_ptr.cpu().numpy())
    assert rows.max() >= 60 and (rows == 0).sum() == 4
    assert not out[torch.as_tensor(rows == 0, device=dev)].any()
    np.testing.assert_allclose(out.double().cpu().numpy(),
                               ref.cpu().numpy(), rtol=0, atol=tol_b)
    # One chunk for the whole plan: the ring wraps over every row.
    one = pair_bucket_acc(Y, plan.i1, plan.i2, plan.row_ptr, fb.table(dev),
                          fb.d_out, fb.g, plan.cap,
                          torch.tensor([0, n_campair], dtype=torch.int32,
                                       device=dev))
    np.testing.assert_allclose(one.double().cpu().numpy(),
                               ref.cpu().numpy(), rtol=0, atol=tol_b)


@pytest.mark.gpu
def test_wrappers_check_their_inputs():
    dev = _card()
    fb = FlatBilinear(6, 6, ata_terms(2, 3), 9)
    A = torch.zeros((8, 6), device=dev)
    with pytest.raises(TypeError):
        fused_bilinear(A.half(), A.half(), fb.table(dev), 9, fb.g)
    with pytest.raises(ValueError):  # table does not match g
        fused_bilinear(A, A, fb.table(dev), 9, fb.g + 1)
    with pytest.raises(ValueError):  # strided operand
        fused_bilinear(torch.zeros((8, 12), device=dev)[:, ::2], A,
                       fb.table(dev), 9, fb.g)
    idx = torch.zeros(15, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # not a whole number of buckets
        pair_bucket_acc(A, idx, idx, idx[:3], fb.table(dev), 9, fb.g, 16)
    # Kernel B takes abt_terms(nb, 3, nb) only, nb <= PAIR_BUCKET_MAX_NB.
    idx = torch.zeros(16, dtype=torch.int32, device=dev)
    chunks = torch.tensor([0, 2], dtype=torch.int32, device=dev)
    Y = torch.zeros((8, 9), device=dev)
    not_abt = FlatBilinear(9, 9, matmul_terms(3, 3, 3), 9)
    with pytest.raises(ValueError, match="not abt_terms"):
        pair_bucket_acc(Y, idx, idx, idx[:3], not_abt.table(dev), 9,
                        not_abt.g, 16, chunks)
    abt = FlatBilinear(9, 9, abt_terms(3, 3, 3), 9)
    out = pair_bucket_acc(Y, idx, idx, idx[:3], abt.table(dev), 9, abt.g,
                          16, chunks)
    assert out.shape == (2, 9) and not out.any()
    with pytest.raises(ValueError, match="chunk"):
        pair_bucket_acc(Y, idx, idx, idx[:3], abt.table(dev), 9, abt.g, 16)
    with pytest.raises(ValueError, match="16-byte"):  # Y's rows are copied
        pair_bucket_acc(torch.zeros((9, 9), device=dev)[1:], idx, idx,
                        idx[:3], abt.table(dev), 9, abt.g, 16, chunks)
    nb = PAIR_BUCKET_MAX_NB + 1
    wide = FlatBilinear(3 * nb, 3 * nb, abt_terms(nb, 3, nb), nb * nb)
    with pytest.raises(ValueError, match="nb <="):
        pair_bucket_acc(torch.zeros((8, 3 * nb), device=dev), idx, idx,
                        idx[:3], wide.table(dev), nb * nb, wide.g, 16, chunks)
