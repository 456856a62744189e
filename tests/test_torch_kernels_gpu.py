"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Imports no JAX, so it runs where only PyTorch and the CUDA
toolkit are installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_kernels_gpu.py

(--noconftest: tests/conftest.py configures JAX.)  Without a card every
test skips itself.

Tolerances: kernel A sums its g <= 3 products in the plain version's
order with explicitly rounded operations, so it agrees to a few ulps of
the largest output (f32 1e-6, f64 1e-13 on unit-normal inputs); kernel
B sums up to 16 * (rows of a camera pair) * g products in another
order than the plain version's gather-sum-segment_sum (f32 2e-5, f64
1e-12)."""

import numpy as np
import pytest
import torch

from dbat_tpu_torch.solve.flatsel import (
    FlatBilinear, abt_terms, ata_terms, atb_terms, matmul_terms,
)
from dbat_tpu_torch.solve.kernels import (
    PairBucketPlan, fused_bilinear, fused_bilinear_plain, pair_bucket_acc,
    pair_bucket_acc_plain,
)

SHAPES = [
    (abt_terms(7, 3, 7), 21, 21, 49),
    (ata_terms(2, 9), 18, 18, 81),
    (atb_terms(2, 9, 3), 18, 6, 27),
    (matmul_terms(7, 3, 3), 21, 9, 21),
    (abt_terms(14, 3, 14), 42, 42, 196),  # the C5 self-pair product
]
DTYPES = [(torch.float32, 1e-6, 2e-5), (torch.float64, 1e-13, 1e-12)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol_a,_tol_b", DTYPES)
@pytest.mark.parametrize("terms,d_a,d_b,d_out", SHAPES)
def test_kernel_a_matches_plain(terms, d_a, d_b, d_out, dtype, tol_a,
                                _tol_b):
    dev = _card()
    rng = np.random.default_rng(3)
    fb = FlatBilinear(d_a, d_b, terms, d_out)
    n = 1001  # not a multiple of the kernel's 32-row tile
    A = torch.as_tensor(rng.normal(size=(n, d_a)), dtype=dtype, device=dev)
    B = torch.as_tensor(rng.normal(size=(n, d_b)), dtype=dtype, device=dev)
    n0 = fused_bilinear.launches
    out = fb(A, B)
    torch.cuda.synchronize()
    assert fused_bilinear.launches == n0 + 1
    ref = fused_bilinear_plain(A, B, fb.table(dev), d_out, fb.g)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=0, atol=tol_a)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,_tol_a,tol_b", DTYPES)
@pytest.mark.parametrize("cap", [8, 16])
def test_kernel_b_matches_plain(cap, dtype, _tol_a, tol_b):
    dev = _card()
    rng = np.random.default_rng(5)
    nb, n_obs, n_campair, n_pairs = 7, 400, 23, 900
    cp = np.sort(rng.integers(0, n_campair, n_pairs))
    i1 = rng.integers(0, n_obs, n_pairs)
    i2 = rng.integers(0, n_obs, n_pairs)
    fb = FlatBilinear(nb * 3, nb * 3, abt_terms(nb, 3, nb), nb * nb)
    plan = PairBucketPlan(i1, i2, cp, n_campair, n_obs, cap=cap, device=dev)
    Y = torch.as_tensor(rng.normal(size=(n_obs, nb * 3)), dtype=dtype,
                        device=dev)
    n0 = pair_bucket_acc.launches
    out = plan(Y, fb)
    torch.cuda.synchronize()
    assert pair_bucket_acc.launches == n0 + 1
    ref = pair_bucket_acc_plain(Y, plan.i1, plan.i2, plan.row_ptr,
                                fb.table(dev), fb.d_out, fb.g, plan.cap)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=0, atol=tol_b)


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
