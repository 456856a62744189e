"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Imports no JAX, so it runs where only PyTorch and the CUDA
toolkit are installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_kernels_gpu.py

(--noconftest: tests/conftest.py configures JAX.)  Without a card every
test skips itself.

Beside the kernels: the fixed-order sums (SegSum, SegScatter, and one
Schur assembly and S build) repeat bit for bit on the card and agree
with the CPU's sums (f64, 1e-12 of the largest entry); a small f64
bundle() on the card agrees with the same call on the CPU (code and
iterations equal, sigma0 within 1e-8 relative).

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
    # nb = 6, fixed IO (the roma watchdog network): U, W, Y and Y Y'.
    (ata_terms(2, 6), 12, 12, 36),
    (atb_terms(2, 6, 3), 12, 6, 18),
    (matmul_terms(6, 3, 3), 18, 9, 18),
    (abt_terms(6, 3, 6), 18, 18, 36),
]
DTYPES = [(torch.float32, 1e-6, 2e-5), (torch.float64, 1e-13, 1e-12)]
#: 6 = EO only (fixed IO; an f32 Y row of 72 bytes, 8- but not
#: 16-byte aligned); 16 = 6 EO + 5 linear IO terms + K1..K3 + P1, P2,
#: the widest camera block of DBAT's models; 32 is the widest kernel B
#: takes.
NBS = [6, 7, 14, 16, PAIR_BUCKET_MAX_NB]


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


def _small_net():
    from dbat_tpu_torch.core.serial import build_serial
    from dbat_tpu_torch.pipeline.synthetic import make_ring_network, perturb

    s = make_ring_network(
        n_img=12, n_pt=400, rays_per_pt=(3, 9), n_obs_target=2000,
        n_ctrl=4, noise_px=0.1,
        est_io_cols=("cc", "px", "py", "K1", "K2", "K3", "P1", "P2"),
        seed=5)
    perturb(s, eo_pos=0.02, eo_ang=0.004, op_pos=0.02, seed=6)
    return s, build_serial(s)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fixed_order_sums_repeat_on_the_card(dtype):
    from dbat_tpu_torch.solve.schur import SchurOps
    from dbat_tpu_torch.solve.segsum import SegScatter, SegSum
    from dbat_tpu_torch.solve.smallblas import inv3x3

    dev = _card()
    rng = np.random.default_rng(6)
    ids = np.minimum(rng.geometric(0.002, 20000) - 1, 40)  # long segments
    data = rng.normal(size=(len(ids), 5))
    seg = SegSum(ids, 41, device=dev)
    a = seg(torch.as_tensor(data, dtype=dtype, device=dev))
    assert torch.equal(a, seg(torch.as_tensor(data, dtype=dtype,
                                              device=dev)))
    targets = rng.integers(0, 50, 30000)
    plan = SegScatter(targets, device=dev)
    flat = torch.as_tensor(data[:, 0].repeat(2)[:30000], dtype=dtype,
                           device=dev)
    b = plan.add_into(torch.zeros(50, dtype=dtype, device=dev), flat)
    assert torch.equal(b, plan.add_into(
        torch.zeros(50, dtype=dtype, device=dev), flat))
    if dtype == torch.float64:
        ref = SegSum(ids, 41)(torch.as_tensor(data))
        np.testing.assert_allclose(a.cpu().numpy(), ref.numpy(), rtol=0,
                                   atol=1e-12 * ref.abs().max().item())
        ref_b = np.zeros(50)
        np.add.at(ref_b, targets, flat.cpu().numpy())
        np.testing.assert_allclose(b.cpu().numpy(), ref_b, rtol=0,
                                   atol=1e-12 * np.abs(ref_b).max())

    s, spec = _small_net()
    ops = SchurOps(s, spec, dtype=dtype, device=dev)
    x0 = ops.x0().to(dtype)
    runs = []
    for _ in range(2):
        U, V, Wb, gc, gp, rw = ops._assemble_impl(x0)
        S = ops._schur_S(U, inv3x3(V), Wb, 0.0)
        runs.append((U, V, Wb, gc, gp, rw, S))
    for first, second in zip(*runs):
        assert torch.equal(first, second)
    if dtype == torch.float64:
        cpu = SchurOps(s, spec, dtype=dtype, device="cpu")
        U, V, Wb, gc, gp, rw = cpu._assemble_impl(x0.cpu())
        S = cpu._schur_S(U, inv3x3(V), Wb, 0.0)
        for card, host in zip(runs[0], (U, V, Wb, gc, gp, rw, S)):
            np.testing.assert_allclose(card.cpu().numpy(), host.numpy(),
                                       rtol=0,
                                       atol=1e-12 * host.abs().max().item())


@pytest.mark.gpu
def test_small_bundle_on_the_card_matches_the_cpu():
    from dbat_tpu_torch.solve.bundle import bundle

    dev = _card()
    out = {}
    for where in (dev, "cpu"):
        s, _spec = _small_net()
        _p, ok, iters, sigma0, info = bundle(
            s, damping="lm", backend="schur", conv_tol=1e-4, device=where)
        out[str(where)] = (ok, iters, info.code, sigma0, s.op)
    card, cpu = out[str(dev)], out["cpu"]
    assert card[0] and card[:3] == cpu[:3]
    assert card[3] == pytest.approx(cpu[3], rel=1e-8)
    np.testing.assert_allclose(card[4], cpu[4], rtol=0,
                               atol=1e-8 * np.abs(cpu[4]).max())
