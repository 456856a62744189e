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
iterations equal, sigma0 within 1e-8 relative).  The posterior
covariance of the small network: COP of f32 ops (extracted in f64)
repeats bit for bit over two fresh instances, and the f64 extraction
on the card matches the CPU's (1e-9 of the largest entry); f64 PCG on
the card matches the direct solve.

Tolerances: kernel A sums its g <= 3 products in term order with
explicitly rounded operations, as the plain version does, so it agrees
to a few ulps of the largest output (f32 1e-6, f64 1e-13 on
unit-normal inputs).  Kernel
B sums up to 16 * (rows of a camera pair) * g products in another order
than the plain version's gather-sum-segment_sum (f32 2e-5, f64 1e-12);
in f32 it is held to the plain version evaluated in f64 on the same
inputs, because over the ~1,000 pairs of a long camera pair the f32
plain version's own rounding exceeds 2e-5.

At the C5 shape with fixed IO (nb 6, f32; a PhotoScan project loaded
with its calibration fixed): kernel A's five products over the 196,715
observations and kernel B over the network's 1,275,817 observation
pairs, on inputs made from a seed: A at the tolerance above, B to 2e-5
of its largest output (a camera pair there sums up to thousands of
pairs, so its outputs are far from unit size)."""

import numpy as np
import pytest
import torch

from dbat_tpu_torch.core.serial import build_serial
from dbat_tpu_torch.pipeline.synthetic import C5_RING, make_ring_network
from dbat_tpu_torch.solve.flatsel import (
    FlatBilinear, abt_terms, ata_terms, atb_terms, matmul_terms,
)
from dbat_tpu_torch.solve.kernels import (
    PAIR_BUCKET_MAX_NB, PairBucketPlan, fused_bilinear, fused_bilinear_plain,
    pair_bucket_acc, pair_bucket_acc_plain,
)
from dbat_tpu_torch.solve.schur import SchurOps

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
def test_kernels_at_the_c5_fixed_io_shape():
    dev = _card()
    s = make_ring_network(**{k: v for k, v in C5_RING.items()
                             if k != "est_io_cols"})
    ops = SchurOps(s, build_serial(s), dtype=torch.float32, device=dev)
    assert ops.n_cb == 6 and ops.n_pairs == 1275817
    rng = np.random.default_rng(8)
    n = ops.n_obs
    tol_a, tol_b = DTYPES[0][1:]
    for fb in (ops._fb_u, ops._fb_v, ops._fb_w, ops._fb_y, ops._fb_pair):
        A = torch.as_tensor(rng.normal(size=(n, fb.d_a)),
                            dtype=torch.float32, device=dev)
        B = torch.as_tensor(rng.normal(size=(n, fb.d_b)),
                            dtype=torch.float32, device=dev)
        out = fb(A, B)
        ref = fused_bilinear_plain(A, B, fb.table(dev), fb.d_out, fb.g)
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=0, atol=tol_a)
    plan, fb = ops._pair_plan, ops._fb_pair
    Y = torch.as_tensor(rng.normal(size=(n, fb.d_a)), dtype=torch.float32,
                        device=dev)
    n0 = pair_bucket_acc.launches
    out = plan(Y, fb)
    assert pair_bucket_acc.launches == n0 + 1
    assert torch.equal(out, plan(Y, fb))
    ref = pair_bucket_acc_plain(Y.double(), plan.i1, plan.i2, plan.row_ptr,
                                fb.table(dev), fb.d_out, fb.g, plan.cap)
    err = float((out.double() - ref).abs().max())
    assert err <= tol_b * float(ref.abs().max())


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


def _small_solved(dev, dtype):
    """The small network after an f64 bundle() on the card, and a
    BundleInfo whose ops are a fresh SchurOps in `dtype` on `dev`."""
    from dbat_tpu_torch.solve.bundle import BundleInfo, bundle
    from dbat_tpu_torch.solve.schur import SchurOps

    s, spec = _small_net()
    _p, ok, _it, sigma0, info = bundle(s, backend="schur", device=dev)
    assert ok
    ops = SchurOps(s, spec, dtype=dtype, device=dev)
    return s, BundleInfo(ops=ops, spec=spec, sigma0=sigma0,
                         final_x=info.final_x)


@pytest.mark.gpu
def test_cop_repeats_bit_for_bit_on_the_card():
    """COP of f32 ops (extracted in f64) from two fresh Covariance
    instances (f64 ops, plans, scatters, solves and Gram products
    rebuilt): bitwise equal, every estimated variance positive."""
    from dbat_tpu_torch.solve.covariance import Covariance

    dev = _card()
    s, info = _small_solved(dev, torch.float32)
    a = Covariance(s, info).cop(chunk=37)
    b = Covariance(s, info).cop(chunk=37)
    assert np.array_equal(a, b)
    est = np.asarray(info.spec.op_x) >= 0
    var = np.einsum("jii->ji", a)
    assert np.isfinite(a).all() and (var[est] > 0).all()


@pytest.mark.gpu
def test_small_covariance_on_the_card_matches_the_cpu():
    """f64: cio, ceo, cop (chunk 37 and the default), copf on the card
    against the same extraction on the CPU, within 1e-9 of the largest
    entry: the two sum in different orders, and the scaled S of this
    network has a condition of ~1e7 (entries 1e-8 of the largest carry
    the same absolute error)."""
    from dbat_tpu_torch.solve.bundle import BundleInfo
    from dbat_tpu_torch.solve.covariance import Covariance
    from dbat_tpu_torch.solve.schur import SchurOps

    dev = _card()
    s, info = _small_solved(dev, torch.float64)
    cpu_info = BundleInfo(
        ops=SchurOps(s, info.spec, dtype=torch.float64, device="cpu"),
        spec=info.spec, sigma0=info.sigma0, final_x=info.final_x)
    card, host = Covariance(s, info), Covariance(s, cpu_info)
    pts = np.arange(0, s.n_op, 9)
    for name, kw in (("cio", {}), ("ceo", {}), ("cop", {"chunk": 37}),
                     ("cop", {}), ("copf", {"pts": pts})):
        got = getattr(card, name)(**kw)
        ref = getattr(host, name)(**kw)
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-9 * np.abs(ref).max(),
                                   err_msg=name)
    assert card.jitter == host.jitter


@pytest.mark.gpu
def test_pcg_on_the_card_matches_the_direct_solve():
    """f64 pcg_solve on the card against the direct (explicit-S) solve
    on the card, and against the same PCG on the CPU."""
    from dbat_tpu_torch.solve.schur import SchurOps

    dev = _card()
    s, spec = _small_net()
    out = {}
    for where in (dev, "cpu"):
        ops = SchurOps(s, spec, dtype=torch.float64, device=where)
        U, V, Wb, gc, gp, _rw = ops._assemble_impl(ops.x0())
        g = ops.join_x(gc, gp)
        p_direct, _L = ops._solve_impl(U, V, Wb, -g, 0.0)
        p_pcg, (iters, rel) = ops._solve_pcg_impl(U, V, Wb, -g, 0.0,
                                                  tol=1e-12, maxiter=2000)
        out[str(where)] = (p_direct.cpu().numpy(), p_pcg.cpu().numpy(),
                           iters, rel)
    direct, pcg, iters, rel = out[str(dev)]
    assert rel < 1e-10 and 0 < iters < 2000
    scale = np.abs(direct).max()
    np.testing.assert_allclose(pcg, direct, rtol=1e-6, atol=1e-8 * scale)
    np.testing.assert_allclose(pcg, out["cpu"][1], rtol=1e-6,
                               atol=1e-8 * scale)


@pytest.mark.gpu
def test_feature_front_end_on_the_card_matches_the_cpu():
    """detect, describe and match of tests/test_features.py's 10 images
    (800x600 px) on the card: twice bit for bit equal, and against the
    CPU with each stage fed the CPU's inputs (port_features.card_vs_cpu):
    valid masks equal, xy within 1e-3 px, descriptors within 1e-5,
    matches equal but for at most 0.5% of them."""
    from port_features import JAX_TEST_NET, card_vs_cpu, same_matches

    from dbat_tpu_torch.features import describe, detect_blobs, \
        match_all_pairs
    from dbat_tpu_torch.features.render import render_network_images

    dev = _card()
    images = render_network_images(make_ring_network(**JAX_TEST_NET),
                                   seed=4)
    runs = []
    for _ in range(2):
        xy, score, valid = detect_blobs(images, max_kp=256, device=dev)
        desc = describe(images, xy, valid, device=dev)
        runs.append(([t.cpu().numpy() for t in (xy, score, valid, desc)],
                     match_all_pairs(desc, valid, device=dev)))
    for a, b in zip(runs[0][0], runs[1][0]):
        np.testing.assert_array_equal(a, b)
    assert same_matches(runs[0][1], runs[1][1])
    gap = card_vs_cpu(images, dev, 256)
    assert gap["valid_equal"] and gap["xy_err"] <= 1e-3
    assert gap["desc_err"] <= 1e-5 and gap["n_matches"] > 400
    assert gap["n_differ"] <= 0.005 * gap["n_matches"]


@pytest.mark.gpu
def test_mesh_on_the_card_matches_the_cpu():
    """The point-partitioned backend on 4 shards of the card against the
    same 4 shards on the CPU, f64: g and the step to 1e-9 of their
    largest entry, one bundle(mesh=) with the same iterations, sigma0
    within 1e-9 relative and x within 1e-9 of its largest entry; both
    kernels launch once per shard call."""
    from dbat_tpu_torch.parallel.mesh import make_mesh
    from dbat_tpu_torch.parallel.sharded import ShardedSchurOps
    from dbat_tpu_torch.solve.bundle import bundle

    _card()
    out = {}
    for where in ("cuda:0", "cpu"):
        s, spec = _small_net()
        ops = ShardedSchurOps(s, spec, mesh=make_mesh([where] * 4))
        a0, b0 = fused_bilinear.launches, pair_bucket_acc.launches
        st = ops.normal(ops.x0())
        p, failed = st.solve(-st.g)
        assert not failed
        if where != "cpu":
            torch.cuda.synchronize()
            # Assembly: U, V, W per shard; S: Y and Y Y' per shard.
            assert fused_bilinear.launches - a0 == 5 * 4
            assert pair_bucket_acc.launches - b0 == 4
        s, _spec = _small_net()
        _p, ok, iters, sigma0, info = bundle(s, damping="gna",
                                             mesh=make_mesh([where] * 4))
        out[where] = (st.g.cpu().numpy(), p.cpu().numpy(), ok, iters,
                      sigma0, info.final_x)
    card, cpu = out["cuda:0"], out["cpu"]
    for a, b in zip(card[:2], cpu[:2]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9 * np.abs(b).max())
    assert card[2] and card[2:4] == cpu[2:4]
    assert card[4] == pytest.approx(cpu[4], rel=1e-9)
    np.testing.assert_allclose(card[5], cpu[5], rtol=0,
                               atol=1e-9 * np.abs(cpu[5]).max())


@pytest.mark.gpu
def test_legacy_mesh_on_the_card_matches_the_cpu():
    """The legacy mesh path (SchurOps(mesh=), observation shards, pair
    chunks) on 4 shards of the card against the same on the CPU, f64:
    g, S and the direct step to 1e-9 of their largest entry; on the
    card the PCG step within tests/test_pcg.py's bounds of the direct
    one (1e-5 relative, 1e-6 of its largest entry: PCG stops at 1e-10
    of its residual, so card and CPU iterates part at ~1e-8); kernel A
    launches per shard and per pair chunk, kernel B never (the chunks
    fold the pairs)."""
    from dbat_tpu_torch.parallel.mesh import make_mesh

    _card()
    out = {}
    for where in ("cuda:0", "cpu"):
        s, spec = _small_net()
        ops = SchurOps(s, spec, mesh=make_mesh([where] * 4),
                       pair_chunk=4096)
        a0, b0 = fused_bilinear.launches, pair_bucket_acc.launches
        x0 = ops.x0()
        U, V, Wb, gc, gp, _rw = ops._assemble_impl(x0)
        g = ops.join_x(gc, gp)
        S = ops._schur_S(U, torch.linalg.inv(V), Wb, 0.0)
        p, _L = ops._solve_impl(U, V, Wb, -g, 0.0)
        if where != "cpu":
            torch.cuda.synchronize()
            # U, V, W per shard; Y, Y Y' per shard and a product per
            # shard and chunk, in _schur_S and again in _solve_impl.
            n_chunk = len(ops._chunks)
            assert fused_bilinear.launches - a0 == 4 * (3 + 2 * (2 + n_chunk))
            assert pair_bucket_acc.launches == b0
            q, (_it, rel) = ops._solve_pcg_impl(U, V, Wb, -g, 0.0)
            assert rel <= 1e-10
            np.testing.assert_allclose(
                q.cpu().numpy(), p.cpu().numpy(), rtol=1e-5,
                atol=1e-6 * p.abs().max().item())
        out[where] = [t.cpu().numpy() for t in (g, S, p)]
    for a, b in zip(out["cuda:0"], out["cpu"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9 * np.abs(b).max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,_tol_a,tol_b", DTYPES)
def test_kernel_b_on_a_shard_plan(dtype, _tol_a, tol_b):
    """Kernel B on one shard's PairBucketPlan (its pad pairs index the
    shard's S_obs, outside Y) against the plain version (in f64 on the
    same inputs)."""
    from dbat_tpu_torch.parallel.mesh import make_mesh
    from dbat_tpu_torch.parallel.sharded import ShardedSchurOps

    dev = _card()
    s, spec = _small_net()
    ops = ShardedSchurOps(s, spec, mesh=make_mesh(["cuda:0"] * 4),
                          dtype=dtype)
    fb = ops._fb_pair
    rng = np.random.default_rng(8)
    pads = 0
    for sh in ops.shards:
        plan = sh.pair_plan
        assert int(plan.i1.max()) <= ops.S_obs
        pads += int((plan.i1 == ops.S_obs).sum())  # outside Y
        Y = torch.as_tensor(rng.normal(size=(ops.S_obs, fb.d_a)),
                            dtype=dtype, device=dev)
        got = plan(Y, fb)
        assert torch.equal(got, plan(Y, fb))
        ref = pair_bucket_acc_plain(Y.double(), plan.i1, plan.i2,
                                    plan.row_ptr, fb.table(dev), fb.d_out,
                                    fb.g, plan.cap)
        np.testing.assert_allclose(got.double().cpu().numpy(),
                                   ref.cpu().numpy(), rtol=0,
                                   atol=tol_b * max(1.0, ref.abs().max()
                                                    .item()))
    assert pads > 0
