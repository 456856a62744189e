"""Port parity: the S fill-in plan (PairBucketPlan, kernel B's plain
version) against the JAX PairBucketPlan with its Pallas kernel in
interpret mode.  f32 at the JAX package's own tolerance, atol 2e-5
(sums over up to ~40 pairs in another order).  Also the plan's cut of
the camera pairs into kernel B's per-warp chunks."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from dbat_tpu.solve.flatsel import FlatBilinear as JFlatBilinear
from dbat_tpu.solve.flatsel import abt_terms as jabt_terms
from dbat_tpu.solve.pallas_kernels import PairBucketPlan as JPlan
from dbat_tpu_torch.solve.flatsel import FlatBilinear, abt_terms
from dbat_tpu_torch.solve.kernels import PairBucketPlan


def _problem(seed=5, nb=7, n_obs=400, n_campair=23, n_pairs=900):
    rng = np.random.default_rng(seed)
    cp = np.sort(rng.integers(0, n_campair, n_pairs))
    i1 = rng.integers(0, n_obs, n_pairs)
    i2 = rng.integers(0, n_obs, n_pairs)
    Yf = rng.normal(size=(n_obs, nb * 3))
    return nb, n_obs, n_campair, cp, i1, i2, Yf


@pytest.mark.parametrize("cap", [8, 16])
def test_plan_matches_jax_interpret(cap):
    nb, n_obs, n_campair, cp, i1, i2, Yf = _problem()
    Y32 = Yf.astype(np.float32)
    jfb = JFlatBilinear(nb * 3, nb * 3, jabt_terms(nb, 3, nb), nb * nb)
    jplan = JPlan(i1, i2, cp, n_campair, n_obs, cap=cap, rows_per_tile=16)
    sL, sR = jfb.slot_major_sels()
    ref = np.asarray(jplan(jnp.asarray(Y32), sL, sR, nb * nb, jfb.g,
                           interpret=True))
    fb = FlatBilinear(nb * 3, nb * 3, abt_terms(nb, 3, nb), nb * nb)
    plan = PairBucketPlan(i1, i2, cp, n_campair, n_obs, cap=cap)
    out = plan(torch.as_tensor(Y32), fb)
    assert out.dtype == torch.float32 and out.shape == (n_campair, nb * nb)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-5)
    # Same padded pair layout as the TPU plan, without its tile rows.
    n_real = int(np.asarray(jplan.row_seg < n_campair).sum())
    assert plan.n_rows == n_real
    np.testing.assert_array_equal(plan.i1.numpy(),
                                  np.asarray(jplan.i1)[: n_real * cap])
    assert plan.pad_ratio < 3.0


def test_plan_matches_segment_sum_f64():
    nb, n_obs, n_campair, cp, i1, i2, Yf = _problem(seed=9)
    jfb = JFlatBilinear(nb * 3, nb * 3, jabt_terms(nb, 3, nb), nb * nb)
    ref = jax.ops.segment_sum(np.asarray(jfb(jnp.asarray(Yf[i1]),
                                             jnp.asarray(Yf[i2]))),
                              cp, num_segments=n_campair)
    fb = FlatBilinear(nb * 3, nb * 3, abt_terms(nb, 3, nb), nb * nb)
    out = PairBucketPlan(i1, i2, cp, n_campair, n_obs)(torch.as_tensor(Yf),
                                                        fb)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


def test_plan_rejects_unsorted_pairs():
    with pytest.raises(ValueError):
        PairBucketPlan([0, 1], [1, 2], [1, 0], 2, 3)



def _skewed_problem(seed=11, nb=7, n_obs=500, n_campair=40):
    """Camera pairs of very different lengths: one of >= 60 bucket rows
    of 16, several with no pairs at all, the rest short."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 40, n_campair)
    sizes[[3, 17, 18, 39]] = 0
    sizes[25] = 60 * 16 + 5
    cp = np.repeat(np.arange(n_campair), sizes)
    n_pairs = len(cp)
    i1 = rng.integers(0, n_obs, n_pairs)
    i2 = rng.integers(0, n_obs, n_pairs)
    Yf = rng.normal(size=(n_obs, nb * 3))
    return nb, n_obs, n_campair, cp, i1, i2, Yf


@pytest.mark.parametrize("n_chunks", [1, 3, 7, 16, 64, 1000, None])
def test_plan_partition_covers_each_camera_pair_once(n_chunks):
    nb, n_obs, n_campair, cp, i1, i2, Yf = _skewed_problem()
    plan = PairBucketPlan(i1, i2, cp, n_campair, n_obs, n_chunks=n_chunks)
    ptr = plan.chunk_ptr.numpy()
    # Contiguous, in order, from the first camera pair to the last.
    assert ptr[0] == 0 and ptr[-1] == n_campair
    assert np.all(np.diff(ptr) >= 0)
    owner = np.repeat(np.arange(plan.n_chunks), np.diff(ptr))
    assert len(owner) == n_campair and np.all(np.diff(owner) >= 0)
    # At most one chunk per camera pair; on the CPU the default is one.
    assert plan.n_chunks == (min(n_chunks, n_campair) if n_chunks else 1)
    # No chunk holds more than the mean plus the longest camera pair.
    rows = plan.row_ptr.numpy()
    per_cp = np.diff(rows)
    per_chunk = rows[ptr[1:]] - rows[ptr[:-1]]
    assert per_chunk.sum() == plan.n_rows
    assert per_chunk.max() <= plan.n_rows / plan.n_chunks + per_cp.max()
    assert per_cp.max() >= 60 and np.sum(per_cp == 0) == 4


@pytest.mark.parametrize("n_chunks", [1, 5, 64])
def test_plain_version_same_with_and_without_partition(n_chunks):
    from dbat_tpu_torch.solve.kernels import pair_bucket_acc_plain

    nb, n_obs, n_campair, cp, i1, i2, Yf = _skewed_problem(seed=12)
    fb = FlatBilinear(nb * 3, nb * 3, abt_terms(nb, 3, nb), nb * nb)
    plan = PairBucketPlan(i1, i2, cp, n_campair, n_obs, n_chunks=n_chunks)
    Y = torch.as_tensor(Yf)
    args = (Y, plan.i1, plan.i2, plan.row_ptr, fb.table("cpu"), fb.d_out,
            fb.g, plan.cap)
    whole = pair_bucket_acc_plain(*args)
    # Chunk by chunk, concatenated: each chunk's camera pairs and rows.
    rp, cap = plan.row_ptr.long(), plan.cap
    parts = []
    for a, b in zip(plan.chunk_ptr.tolist()[:-1], plan.chunk_ptr.tolist()[1:]):
        r0, r1 = int(rp[a]), int(rp[b])
        parts.append(pair_bucket_acc_plain(
            Y, plan.i1[r0 * cap:r1 * cap], plan.i2[r0 * cap:r1 * cap],
            plan.row_ptr[a:b + 1] - r0, *args[4:]))
    parted = torch.cat(parts, 0)
    assert parted.shape == (n_campair, nb * nb)
    np.testing.assert_array_equal(parted.numpy(), whole.numpy())
    # Empty camera pairs give zeros; the plan's own call agrees.
    assert not parted[[3, 17, 18, 39]].any()
    ref = np.zeros((n_campair, nb * nb))
    np.add.at(ref, cp, np.einsum("nak,nck->nac", Yf[i1].reshape(-1, nb, 3),
                                 Yf[i2].reshape(-1, nb, 3)).reshape(-1,
                                                                    nb * nb))
    np.testing.assert_allclose(plan(Y, fb).numpy(), ref, rtol=1e-12,
                               atol=1e-12)
