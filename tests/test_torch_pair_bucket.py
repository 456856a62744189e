"""Port parity: the S fill-in plan (PairBucketPlan, kernel B's plain
version) against the JAX PairBucketPlan with its Pallas kernel in
interpret mode.  f32 at the JAX package's own tolerance, atol 2e-5
(sums over up to ~40 pairs in another order)."""

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

