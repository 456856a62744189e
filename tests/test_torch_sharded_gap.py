"""Port parity: the f32 sharded solve's gap on a fixed run
(tests/port_sharded_gap.py).  10 fixed f32 fused_gna iterations from a
far start end higher on the point-partitioned backend (8 shards) than
on the unsharded SchurOps, in the JAX package as in the port: the JAX
package's sharded solve has a fixed 1e-3 Cholesky jitter where its
unsharded one climbs a ladder from 3e-6, and the port keeps both.
Each of the four runs within 1e-4 relative of the other package's
same run; the two packages' gaps, sharded over unsharded, within 5% of
each other and above 1e-3."""

import pytest

from port_sharded_gap import fixed_runs, gaps


def test_sharded_f32_gap_is_the_jax_packages():
    runs = fixed_runs()
    for backend in ("unsharded", "8 shards"):
        assert runs[("port", backend)] == pytest.approx(
            runs[("jax", backend)], rel=1e-4)
    g = gaps(runs)
    assert g["jax"] > 1e-3
    assert g["port"] == pytest.approx(g["jax"], rel=0.05)
