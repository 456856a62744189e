"""Port parity: fused_gna of dbat_tpu_torch against dbat_tpu's fused_gna
on the same network: status code, iteration count and the final
residual norm (sigma0 up to the constant sqrt(dof)).

f64: identical codes and counts, sigma0 within 1e-8 relative.  f32:
identical codes and counts on this seed, sigma0 within 1e-4 relative
(f32 sums in another order move the final residual in its 5th digit),
and the residual norms along the way within 1e-2 (an f32 step carries
~2% error on this network in both packages, test_torch_schur)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dbat_tpu.core.serial import build_serial as jbuild_serial
from dbat_tpu.pipeline.synthetic import make_ring_network as jmake
from dbat_tpu.pipeline.synthetic import perturb as jperturb
from dbat_tpu.solve.fused import fused_gna as jfused_gna
from dbat_tpu.solve.schur import SchurOps as JSchurOps
from dbat_tpu_torch.core.serial import build_serial
from dbat_tpu_torch.pipeline.synthetic import make_ring_network, perturb
from dbat_tpu_torch.solve import solvers
from dbat_tpu_torch.solve.fused import _buffer_cap, fused_gna
from dbat_tpu_torch.solve.schur import SchurOps

NET = dict(n_img=12, n_pt=400, rays_per_pt=(3, 9), n_obs_target=2000,
           n_ctrl=4, noise_px=0.1,
           est_io_cols=("cc", "px", "py", "K1", "K2", "K3", "P1", "P2"),
           seed=5)


def _ops(jdt, tdt):
    j = jmake(**NET)
    jperturb(j, eo_pos=0.02, eo_ang=0.004, op_pos=0.02, seed=6)
    t = make_ring_network(**NET)
    perturb(t, eo_pos=0.02, eo_ang=0.004, op_pos=0.02, seed=6)
    return (JSchurOps(j, jbuild_serial(j), dtype=jdt),
            SchurOps(t, build_serial(t), dtype=tdt, device="cpu"))


def _agree(rj, rt, rtol, rtol_path=None):
    assert rt.code == rj.code
    assert rt.iters == rj.iters
    assert len(rt.res_norms) == len(rj.res_norms)
    assert rt.damping["alphas"] == rj.damping["alphas"]
    assert rt.damping["floor_stall"] == rj.damping["floor_stall"]
    nj = np.linalg.norm(rj.final_rw)
    nt = np.linalg.norm(rt.final_rw)
    assert nt == pytest.approx(nj, rel=rtol)
    np.testing.assert_allclose(rt.res_norms[-1], rj.res_norms[-1], rtol=rtol)
    np.testing.assert_allclose(rt.res_norms, rj.res_norms,
                               rtol=rtol_path or rtol)


def test_fused_gna_matches_jax_f64():
    jops, tops = _ops(jnp.float64, torch.float64)
    x0 = np.asarray(jops.x0())
    rj = jfused_gna(jops, x0, max_iter=20)
    rt = fused_gna(tops, x0, max_iter=20)
    assert rt.code == solvers.OK
    _agree(rj, rt, 1e-8)
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-9)
    assert rt.damping["host_syncs"] >= rt.iters


def test_fused_gna_too_many_iters_matches_jax():
    """Fixed-iteration run (conv_tol 0, stall rule off) from a far
    start: TOO_MANY_ITERS, with the final norm appended."""
    jops, tops = _ops(jnp.float64, torch.float64)
    rng = np.random.default_rng(99)
    x0 = np.asarray(jops.x0()) + 0.05 * rng.standard_normal(jops.n_x)
    rj = jfused_gna(jops, x0, max_iter=3, conv_tol=0.0, stall_tol=-1.0)
    rt = fused_gna(tops, x0, max_iter=3, conv_tol=0.0, stall_tol=-1.0)
    assert rt.code == solvers.TOO_MANY_ITERS
    assert rt.iters == 4 and len(rt.res_norms) == 5
    _agree(rj, rt, 1e-8)


def test_fused_gna_matches_jax_f32_absterm():
    """bench.py's time-to-convergence call, at a small size, in f32."""
    jops, tops = _ops(jnp.float32, torch.float32)
    x0 = np.asarray(jops.x0())
    floor = float(np.sqrt(tops.n_res - tops.n_x))
    rj = jfused_gna(jops, x0, max_iter=20, conv_tol=floor, abs_term=True)
    rt = fused_gna(tops, x0, max_iter=20, conv_tol=floor, abs_term=True)
    assert rt.code == solvers.OK and rt.x.dtype == np.float32
    _agree(rj, rt, 1e-4, rtol_path=1e-2)


def test_buffer_cap():
    assert _buffer_cap(20) == 66 and _buffer_cap(64) == 66
    assert _buffer_cap(65) == 128 and _buffer_cap(300) == 512
