"""Port parity: per-observation residuals and Jacobian blocks of
dbat_tpu_torch.models against dbat_tpu.models, all six model codes.

Inputs come from a seeded ring network with randomized IO (aspect,
skew, K, P) and perturbed EO.  f64 on both sides; tolerance rtol 1e-12
plus an absolute 1e-12 of the largest entry (entries that are zero in
exact arithmetic come out as roundoff of the terms that cancel)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dbat_tpu.models import residuals as jres
from dbat_tpu_torch.models import residuals as tres
from dbat_tpu_torch.pipeline.synthetic import make_ring_network

MODELS = (1, 2, 3, 4, 5, -1)


def _inputs(n_obs=300, seed=3):
    rng = np.random.default_rng(seed)
    s = make_ring_network(n_img=10, n_pt=60, rays_per_pt=(3, 8),
                          n_obs_target=n_obs, noise_px=0.3, seed=seed)
    io = s.io[s.obs_img].copy()
    io[:, 3] += rng.normal(0, 1e-3, s.n_obs)  # aspect
    io[:, 4] = rng.normal(0, 1e-3, s.n_obs)  # skew
    io[:, 5:8] = rng.normal(0, 1e-3, (s.n_obs, 3)) * [1, 1e-2, 1e-4]
    io[:, 8:10] = rng.normal(0, 1e-4, (s.n_obs, 2))
    eo = s.eo[s.obs_img] + rng.normal(0, 0.01, (s.n_obs, 6))
    op = s.op[s.obs_pt]
    return (io, eo, op, s.ip_px, s.sensor_px_size[s.obs_img, 0]), s


def _close(port, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(port), ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("model", MODELS)
def test_residuals_match_jax(model):
    args, s = _inputs()
    ref = jres.make_obs_residual_fn(model, s.nK, s.nP)(
        *[jnp.asarray(a) for a in args])
    out = tres.make_obs_residual_fn(model, s.nK, s.nP)(
        *[torch.as_tensor(a) for a in args])
    assert out.shape == (s.n_obs, 2) and out.dtype == torch.float64
    _close(out, ref)


@pytest.mark.parametrize("with_io", [True, False])
@pytest.mark.parametrize("model", MODELS)
def test_jacobians_match_jax(model, with_io):
    args, s = _inputs()
    ref = jres.make_obs_jacobian_fn(model, s.nK, s.nP, with_io=with_io)(
        *[jnp.asarray(a) for a in args])
    out = tres.make_obs_jacobian_fn(model, s.nK, s.nP, with_io=with_io)(
        *[torch.as_tensor(a) for a in args])
    assert len(out) == len(ref) == (4 if with_io else 3)
    for o, r in zip(out, ref):
        assert tuple(o.shape) == tuple(r.shape)
        _close(o, r)


@pytest.mark.parametrize("model", MODELS)
def test_jacobians_keep_float32(model):
    """f32 inputs give f32 residuals and Jacobian blocks on every path
    (forward-mode tangents must not promote to f64)."""
    args, s = _inputs(n_obs=200)
    t32 = [torch.as_tensor(a, dtype=torch.float32) for a in args]
    for with_io in (True, False):
        out = tres.make_obs_jacobian_fn(model, s.nK, s.nP,
                                        with_io=with_io)(*t32)
        assert all(o.dtype == torch.float32 for o in out)
        assert all(torch.isfinite(o).all() for o in out)


def test_projection_jacobian_matches_jax():
    args, _s = _inputs()
    _io, eo, op, _u, _px = args
    focal = -7.0 * np.ones(len(op))
    ref = [np.stack(v) for v in zip(*[
        jres.projection_jacobian(jnp.asarray(op[k]), jnp.asarray(eo[k, :3]),
                                 jnp.asarray(eo[k, 3:]), focal[k])
        for k in range(0, len(op), 37)])]
    out = tres.projection_jacobian(
        torch.as_tensor(op[::37]), torch.as_tensor(eo[::37, :3]),
        torch.as_tensor(eo[::37, 3:]), torch.as_tensor(focal[::37]))
    for o, r in zip(out, ref):
        _close(o, r)


def test_bad_model_raises():
    with pytest.raises(ValueError):
        tres.make_obs_residual_fn(7, 3, 2)
