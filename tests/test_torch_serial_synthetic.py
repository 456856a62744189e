"""Port parity: the synthetic generator, the x-vector layout and the
host-side x0 are identical (bit for bit) in both packages; tensor
serialize/deserialize round-trips."""

import dataclasses

import numpy as np
import pytest
import torch

from dbat_tpu.core.serial import build_serial as jbuild_serial
from dbat_tpu.pipeline.synthetic import make_ring_network as jmake
from dbat_tpu.pipeline.synthetic import perturb as jperturb
from dbat_tpu_torch.core.project import Project, project_from_arrays
from dbat_tpu_torch.core.serial import build_serial, deserialize, serialize
from dbat_tpu_torch.pipeline.synthetic import make_ring_network, perturb

NETS = [
    dict(n_img=12, n_pt=300, rays_per_pt=(3, 9), n_obs_target=1500,
         noise_px=0.1, est_io_cols=("cc", "px", "py", "K1", "K2", "K3",
                                    "P1", "P2"), seed=17),
    dict(n_img=8, n_pt=50, rays_per_pt=4, n_ctrl=6, dist_model=2, seed=3),
]


def _equal(a, b):
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("kw", NETS)
def test_same_seed_same_network_and_layout(kw):
    j = jmake(**kw)
    jperturb(j, io_scale=0.01, seed=4)
    t = make_ring_network(**kw)
    perturb(t, io_scale=0.01, seed=4)
    for f in dataclasses.fields(Project):
        _equal(getattr(t, f.name), getattr(j, f.name))
    js, ts = jbuild_serial(j), build_serial(t)
    for f in dataclasses.fields(ts):
        _equal(getattr(ts, f.name), getattr(js, f.name))


def test_param_names_match_jax():
    from dbat_tpu.core.paramtypes import param_names as jparam_names
    from dbat_tpu_torch.core.paramtypes import param_names

    for kw in NETS:
        t = make_ring_network(**kw)
        assert param_names(t, build_serial(t)) == jparam_names(
            t, jbuild_serial(t))


def test_project_from_arrays_carries_a_jax_project():
    j = jmake(**NETS[0])
    fields = {f.name: getattr(j, f.name) for f in dataclasses.fields(Project)}
    p = project_from_arrays(fields)
    for name, v in fields.items():
        _equal(getattr(p, name), v)
    assert p.io is not j.io  # copied
    with pytest.raises(ValueError):
        project_from_arrays({**fields, "not_a_field": 1})


def test_x0_matches_jax():
    import jax.numpy as jnp

    from dbat_tpu.solve.ops import BundleOps as JOps
    from dbat_tpu_torch.solve.ops import BundleOps

    j = jmake(**NETS[0])
    jperturb(j)
    t = make_ring_network(**NETS[0])
    perturb(t)
    for jd, td in ((jnp.float64, torch.float64), (jnp.float32, torch.float32)):
        jx = np.asarray(JOps(j, jbuild_serial(j), dtype=jd).x0())
        tx = BundleOps(t, build_serial(t), dtype=td, device="cpu").x0()
        assert tx.dtype == td
        np.testing.assert_array_equal(tx.numpy(), jx)


def test_serialize_round_trip_on_tensors():
    t = make_ring_network(**NETS[0])
    spec = build_serial(t)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=spec.n_x))
    base = [torch.as_tensor(a) for a in (t.io, t.eo, t.op)]
    io, eo, op = deserialize(spec, x, *base)
    # Fixed entries keep their value; estimated ones come from x.
    np.testing.assert_array_equal(io.numpy()[spec.io_x < 0],
                                  t.io[spec.io_x < 0])
    np.testing.assert_array_equal(op.numpy()[spec.op_x >= 0],
                                  x.numpy()[spec.op_x[spec.op_x >= 0]])
    x2 = serialize(spec, io, eo, op)
    assert torch.is_tensor(x2)
    np.testing.assert_array_equal(x2.numpy(), x.numpy())
    np.testing.assert_array_equal(
        serialize(spec, io.numpy(), eo.numpy(), op.numpy()), x.numpy())
