"""The f32 sharded solve's gap on a fixed run, in both packages.

    JAX_PLATFORMS=cpu python tests/port_sharded_gap.py

The point-partitioned backend of the JAX package solves the reduced
camera system with a fixed f32 Cholesky jitter of 1e-3 of the scaled
diagonal (dbat_tpu/parallel/sharded.py:553), where its unsharded
SchurOps climbs a ladder from 3e-6; the port keeps both solves as they
are.  Far from the optimum the fixed jitter damps the steps, so a fixed
run on the shards ends above the unsharded run from the same start.

`fixed_runs` runs GAP_NET (a C5-like ring cut to a size the CPU runs in
seconds: every ray count, the 8 self-calibrated IO parameters) from
chip_smoke.py's phase 6 start (x0 plus 0.05 N(0, 1) in every unknown,
seed 99) for 10 fixed f32 fused_gna iterations, in the JAX package (8
virtual CPU devices) and in the port (8 CPU shards), sharded and
unsharded, and returns each final ||r_w||.  Run as a script it prints
them and the relative gaps, sharded over unsharded, of each package.
tests/test_torch_multichip.py holds the port's gap to the JAX
package's.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dbat_tpu.core.serial import build_serial as jbuild_serial  # noqa: E402
from dbat_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from dbat_tpu.parallel.sharded import ShardedSchurOps as JSharded  # noqa
from dbat_tpu.pipeline.synthetic import make_ring_network as jmake  # noqa
from dbat_tpu.solve.fused import fused_gna as jfused_gna  # noqa: E402
from dbat_tpu.solve.schur import SchurOps as JSchurOps  # noqa: E402
from dbat_tpu_torch.core.project import Project, project_from_arrays  # noqa
from dbat_tpu_torch.core.serial import build_serial  # noqa: E402
from dbat_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from dbat_tpu_torch.parallel.sharded import ShardedSchurOps  # noqa: E402
from dbat_tpu_torch.solve.fused import fused_gna  # noqa: E402
from dbat_tpu_torch.solve.schur import SchurOps  # noqa: E402

#: C5_RING (bench.py:138-145) with 40 of its 239 cameras and 1,500 of
#: its 17,993 points; the ray counts, noise and IO columns are C5's.
GAP_NET = dict(n_img=40, n_pt=1500, rays_per_pt=(3, 40),
               n_obs_target=16400, n_ctrl=8, noise_px=0.1, ip_std_px=0.1,
               est_io_cols=("cc", "px", "py", "K1", "K2", "K3", "P1", "P2"),
               seed=17)
N_FIXED = 10


def fixed_runs():
    """{(package, backend): final ||r_w||} of the fixed f32 runs."""
    import dataclasses

    j = jmake(**GAP_NET)
    t = project_from_arrays({f.name: getattr(j, f.name)
                             for f in dataclasses.fields(Project)})
    jspec, spec = jbuild_serial(j), build_serial(t)
    one = SchurOps(t, spec, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(99)
    start = one.x0().numpy() + 0.05 * rng.standard_normal(one.n_x)
    ops = {
        ("jax", "unsharded"): JSchurOps(j, jspec, dtype=np.float32),
        ("jax", "8 shards"): JSharded(j, jspec, mesh=jmake_mesh(),
                                      dtype=np.float32),
        ("port", "unsharded"): one,
        ("port", "8 shards"): ShardedSchurOps(
            t, spec, mesh=make_mesh(["cpu"] * 8), dtype=torch.float32),
    }
    out = {}
    for key, o in ops.items():
        run = jfused_gna if key[0] == "jax" else fused_gna
        r = run(o, start.astype(np.float32), max_iter=N_FIXED,
                conv_tol=0.0, stall_tol=-1.0)
        rw = np.asarray(r.final_rw, np.float64)
        out[key] = float(np.sqrt(rw @ rw))
    return out


def gaps(runs):
    """{package: ||r_w|| on 8 shards / unsharded - 1}."""
    return {pkg: runs[(pkg, "8 shards")] / runs[(pkg, "unsharded")] - 1
            for pkg in ("jax", "port")}


if __name__ == "__main__":
    runs = fixed_runs()
    for key, rn in runs.items():
        print(f"{key[0]:4s} {key[1]:9s} ||r_w|| after {N_FIXED} fixed f32 "
              f"iterations: {rn!r}")
    print(f"sharded over unsharded, relative: {gaps(runs)}")
