"""The JAX package's outcome for chip_smoke.py's polish phase.

    JAX_PLATFORMS=cpu python scripts/jax_polish_reference.py

Runs dbat_tpu's bundle() on the CPU on the roma watchdog network
(ROMA_RING of dbat_tpu_torch/pipeline/synthetic.py, bench.py:69-75,
perturbation seed 24), f32 LM on the Schur backend asked for a relative
1e-6, so that the f64 polish runs: once eager (jax.disable_jit()) and
once jitted, and prints ok, code, the iterations, sigma0, the pre-polish
sigma0 and the polish steps of each.  chip_smoke.py's POLISH_EXPECT
holds the eager run's numbers; the jitted run is printed to show why
not those (XLA's CPU build of the f32 Schur solve fails to factor at
small lambda on this network).  About 2 minutes and 3 GB on the CPU.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp

from dbat_tpu.pipeline.synthetic import make_ring_network, perturb
from dbat_tpu.solve.bundle import bundle
# The network's arguments come from the port, so POLISH_EXPECT always
# describes the network chip_smoke.py runs.
from dbat_tpu_torch.pipeline.synthetic import ROMA_RING


def run(eager):
    r = make_ring_network(**ROMA_RING)
    perturb(r, eo_pos=0.02, eo_ang=0.004, op_pos=0.02, seed=24)
    t0 = time.time()
    with jax.disable_jit(eager):
        _p, ok, iters, sigma0, info = bundle(
            r, damping="lm", dtype=jnp.float32, backend="schur",
            max_iter=40, conv_tol=1e-6, abs_term=False)
    print({"mode": "eager" if eager else "jit", "ok": ok, "code": info.code,
           "iters": iters, "sigma0": sigma0,
           "sigma0_prepolish": info.sigma0_prepolish,
           "polish_iters": info.polish_iters,
           "floor_stall": info.damping.get("floor_stall"),
           "first_lambdas": info.damping["lambdas"][:6],
           "seconds": round(time.time() - t0, 1)}, flush=True)


if __name__ == "__main__":
    run(eager=True)
    run(eager=False)
