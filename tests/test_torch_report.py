"""Port parity: the DBAT result file written by dbat_tpu_torch's
write_report against dbat_tpu's, each after its own f64 bundle() on the
CPU on the same self-calibrating ring network (port_shared.py, shared
with test_torch_covariance.py), on the Schur backend (the C5 shape's;
the dense covariance branch is held to the Schur one in
test_torch_covariance.py).

Lines that change from run to run are masked, and nothing else: the
computation UUID, the time stamp of the last bundle run, the package
version and the five execution times.  Every other line must have the
same words, and its numbers must agree within rtol 1e-8 (the two
bundles agree to their parity tolerance, test_torch_bundle.py).  The
posterior std the two return are held to the same 1e-8."""

import re

import numpy as np

from dbat_tpu.io.report import write_report as jwrite_report
from dbat_tpu_torch.io.report import write_report
from dbat_tpu_torch.solve.bundle import bundle
from port_shared import jax_solved, one_thread  # noqa: F401

MASKED = ("Computation UUID", "Last Bundle Run", "DBAT-TPU version",
          "Bundle:", "Post-cov prep:", "Post-cov CIO:", "Post-cov CEO:",
          "Post-cov COP:")
NUMBER = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")


def _tokens(line):
    """(words, numbers) of a report line."""
    return NUMBER.sub("#", line), [float(v) for v in NUMBER.findall(line)]


def test_report_matches_jax(tmp_path):
    t, pj, ij = jax_solved()
    pt, ok, _, _, it = bundle(t, backend="schur", device="cpu")
    assert ok
    stats_j = jwrite_report(pj, ij, tmp_path / "jax.txt")
    stats_t = write_report(pt, it, tmp_path / "port.txt")

    ref = (tmp_path / "jax.txt").read_text().splitlines()
    got = (tmp_path / "port.txt").read_text().splitlines()
    assert len(got) == len(ref) > 400
    n_masked = 0
    for a, b in zip(got, ref):
        if b.strip().startswith(MASKED):
            assert a.strip().split(":")[0] == b.strip().split(":")[0]
            n_masked += 1
            continue
        (wa, na), (wb, nb) = _tokens(a), _tokens(b)
        assert wa == wb, (a, b)
        np.testing.assert_allclose(na, nb, rtol=1e-8, atol=0,
                                   err_msg=f"{a!r} vs {b!r}")
    assert n_masked == len(MASKED)
    for key in ("std_io", "std_eo", "std_op"):
        np.testing.assert_allclose(stats_t[key], stats_j[key], rtol=1e-8,
                                   atol=0)
