"""Port parity: the result-file writers, the statistics file and the
report comparison of dbat_tpu_torch (io/writers.py, io/stats.py,
io/report_compare.py) against dbat_tpu's.

The writers get the same project (a ring network with residuals and
posterior std made from a seed) in both packages and must write the
same text, apart from the lines that change from run to run (the UUID,
the time stamp) and the package's name.  report_compare mirrors the 8
cases of tests/test_report_compare_unit.py as one parametrised test,
run on the port's module, and holds the port's parse and comparison
to the JAX package's on those inputs."""

import numpy as np
import pytest

from dbat_tpu.io import report_compare as jrc
from dbat_tpu.io import stats as jst
from dbat_tpu.io import writers as jwr
from dbat_tpu.pipeline.synthetic import make_ring_network as jmake
from dbat_tpu.pipeline.synthetic import perturb as jperturb
from dbat_tpu_torch.io import report_compare as trc
from dbat_tpu_torch.io import stats as tst
from dbat_tpu_torch.io import writers as twr
from port_shared import port_project

#: Lines that may differ: run-to-run values and the package's name.
VOLATILE = ("# Execution UUID:", "# Generated by", "Execution time stamp:")


def _pair():
    j = jmake(n_img=9, n_pt=90, rays_per_pt=(2, 7), n_obs_target=360,
              n_ctrl=4, seed=11)
    jperturb(j, seed=2)
    j.is_check[20:23] = True
    rng = np.random.default_rng(6)
    res = rng.normal(scale=0.3, size=(j.n_obs, 2))
    j.post = {"ip_res_px": res}
    t = port_project(j)
    t.post = {"ip_res_px": res.copy()}
    return j, t


def _same_text(got, ref):
    got, ref = got.splitlines(), ref.splitlines()
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        if b.startswith(VOLATILE):
            assert a.split(":")[0].split(" by")[0] == \
                b.split(":")[0].split(" by")[0]
        else:
            assert a == b


@pytest.mark.parametrize("with_std", [False, True])
def test_eo_file(tmp_path, with_std):
    j, t = _pair()
    std = (np.random.default_rng(1).uniform(1e-4, 1e-2, (j.n_img, 6))
           if with_std else None)
    twr.write_eo_file(str(tmp_path / "port.txt"), t, std, script_name="s.xml")
    jwr.write_eo_file(str(tmp_path / "jax.txt"), j, std, script_name="s.xml")
    text = (tmp_path / "port.txt").read_text()
    _same_text(text, (tmp_path / "jax.txt").read_text())
    assert "# Generated by dbat_tpu_torch." in text
    assert len(text.splitlines()) == 5 + j.n_img


@pytest.mark.parametrize("top", [1, 50, 10_000])
def test_top_residuals(tmp_path, top):
    j, t = _pair()
    twr.write_top_residuals(str(tmp_path / "port.txt"), t, top, "s.xml")
    jwr.write_top_residuals(str(tmp_path / "jax.txt"), j, top, "s.xml")
    text = (tmp_path / "port.txt").read_text()
    _same_text(text, (tmp_path / "jax.txt").read_text())
    assert len(text.splitlines()) == 6 + min(top, j.n_obs)


def test_cam_angles_and_stats_file(tmp_path):
    j, t = _pair()
    j.op[5] = t.op[5] = np.nan  # a point without a value is skipped
    np.testing.assert_array_equal(tst.cam_angles(t), jst.cam_angles(j))
    tst.write_stats(t, str(tmp_path / "port.txt"), desc="ring")
    jst.write_stats(j, str(tmp_path / "jax.txt"), desc="ring")
    text = (tmp_path / "port.txt").read_text()
    _same_text(text, (tmp_path / "jax.txt").read_text())
    for section in ("IMAGE STATISTICS", "CONTROL POINT STATISTICS",
                    "OBJECT POINT STATISTICS"):
        assert section in text


# -- report_compare: the 8 cases of tests/test_report_compare_unit.py --------

def _ulp_from_printed_precision(m):
    assert m._ulp("30873.9") == 0.1
    assert m._ulp("2.08e-05") == 1e-7
    assert m._ulp("0.00105") == 1e-5
    assert m._ulp("42") == 1.0
    assert m._is_int("42") and not m._is_int("42.0")


def _last_printed_digit_tolerance(m):
    ours = "   K2:\n      Value: -4.41171e-05 mm\n"
    gold = "   K2:\n      Value: -4.41172e-05 mm\n"
    assert m.compare_reports(ours, gold) == []
    worse = "   K2:\n      Value: -4.41190e-05 mm\n"
    assert m.compare_reports(worse, gold)


def _integers_compare_exactly(m):
    assert m.compare_reports("  Redundancy 3725\n", "  Redundancy 3726\n")
    assert m.compare_reports("  Redundancy 3725\n",
                             "  Redundancy 3725\n") == []


def _indentation_paths_qualify_repeated_labels(m):
    a = "A\n   Value: 1.5\nB\n   Value: 2.5\n"
    b = "A\n   Value: 1.5\nB\n   Value: 9.9\n"
    diffs = m.compare_reports(a, b)
    assert len(diffs) == 1 and diffs[0].startswith("B /")


def _path_values_stripped_but_units_kept(m):
    ours = ("   Input file name  : /our/path/x.txt\n"
            "   X resolution:\n      Value: 313.249 px/mm\n")
    gold = ("   Input file name  : /their/path/y.txt\n"
            "   X resolution:\n      Value: 313.374 px/mm\n")
    diffs = m.compare_reports(ours, gold)
    assert len(diffs) == 1 and "X resolution" in diffs[0]


def _padding_insensitive_keys(m):
    assert m.compare_reports("  Value:     1.5 mm\n",
                             "  Value: 1.5 mm\n") == []


def _one_sided_keys_flagged_unless_allowed(m):
    diffs = m.compare_reports("  OursOnly: 1\n", "  GoldenOnly: 2\n")
    assert any("ours-only" in d for d in diffs)
    assert any("golden-only" in d for d in diffs)
    assert m.compare_reports(
        "  OursOnly: 1\n", "  GoldenOnly: 2\n",
        ours_only=["OursOnly"], golden_only=["GoldenOnly"]) == []


def _parse_collects_repeated_keys_in_order(m):
    ent = m.parse_report("T\n   Max: 1.0\n   Max: 2.0\n")
    key = ("T", "Max: #")
    assert [v[0][0] for v in ent[key]] == [1.0, 2.0]


@pytest.mark.parametrize("case", [
    _ulp_from_printed_precision, _last_printed_digit_tolerance,
    _integers_compare_exactly, _indentation_paths_qualify_repeated_labels,
    _path_values_stripped_but_units_kept, _padding_insensitive_keys,
    _one_sided_keys_flagged_unless_allowed,
    _parse_collects_repeated_keys_in_order,
], ids=lambda f: f.__name__[1:])
def test_report_compare_case(case):
    case(trc)


REPORTS = (
    "Report\n   Sigma0: 0.99412\n   Values:\n      cc: 7.00001 mm\n"
    "   Input file name  : /a/b.xml\n   Redundancy 3725\n"
    "   Max: 1.5 (pt 12)\n   Max: 2.5e-05 (pt 13)\n",
    "Report\n   Sigma0: 0.99413\n   Values:\n      cc: 7.00011 mm\n"
    "   Input file name  : /c/d.xml\n   Redundancy 3724\n"
    "   Max: 1.5 (pt 12)\n   Extra: 3\n",
)


@pytest.mark.parametrize("kw", [{}, {"rtol": 1e-4}, {"volatile": ["Max"]},
                                {"ours_only": ["Max"], "golden_only":
                                 ["Extra"], "loose": [("cc", 1e-3)]}])
def test_report_compare_matches_jax(kw):
    ours, gold = REPORTS
    assert trc.parse_report(ours) == jrc.parse_report(ours)
    assert trc.compare_reports(ours, gold, **kw) == \
        jrc.compare_reports(ours, gold, **kw)
