"""Port parity: the text-table loaders of dbat_tpu_torch (io/cpt.py,
io/tables.py, io/eotable.py) against dbat_tpu's on the same files.

Tables made from a numpy seed are written once per test to tmp_path
with %.17g, and hand-written edge cases cover comments, blank lines,
every control-point std count (3, 4, 5, 6 and 12 values), every
format part of the EO table and the malformed inputs each loader
rejects.  The port's loaders are copies of the JAX package's numpy
code: results must be exactly equal."""

import numpy as np
import pytest

from dbat_tpu.io import cpt as jcpt
from dbat_tpu.io import eotable as jeo
from dbat_tpu.io import tables as jtab
from dbat_tpu_torch.io import cpt as tcpt
from dbat_tpu_torch.io import eotable as teo
from dbat_tpu_torch.io import tables as ttab
from port_shared import same_fields

CPT_LINES = """\
# id,label,x,y,z[,std...]
1, a, 1.5, -2.25, 3.125

2,b,0.1,0.2,0.3,0.01
   # indented comment
3,c,4,5,6,0.02,0.05
4,d,7,8,9,0.1,0.2,0.3
5,e,1,2,3,4,0.5,0.1,0.5,9,0.2,0.1,0.2,1
"""


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def test_cpt_every_std_count(tmp_path):
    path = _write(tmp_path, "cpt.txt", CPT_LINES)
    got, ref = tcpt.load_cpt(path), jcpt.load_cpt(path)
    same_fields(got, ref)
    assert got.cov.shape == (3, 3, 5)
    np.testing.assert_array_equal(got.std[:, 0], 0.0)
    np.testing.assert_array_equal(got.std[:, 2], [0.02, 0.02, 0.05])


@pytest.mark.parametrize("has_id,has_name", [(True, False), (False, True),
                                             (False, False)])
def test_cpt_without_id_or_label(tmp_path, has_id, has_name):
    rows = [("7", "p7"), ("8", "p8")]
    lines = [",".join([i] * has_id + [n] * has_name + ["1", "2", "3"])
             for i, n in rows]
    path = _write(tmp_path, "cpt.txt", "\n".join(lines) + "\n")
    got = tcpt.load_cpt(path, has_id=has_id, has_name=has_name)
    same_fields(got, jcpt.load_cpt(path, has_id=has_id, has_name=has_name))
    assert got.cov is None


def test_cpt_rejects_a_bad_count_and_reads_an_empty_file(tmp_path):
    bad = _write(tmp_path, "bad.txt", "1,a,1,2,3,4,5,6,7\n")
    for mod in (tcpt, jcpt):
        with pytest.raises(ValueError, match="Bad number of items"):
            mod.load_cpt(bad)
    empty = _write(tmp_path, "empty.txt", "# nothing\n\n")
    got = tcpt.load_cpt(empty)
    same_fields(got, jcpt.load_cpt(empty))
    assert got.pos.shape == (3, 0)


def test_image_table(tmp_path):
    text = "# id,path\n3,images/a.jpg\n\n1, images/b.jpg\n"
    path = _write(tmp_path, "images.txt", text)
    ids, paths = ttab.load_image_table(path)
    rids, rpaths = jtab.load_image_table(path)
    np.testing.assert_array_equal(ids, rids)
    assert paths == rpaths == ["images/a.jpg", "images/b.jpg"]
    flipped = _write(tmp_path, "flipped.txt", "a.jpg,4\nb.jpg,2\n")
    got = ttab.load_image_table(flipped, "path,id")
    ref = jtab.load_image_table(flipped, "path,id")
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1] == ref[1]


@pytest.mark.parametrize("fmt", ["im,id,x,y,sxy", "im,id,x,y,sx,sy",
                                 "im,id,x,y", "id,im,y,x,sy,sx"])
def test_image_points(tmp_path, fmt):
    rng = np.random.default_rng(3)
    n = 500
    cols = {"im": rng.integers(1, 9, n), "id": rng.integers(1, 400, n),
            "x": rng.uniform(0, 2272, n), "y": rng.uniform(0, 1704, n),
            "sxy": rng.uniform(0.05, 0.5, n), "sx": rng.uniform(0.05, 0.5, n),
            "sy": rng.uniform(0.05, 0.5, n)}
    parts = fmt.split(",")
    table = np.column_stack([cols[p] for p in parts])
    path = str(tmp_path / "pts.txt")
    np.savetxt(path, table, delimiter=",", fmt="%.17g", header=fmt)
    got = ttab.load_image_pts(path, fmt, default_sxy=0.25)
    ref = jtab.load_image_pts(path, fmt, default_sxy=0.25)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[:, 2], cols["x"])  # %.17g: exact


def test_image_points_reject_a_wrong_format(tmp_path):
    path = _write(tmp_path, "pts.txt", "1,2,3.5,4.5,0.1\n")
    for mod in (ttab, jtab):
        with pytest.raises(ValueError, match="columns"):
            mod.load_image_pts(path, "im,id,x,y")


@pytest.mark.parametrize("fmt,row", [
    ("id,label,x,y,z", "5,cp5,1.5,2.5,3.5"),
    ("id,x,y,z,sx,sy,sz", "5,1.5,2.5,3.5,0.1,0.2,0.3"),
    ("label,x,y,z,sxy,sz", "cp5,1.5,2.5,3.5,0.1,0.2"),
    ("id,label,x,y,z,sxyz", "5,cp5,1.5,2.5,3.5,0.04"),
])
def test_ctrl_points(tmp_path, fmt, row):
    path = _write(tmp_path, "ctrl.txt", f"# {fmt}\n{row}\n\n{row}\n")
    same_fields(ttab.load_ctrl_pts(path, fmt), jtab.load_ctrl_pts(path, fmt))


def test_ctrl_points_filter_and_errors(tmp_path):
    path = _write(tmp_path, "cpt.txt", CPT_LINES)
    for mode in ("keep", "remove"):
        got = ttab.filter_ctrl_pts(tcpt.load_cpt(path), [2, 5], mode)
        ref = jtab.filter_ctrl_pts(jcpt.load_cpt(path), [2, 5], mode)
        same_fields(got, ref)
    assert list(got.id) == [1, 3, 4]
    for tab, cp in ((ttab, tcpt), (jtab, jcpt)):
        with pytest.raises(ValueError, match="Bad filter mode"):
            tab.filter_ctrl_pts(cp.load_cpt(path), [2], "drop")
        with pytest.raises(ValueError, match="items"):
            tab.load_ctrl_pts(path, "id,label,x,y,z")


@pytest.mark.parametrize("fmt", [
    "id,label,x,y,z,omega,phi,kappa",
    "id,ignored,x,y,z,sx,sy,sz,omega,phi,kappa,so,sp,sk",
    "label,x,y,z,sxyz,omega,phi,kappa,sang",
    "id,x,y,z,sxy,sz",
])
def test_eo_table(tmp_path, fmt):
    rng = np.random.default_rng(8)
    parts = fmt.split(",")
    lines = [f"# {fmt}"]
    for i in range(6):
        vals = {"id": str(i + 1), "label": f"img{i}", "ignored": "skip"}
        lines.append(",".join(vals.get(p, f"{rng.normal():.17g}")
                              for p in parts))
    path = _write(tmp_path, "eo.txt", "\n".join(lines) + "\n")
    got, ref = teo.load_eo_table(path, fmt), jeo.load_eo_table(path, fmt)
    same_fields(got, ref)
    if "omega" in parts:  # degrees in the file, radians in the table
        deg = float(lines[1].split(",")[parts.index("omega")])
        assert got.ang[0, 0] == deg * np.pi / 180.0


def test_eo_table_errors(tmp_path):
    path = _write(tmp_path, "eo.txt", "1,img,1,2,3\n")
    for mod in (teo, jeo):
        with pytest.raises(ValueError, match="Invalid format parts"):
            mod.load_eo_table(path, "id,label,x,y,height")
        with pytest.raises(ValueError, match="wrong number of elements"):
            mod.load_eo_table(path, "id,label,x,y,z,omega")


@pytest.mark.parametrize("has", [(True, True), (False, True), (True, False)])
def test_legacy_eo_table(tmp_path, has):
    rows = ["3,st3,10.5,-2.5,1.25,0.01", "4,st4,11,-3,1.5"]
    lines = [",".join(t for k, t in enumerate(r.split(","))
                      if (k != 0 or has[0]) and (k != 1 or has[1]))
             for r in rows]
    path = _write(tmp_path, "eo.txt", "# legacy\n" + "\n".join(lines) + "\n")
    got = teo.legacy_load_eo_table(path, has)
    same_fields(got, jeo.legacy_load_eo_table(path, has))
    assert np.isnan(got.ang).all()
