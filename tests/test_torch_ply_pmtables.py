"""Port parity: PLY (io/ply.py ply_read, ply_write) and the PhotoModeler
tables and report (io/pmtables.py load_pm_3d_tbl, load_pm_2d_tbl,
load_pm_report) of dbat_tpu_torch against dbat_tpu's.

PLY: elements of every scalar type made from a seed, written by one
package and read by the other, in ascii and binary little-endian, both
ways; the two writers' bytes are equal and what is read back equals
what was written (exactly; ascii read as float64 from the text that
numpy prints for each type).  The PM loaders read
small synthetic files in PhotoModeler's layouts, field for field
exactly equal to the JAX package's."""

import io

import numpy as np
import pytest

from dbat_tpu.io import ply as jply
from dbat_tpu.io import pmtables as jpmt
from dbat_tpu_torch.io import ply as tply
from dbat_tpu_torch.io import pmtables as tpmt
from port_shared import same_data


def _elements():
    rng = np.random.default_rng(7)
    n = 9
    return {
        "vertex": {
            "x": rng.standard_normal(n).astype(np.float32),
            "y": rng.standard_normal(n),
            "id": rng.integers(0, 2**31 - 1, n).astype(np.int32),
            "flag": rng.integers(0, 255, n).astype(np.uint8),
            "rank": rng.integers(0, 60000, n).astype(np.uint16),
            "count": rng.integers(0, 2**32 - 1, n, dtype=np.uint64)
            .astype(np.uint32),
        },
        "face": {"a": np.arange(4, dtype=np.int16),
                 "w": rng.standard_normal(4).astype(np.float64)},
    }


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ply_round_trip_across_packages(tmp_path, fmt, writer):
    els = _elements()
    write, read = ((tply.ply_write, jply.ply_read) if writer == "port"
                   else (jply.ply_write, tply.ply_read))
    path = tmp_path / "a.ply"
    write(str(path), els, fmt=fmt)
    back = read(str(path))
    same_data(back, (tply if writer == "jax" else jply).ply_read(str(path)),
              "ply")
    for name, props in els.items():
        assert list(back[name]) == list(props)
        for p, v in props.items():
            got = back[name][p]
            if fmt == "ascii":  # read as f64 from each type's shortest text
                assert got.dtype == np.float64
                np.testing.assert_array_equal(got.astype(v.dtype), v)
            else:
                assert got.dtype == v.dtype
                np.testing.assert_array_equal(got, v)
    # Both writers give the same bytes, to a path or a file object.
    buf_t, buf_j = io.BytesIO(), io.BytesIO()
    tply.ply_write(buf_t, els, fmt=fmt)
    jply.ply_write(buf_j, els, fmt=fmt)
    assert buf_t.getvalue() == buf_j.getvalue() == path.read_bytes()


def test_ply_rejects_what_the_jax_reader_rejects(tmp_path):
    bad = tmp_path / "bad.ply"
    bad.write_bytes(b"not a ply file")
    with pytest.raises(ValueError):
        tply.ply_read(str(bad))
    lst = tmp_path / "list.ply"
    lst.write_bytes(b"ply\nformat ascii 1.0\nelement face 1\n"
                    b"property list uchar int vertex_index\nend_header\n"
                    b"3 0 1 2\n")
    with pytest.raises(NotImplementedError):
        tply.ply_read(str(lst))


TBL_3D = """\
PhotoModeler 3D point table
Exported for a test

Id,Name,X (m),Y (m),Z (m),X Precision,Y Precision,Z Precision,\
RMS Residual (pixels),Photos (used)
317,corner,999604.584362,112344.429291,139.446880,0.018165,0.018040,\
0.038075,0.41,"1,2,3,4"
318,,999610.5,112350.25,140.125,0.02,0.021,0.04,,"2,5"
402,tower,999620.0,112360.0,150.5,0.03,0.03,0.05,1.2,"1,5"
"""

TBL_2D = """\
PhotoModeler 2D point table

Object Point ID,Photo #,X (pixels),Y (pixels),Residual X,Residual Y
317,1,1024.5,768.25,0.198028,0.644130
317,2,1030.0,770.0,-0.1,0.05
402,5,12.5,1500.75,0.3,-0.4
"""

REPORT = """\
Project Name: w-op0.pmr
Last Processing Attempt: Wed Jun 01 10:00:00 2016
Version: PhotoModeler Scanner 2016.0.1
Status: successful

Processing Options
  Orientation: off
  Global Optimization: on
  Calibration: off
  Constraints: on

Total Error
  Number of Processing Iterations: 2
  Number of Processing Stages: 1
  First Error: 0.984
  Last Error: 0.977

Photo 1: 8811.jpg
  Omega
    Value: 0.785790 deg
    Deviation: Omega: 0.044 deg
    Correlations over 95.0%: Y:-100.0%
  Phi
    Value: -0.417816 deg
    Deviation: Phi: 0.030 deg
    Correlations over 95.0%: X:99.9%
  Kappa
    Value: -89.916336 deg
    Deviation: Kappa: 0.005 deg
  Xc
    Value: -118.602057 m
    Deviation: X: 0.967 m
  Yc
    Value: 109.300609 m
    Deviation: Y: 1.376 m
  Zc
    Value: 1776.749767 m
    Deviation: Z: 0.174 m
Photo 2: 8812.jpg
  Omega
    Value: 1.5 deg
  Phi
    Value: -0.5 deg
    Deviation: Phi: 0.031 deg
  Kappa
    Value: -90.1 deg
  Xc
    Value: -20.0 m
  Yc
    Value: 110.0 m
  Zc
    Value: 1777.0 m

Photographs
  Total Number: 5
  Bad Photos: 0
  Weak Photos: 1
  OK Photos: 4
  Number Oriented: 5
  Number with inverse camera flags set: 0

Cameras
  Camera1: 2013
    Calibration: no
    Number of photos using camera: 5

Photo Coverage
  References points outside calibrated coverage region:
    Point 317 on Photo 2
    Point 402 on Photo 5

Point Marking Residuals
  Overall RMS: 1.089 pixels
  Maximum: 2.172 pixels
    Point 410 on Photo 4
  Maximum RMS: 1.849 pixels
    Point 410
  Minimum RMS: 0.107 pixels
    Point 12

Point Tightness
  Maximum: 0.21 m
    Point 422
  Minimum: 0.0045 m
    Point 634

Point Precisions
  Overall RMS Vector Length: 0.0472 m
  Maximum Vector Length: 0.0451 m
    Point 7
  Minimum Vector Length: 0.0101 m
    Point 8
  Maximum X: 0.0196 m
  Maximum Y: 0.0196 m
  Maximum Z: 0.0394 m
  Minimum X: 0.0021 m
  Minimum Y: 0.0022 m
  Minimum Z: 0.0051 m

Point Angles
  Maximum: 25.79 deg
    Point 410
  Minimum: 1.05 deg
    Point 20
  Average: 15.73 deg
"""


def test_pm_3d_table_matches_jax(tmp_path):
    path = tmp_path / "3dpts.txt"
    path.write_text(TBL_3D)
    t = tpmt.load_pm_3d_tbl(str(path))
    same_data(t, jpmt.load_pm_3d_tbl(str(path)), "Pm3dTable")
    assert t.id.tolist() == [317, 318, 402] and t.name[1] == ""
    np.testing.assert_array_equal(
        t.pos[:, 0], [999604.584362, 112344.429291, 139.446880])
    assert np.isnan(t.rms[1]) and t.vis.shape == (5, 3)
    assert t.vis[:, 0].tolist() == [True, True, True, True, False]


def test_pm_2d_table_matches_jax(tmp_path):
    path = tmp_path / "2dpts.txt"
    path.write_text(TBL_2D)
    t = tpmt.load_pm_2d_tbl(str(path))
    same_data(t, jpmt.load_pm_2d_tbl(str(path)), "Pm2dTable")
    assert t.id.tolist() == [317, 317, 402] and t.im_no.tolist() == [1, 2, 5]
    np.testing.assert_array_equal(t.res[:, 0], [0.198028, 0.644130])


def test_pm_report_matches_jax(tmp_path):
    path = tmp_path / "pmreport.txt"
    path.write_text(REPORT)
    r = tpmt.load_pm_report(str(path))
    same_data(r, jpmt.load_pm_report(str(path)), "PmReport")
    assert r.proj_name == "w-op0.pmr" and r.status == "successful"
    assert (r.n_iterations, r.n_stages) == (2, 1)
    assert r.proc_opts == {"orient": False, "global_opt": True,
                           "calibration": False, "constraints": True}
    assert r.photo_labels == ["8811.jpg", "8812.jpg"]
    assert r.eo.shape == (2, 6) and np.isnan(r.eo_std[1, 0])
    assert (1, 3, 1, -1.0) in r.eo_corr
    assert r.image_count["weak"] == 1
    assert r.cameras == [{"name": "2013", "calibrated": False,
                          "used_in_images": 5}]
    assert r.pts_uncalibrated == [(317, 2), (402, 5)]
    assert r.mark_residuals["mark_max"] == {"rms": 2.172, "id": 410,
                                            "im_no": 4}
    assert r.tightness["min"] == {"value": 0.0045, "id": 634}
    assert r.pt_angles["avg"] == 15.73
