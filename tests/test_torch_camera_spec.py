"""Port parity: camera specifications and the camera XML of
dbat_tpu_torch (pipeline/camera_spec.py) against dbat_tpu's.

<camera> elements covering every field and shortcut ('auto' sensor
width and aspect, cc 'focal', pp 'default', all 'default', K/P padded
or cut by nK/nP) parse to equal CameraSpecs in both packages, with
equal derived values; a camera file with two cameras loads equal; and
write_camera_xml writes the same text in both, which reads back to the
written IO row (storable signs undone exactly; the aspect through
1 - aspect; the focal length at 6 digits)."""

import xml.etree.ElementTree as ET

import numpy as np
import pytest

from dbat_tpu.pipeline import camera_spec as jcs
from dbat_tpu.pipeline.synthetic import make_ring_network as jmake
from dbat_tpu_torch.pipeline import camera_spec as tcs
from port_shared import port_project, same_fields

CAMERAS = {
    "full": """<camera><id>2</id><name>c4040z</name><unit>mm</unit>
        <sensor>7.3,5.4</sensor><image>2272,1704</image>
        <aspect>1.0125</aspect><focal>7.45699532273933752</focal>
        <model>3</model><nK>3</nK><nP>2</nP><calibrated>yes</calibrated>
        <cc>7.46</cc><pp>3.6154,2.6133</pp><skew>1e-4</skew>
        <K>0.0045886,-1.2e-5,3e-7</K><P>1e-5,-2e-5</P></camera>""",
    "auto": """<camera><sensor>auto,5.4</sensor><image>2272,1704</image>
        <aspect>auto</aspect><focal>7</focal><cc>focal</cc>
        <pp>default</pp></camera>""",
    "auto sensor, given aspect": """<camera><sensor>auto,4.8</sensor>
        <image>1600,1200</image><aspect>1.01</aspect><focal>6</focal>
        </camera>""",
    "all default": """<camera><sensor>7.3,5.4</sensor>
        <image>2272,1704</image><focal>7.1</focal><model>1</model>
        <all>default</all></camera>""",
    "padded K and P": """<camera><sensor>7.3,5.4</sensor>
        <image>2272,1704</image><aspect>1</aspect><focal>7</focal>
        <K>1e-3</K><nK>3</nK><P>1e-5,2e-5,3e-5</P><nP>2</nP></camera>""",
    "nK without K": """<camera><sensor>7.3,5.4</sensor>
        <image>2272,1704</image><aspect>1</aspect><nK>2</nK><nP>0</nP>
        </camera>""",
}


def _derived(cam):
    return (cam.eval_sensor(), cam.eval_aspect(), cam.io_vector(),
            cam.io_vector(nK=2, nP=1), cam.nK, cam.nP)


@pytest.mark.parametrize("name", list(CAMERAS))
def test_camera_element(name):
    el = ET.fromstring(CAMERAS[name])
    got, ref = tcs.parse_camera_element(el), jcs.parse_camera_element(el)
    same_fields(got, ref)
    for a, b in zip(_derived(got), _derived(ref)):
        np.testing.assert_array_equal(a, b)


def test_cameras_file(tmp_path):
    body = CAMERAS["full"] + CAMERAS["auto"]
    path = tmp_path / "cams.xml"
    path.write_text('<?xml version="1.0"?><document '
                    f'dbat_camera_version="1.0"><cameras>{body}</cameras>'
                    "</document>")
    got, ref = tcs.load_cameras_xml(str(path)), jcs.load_cameras_xml(str(path))
    assert len(got) == len(ref) == 2
    for a, b in zip(got, ref):
        same_fields(a, b)


@pytest.mark.parametrize("row", [0, 3])
def test_write_and_read_back(tmp_path, row):
    j = jmake(n_img=5, n_pt=40, est_io_cols=("cc",), seed=2)
    j.io[:, 0] += 1e-3 * np.arange(5)
    j.io[:, 4] = 2e-4
    t = port_project(j)
    tcs.write_camera_xml(str(tmp_path / "port.xml"), t, cam_row=row)
    jcs.write_camera_xml(str(tmp_path / "jax.xml"), j, cam_row=row)
    text = (tmp_path / "port.xml").read_text()
    assert text == (tmp_path / "jax.xml").read_text()
    assert f"<focal>{t.io[row, 0]:.6g}</focal>" in text
    (cam,) = tcs.load_cameras_xml(str(tmp_path / "port.xml"))
    io = cam.io_vector()
    want = t.io[row].copy()
    want[3] = 1.0 - (1.0 - want[3])
    np.testing.assert_array_equal(io, want)
    np.testing.assert_array_equal(cam.eval_sensor(), t.sensor_ss_size[row])
    assert cam.focal_length == float(f"{t.io[row, 0]:.6g}")
    assert cam.model == t.dist_model and cam.calibrated
