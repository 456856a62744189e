"""Camera specifications (the @DBATCamera analog) and camera XML I/O (a
numpy copy of dbat_tpu/pipeline/camera_spec.py).

References: code/classes/@DBATCamera/DBATCamera.m (value class with
PhotoModeler sign conventions for storable pp/K/P — PMSign=-1),
code/script/parsedbatxmlcamstruct.m (XML fields, 'auto' sensor/aspect),
code/script/loadcameras.m (dbat_camera_version 1.0 documents).

Storable (file) convention vs internal convention: storable py, K, P
are negated relative to the internal DBAT parameters
(DBATCamera.m:59-90); the internal IO vector is
[cc, px, py, 1-aspect, skew, K.., P..].
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class CameraSpec:
    id: int = -1
    name: str = ""
    unit: str = "mm"
    sensor_size: np.ndarray = None  # [w,h] physical; w may be nan=auto
    image_size: np.ndarray = None  # [w,h] px
    focal_length: float = np.nan
    aspect_ratio: float = np.nan  # nan = auto
    skew: float = 0.0
    camera_constant: float = np.nan
    model: int = 3
    calibrated: bool = False
    # Internal-convention values:
    pp: np.ndarray = None  # internal (py negative)
    K: np.ndarray = field(default_factory=lambda: np.full(3, np.nan))
    P: np.ndarray = field(default_factory=lambda: np.full(2, np.nan))

    @property
    def nK(self):
        return len(self.K)

    @property
    def nP(self):
        return len(self.P)

    def eval_sensor(self) -> np.ndarray:
        """Resolve 'auto' sensor width (parsedbatxmlcamstruct.m
        evalsensor): w = aspect*h*imW/imH."""
        s = np.array(self.sensor_size, dtype=float)
        if np.isnan(s[0]):
            a = self.aspect_ratio if np.isfinite(self.aspect_ratio) else 1.0
            s[0] = a * s[1] * self.image_size[0] / self.image_size[1]
        return s

    def eval_aspect(self) -> float:
        if np.isfinite(self.aspect_ratio):
            return self.aspect_ratio
        px = self.eval_sensor() / self.image_size
        return px[0] / px[1]

    def io_vector(self, nK=None, nP=None) -> np.ndarray:
        """Internal IO vector [cc,px,py,as,sk,K..,P..]."""
        nK = nK if nK is not None else self.nK
        nP = nP if nP is not None else self.nP
        v = np.full(5 + nK + nP, np.nan)
        v[0] = self.camera_constant
        if self.pp is not None:
            v[1:3] = self.pp
        v[3] = 1.0 - self.eval_aspect()
        v[4] = self.skew
        v[5:5 + min(nK, self.nK)] = self.K[:nK]
        v[5 + nK:5 + nK + min(nP, self.nP)] = self.P[:nP]
        return v


def _get_text(el, tag):
    e = el.find(tag)
    return e.text.strip() if e is not None and e.text else None


def parse_camera_element(el) -> CameraSpec:
    """One <camera> XML element -> CameraSpec
    (parsedbatxmlcamstruct.m)."""
    cam = CameraSpec()
    t = _get_text
    if t(el, "id"):
        cam.id = int(t(el, "id"))
    if t(el, "name"):
        cam.name = t(el, "name")
    if t(el, "unit"):
        cam.unit = t(el, "unit")
    if t(el, "sensor"):
        ss = [x.strip() for x in t(el, "sensor").split(",")]
        cam.sensor_size = np.array(
            [np.nan if ss[0] == "auto" else float(ss[0]), float(ss[1])]
        )
    if t(el, "image"):
        cam.image_size = np.array(
            [int(x) for x in t(el, "image").split(",")], dtype=float
        )
    if t(el, "aspect"):
        v = t(el, "aspect")
        cam.aspect_ratio = np.nan if v == "auto" else float(v)
    if t(el, "focal"):
        cam.focal_length = float(t(el, "focal"))
    if t(el, "model"):
        cam.model = int(t(el, "model"))
    if t(el, "skew"):
        cam.skew = float(t(el, "skew"))
    if t(el, "calibrated"):
        cam.calibrated = t(el, "calibrated") == "yes"

    nK = int(t(el, "nK")) if t(el, "nK") else None
    nP = int(t(el, "nP")) if t(el, "nP") else None
    if t(el, "K"):
        # storable -> internal: negate (PMSign)
        cam.K = -np.array([float(x) for x in t(el, "K").split(",")])
    if nK is not None:
        K = cam.K if cam.K is not None else np.full(0, np.nan)
        K = np.concatenate([K[:nK], np.full(max(0, nK - len(K)), np.nan)])
        cam.K = K
    if t(el, "P"):
        cam.P = -np.array([float(x) for x in t(el, "P").split(",")])
    if nP is not None:
        P = cam.P if cam.P is not None else np.full(0, np.nan)
        P = np.concatenate([P[:nP], np.full(max(0, nP - len(P)), np.nan)])
        cam.P = P

    if t(el, "cc"):
        v = t(el, "cc")
        cam.camera_constant = (cam.focal_length if v == "focal"
                               else float(v))
    if t(el, "pp"):
        v = t(el, "pp")
        if v == "default":
            s = cam.eval_sensor()
            cam.pp = np.array([s[0] / 2, -s[1] / 2])
        else:
            p = np.array([float(x) for x in v.split(",")])
            cam.pp = np.array([p[0], -p[1]])  # storable -> internal
    if t(el, "all") == "default":
        cam.camera_constant = cam.focal_length
        s = cam.eval_sensor()
        cam.pp = np.array([s[0] / 2, -s[1] / 2])
        cam.aspect_ratio = 1.0
        cam.skew = 0.0
        cam.K = np.zeros(cam.nK)
        cam.P = np.zeros(cam.nP)

    if not np.isfinite(cam.aspect_ratio):
        cam.aspect_ratio = cam.eval_aspect()
    else:
        cam.sensor_size = cam.eval_sensor()
    return cam


def load_cameras_xml(path: str):
    """DBAT camera XML file -> list[CameraSpec] (loadcameras.m)."""
    import xml.etree.ElementTree as ET

    doc = ET.parse(path).getroot()
    cams = doc.find("cameras")
    return [parse_camera_element(c) for c in cams.findall("camera")]


def write_camera_xml(path: str, project, cam_row: int = 0,
                     std_io=None) -> None:
    """Write a calibrated camera XML (the c4040z.xml output format;
    parseoutputfiles.m WritePostIOFile). Storable sign conventions."""
    p = project
    io = p.io[cam_row]
    nK, nP = p.nK, p.nP
    sensor = p.sensor_ss_size[cam_row]
    aspect = 1.0 - io[3]
    lines = [
        '<?xml version="1.0" encoding="utf-8"?>',
        '<document dbat_camera_version="1.0">',
        "   <cameras>",
        "      <camera>",
        f"         <id>1</id>",
        f"         <name>{p.title}</name>",
        f"         <unit>{p.cam_unit}</unit>",
        "         <calibrated>yes</calibrated>",
        f"         <sensor>{sensor[0]:.17g},{sensor[1]:.17g}</sensor>",
        f"         <image>{int(p.sensor_im_size[cam_row,0])},"
        f"{int(p.sensor_im_size[cam_row,1])}</image>",
        f"         <aspect>{aspect:.17g}</aspect>",
        f"         <focal>{io[0]:.6g}</focal>",
        f"         <model>{p.dist_model}</model>",
        f"         <nK>{nK}</nK>",
        f"         <nP>{nP}</nP>",
        f"         <cc>{io[0]:.17g}</cc>",
        f"         <pp>{io[1]:.17g},{-io[2]:.17g}</pp>",
        f"         <skew>{io[4]:.17g}</skew>",
        "         <K>" + ",".join(f"{-v:.17g}" for v in io[5:5 + nK]) + "</K>",
        "         <P>" + ",".join(
            f"{-v:.17g}" for v in io[5 + nK:5 + nK + nP]
        ) + "</P>",
        "      </camera>",
        "   </cameras>",
        "</document>",
    ]
    with open(path, "wt") as fh:
        fh.write("\n".join(lines) + "\n")
