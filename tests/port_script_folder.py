"""A network written as a DBAT script folder: the scaffolding that the
script tests (test_torch_script.py) and chip_smoke.py's script phases
share.  Imports numpy and dbat_tpu_torch only, so that chip_smoke.py
can import it on the card's machine.

write_script_folder(): cameras.xml, the image table, the image-point
table, the control points, the prior EO table and script.xml, numbers
printed with %.17g.  image_major() puts a network's observations in the
order such a folder gives them, as_text_carries() gives it the values
the folder carries, and read_eo_file() reads back the EO file that a
script writes."""

import os

import numpy as np

#: Operations of the C5 script (chip_smoke.py phase 11): IO from the
#: camera file, the perturbed EO start from the prior EO table, the
#: self-calibration of bench.py's C5 shape, the points by forward
#: intersection, the bundle.
C5_SCRIPT_OPS = """\
    <operation min_rays="2">check_ray_count</operation>
    <operation><set_initial_values><io>loaded</io><eo>loaded</eo>
      </set_initial_values></operation>
    <operation><set_bundle_estimate_params><io><cc>true</cc><pp>true</pp>
      <K>true</K><P>true</P></io></set_bundle_estimate_params></operation>
    <operation>forward_intersection</operation>
    <operation>bundle_adjustment</operation>"""
#: Operations of the small script (chip_smoke.py phase 5 and the script
#: tests): EO and OP from the measurements alone, the outlier screen,
#: the bundle.
POSEGRAPH_SCRIPT_OPS = """\
    <operation min_rays="2">check_ray_count</operation>
    <operation><set_initial_values><io>loaded</io></set_initial_values>
      </operation>
    <operation><set_bundle_estimate_params><io><cc>true</cc><pp>true</pp>
      <K>true</K><P>true</P></io></set_bundle_estimate_params></operation>
    <operation><pose_graph_init min_shared="10" ransac_iters="80"/>
      </operation>
    <operation><prune_by_reprojection max_px="3.0"/></operation>
    <operation>bundle_adjustment</operation>"""
SCRIPT_XML = """\
<?xml version="1.0" encoding="utf-8"?>
<document dbat_script_version="1.0">
  <meta><name>{title}</name></meta>
  <input base_dir="$HERE">
    <cameras><file>cameras.xml</file></cameras>
    <images><file format="id,path">images.txt</file></images>
    <image_pts><file format="im,id,x,y,sxy">image_pts.txt</file></image_pts>
    <ctrl_pts><file format="id,label,x,y,z">ctrl_pts.txt</file></ctrl_pts>
    <prior_eo><file format="id,label,x,y,z,omega,phi,kappa">prior_eo.txt</file>
      </prior_eo>
  </input>
  <operations>
{operations}
  </operations>
  <output>
    <files base_dir="$HERE/result">
      <report><file>report.txt</file></report>
      <io><file>camera.xml</file></io>
      <eo><file>eo.txt</file></eo>
      <image_residuals top_count="50"><file>residuals.txt</file>
        </image_residuals>
    </files>
  </output>
</document>
"""


def image_major(project):
    """Put the observations in the order a script's tables give them (by
    image, then by point id), in place; returns the project."""
    p = project
    order = np.lexsort((p.op_id[p.obs_pt], p.obs_img))
    for name in ("obs_img", "obs_pt", "ip_px", "ip_std_px", "ip_id"):
        setattr(p, name, getattr(p, name)[order])
    return p


def as_text_carries(project):
    """Give the project the values its script folder carries, in place:
    EO angles through degrees (the EO table: degrees printed with %.17g,
    read back times pi/180) and the affinity through the aspect ratio
    (the camera file: 1 - affinity).  Every other value round-trips
    through %.17g exactly.  Returns the project."""
    p = project
    p.eo[:, 3:6] = (p.eo[:, 3:6] * (180.0 / np.pi)) * (np.pi / 180.0)
    for io in (p.io, p.prior_io_val):
        io[:, 3] = 1.0 - (1.0 - io[:, 3])
    return p


def write_script_folder(project, folder, operations):
    """Write `project` as a DBAT script folder and return the script's
    path: cameras.xml (image 0's camera, shared by every image), an
    id,path image table, an im,id,x,y,sxy image-point table, the control
    points as id,label,x,y,z, the current EO as the prior EO table
    (angles in degrees) and script.xml running `operations` with the
    report, io, eo and image_residuals outputs.  Numbers are printed with
    %.17g."""
    from dbat_tpu_torch.pipeline.camera_spec import write_camera_xml

    p = project
    os.makedirs(folder, exist_ok=True)

    def path(name):
        return os.path.join(folder, name)

    write_camera_xml(path("cameras.xml"), p)
    with open(path("images.txt"), "wt") as fh:
        fh.write("# id,path\n")
        for i in range(p.n_img):
            fh.write(f"{p.img_ids[i]},images/{p.img_labels[i]}\n")
    pts = np.column_stack([p.img_ids[p.obs_img], p.op_id[p.obs_pt],
                           p.ip_px, p.ip_std_px[:, 0]])
    np.savetxt(path("image_pts.txt"), pts, delimiter=",",
               fmt=("%d", "%d", "%.17g", "%.17g", "%.17g"),
               header="im,id,x,y,sxy")
    with open(path("ctrl_pts.txt"), "wt") as fh:
        fh.write("# id,label,x,y,z\n")
        for k in np.flatnonzero(p.is_ctrl):
            x, y, z = p.prior_op_val[k]
            fh.write(f"{p.op_id[k]},{p.op_id[k]},{x:.17g},{y:.17g},"
                     f"{z:.17g}\n")
    with open(path("prior_eo.txt"), "wt") as fh:
        fh.write("# id,label,x,y,z,omega,phi,kappa (degrees)\n")
        for i in range(p.n_img):
            ang = p.eo[i, 3:6] * (180.0 / np.pi)
            fh.write(f"{p.img_ids[i]},{p.img_labels[i]},"
                     + ",".join(f"{v:.17g}" for v in (*p.eo[i, :3], *ang))
                     + "\n")
    with open(path("script.xml"), "wt") as fh:
        fh.write(SCRIPT_XML.format(title=p.title, operations=operations))
    return path("script.xml")


def read_eo_file(path):
    """The rows of an EO file (write_eo_file): their labels, and an
    (n_img, 14) array of the values (EO number, EO id, x, y, z, omega,
    phi, kappa, then the six posterior std in columns 8:14)."""
    rows = [ln.split(", ") for ln in open(path).read().splitlines()
            if ln and not ln.startswith("#")]
    return [r[-1] for r in rows], np.array([[float(v) for v in r[:-1]]
                                            for r in rows])
