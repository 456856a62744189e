"""A network written as a PhotoModeler text export, and the camcal
demo's folder: the writers that the PM and demo tests
(test_torch_pm.py, test_torch_demos.py) and chip_smoke.py's input phase
share.  Imports numpy and dbat_tpu_torch only, so that chip_smoke.py
can import it on the card's machine.

write_pm_export() is a copy of tests/test_pm_fullscale.py
write_pm_export, which test_torch_pm.py holds byte-equal to it.
write_camcal_folder() writes a network the way the camcal demo reads
it: a PM export without a control table, control points numbered above
1000 and given by ref/camcal-fixed.txt.

The same callers share the small .psz network (SMALL_PSZ), the
local->global similarity it is written with (similarity()) and the
numpy formulas of the host's native helpers (numpy_native())."""

import os

import numpy as np

#: A small ring network, written as a .psz for ps_postproc.
SMALL_PSZ = dict(n_img=12, n_pt=300, rays_per_pt=(3, 9), n_obs_target=1500,
                 n_ctrl=5, noise_px=0.1, ip_std_px=0.1, seed=3)

#: A camcal-style network: 8 images that each see all 90 points, 8 of
#: them control points, so that every image can be resected.
CAMCAL_RING = dict(n_img=8, n_pt=90, rays_per_pt=8, n_ctrl=8,
                   noise_px=0.1, ip_std_px=0.1, seed=21)


def write_pm_export(path, s, ip_std=0.1):
    """Project -> PhotoModeler text export (inverse of from_pm's
    conventions: py/K/P sign flips, kappa-phi-omega degrees,
    0-based photo index in the mark table)."""
    nK, nP = s.nK, s.nP
    deg = 180.0 / np.pi

    def cam_line(i):
        xs, ys = s.sensor_ss_size[i]
        return (f"{s.io[i,0]:.6f} {s.io[i,1]:.6f} {-s.io[i,2]:.6f} "
                f"{xs:.6f} {ys:.6f} "
                + " ".join(f"{-v:.10f}" for v in s.io[i, 5:5 + nK + nP]))

    lines = [
        "synthetic C5-shape full-scale export",
        f"0.000500 20 {int(s.sensor_im_size[0,0])} "
        f"{int(s.sensor_im_size[0,1])}",
        f"1.0 {ip_std} 10.0 100.0 100.0 100.0 20.0 20.0 20.0",
        cam_line(0),
        "0.0 " * (5 + nK + nP - 1) + "0.0",
    ]
    for i in range(s.n_img):
        k, p, o = s.eo[i, 5] * deg, s.eo[i, 4] * deg, s.eo[i, 3] * deg
        lines.append(f"{i} img{i:04d}.jpg")
        lines.append(f"{i} {s.eo[i,0]:.9f} {s.eo[i,1]:.9f} "
                     f"{s.eo[i,2]:.9f} {k:.9f} {p:.9f} {o:.9f}")
        lines.append(f"{i} 0 0 0 0 0 0")
        lines.append("")  # no position covariances
        lines.append(f"{i} " + cam_line(i))
        lines.append(f"{i} " + "0.0 " * (5 + nK + nP - 1) + "0.0")
    lines.append("")  # end of photo blocks

    is_ctrl = np.asarray(s.is_ctrl)
    for j in np.flatnonzero(is_ctrl):
        x, y, z = s.op[j]
        lines.append(f"{s.op_id[j]} {x:.9f} {y:.9f} {z:.9f} 0 0 0")
    lines.append("")
    # PM object table lists every 3D point (ctrl included): from_pm
    # takes op values from here and ctrl priors from the table above.
    for j in range(s.n_op):
        x, y, z = s.op[j]
        lines.append(f"{s.op_id[j]} {x:.9f} {y:.9f} {z:.9f} 0 0 0")
    lines.append("")
    ids = np.asarray(s.op_id)[s.obs_pt]
    rows = np.column_stack([s.obs_img, ids, s.ip_px])
    for im, pid, x, y in rows:
        lines.append(f"{int(im)} {int(pid)} {x:.6f} {y:.6f} "
                     f"{ip_std} {ip_std}")
    lines.append("")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def write_cpt_file(path, s, std=None):
    """The control points of `s` as an id,label,x,y,z[,sx,sy,sz] file
    (%.17g), exact or with std (std, std, 2 std)."""
    with open(path, "w") as fh:
        fh.write("# id,label,x,y,z[,sx,sy,sz]\n")
        for k in np.flatnonzero(s.is_ctrl):
            x, y, z = s.op[k]
            extra = "" if std is None else f",{std},{std},{2 * std}"
            fh.write(f"{s.op_id[k]},{s.op_id[k]},{x:.17g},{y:.17g},"
                     f"{z:.17g}{extra}\n")


def camcal_network(**kw):
    """make_ring_network(**CAMCAL_RING, **kw) with the control points
    numbered 1001 on, as in the camcal demo's files."""
    from dbat_tpu_torch.pipeline.synthetic import make_ring_network

    s = make_ring_network(**{**CAMCAL_RING, **kw})
    s.op_id = np.where(s.is_ctrl, 1000 + s.op_id, s.op_id)
    return s


def write_camcal_folder(data_dir, s, suffix=""):
    """`s` as the camcal demo's data folder: pmexports/camcal-pmexport
    {suffix}.txt without a control table, ref/camcal-fixed.txt.  Returns
    the export's path."""
    for sub in ("pmexports", "ref"):
        os.makedirs(os.path.join(data_dir, sub), exist_ok=True)
    write_cpt_file(os.path.join(data_dir, "ref", "camcal-fixed.txt"), s)
    s = s.copy()
    s.is_ctrl[:] = False
    path = os.path.join(data_dir, "pmexports",
                        f"camcal-pmexport{suffix}.txt")
    write_pm_export(path, s)
    return path


def similarity():
    """tests/test_psz_fullscale.py's local->global similarity: scale 17,
    a rotation of 0.3 rad about z and a translation."""
    th = 0.3
    L2G = np.eye(4)
    L2G[:3, :3] = 17.0 * np.array([[np.cos(th), -np.sin(th), 0],
                                   [np.sin(th), np.cos(th), 0],
                                   [0, 0, 1.0]])
    L2G[:3, 3] = [1000.0, -2000.0, 50.0]
    return L2G


def numpy_native(A, B, n, M3, Vinv, Y, s2):
    """The numpy formulas of the host's native helpers (the fallbacks of
    dbat_tpu/io/native.py): diag_block_outer, batch_inv3, icpc_blocks."""
    m = B.shape[1] // n
    AB = A @ B
    dbo = np.stack([B[:, j * n:(j + 1) * n].T @ AB[:, j * n:(j + 1) * n]
                    for j in range(m)])
    Yr = Y.reshape(Y.shape[0], Vinv.shape[0], 3)
    G = np.einsum("kja,kjb->jab", Yr, Yr)
    icpc = s2 * (Vinv + np.einsum("jab,jbc,jcd->jad", Vinv, G, Vinv))
    return {"diag_block_outer": dbo, "batch_inv3": np.linalg.inv(M3),
            "icpc_blocks": icpc}
