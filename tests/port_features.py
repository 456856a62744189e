"""What the port's feature tests and chip_smoke.py's features phase
share; imports no JAX.

write_png(path, px, depth, filters): a PNG writer on the standard
library and numpy (no matplotlib, no Pillow).  It writes a
non-interlaced PNG of gray (H, W), gray + alpha (H, W, 2), RGB
(H, W, 3) or RGBA (H, W, 4) integer samples at bit depth 8 or 16; row r
is filtered with filters[r % len(filters)] (0 None, 1 Sub, 2 Up, 3
Average, 4 Paeth), so a reader meets every filter type in one file.

to_gray8(images, lo, hi): float images to 8-bit gray samples, 256
equal levels over [lo, hi] (the colour index of matplotlib's imsave
with vmin=lo, vmax=hi).

features_script(sensor, image, focal): the DBAT script of
tests/test_script_features.py (the <features> input, pose-graph
initialisation, two screens and two bundles, the report) for another
camera; write_features_folder() writes it beside its images as 8-bit
gray PNGs and the image table.

detection_stats(gt, xy, valid): tests/test_features.py's detection
measure: of the ground truth's targets inside a 10 px margin and 8 px
from any other, how many have a detection within 1 px, and those
detections' errors.

JAX_TEST_NET: make_ring_network's arguments for tests/test_features.py's
network (10 images of 800 x 600 px), which the port's feature, script
and card tests render with seed 4.

same_matches(a, b, sim_tol): two match_all_pairs results hold the same
pairs and slots, their similarities within sim_tol (0: bit for bit).

card_vs_cpu(images, card, max_kp): detect, describe and match on the
card and on the CPU, each stage fed the CPU's inputs of the stage
before."""

import os
import struct
import zlib

import numpy as np

COLOUR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}
JAX_TEST_NET = dict(n_img=10, n_pt=80, rays_per_pt=6, n_ctrl=0,
                    noise_px=0.0, ip_std_px=0.1, radius=7.0,
                    sensor=(8.0, 6.0), im_size=(800, 600),
                    K=(0.0, 0.0, 0.0), P=(0.0, 0.0), seed=3)


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def write_png(path, px, depth=8, filters=(0,), level=6):
    px = np.asarray(px)
    h = px.shape[0]
    ch = 1 if px.ndim == 2 else px.shape[2]
    if depth == 16:
        raw = px.astype(">u2").reshape(h, -1).view(np.uint8)
    else:
        raw = px.astype(np.uint8).reshape(h, -1)
    x = raw.astype(np.int32)
    bpp = ch * depth // 8
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    ftype = np.asarray(filters, np.uint8)[np.arange(h) % len(filters)]
    pred = np.zeros_like(x)
    for f, predict in ((1, lambda r: a[r]), (2, lambda r: b[r]),
                       (3, lambda r: (a[r] + b[r]) >> 1),
                       (4, lambda r: _paeth(a[r], b[r], c[r]))):
        rows = np.flatnonzero(ftype == f)
        pred[rows] = predict(rows)
    rows = np.concatenate([ftype[:, None],
                           ((x - pred) & 0xFF).astype(np.uint8)], axis=1)
    header = struct.pack(">IIBBBBB", px.shape[1], h, depth, COLOUR_TYPE[ch],
                         0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
                 + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
                 + _chunk(b"IEND", b""))


def to_gray8(images, lo, hi):
    v = (np.asarray(images, np.float64) - lo) / (hi - lo)
    return np.clip(np.floor(v * 256), 0, 255).astype(np.uint8)


def features_script(sensor, image, focal):
    return f"""<?xml version="1.0" encoding="UTF-8"?>
<document dbat_script_version="1.0">
  <meta><name>features-from-pixels demo</name></meta>
  <input>
    <cameras>
      <camera>
        <id>1</id>
        <name>synthcam</name>
        <unit>mm</unit>
        <sensor>{sensor[0]:g},{sensor[1]:g}</sensor>
        <image>{image[0]:d},{image[1]:d}</image>
        <focal>{focal:g}</focal>
        <model>3</model>
        <nK>3</nK>
        <nP>2</nP>
        <all>default</all>
      </camera>
    </cameras>
    <images image_base_dir="">
      <file format="id,path">images.txt</file>
    </images>
    <features detector="blob" max_kp="256" ratio="0.9" sxy="0.1"/>
  </input>
  <operations>
    <operation><pose_graph_init min_shared="10" ransac_iters="100"/></operation>
    <operation><prune_by_reprojection max_px="8.0" min_views="3"/></operation>
    <operation><set_datum ref_cam="1">depend</set_datum></operation>
    <operation>bundle_adjustment</operation>
    <operation><prune_by_reprojection max_px="1.0" min_views="3"/></operation>
    <operation>bundle_adjustment</operation>
  </operations>
  <output>
    <files base_dir="$HERE">
      <report><file>features-report.txt</file></report>
    </files>
  </output>
</document>
"""


def write_features_folder(images, folder, script):
    """The images as 8-bit gray PNGs (every filter type, zlib level 1)
    over their own range, the image table and the script in `folder`;
    returns the script's path."""
    lo, hi = float(images.min()), float(images.max())
    rows = []
    for i, img in enumerate(images):
        path = os.path.join(folder, f"img{i:02d}.png")
        write_png(path, to_gray8(img, lo, hi), filters=(0, 1, 2, 3, 4),
                  level=1)
        rows.append(f"{i + 1},{path}")
    with open(os.path.join(folder, "images.txt"), "wt") as fh:
        fh.write("\n".join(rows) + "\n")
    xml = os.path.join(folder, "script.xml")
    with open(xml, "wt") as fh:
        fh.write(script)
    return xml


def detection_stats(gt, xy, valid):
    """(found, total, errors) over the isolated in-border targets."""
    W, H = (int(v) for v in gt.sensor_im_size[0])
    errs, total = [], 0
    for i in range(gt.n_img):
        pts = gt.ip_px[gt.obs_img == i]
        if not len(pts):
            continue
        inb = ((pts[:, 0] >= 10) & (pts[:, 0] < W - 10)
               & (pts[:, 1] >= 10) & (pts[:, 1] < H - 10))
        dmat = np.linalg.norm(pts[:, None] - pts[None, :], axis=2)
        np.fill_diagonal(dmat, np.inf)
        isolated = dmat.min(axis=1) >= 8.0
        total += int((inb & isolated).sum())
        det = xy[i][valid[i]]
        for j in np.flatnonzero(inb & isolated):
            d = np.linalg.norm(det - pts[j], axis=1)
            if len(d) and d.min() < 1.0:
                errs.append(d.min())
    return len(errs), total, np.asarray(errs)


def same_matches(a, b, sim_tol=0.0):
    """a and b (match_all_pairs results) pair the same images and slots,
    their similarities within sim_tol."""
    return list(a) == list(b) and all(
        np.array_equal(a[k][0], b[k][0]) and np.array_equal(a[k][1], b[k][1])
        and np.allclose(a[k][2], b[k][2], rtol=0, atol=sim_tol)
        for k in a)


def _match_set(matches):
    return {(k, int(a), int(b)) for k, m in matches.items()
            for a, b in zip(m[0], m[1])}


def card_vs_cpu(images, card, max_kp):
    """Detect, describe and match `images` on the card and on the CPU;
    describe and match on both sides take the CPU's keypoints and
    descriptors.  Returns {"valid_equal", "xy_err" (px, over valid
    slots), "desc_err", "n_matches" (CPU), "n_differ" (matches in one
    set only)}."""
    from dbat_tpu_torch.features import describe, detect_blobs, \
        match_all_pairs

    runs = []
    for where in ("cpu", card):
        xy, _score, valid = (a.cpu().numpy() for a in detect_blobs(
            images, max_kp=max_kp, device=where))
        if not runs:
            cpu_xy, cpu_valid = xy, valid
        desc = describe(images, cpu_xy, cpu_valid,
                        device=where).cpu().numpy()
        if not runs:
            cpu_desc = desc
        runs.append((xy, valid, desc, _match_set(
            match_all_pairs(cpu_desc, cpu_valid, device=where))))
    (xy, valid, desc, m), (xy_c, valid_c, desc_c, m_c) = runs
    both = valid & valid_c
    return {"valid_equal": bool(np.array_equal(valid, valid_c)),
            "xy_err": float(np.abs(xy_c - xy)[both].max()),
            "desc_err": float(np.abs(desc_c - desc).max()),
            "n_matches": len(m), "n_differ": len(m ^ m_c)}
