"""PNG reader without matplotlib or Pillow (stdlib zlib + numpy).

Reads non-interlaced 8- and 16-bit PNGs in gray, gray + alpha, RGB and
RGBA, with every filter type (the row unfilter runs in the host's
native helpers, io/native.py, or their plain Python loop where they
cannot be built), and
returns the float32 array `matplotlib.image.imread` gives for the same
file:

  gray          (H, W)    v / 255 or v / 65535
  gray + alpha  (H, W, 4) the gray value as R, G and B, then alpha
  RGB, RGBA     (H, W, 3) or (H, W, 4)

(for gray + alpha, RGB and RGBA matplotlib reads 16-bit samples
through Pillow, which keeps their high byte, and divides by 255).
Anything else raises UnsupportedImage.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .native import png_unfilter

SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: colour type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


class UnsupportedImage(ValueError):
    """The file is not a PNG this reader decodes."""


def _chunks(data, path):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if pos + 12 + n > len(data):
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: PNG without IEND")


def read_png(path) -> np.ndarray:
    """The float32 image array of a PNG file, as matplotlib reads it."""
    with open(path, "rb") as fh:
        data = fh.read()
    if not data.startswith(SIGNATURE):
        raise UnsupportedImage(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _comp, _filt, interlace = header
    if depth not in (8, 16) or ctype not in _CHANNELS or interlace:
        raise UnsupportedImage(
            f"{path}: PNG with bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace}: only non-interlaced 8- and 16-bit "
            f"gray, gray + alpha, RGB and RGBA are read")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (1 + w * bpp):
        raise ValueError(f"{path}: {len(raw)} bytes of image data, "
                         f"expected {h * (1 + w * bpp)}")
    px = png_unfilter(np.frombuffer(raw, np.uint8).reshape(h, 1 + w * bpp),
                      bpp)
    if depth == 16:
        px = px.reshape(h, w, ch, 2)
        if ch == 1:
            v = px[..., 0, 0].astype(np.uint16) << 8 | px[..., 0, 1]
            return np.divide(v, 2**16 - 1, dtype=np.float32)
        px = px[..., 0]  # the high byte, as Pillow keeps it
    px = px.reshape(h, w, ch)
    if ch == 1:
        return np.divide(px[..., 0], 2**8 - 1, dtype=np.float32)
    if ch == 2:
        px = px[..., [0, 0, 0, 1]]
    return np.divide(px, 2**8 - 1, dtype=np.float32)
