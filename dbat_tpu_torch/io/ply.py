"""Minimal PLY reader and writer (ref code/xchg/ply_read.m, used by
loadpsz; a numpy copy of dbat_tpu/io/ply.py).

Supports ascii and binary little/big endian with scalar properties —
all that PhotoScan point clouds need. Returns
{element_name: {property_name: np.ndarray}}.
"""

from __future__ import annotations

import numpy as np

_TYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def ply_read(path: str) -> dict:
    with open(path, "rb") as fh:
        data = fh.read()

    end = data.find(b"end_header")
    if end < 0:
        raise ValueError(f"{path}: not a PLY file")
    nl = data.find(b"\n", end)
    header = data[:nl].decode("ascii", "replace").splitlines()
    body = data[nl + 1:]

    fmt = None
    elements = []  # (name, count, [(prop, dtype)])
    for line in header:
        t = line.strip().split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            elements.append((t[1], int(t[2]), []))
        elif t[0] == "property":
            if t[1] == "list":
                raise NotImplementedError("PLY list properties unsupported")
            elements[-1][2].append((t[2], _TYPES[t[1]]))

    out = {}
    if fmt == "ascii":
        txt = body.decode("ascii").split()
        pos = 0
        for name, count, props in elements:
            ncol = len(props)
            arr = np.array(txt[pos:pos + count * ncol], dtype=np.float64)
            arr = arr.reshape(count, ncol)
            pos += count * ncol
            out[name] = {p: arr[:, k] for k, (p, _) in enumerate(props)}
        return out

    endian = "<" if "little" in fmt else ">"
    off = 0
    for name, count, props in elements:
        dt = np.dtype([(p, endian + d) for p, d in props])
        arr = np.frombuffer(body, dtype=dt, count=count, offset=off)
        off += dt.itemsize * count
        out[name] = {p: np.array(arr[p]) for p, _ in props}
    return out


def ply_write(path, elements: dict, fmt: str = "binary_little_endian"):
    """Write a PLY file (ref code/xchg/ply_write.m).

    elements: {element_name: {prop_name: array}} — all arrays in an
    element must share length; dtypes map to PLY scalar types.
    `path` may be a filesystem path or a binary file object (e.g.
    io.BytesIO for in-memory archives).
    """
    inv = {"i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
           "i4": "int", "u4": "uint", "f4": "float", "f8": "double"}
    header = ["ply", f"format {fmt} 1.0"]
    bodies = []
    for name, props in elements.items():
        arrs = {p: np.asarray(v) for p, v in props.items()}
        n = len(next(iter(arrs.values())))
        header.append(f"element {name} {n}")
        dt_items = []
        for p, v in arrs.items():
            code = v.dtype.str[1:]
            if code not in inv:
                v = v.astype(np.float64)
                code = "f8"
                arrs[p] = v
            header.append(f"property {inv[code]} {p}")
            dt_items.append((p, ("<" if "little" in fmt else ">") + code))
        rec = np.empty(n, dtype=np.dtype(dt_items))
        for p, v in arrs.items():
            rec[p] = v
        bodies.append(rec)
    header.append("end_header")

    def _emit(fh):
        fh.write(("\n".join(header) + "\n").encode("ascii"))
        if fmt == "ascii":
            for rec in bodies:
                for row in rec:
                    fh.write((" ".join(str(x) for x in row) + "\n")
                             .encode("ascii"))
        else:
            for rec in bodies:
                fh.write(rec.tobytes())

    if hasattr(path, "write"):
        _emit(path)
    else:
        with open(path, "wb") as fh:
            _emit(fh)
