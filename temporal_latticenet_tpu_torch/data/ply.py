"""Minimal PLY reader and writer, a copy of the JAX package's (binary little-endian + ascii), replacing the
``plyfile`` dependency of the reference Paris-Lille loader
(upstream dataloader/parisLille_dataloader.py:10,115).  Reads vertex
elements into a numpy structured array."""

from __future__ import annotations

import numpy as np

_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply_vertices(path: str) -> np.ndarray:
    """Returns a structured array of the 'vertex' element's properties."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # list of (name, count, [(prop_name, dtype)])
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in header")
            tok = line.decode("ascii", "replace").strip().split()
            if not tok:
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                cur = (tok[1], int(tok[2]), [])
                elements.append(cur)
            elif tok[0] == "property":
                if tok[1] == "list":
                    raise ValueError("list properties unsupported")
                cur[2].append((tok[2], _TYPES[tok[1]]))
            elif tok[0] == "end_header":
                break

        if fmt not in ("binary_little_endian", "ascii"):
            raise ValueError(f"unsupported PLY format {fmt}")

        out = None
        for name, count, props in elements:
            dt = np.dtype([(p, ("<" + t) if fmt.startswith("binary") else t)
                           for p, t in props])
            if fmt == "ascii":
                rows = [tuple(f.readline().split()) for _ in range(count)]
                arr = np.array(rows, dtype=dt) if rows else np.empty(0, dt)
            else:
                arr = np.frombuffer(f.read(count * dt.itemsize), dtype=dt,
                                    count=count)
            if name == "vertex":
                out = arr
        if out is None:
            raise ValueError(f"{path}: no vertex element")
        return out


def write_ply_vertices(path: str, fields: dict):
    """Write a binary_little_endian PLY with the given per-vertex fields
    (used by tests and the prediction/visualisation exporters)."""
    names = list(fields.keys())
    n = len(fields[names[0]])
    inv_types = {v: k for k, v in _TYPES.items()}
    dt = np.dtype([(k, np.asarray(v).dtype.str.lstrip("<>=|"))
                   for k, v in fields.items()])
    arr = np.empty(n, dtype=dt)
    for k in names:
        arr[k] = np.asarray(fields[k])
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for k in names:
            tname = inv_types[np.dtype(arr.dtype[k]).str.lstrip("<>=|")]
            f.write(f"property {tname} {k}\n".encode())
        f.write(b"end_header\n")
        f.write(arr.tobytes())
