"""Minimal PLY reader/writer (ascii + binary_little_endian), numpy-only.

The port's copy of ``deepviewagg_tpu/utils/ply.py`` (which replaces the
reference's ``plyfile`` dependency): the files it writes are byte-identical
to the JAX package's, and it reads theirs.  Only the 'vertex' element path
is implemented; other elements, list properties included, are skipped.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

__all__ = ["read_ply", "write_ply"]

_PLY_TO_NP = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}
_NP_TO_PLY = {"i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
              "i4": "int", "u4": "uint", "f4": "float", "f8": "double"}


def read_ply(path: str, element: str = "vertex") -> Dict[str, np.ndarray]:
    """Read one element's properties as a dict of 1-D arrays."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"not a ply file: {path}")
        fmt = None
        elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in header")
            tok = line.strip().split()
            if not tok or tok[0] == b"comment":
                continue
            if tok[0] == b"format":
                fmt = tok[1].decode()
            elif tok[0] == b"element":
                elements.append((tok[1].decode(), int(tok[2]), []))
            elif tok[0] == b"property":
                if tok[1] == b"list":
                    elements[-1][2].append(
                        (tok[4].decode(),
                         f"list:{_PLY_TO_NP[tok[2].decode()]}:"
                         f"{_PLY_TO_NP[tok[3].decode()]}")
                    )
                else:
                    elements[-1][2].append(
                        (tok[2].decode(), _PLY_TO_NP[tok[1].decode()])
                    )
            elif tok[0] == b"end_header":
                break

        out: Dict[str, np.ndarray] = {}
        for name, count, props in elements:
            is_target = name == element
            has_list = any(t.startswith("list:") for _, t in props)
            if fmt == "ascii":
                rows = [f.readline().split() for _ in range(count)]
                if is_target and not has_list:
                    arr = np.array(rows)
                    for i, (pname, typ) in enumerate(props):
                        out[pname] = arr[:, i].astype(np.dtype(typ))
                continue
            if fmt != "binary_little_endian":
                raise ValueError(f"unsupported ply format {fmt}")
            if not has_list:
                dtype = np.dtype([(p, "<" + t) for p, t in props])
                data = np.frombuffer(f.read(dtype.itemsize * count),
                                     dtype=dtype, count=count)
                if is_target:
                    for pname, _ in props:
                        out[pname] = np.ascontiguousarray(data[pname])
            else:
                # variable-length lists (e.g. faces): walk row by row
                for _ in range(count):
                    for pname, typ in props:
                        if typ.startswith("list:"):
                            _, ct, vt = typ.split(":")
                            k = int(np.frombuffer(f.read(np.dtype(ct).itemsize),
                                                  dtype="<" + ct)[0])
                            f.read(np.dtype(vt).itemsize * k)
                        else:
                            f.read(np.dtype(typ).itemsize)
        return out


def write_ply(path: str, fields: Dict[str, np.ndarray],
              element: str = "vertex") -> None:
    """Write 1-D arrays of equal length as one binary ply element."""
    names = list(fields)
    n = len(fields[names[0]])
    dtype = np.dtype([
        (k, "<" + np.dtype(fields[k].dtype).str[1:]) for k in names
    ])
    rows = np.empty(n, dtype)
    for k in names:
        rows[k] = fields[k]
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element {element} {n}\n".encode())
        for k in names:
            ply_t = _NP_TO_PLY[np.dtype(fields[k].dtype).str[1:]]
            f.write(f"property {ply_t} {k}\n".encode())
        f.write(b"end_header\n")
        f.write(rows.tobytes())
