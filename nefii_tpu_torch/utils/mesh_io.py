"""Triangle-mesh IO (the port's copy of nefii_tpu/utils/mesh_io.py): OBJ
and PLY (ascii + binary_little_endian) parsing and writing in numpy.

load_mesh returns (vertices [V,3] float64, faces [F,3] int32); polygon
faces are fan-triangulated. save_mesh writes OBJ text or binary
little-endian PLY.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def load_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    lower = path.lower()
    if lower.endswith(".obj"):
        return load_obj(path)
    if lower.endswith(".ply"):
        return load_ply(path)
    raise ValueError(f"unsupported mesh format: {path}")


def save_mesh(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    lower = path.lower()
    if lower.endswith(".obj"):
        with open(path, "w") as f:
            for v in vertices:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
            for tri in faces:
                f.write(f"f {tri[0]+1} {tri[1]+1} {tri[2]+1}\n")
        return
    if lower.endswith(".ply"):
        with open(path, "wb") as f:
            header = (
                "ply\nformat binary_little_endian 1.0\n"
                f"element vertex {len(vertices)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                f"element face {len(faces)}\n"
                "property list uchar int vertex_indices\nend_header\n"
            )
            f.write(header.encode())
            f.write(np.asarray(vertices, "<f4").tobytes())
            fd = np.empty((len(faces), 13), np.uint8)
            fd[:, 0] = 3
            fd[:, 1:] = np.asarray(faces, "<i4").view(np.uint8).reshape(len(faces), 12)
            f.write(fd.tobytes())
        return
    raise ValueError(f"unsupported mesh format: {path}")


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) for tok in line.split()[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int32)


_PLY_TYPES = {
    "char": ("i1", 1), "int8": ("i1", 1),
    "uchar": ("u1", 1), "uint8": ("u1", 1),
    "short": ("i2", 2), "int16": ("i2", 2),
    "ushort": ("u2", 2), "uint16": ("u2", 2),
    "int": ("i4", 4), "int32": ("i4", 4),
    "uint": ("u4", 4), "uint32": ("u4", 4),
    "float": ("f4", 4), "float32": ("f4", 4),
    "double": ("f8", 8), "float64": ("f8", 8),
}


def load_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        data = f.read()

    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii", errors="replace").splitlines()
    body = data[end:]

    fmt = None
    elements = []  # (name, count, [(prop_kind, ...)])
    for line in header:
        toks = line.split()
        if not toks:
            continue
        if toks[0] == "format":
            fmt = toks[1]
        elif toks[0] == "element":
            elements.append([toks[1], int(toks[2]), []])
        elif toks[0] == "property":
            if toks[1] == "list":
                elements[-1][2].append(("list", toks[2], toks[3], toks[-1]))
            else:
                elements[-1][2].append(("scalar", toks[1], toks[-1]))

    verts = None
    faces = []

    if fmt == "ascii":
        lines = body.decode().split("\n")
        li = 0
        for name, count, props in elements:
            rows = lines[li : li + count]
            li += count
            if name == "vertex":
                arr = np.array([r.split()[: len(props)] for r in rows], np.float64)
                names = [p[-1] for p in props]
                xyz = [names.index(c) for c in ("x", "y", "z")]
                verts = arr[:, xyz]
            elif name == "face":
                for r in rows:
                    toks = r.split()
                    n = int(toks[0])
                    idx = list(map(int, toks[1 : 1 + n]))
                    for k in range(1, n - 1):
                        faces.append([idx[0], idx[k], idx[k + 1]])
    elif fmt == "binary_little_endian":
        off = 0
        for name, count, props in elements:
            if name == "vertex":
                assert all(p[0] == "scalar" for p in props)
                dtypes = [(_p[-1], "<" + _PLY_TYPES[_p[1]][0]) for _p in props]
                # unique field names
                seen = {}
                fields = []
                for nme, dt in dtypes:
                    if nme in seen:
                        seen[nme] += 1
                        nme = f"{nme}_{seen[nme]}"
                    else:
                        seen[nme] = 0
                    fields.append((nme, dt))
                rec = np.dtype(fields)
                arr = np.frombuffer(body, rec, count=count, offset=off)
                off += rec.itemsize * count
                verts = np.stack(
                    [arr["x"].astype(np.float64), arr["y"].astype(np.float64), arr["z"].astype(np.float64)], -1
                )
            elif name == "face":
                (kind, cnt_t, idx_t, _), = props
                cnt_dt, cnt_sz = _PLY_TYPES[cnt_t]
                idx_dt, idx_sz = _PLY_TYPES[idx_t]
                for _ in range(count):
                    n = int(np.frombuffer(body, "<" + cnt_dt, 1, off)[0])
                    off += cnt_sz
                    idx = np.frombuffer(body, "<" + idx_dt, n, off).astype(np.int64)
                    off += idx_sz * n
                    for k in range(1, n - 1):
                        faces.append([idx[0], idx[k], idx[k + 1]])
            else:
                # skip unknown fixed-size elements
                row = sum(_PLY_TYPES[p[1]][1] for p in props if p[0] == "scalar")
                off += row * count
    else:
        raise ValueError(f"unsupported PLY format {fmt!r}")

    if verts is None:
        raise ValueError("PLY file has no vertex element")
    return verts, np.asarray(faces, np.int32).reshape(-1, 3)
