"""Data IO: images, meshes, constraint files, imagedumps.

Replacement for the reference example harness's IO stack (mLib
PNG loading, OpenMesh .ply/.off/.obj, the .imagedump raw format from
API/src/im.t, and per-example constraint files). Pure numpy parsers; PIL is
used only for PNG codec work.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# images
# ---------------------------------------------------------------------------


def load_image(path: str, dtype=np.float32, scale=1.0 / 255.0) -> np.ndarray:
    """PNG/JPG -> [H, W, C] float array in [0,1] (mLib-equivalent loading)."""
    from PIL import Image

    img = np.asarray(Image.open(path))
    if img.ndim == 2:
        img = img[..., None]
    return img.astype(dtype) * scale


def save_image(path: str, arr: np.ndarray, scale=255.0) -> None:
    from PIL import Image

    a = np.asarray(arr)
    if a.ndim == 3 and a.shape[-1] == 1:
        a = a[..., 0]
    a = np.clip(a * scale, 0, 255).astype(np.uint8)
    Image.fromarray(a).save(path)


# ---------------------------------------------------------------------------
# .imagedump — the reference's raw float image format (API/src/im.t:23-53):
# int32 width, height, channels, datatype(0=float32), then raw data.
# ---------------------------------------------------------------------------


def load_imagedump(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        w, h, c, t = struct.unpack("<iiii", f.read(16))
        if t == 0:
            dt, sz = "<f4", 4
        elif t == 1:
            dt, sz = "<u1", 1
        else:
            raise ValueError(f"imagedump type {t} unsupported (0=float, 1=uchar)")
        data = np.frombuffer(f.read(sz * w * h * c), dtype=dt)
    return data.reshape(h, w, c) if c > 1 else data.reshape(h, w)


def save_imagedump(path: str, arr: np.ndarray) -> None:
    a = np.asarray(arr, dtype="<f4")
    if a.ndim == 2:
        a = a[..., None]
    h, w, c = a.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<iiii", w, h, c, 0))
        f.write(a.tobytes())


# ---------------------------------------------------------------------------
# meshes: minimal PLY (ascii + binary_little_endian), OFF, OBJ readers
# (replaces the reference's OpenMesh dependency for the bundled examples)
# ---------------------------------------------------------------------------

_PLY_TYPES = {
    "float": ("<f4", 4), "float32": ("<f4", 4),
    "double": ("<f8", 8), "float64": ("<f8", 8),
    "int": ("<i4", 4), "int32": ("<i4", 4),
    "uint": ("<u4", 4), "uint32": ("<u4", 4),
    "short": ("<i2", 2), "ushort": ("<u2", 2),
    "char": ("<i1", 1), "uchar": ("<u1", 1), "uint8": ("<u1", 1),
}


def load_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (vertices [N,3] float32, faces [F,3] int32)."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii", "replace").splitlines()
    body = data[header_end:]
    fmt = None
    elements = []  # (name, count, [(prop_type, prop_name) | ('list', idx_t, cnt_t, name)])
    cur = None
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            cur = (parts[1], int(parts[2]), [])
            elements.append(cur)
        elif parts[0] == "property" and cur is not None:
            if parts[1] == "list":
                cur[2].append(("list", parts[2], parts[3], parts[4]))
            else:
                cur[2].append((parts[1], parts[2]))

    verts, faces = None, None
    if fmt == "ascii":
        tokens = body.decode("ascii").split()
        pos = 0
        for name, count, props in elements:
            if name == "vertex":
                width = len(props)
                arr = np.array(tokens[pos : pos + count * width], dtype=np.float32)
                arr = arr.reshape(count, width)
                verts = arr[:, :3]
                pos += count * width
            elif name == "face":
                out = []
                for _ in range(count):
                    k = int(tokens[pos]); pos += 1
                    out.append([int(t) for t in tokens[pos : pos + k]][:3])
                    pos += k
                faces = np.array(out, dtype=np.int32)
            else:
                for _ in range(count):
                    pos += len(props)
    elif fmt == "binary_little_endian":
        off = 0
        for name, count, props in elements:
            if name == "vertex":
                if any(p[0] == "list" for p in props):
                    raise ValueError("list property in vertex element unsupported")
                dtypes = [(_p[1], _PLY_TYPES[_p[0]][0]) for _p in props]
                rec = np.dtype(dtypes)
                arr = np.frombuffer(body, dtype=rec, count=count, offset=off)
                off += rec.itemsize * count
                verts = np.stack(
                    [arr["x"], arr["y"], arr["z"]], axis=-1
                ).astype(np.float32)
            elif name == "face":
                out = []
                for _ in range(count):
                    p = props[0]
                    cnt_t, idx_t = _PLY_TYPES[p[1]], _PLY_TYPES[p[2]]
                    k = int(np.frombuffer(body, cnt_t[0], 1, off)[0])
                    off += cnt_t[1]
                    idx = np.frombuffer(body, idx_t[0], k, off)
                    off += idx_t[1] * k
                    out.append(list(idx[:3]))
                faces = np.array(out, dtype=np.int32)
            else:
                rec = np.dtype([(_p[1], _PLY_TYPES[_p[0]][0]) for _p in props])
                off += rec.itemsize * count
    else:
        raise ValueError(f"unsupported ply format {fmt}")
    if verts is None:
        raise ValueError("no vertex element in ply")
    return verts, (faces if faces is not None else np.zeros((0, 3), np.int32))


def load_off(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with open(path) as f:
        tokens = f.read().split()
    assert tokens[0].upper().startswith("OFF") or tokens[0] == "OFF"
    nv, nf = int(tokens[1]), int(tokens[2])
    pos = 4
    verts = np.array(tokens[pos : pos + nv * 3], dtype=np.float32).reshape(nv, 3)
    pos += nv * 3
    faces = []
    for _ in range(nf):
        k = int(tokens[pos]); pos += 1
        faces.append([int(t) for t in tokens[pos : pos + k]][:3])
        pos += k
    return verts, np.array(faces, dtype=np.int32)


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            p = line.split()
            if not p:
                continue
            if p[0] == "v":
                verts.append([float(x) for x in p[1:4]])
            elif p[0] == "f":
                idx = [int(t.split("/")[0]) - 1 for t in p[1:]]
                faces.append(idx[:3])
    return np.array(verts, np.float32), np.array(faces, np.int32)


def load_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    if path.endswith(".ply"):
        return load_ply(path)
    if path.endswith(".off"):
        return load_off(path)
    if path.endswith(".obj"):
        return load_obj(path)
    raise ValueError(f"unsupported mesh format: {path}")


def _load_fastgraph():
    """Native graph builder (native/src/fastgraph.c), if built."""
    try:
        import opt_tpu_fastgraph  # installed on sys.path

        return opt_tpu_fastgraph
    except ImportError:
        pass
    import importlib.util
    import sysconfig
    import os

    so = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "native", "build",
        "opt_tpu_fastgraph" + sysconfig.get_config_var("EXT_SUFFIX"),
    )
    if os.path.exists(so):
        spec = importlib.util.spec_from_file_location("opt_tpu_fastgraph", so)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    return None


_FASTGRAPH = _load_fastgraph()


def mesh_edges(faces: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Directed edge list (v0, v1) — both directions, deduplicated — the
    shape the reference's createGraphFromNeighborLists consumes
    (examples/shared/OptGraph.h:64-75). Uses the native builder
    (native/src/fastgraph.c) when available."""
    faces = np.ascontiguousarray(faces, dtype=np.int32)
    if _FASTGRAPH is not None:
        b0, b1 = _FASTGRAPH.build_edges(faces.tobytes())
        return np.frombuffer(b0, np.int32).copy(), np.frombuffer(b1, np.int32).copy()
    e = np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0
    )
    e = np.concatenate([e, e[:, ::-1]], axis=0)
    e = np.unique(e, axis=0)
    return e[:, 0].astype(np.int32), e[:, 1].astype(np.int32)


def csr_from_edges(v0: np.ndarray, v1: np.ndarray, num_vertices: int):
    """CSR adjacency (row_ptr, col_idx) from a v0-sorted edge list — the
    reference's neighbor-list graph input format (OptGraph.h:64-75)."""
    v0 = np.ascontiguousarray(v0, np.int32)
    v1 = np.ascontiguousarray(v1, np.int32)
    if _FASTGRAPH is not None:
        rp, ci = _FASTGRAPH.csr_from_edges(v0.tobytes(), v1.tobytes(), int(num_vertices))
        return np.frombuffer(rp, np.int32).copy(), np.frombuffer(ci, np.int32).copy()
    row = np.zeros(num_vertices + 1, np.int32)
    np.add.at(row, v0 + 1, 1)
    return np.cumsum(row, dtype=np.int32), v1.copy()


def sqrt3_subdivide(verts: np.ndarray, faces: np.ndarray):
    """One step of Kobbelt sqrt(3) subdivision.

    The reference's arap example runs OpenMesh's Sqrt3T subdivider once before
    solving (arap_mesh_deformation/src/main.cpp:58-72), and its .mrk marker
    files index the subdivided mesh. Vertex ordering matches OpenMesh:
    original vertices keep their indices, one new vertex per face is appended
    in face order; original vertices are smoothed with Kobbelt's
    a_n = (4 - 2 cos(2*pi/n)) / 9.
    """
    nv = len(verts)
    centroids = verts[faces].mean(axis=1)
    # adjacency for smoothing
    neighbors: Dict[int, set] = {}
    for a, b, c in faces:
        for x, y in ((a, b), (b, c), (c, a)):
            neighbors.setdefault(int(x), set()).add(int(y))
            neighbors.setdefault(int(y), set()).add(int(x))
    smoothed = verts.copy()
    for v, nbrs in neighbors.items():
        n = len(nbrs)
        a_n = (4.0 - 2.0 * np.cos(2.0 * np.pi / n)) / 9.0
        avg = verts[list(nbrs)].mean(axis=0)
        smoothed[v] = (1.0 - a_n) * verts[v] + a_n * avg
    new_verts = np.concatenate([smoothed, centroids], axis=0).astype(np.float32)

    # flip original edges: each interior edge (a,b) adjacent to faces f,g
    # becomes triangles (a, cf, cg) and (b, cg, cf)
    edge_face: Dict[tuple, int] = {}
    new_faces = []
    for fi, (a, b, c) in enumerate(faces):
        cf = nv + fi
        for x, y in ((int(a), int(b)), (int(b), int(c)), (int(c), int(a))):
            key = (min(x, y), max(x, y))
            gi = edge_face.pop(key, None)
            if gi is None:
                edge_face[key] = fi
            else:
                cg = nv + gi
                new_faces.append([x, cf, cg])
                new_faces.append([y, cg, cf])
    for (x, y), fi in edge_face.items():  # boundary edges keep their face
        new_faces.append([x, y, nv + fi])
    return new_verts, np.array(new_faces, dtype=np.int32)


def load_constraints(path: str) -> np.ndarray:
    """image_warping .constraints file: first line count, then x y x' y'."""
    with open(path) as f:
        n = int(f.readline())
        rows = [[float(t) for t in f.readline().split()] for _ in range(n)]
    return np.array(rows, dtype=np.float32)


def load_mrk(path: str) -> np.ndarray:
    """Marker constraint file (.mrk) used by mesh deformation examples:
    lines of 'x y z vertex_index' (plus possibly extra columns)."""
    rows = []
    with open(path) as f:
        for line in f:
            p = line.split()
            if len(p) >= 4:
                rows.append([float(p[0]), float(p[1]), float(p[2]), float(p[-1])])
    return np.array(rows, dtype=np.float32)


def save_mesh(path: str, verts: np.ndarray, faces=None) -> None:
    """Write a mesh as ascii .ply or .off — the reference apps' output step
    (OpenMesh::IO::write_mesh(*res, "out.ply"),
    arap_mesh_deformation/src/main.cpp:108)."""
    verts = np.asarray(verts, np.float32)
    faces = None if faces is None or len(faces) == 0 else np.asarray(faces)
    nf = 0 if faces is None else len(faces)
    if path.endswith(".off"):
        header = "OFF\n%d %d 0\n" % (len(verts), nf)
    else:
        header = (
            "ply\nformat ascii 1.0\nelement vertex %d\n"
            "property float x\nproperty float y\nproperty float z\n"
            "element face %d\nproperty list uchar int vertex_indices\n"
            "end_header\n" % (len(verts), nf)
        )
    with open(path, "w") as f:
        f.write(header)
        for v in verts:
            f.write("%g %g %g\n" % tuple(v[:3]))
        if faces is not None:
            for fc in faces:
                f.write("%d %s\n" % (len(fc), " ".join(str(int(i)) for i in fc)))
