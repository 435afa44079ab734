"""Point-cloud and result file I/O (the JAX package's ``utils/file_io.py``): KITTI
``.bin``, ascii and binary ``.pcd``, ``.ply`` (with optional triangular faces),
``.xyz``, json dicts and the tracking-result line, with vectorised numpy readers
and writers."""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np


def get_pts_from_bin(bin_file, num_features: int = 4) -> np.ndarray:
    """KITTI lidar .bin: flat float32 records."""
    pts = np.fromfile(str(bin_file), dtype=np.float32)
    return pts.reshape(-1, num_features)


def make_sure_path_valid(path):
    Path(path).mkdir(parents=True, exist_ok=True)


def save_dict_as_json(d: dict, json_path, indent: int = 4):
    def default(o):
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, (np.integer, np.floating)):
            return o.item()
        raise TypeError(f"not JSON serializable: {type(o)}")

    with open(json_path, "w") as f:
        json.dump(d, f, indent=indent, default=default)


def load_json_as_dict(json_path) -> dict:
    with open(json_path) as f:
        return json.load(f)


def save_track_results(fp, info, corners):
    """One line per frame: the info fields, then the 24 corner coordinates of an
    (8, 3) corner array, row by row."""
    result = list(info) + np.concatenate(np.asarray(corners), axis=0).tolist()
    fp.write(" ".join(map(str, result)) + "\n")


# ----------------------------------------------------------------------- .pcd


def read_pcd(path) -> np.ndarray:
    """Read a .pcd file (ascii or binary), returning the xyz columns (N, 3)."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", errors="ignore").strip()
            if not line or line.startswith("#"):
                continue
            key, _, value = line.partition(" ")
            header[key.upper()] = value
            if key.upper() == "DATA":
                break
        fields = header.get("FIELDS", "x y z").split()
        sizes = [int(s) for s in header.get("SIZE", "4 4 4").split()]
        types = header.get("TYPE", "F F F").split()
        n = int(header.get("POINTS", header.get("WIDTH", "0")))
        fmt = header["DATA"].split()[0].lower()

        np_types = {"F": "f", "I": "i", "U": "u"}
        dtype = np.dtype(
            [(name, f"{np_types[t]}{s}") for name, t, s in zip(fields, types, sizes)]
        )
        if fmt == "ascii":
            data = np.loadtxt(f, dtype=dtype, max_rows=n)
        elif fmt == "binary":
            data = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
        else:
            raise ValueError(f"unsupported .pcd DATA format {fmt!r}")
    return np.stack([data["x"], data["y"], data["z"]], axis=1).astype(np.float32)


# the name the reference code uses
readPCD = read_pcd


def save_pts_as_pcd(points, path, name=None, binary: bool = False):
    """Write (N, 3) points as .pcd; returns its path."""
    if name is not None:
        make_sure_path_valid(path)
        out = os.path.join(str(path), name)
    else:
        out = str(path)
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
        "FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    with open(out, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(points.tobytes())
        else:
            np.savetxt(f, points, fmt="%.6f")
    return out


# ----------------------------------------------------------------------- .xyz


def save_xyz_file(points, xyz_path):
    np.savetxt(str(xyz_path), np.asarray(points)[:, :3], fmt="%f")


def read_xyz_file(xyz_path) -> np.ndarray:
    return np.loadtxt(str(xyz_path), dtype=np.float32).reshape(-1, 3)


# ----------------------------------------------------------------------- .ply


def write_ply(filename, points, faces=None, field_names=("x", "y", "z")):
    """Binary little-endian PLY writer: ``points`` an (N, C) array matching
    ``field_names``, ``faces`` an optional (M, 3) int array."""
    points = np.asarray(points)
    n = points.shape[0]
    filename = str(filename)
    if not filename.endswith(".ply"):
        filename += ".ply"
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {name}" for name in field_names]
    vertex_dtype = np.dtype([(name, "<f4") for name in field_names])
    if faces is not None:
        faces = np.asarray(faces, np.int32)
        header += [f"element face {faces.shape[0]}", "property list uchar int vertex_indices"]
    header.append("end_header")

    with open(filename, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        rec = np.rec.fromarrays(
            [points[:, i].astype("<f4") for i in range(len(field_names))], dtype=vertex_dtype
        )
        f.write(rec.tobytes())
        if faces is not None:
            face_dtype = np.dtype([("count", "u1"), ("idx", "<i4", (3,))])
            frec = np.empty(faces.shape[0], dtype=face_dtype)
            frec["count"] = 3
            frec["idx"] = faces
            f.write(frec.tobytes())
    return filename


def read_ply(filename, triangular_mesh: bool = False):
    """Binary or ascii little-endian PLY reader. Returns the vertex record array,
    or (vertices, faces) with ``triangular_mesh``."""
    with open(filename, "rb") as f:
        line = f.readline().decode("ascii").strip()
        if line != "ply":
            raise ValueError("not a ply file")
        fmt = None
        n_vertex = n_face = 0
        properties = []
        current = None
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element vertex"):
                n_vertex = int(line.split()[-1])
                current = "vertex"
            elif line.startswith("element face"):
                n_face = int(line.split()[-1])
                current = "face"
            elif line.startswith("property") and current == "vertex":
                _, typ, name = line.split()
                np_map = {"float": "<f4", "float32": "<f4", "double": "<f8",
                          "int": "<i4", "uchar": "u1"}
                properties.append((name, np_map[typ]))
            elif line == "end_header":
                break
        dtype = np.dtype(properties)
        if fmt == "ascii":
            vertices = np.loadtxt(f, dtype=dtype, max_rows=n_vertex)
            faces = (
                np.loadtxt(f, dtype=np.int32, max_rows=n_face)[:, 1:4]
                if n_face else None
            )
        else:
            vertices = np.frombuffer(f.read(n_vertex * dtype.itemsize), dtype=dtype,
                                     count=n_vertex)
            if n_face:
                face_dtype = np.dtype([("count", "u1"), ("idx", "<i4", (3,))])
                faces = np.frombuffer(f.read(n_face * face_dtype.itemsize),
                                      dtype=face_dtype, count=n_face)["idx"]
            else:
                faces = None
    if triangular_mesh:
        return vertices, faces
    return vertices


def save_ply(save_path, points, faces=None):
    """Write the xyz columns of ``points`` (and ``faces``) as .ply."""
    return write_ply(save_path, np.asarray(points)[:, :3], faces=faces)
