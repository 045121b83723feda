"""Minimal PCD reader/writer (the PCL file format).

Covers the subset the reference produces/consumes: x/y/z[/intensity]
float32 fields, ascii or binary DATA (utils/sample_data/*/Scans/*.pcd are
binary; pcl::io::savePCDFileBinary writes keyframe scans at
src/laserPosegraphOptimization.cpp:697).
"""

from __future__ import annotations

import numpy as np


def read_pcd(path: str) -> np.ndarray:
    """Returns [N, F] float32 (columns in header FIELDS order)."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if not line or line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key] = val
            if key == "DATA":
                break
        fields = header["FIELDS"].split()
        sizes = list(map(int, header["SIZE"].split()))
        types = header["TYPE"].split()
        counts = list(map(int, header.get("COUNT", " ".join(["1"] * len(fields))).split()))
        n = int(header["POINTS"])
        mode = header["DATA"]

        np_types = {("F", 4): "f4", ("F", 8): "f8", ("U", 1): "u1",
                    ("U", 2): "u2", ("U", 4): "u4", ("I", 1): "i1",
                    ("I", 2): "i2", ("I", 4): "i4"}
        if mode == "ascii":
            data = np.loadtxt(f, dtype=np.float32, max_rows=n)
            return data.reshape(n, -1).astype(np.float32)
        elif mode == "binary":
            dtype = np.dtype(
                [
                    (name, np_types[(t, s)], (c,) if c > 1 else ())
                    for name, t, s, c in zip(fields, types, sizes, counts)
                ]
            )
            raw = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
            cols = [raw[name].reshape(n, -1).astype(np.float32) for name in fields]
            return np.concatenate(cols, axis=1)
        else:
            raise ValueError(f"unsupported PCD DATA mode {mode}")


def write_pcd(path: str, points: np.ndarray, binary: bool = True) -> None:
    """Writes x y z [intensity] float32."""
    points = np.asarray(points, dtype=np.float32)
    n, f = points.shape
    fields = ["x", "y", "z", "intensity"][:f]
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {' '.join(fields)}\n"
        f"SIZE {' '.join(['4'] * f)}\n"
        f"TYPE {' '.join(['F'] * f)}\n"
        f"COUNT {' '.join(['1'] * f)}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    with open(path, "wb") as fh:
        fh.write(header.encode("ascii"))
        if binary:
            fh.write(np.ascontiguousarray(points).tobytes())
        else:
            np.savetxt(fh, points, fmt="%.6f")
