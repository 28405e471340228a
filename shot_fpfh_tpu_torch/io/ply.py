"""Binary PLY reader/writer and the data-loading entry point.

Framework-free copy of ``shot_fpfh_tpu.io.ply``; the normals callback must
return a host array (the port's CLI passes one that moves its result to the
host).

Host-side I/O mirroring the reference (helpers/io_ply.py): binary
little/big-endian PLY with vertex properties into a NumPy structured array
(ASCII rejected, as in the reference), writer emitting a text header + raw
binary records, and ``get_data`` which loads points + normals (accepting
``nx/ny/nz`` or ``n_x/n_y/n_z`` fields), optionally recomputes normals via a
callback, and optionally removes duplicates (round to 4 decimals + unique).
"""

from __future__ import annotations

import logging
import sys
from typing import Protocol

import numpy as np

logger = logging.getLogger(__name__)

_PLY_TO_NUMPY = {
    "int8": "i1", "char": "i1",
    "uint8": "u1", "uchar": "u1",
    "int16": "i2", "short": "i2",
    "uint16": "u2", "ushort": "u2",
    "int32": "i4", "int": "i4",
    "uint32": "u4", "uint": "u4",
    "float32": "f4", "float": "f4",
    "float64": "f8", "double": "f8",
}
_FORMAT_PREFIX = {"binary_little_endian": "<", "binary_big_endian": ">"}


def read_ply(filename: str) -> np.ndarray:
    """Read a binary .ply file into a structured array (vertex element)."""
    with open(filename, "rb") as f:
        if b"ply" not in f.readline():
            raise ValueError(f"{filename!r} is missing the 'ply' magic header line")
        fmt = f.readline().split()[1].decode()
        if fmt == "ascii":
            raise ValueError(
                f"{filename!r} is an ASCII .ply; only binary .ply is supported"
            )
        prefix = _FORMAT_PREFIX[fmt]

        num_points = None
        properties: list[tuple[str, str]] = []
        line = b""
        while b"end_header" not in line:
            line = f.readline()
            if not line:
                break
            if line.startswith(b"element"):
                num_points = int(line.split()[2])
            elif line.startswith(b"property"):
                parts = line.split()
                properties.append(
                    (parts[2].decode(), prefix + _PLY_TO_NUMPY[parts[1].decode()])
                )
        return np.fromfile(f, dtype=properties, count=num_points)


def write_ply(filename: str, field_list, field_names: list[str]) -> bool:
    """Write columns to a binary .ply (native byte order), reference-compatible
    (helpers/io_ply.py:124-213)."""
    fields = list(field_list) if isinstance(field_list, (list, tuple)) else [field_list]
    for i, field in enumerate(fields):
        if field is None:
            logger.warning("write_ply: refusing to write a None field")
            return False
        field = np.asarray(field)
        if field.ndim > 2:
            logger.warning("write_ply: fields must be 1-D or 2-D arrays")
            return False
        fields[i] = field.reshape(-1, 1) if field.ndim < 2 else field

    n_rows = {f.shape[0] for f in fields}
    if len(n_rows) != 1:
        logger.warning("write_ply: fields disagree on the number of rows")
        return False
    if sum(f.shape[1] for f in fields) != len(field_names):
        logger.warning("write_ply: field_names count does not match total columns")
        return False

    if not filename.endswith(".ply"):
        filename += ".ply"

    columns = [col for f in fields for col in f.T]
    dtype = [(name, col.dtype.str) for name, col in zip(field_names, columns)]

    header = ["ply", f"format binary_{sys.byteorder}_endian 1.0",
              f"element vertex {columns[0].shape[0]}"]
    header += [f"property {col.dtype.name} {name}" for name, col in zip(field_names, columns)]
    header.append("end_header")

    with open(filename, "w") as f:
        f.write("\n".join(header) + "\n")
    data = np.empty(columns[0].shape[0], dtype=dtype)
    for name, col in zip(field_names, columns):
        data[name] = col
    with open(filename, "ab") as f:
        data.tofile(f)
    return True


class NormalsComputationCallback(Protocol):
    def __call__(
        self, query_points, cloud_points, *, k=None, radius=None, pre_computed_normals=None
    ): ...


def get_data(
    data_path: str,
    remove_duplicates: bool = False,
    recompute_normals: bool = True,
    k: int | None = None,
    radius: float | None = None,
    normals_computation_callback: NormalsComputationCallback | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Load (points, normals) from a .ply file (reference
    helpers/io_ply.py:259-301): normals taken from ``nx/ny/nz`` or
    ``n_x/n_y/n_z`` fields if present (optionally recomputed with the callback,
    sign-aligned to the stored ones), otherwise computed from scratch."""
    data = read_ply(data_path)
    points = np.vstack((data["x"], data["y"], data["z"])).T.astype(np.float64)

    fields = data.dtype.fields.keys()
    normals = None
    for trio in (("nx", "ny", "nz"), ("n_x", "n_y", "n_z")):
        if trio[0] in fields:
            normals = np.vstack([data[c] for c in trio]).T.astype(np.float64)
            break

    if normals is not None and recompute_normals:
        logger.info("Recomputing normals.")
        normals = np.asarray(
            normals_computation_callback(
                points, points, k=k, radius=radius, pre_computed_normals=normals
            )
        )
    elif normals is None:
        if normals_computation_callback is None:
            raise ValueError(
                f"{data_path!r} has no normal fields (nx/ny/nz or n_x/n_y/n_z) and "
                "no normals_computation_callback was given to compute them"
            )
        normals = np.asarray(
            normals_computation_callback(points, points, k=k, radius=radius)
        )

    if remove_duplicates:
        keep = np.unique(points.round(decimals=4), axis=0, return_index=True)[1]
        return points[keep], normals[keep]
    return points, normals
