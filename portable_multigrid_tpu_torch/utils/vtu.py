"""VTU output for structured-grid solutions (pure Python, zlib-compressed).

The counterpart of the reference's DataOut VTU output with
best-speed compression (reference: source/geometric_multigrid/program.cc:368-380).
Writes VTK ImageData (.vti) — the natural format for a structured DoF grid —
with appended zlib-compressed binary data, readable by ParaView/VisIt.

A copy of ``portable_multigrid_tpu/utils/vtu.py`` (NumPy and zlib);
tests/test_torch_utils.py holds its bytes equal to that module's.
"""

from __future__ import annotations

import base64
import struct
import zlib

import numpy as np

from ..fem.space import FESpace


def _encode_block(data: bytes, level: int = 1) -> bytes:
    """VTK compressed-binary encoding: one-block zlib with a 4-word header."""
    comp = zlib.compress(data, level)
    header = struct.pack("<4I", 1, len(data), len(data), len(comp))
    return base64.b64encode(header) + base64.b64encode(comp)


def write_vti(
    filename: str,
    space: FESpace,
    fields: dict[str, np.ndarray],
    compression_level: int = 1,
) -> None:
    """Write nodal grid fields to a .vti file.

    fields: name -> array of shape space.grid_shape (scalar) or
    (k,) + grid_shape (k-component vector field).

    Note: the DoF grid is written as a uniform-spacing image grid; for
    Gauss–Lobatto nodal points (p > 1) the in-cell spacing is approximated as
    uniform, which is the standard "patches" visualization the reference's
    build_patches performs too.
    """
    dim = space.dim
    N = space.points_per_axis
    n = [N - 1] * dim + [0] * (3 - dim)
    spacing = [(space.mesh.b - space.mesh.a) / max(N - 1, 1)] * 3

    pieces = []
    names = []
    for name, arr in fields.items():
        arr = np.asarray(arr, dtype=np.float32)
        if arr.shape == space.grid_shape:
            comps = 1
            # VTK expects x fastest; our axis 0 is slowest -> transpose
            flat = np.ascontiguousarray(arr.transpose()).reshape(-1)
        elif arr.ndim == dim + 1:
            comps = arr.shape[0]
            flat = np.stack(
                [np.ascontiguousarray(c.transpose()).reshape(-1) for c in arr],
                axis=-1,
            ).reshape(-1)
        else:
            raise ValueError(f"bad field shape for {name}: {arr.shape}")
        names.append((name, comps))
        pieces.append(_encode_block(flat.tobytes(), compression_level))

    extent = f"0 {n[0]} 0 {n[1]} 0 {n[2]}"
    lines = [
        '<?xml version="1.0"?>',
        '<VTKFile type="ImageData" version="1.0" byte_order="LittleEndian" '
        'header_type="UInt32" compressor="vtkZLibDataCompressor">',
        f'  <ImageData WholeExtent="{extent}" Origin="{space.mesh.a} '
        f'{space.mesh.a} {space.mesh.a}" '
        f'Spacing="{spacing[0]} {spacing[1]} {spacing[2]}">',
        f'    <Piece Extent="{extent}">',
        f'      <PointData Scalars="{names[0][0]}">',
    ]
    for (name, comps), blob in zip(names, pieces):
        lines.append(
            f'        <DataArray type="Float32" Name="{name}" '
            f'NumberOfComponents="{comps}" format="binary">'
        )
        lines.append("          " + blob.decode("ascii"))
        lines.append("        </DataArray>")
    lines += [
        "      </PointData>",
        "    </Piece>",
        "  </ImageData>",
        "</VTKFile>",
    ]
    with open(filename, "w") as f:
        f.write("\n".join(lines) + "\n")


def vertex_values(gmesh, degree: int, l2g: np.ndarray, u) -> np.ndarray:
    """Per-mesh-vertex values of a Q_degree FE function on a GeneralMesh.

    Extracts the corner DoFs of each cell (local lexicographic index
    sum_k bit_k * degree * (degree+1)^(dim-1-k)) — continuity makes the
    per-vertex value well defined."""
    dim = gmesh.dim
    p = degree
    u = np.asarray(u).reshape(-1)
    out = np.zeros(gmesh.vertices.shape[0])
    corners = []
    for v in range(2**dim):
        idx = 0
        for k in range(dim):
            bit = (v >> (dim - 1 - k)) & 1
            idx += bit * p * (p + 1) ** (dim - 1 - k)
        corners.append(idx)
    out[gmesh.cells.reshape(-1)] = u[l2g[:, corners].reshape(-1)]
    return out


# VTK cell types and lexicographic -> VTK corner permutations
_VTK_CELL = {1: (3, [0, 1]), 2: (9, [0, 1, 3, 2]), 3: (12, [0, 1, 3, 2, 4, 5, 7, 6])}


def write_vtu(
    filename: str,
    gmesh,
    fields: dict[str, np.ndarray],
    compression_level: int = 1,
) -> None:
    """Write per-VERTEX fields on a general/unstructured mesh to a .vtu
    (VTK UnstructuredGrid) file — the output path for the unstructured and
    curved-geometry models (use :func:`vertex_values` to sample a Q_p
    solution at the vertices; the analog of the reference's DataOut with
    one patch subdivision, source/geometric_multigrid/program.cc:368-380).
    """
    dim = gmesh.dim
    V = gmesh.vertices.shape[0]
    E = gmesh.n_cells
    ctype, perm = _VTK_CELL[dim]

    pts = np.zeros((V, 3), dtype=np.float32)
    pts[:, :dim] = gmesh.vertices
    conn = gmesh.cells[:, perm].astype(np.int32)
    offsets = (np.arange(1, E + 1) * conn.shape[1]).astype(np.int32)
    types = np.full(E, ctype, dtype=np.uint8)

    def arr_lines(name, typ, comps, data_bytes):
        blob = _encode_block(data_bytes, compression_level).decode("ascii")
        head = f'        <DataArray type="{typ}" '
        if name:
            head += f'Name="{name}" '
        if comps:
            head += f'NumberOfComponents="{comps}" '
        head += 'format="binary">'
        return [head, "          " + blob, "        </DataArray>"]

    lines = [
        '<?xml version="1.0"?>',
        '<VTKFile type="UnstructuredGrid" version="1.0" '
        'byte_order="LittleEndian" header_type="UInt32" '
        'compressor="vtkZLibDataCompressor">',
        "  <UnstructuredGrid>",
        f'    <Piece NumberOfPoints="{V}" NumberOfCells="{E}">',
        "      <Points>",
        *arr_lines(None, "Float32", 3, pts.tobytes()),
        "      </Points>",
        "      <Cells>",
        *arr_lines("connectivity", "Int32", None, conn.tobytes()),
        *arr_lines("offsets", "Int32", None, offsets.tobytes()),
        *arr_lines("types", "UInt8", None, types.tobytes()),
        "      </Cells>",
    ]
    if fields:
        lines.append(f'      <PointData Scalars="{next(iter(fields))}">')
        for name, arr in fields.items():
            arr = np.asarray(arr, dtype=np.float32)
            if arr.shape != (V,):
                raise ValueError(
                    f"field {name!r} must be per-vertex [{V}], got {arr.shape}"
                )
            lines += arr_lines(name, "Float32", 1, arr.tobytes())
        lines.append("      </PointData>")
    lines += [
        "    </Piece>",
        "  </UnstructuredGrid>",
        "</VTKFile>",
    ]
    with open(filename, "w") as f:
        f.write("\n".join(lines) + "\n")
