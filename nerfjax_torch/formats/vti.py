"""VTK XML ImageData (.vti) writer (the port's own copy of
``nerfjax/formats/vti.py``).

Replaces the reference's pyvista dependency (scripts/write_format.py:41-87)
with a direct VTK XML serialization. Matches the reference's conventions:
volume transposed to (Z,Y,X), RGB collapsed to grayscale mean, dimensions =
shape+1 (cell data), spacing 1, origin 0, Fortran-order flattening, raw
appended binary encoding. Readable by ParaView/VTK.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


def write_vti_volume(volume: np.ndarray, path: str | Path, name: str = "values") -> None:
    """Write a [X,Y,Z] (or [X,Y,Z,3] RGB -> grayscale-mean) uint8 volume as
    cell data of a VTK ImageData file."""
    vol = np.asarray(volume)
    if vol.ndim == 4:
        vol = np.transpose(vol, (2, 1, 0, 3))
        vol = np.mean(vol, axis=-1).astype(np.uint8)
    else:
        vol = np.transpose(vol, (2, 1, 0)).astype(np.uint8)

    # vol is now (Z, Y, X); VTK dims (points) = cells + 1 in (X, Y, Z) order
    nz, ny, nx = vol.shape
    raw = np.asfortranarray(vol).tobytes(order="F")
    payload = struct.pack("<I", len(raw)) + raw

    header = (
        '<?xml version="1.0"?>\n'
        '<VTKFile type="ImageData" version="1.0" byte_order="LittleEndian" '
        'header_type="UInt32">\n'
        f'  <ImageData WholeExtent="0 {nx} 0 {ny} 0 {nz}" '
        'Origin="0 0 0" Spacing="1 1 1">\n'
        f'    <Piece Extent="0 {nx} 0 {ny} 0 {nz}">\n'
        "      <PointData/>\n"
        f'      <CellData Scalars="{name}">\n'
        f'        <DataArray type="UInt8" Name="{name}" '
        'NumberOfComponents="1" format="appended" offset="0"/>\n'
        "      </CellData>\n"
        "    </Piece>\n"
        "  </ImageData>\n"
        '  <AppendedData encoding="raw">\n_'
    )
    footer = "\n  </AppendedData>\n</VTKFile>\n"

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(payload)
        f.write(footer.encode())
    print(f"Saved VTK volume to: {path}")


def read_vti_volume(path: str | Path) -> np.ndarray:
    """Minimal reader for files this module writes (tests): returns (Z,Y,X)."""
    buf = Path(path).read_bytes()
    head_end = buf.index(b"_", buf.index(b'encoding="raw">')) + 1
    header = buf[:head_end].decode()
    import re

    m = re.search(r'WholeExtent="0 (\d+) 0 (\d+) 0 (\d+)"', header)
    nx, ny, nz = (int(m.group(i)) for i in (1, 2, 3))
    (nbytes,) = struct.unpack_from("<I", buf, head_end)
    raw = np.frombuffer(buf, np.uint8, count=nbytes, offset=head_end + 4)
    return raw.reshape((nz, ny, nx), order="F")
