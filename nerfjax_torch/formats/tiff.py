"""Minimal multi-page TIFF writer for uint8 volumes (the port's own copy of
``nerfjax/formats/tiff.py``).

Replaces the reference's tifffile dependency (scripts/write_format.py:90-143)
with a self-contained baseline-TIFF implementation: little-endian, one page
per leading-axis slice, uncompressed single-strip pages, photometric
minisblack (grayscale) or rgb. Readable by tifffile/PIL/ImageJ/napari and
ParaView.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

# TIFF tag ids
_IMAGE_WIDTH = 256
_IMAGE_LENGTH = 257
_BITS_PER_SAMPLE = 258
_COMPRESSION = 259
_PHOTOMETRIC = 262
_STRIP_OFFSETS = 273
_SAMPLES_PER_PIXEL = 277
_ROWS_PER_STRIP = 278
_STRIP_BYTE_COUNTS = 279
_PLANAR_CONFIG = 284

_SHORT = 3
_LONG = 4


def _entry(tag: int, typ: int, count: int, value: int) -> bytes:
    if typ == _SHORT and count == 1:
        return struct.pack("<HHIHH", tag, typ, count, value, 0)
    return struct.pack("<HHII", tag, typ, count, value)


def write_tiff_volume(volume: np.ndarray, path: str | Path) -> None:
    """Write a [Z,Y,X] (grayscale) or [Z,Y,X,3] (RGB) uint8 volume as a
    multi-page TIFF, one page per z-slice."""
    volume = np.ascontiguousarray(volume, np.uint8)
    if volume.ndim == 3:
        nz, h, w = volume.shape
        spp = 1
        photometric = 1  # minisblack
    elif volume.ndim == 4 and volume.shape[-1] == 3:
        nz, h, w, _ = volume.shape
        spp = 3
        photometric = 2  # rgb
    else:
        raise ValueError(f"unsupported volume shape {volume.shape}")

    page_bytes = h * w * spp
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    with open(path, "wb") as f:
        f.write(b"II*\x00")  # little-endian magic
        first_ifd_ptr_pos = f.tell()
        f.write(struct.pack("<I", 0))  # patched later

        prev_ifd_link = first_ifd_ptr_pos
        for z in range(nz):
            data_off = f.tell()
            f.write(volume[z].tobytes())

            extra_off = None
            if spp == 3:
                # BitsPerSample needs 3 SHORTs -> stored out of line
                extra_off = f.tell()
                f.write(struct.pack("<HHH", 8, 8, 8))
            if f.tell() % 2:
                f.write(b"\x00")

            ifd_off = f.tell()
            entries = [
                _entry(_IMAGE_WIDTH, _LONG, 1, w),
                _entry(_IMAGE_LENGTH, _LONG, 1, h),
                (
                    _entry(_BITS_PER_SAMPLE, _SHORT, 3, extra_off)
                    if spp == 3
                    else _entry(_BITS_PER_SAMPLE, _SHORT, 1, 8)
                ),
                _entry(_COMPRESSION, _SHORT, 1, 1),
                _entry(_PHOTOMETRIC, _SHORT, 1, photometric),
                _entry(_STRIP_OFFSETS, _LONG, 1, data_off),
                _entry(_SAMPLES_PER_PIXEL, _SHORT, 1, spp),
                _entry(_ROWS_PER_STRIP, _LONG, 1, h),
                _entry(_STRIP_BYTE_COUNTS, _LONG, 1, page_bytes),
                _entry(_PLANAR_CONFIG, _SHORT, 1, 1),
            ]
            f.write(struct.pack("<H", len(entries)))
            for e in entries:
                f.write(e)
            next_link_pos = f.tell()
            f.write(struct.pack("<I", 0))

            # patch previous IFD link (or the header pointer) to this IFD
            f.seek(prev_ifd_link)
            f.write(struct.pack("<I", ifd_off))
            f.seek(0, 2)
            prev_ifd_link = next_link_pos


def read_tiff_volume(path: str | Path) -> np.ndarray:
    """Minimal reader for the files this module writes (used in tests)."""
    with open(path, "rb") as f:
        buf = f.read()
    assert buf[:4] == b"II*\x00"
    (ifd_off,) = struct.unpack_from("<I", buf, 4)
    pages = []
    while ifd_off:
        (n,) = struct.unpack_from("<H", buf, ifd_off)
        tags = {}
        for i in range(n):
            tag, typ, count, value = struct.unpack_from(
                "<HHII", buf, ifd_off + 2 + i * 12
            )
            if typ == _SHORT and count == 1:
                value &= 0xFFFF
            tags[tag] = (typ, count, value)
        w = tags[_IMAGE_WIDTH][2]
        h = tags[_IMAGE_LENGTH][2]
        spp = tags.get(_SAMPLES_PER_PIXEL, (_SHORT, 1, 1))[2]
        off = tags[_STRIP_OFFSETS][2]
        nbytes = tags[_STRIP_BYTE_COUNTS][2]
        page = np.frombuffer(buf, np.uint8, count=nbytes, offset=off)
        pages.append(page.reshape((h, w) if spp == 1 else (h, w, spp)))
        (ifd_off,) = struct.unpack_from("<I", buf, ifd_off + 2 + n * 12)
    return np.stack(pages)
