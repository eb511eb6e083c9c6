"""Image loading/saving.

8-bit grayscale PNG, the format the pipeline writes (``synthetic.py``,
``restore.py``), is read and written here with numpy + ``zlib`` alone.
Other inputs (JPEG, BMP, and PNGs in other colour types or bit depths)
go through Pillow, which is optional: without it they fail with a
``RuntimeError`` that names the file.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SUPPORTED_IMAGE_EXTS = (".bmp", ".png", ".jpg", ".jpeg")

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _pil_image(path: Path):
    try:
        from PIL import Image
    except ModuleNotFoundError as exc:
        raise RuntimeError(
            f"{path}: reading this image needs Pillow, which is not "
            "installed (only 8-bit grayscale PNG is read without it)."
        ) from exc
    return Image


def _png_chunks(data: bytes):
    pos = len(_PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _unfilter(raw: np.ndarray) -> np.ndarray:
    """Undo PNG per-row filters for one byte per pixel (RFC 2083 §6)."""
    rows = raw.shape[0]
    out = raw[:, 1:].copy()
    prior = np.zeros(out.shape[1], np.uint8)
    for r in range(rows):
        kind = raw[r, 0]
        line = out[r]
        if kind == 1:  # Sub
            line[:] = np.cumsum(line, dtype=np.uint8)
        elif kind == 2:  # Up
            line += prior
        elif kind in (3, 4):  # Average, Paeth: sequential along the row
            vals = line.astype(np.int32)
            up = prior.astype(np.int32)
            left = upleft = 0
            for c in range(vals.size):
                if kind == 3:
                    pred = (left + up[c]) >> 1
                else:
                    p = left + up[c] - upleft
                    pa, pb, pc = abs(p - left), abs(p - up[c]), abs(p - upleft)
                    pred = left if pa <= pb and pa <= pc else (
                        up[c] if pb <= pc else upleft)
                left = (vals[c] + pred) & 0xFF
                vals[c] = left
                upleft = up[c]
            line[:] = vals.astype(np.uint8)
        elif kind != 0:
            raise ValueError(f"bad PNG filter type {kind}")
        prior = line
    return out


def _read_gray_png(path: Path) -> np.ndarray | None:
    """Decode an 8-bit grayscale non-interlaced PNG; None for other PNGs."""
    data = Path(path).read_bytes()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, colour, _, _, interlace = header
    if (depth, colour, interlace) != (8, 0, 0):
        return None
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return _unfilter(raw.reshape(height, width + 1))


def load_gray_u8(path: Path) -> np.ndarray:
    """Load any supported image as a (H, W) grayscale uint8 matrix."""
    path = Path(path)
    arr = _read_gray_png(path) if path.suffix.lower() == ".png" else None
    if arr is None:
        Image = _pil_image(path)
        with Image.open(path) as img:
            arr = np.asarray(img.convert("L"), dtype=np.uint8)
    if arr.ndim != 2:
        raise ValueError(f"Expected 2D grayscale image, got shape={arr.shape}.")
    return arr


def _chunk(kind: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(kind + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def save_gray_png(path: Path, arr_u8: np.ndarray) -> None:
    """Save a (H, W) uint8 matrix as an 8-bit grayscale PNG."""
    if arr_u8.ndim != 2 or arr_u8.dtype != np.uint8:
        raise ValueError(
            f"Expected 2D uint8 array, got shape={arr_u8.shape} "
            f"dtype={arr_u8.dtype}."
        )
    height, width = arr_u8.shape
    raw = np.zeros((height, width + 1), np.uint8)  # filter byte 0 per row
    raw[:, 1:] = arr_u8
    header = struct.pack(">IIBBBBB", width, height, 8, 0, 0, 0, 0)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(
        _PNG_SIGNATURE
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


def iter_image_files(image_dir: Path) -> list[Path]:
    files = [
        p
        for p in image_dir.iterdir()
        if p.is_file() and p.suffix.lower() in SUPPORTED_IMAGE_EXTS
    ]
    return sorted(files, key=lambda p: p.name.lower())
