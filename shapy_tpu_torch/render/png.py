"""A PNG writer on the standard library (``zlib``), the port's one image
writer.

The JAX package writes the demo's images and the measurement overlay with
``cv2.imwrite``; the port writes them here, so that the demo needs no
``cv2`` (a machine with the card may not have it): 8-bit RGB or RGBA, one
IDAT chunk, every scanline with filter 0 (None). Decoded, a file holds
exactly the pixels of the array, as ``cv2.imwrite``'s file of the same
array does (``cv2`` stores BGR order, which its reader turns back).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {3: 2, 4: 6}  # channels -> PNG colour type (RGB, RGBA)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """(H, W, 3) RGB or (H, W, 4) RGBA uint8 -> the bytes of a PNG file."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or \
            image.shape[2] not in _COLOR_TYPES:
        raise ValueError("encode_png takes (H, W, 3|4) uint8, got "
                         f"{image.dtype} {image.shape}")
    H, W, C = image.shape
    header = struct.pack(">IIBBBBB", W, H, 8, _COLOR_TYPES[C], 0, 0, 0)
    rows = np.zeros((H, 1 + W * C), np.uint8)  # a leading 0: filter None
    rows[:, 1:] = image.reshape(H, W * C)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> None:
    """Write (H, W, 3) RGB or (H, W, 4) RGBA uint8 to ``path`` as PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(image))
