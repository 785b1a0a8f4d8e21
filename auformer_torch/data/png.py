"""A PNG reader on the standard library's ``zlib`` (the JAX package reads
PNGs with cv2, auformer/data/ingest.py:45-51).

``read_png(path)`` returns what ``cv2.imread(path, cv2.IMREAD_UNCHANGED)``
returns, with the colour channels in RGB(A) order where cv2's are BGR(A):

  colour type 0, grey       (H, W); depths 1, 2 and 4 scaled to 0..255
                            (libpng's expand); a tRNS key is ignored
  colour type 2, RGB        (H, W, 3); with a tRNS key (H, W, 4), alpha 0
                            where a pixel equals the key, else opaque
  colour type 3, palette    (H, W, 3) through PLTE at depths 1-8; with
                            tRNS (H, W, 4), the entries past tRNS opaque
  colour type 4, grey+alpha (H, W, 4): the grey level in R, G and B
  colour type 6, RGBA       (H, W, 4)

uint8 at depths up to 8, uint16 at depth 16. Adam7-interlaced images are
read pass by pass. Every chunk's CRC is checked; a file this reader cannot
read raises ValueError naming what it lacks.

The five row filters are undone one row at a time: None, Sub (a running
sum per byte lane) and Up are numpy operations over the row; Average and
Paeth depend on the reconstructed byte to the left, and run byte by byte.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel, and the bit depths it allows
_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunks(data: bytes, path: str):
    """Yield (type, body) of each chunk up to IEND, each CRC checked."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path} is not a PNG file (no PNG signature)")
    off = 8
    while off + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[off:off + 8])
        body = data[off + 8:off + 8 + length]
        if len(body) != length or off + 12 + length > len(data):
            raise ValueError(f"{path}: chunk {kind!r} runs past the end")
        crc, = struct.unpack(">I", data[off + 8 + length:off + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: CRC mismatch in chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        off += 12 + length
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def _average_row(row: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(row)):
        left = row[i - bpp] if i >= bpp else 0
        row[i] = (row[i] + ((left + prior[i]) >> 1)) & 0xFF


def _paeth_row(row: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(row)):
        if i >= bpp:
            a, c = row[i - bpp], prior[i - bpp]
        else:
            a = c = 0
        b = prior[i]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        row[i] = (row[i] + (a if pa <= pb and pa <= pc
                            else b if pb <= pc else c)) & 0xFF


def _unfilter(raw: memoryview, rows: int, row_bytes: int, bpp: int,
              path: str) -> np.ndarray:
    """Undo the row filters of ``rows`` filtered rows (a filter byte, then
    ``row_bytes`` bytes each) -> (rows, row_bytes) uint8."""
    out = np.empty((rows, row_bytes), np.uint8)
    prior = np.zeros(row_bytes, np.uint8)
    stride = row_bytes + 1
    for y in range(rows):
        kind = raw[y * stride]
        cur = np.frombuffer(raw[y * stride + 1:(y + 1) * stride], np.uint8)
        if kind == 0:
            out[y] = cur
        elif kind == 1:
            lanes = np.zeros(-(-row_bytes // bpp) * bpp, np.uint8)
            lanes[:row_bytes] = cur
            out[y] = np.cumsum(lanes.reshape(-1, bpp), 0, dtype=np.uint8
                               ).reshape(-1)[:row_bytes]
        elif kind == 2:
            out[y] = cur + prior
        elif kind in (3, 4):
            row = bytearray(cur)
            (_average_row if kind == 3 else _paeth_row)(
                row, prior.tobytes(), bpp)
            out[y] = np.frombuffer(row, np.uint8)
        else:
            raise ValueError(f"{path}: unknown row filter type {kind}")
        prior = out[y]
    return out


def _samples(rows: np.ndarray, width: int, depth: int, samples: int
             ) -> np.ndarray:
    """Unfiltered rows -> (rows, width, samples) of the raw sample values:
    uint8 for depth <= 8 (sub-byte depths unpacked, not yet scaled),
    big-endian pairs read as uint16 for depth 16."""
    n = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(n, width, samples)
    if depth == 8:
        return rows.reshape(n, width, samples)
    bits = np.unpackbits(rows, axis=1)[:, :width * depth]
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits.reshape(n, width, depth) * weights).sum(
        -1, dtype=np.uint8)[..., None]


def read_png(path: str) -> np.ndarray:
    """The image of a PNG file as cv2.imread(IMREAD_UNCHANGED) gives it, in
    RGB(A) order (module docstring)."""
    with open(path, "rb") as f:
        data = f.read()
    header = None
    palette = trns = None
    idat = []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind != b"IEND" and not kind[0] & 0x20:
            raise ValueError(f"{path}: unknown critical chunk {kind!r}")
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or no IDAT chunk")
    width, height, depth, ctype, method, filt, interlace = header
    if ctype not in _SAMPLES or depth not in _DEPTHS[ctype]:
        raise ValueError(f"{path}: colour type {ctype} at bit depth {depth} "
                         "is not a PNG format")
    if method != 0 or filt != 0 or interlace not in (0, 1):
        raise ValueError(f"{path}: compression {method}, filter method "
                         f"{filt} or interlace {interlace} is not PNG's")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: a palette image without PLTE")
    samples = _SAMPLES[ctype]
    bpp = max(1, samples * depth // 8)
    raw = memoryview(zlib.decompress(b"".join(idat)))

    def image(w: int, h: int, off: int) -> tuple[np.ndarray, int]:
        row_bytes = (w * samples * depth + 7) // 8
        need = h * (row_bytes + 1)
        if off + need > len(raw):
            raise ValueError(f"{path}: the image data is truncated")
        rows = _unfilter(raw[off:off + need], h, row_bytes, bpp, path)
        return _samples(rows, w, depth, samples), off + need

    if interlace == 0:
        pix, _ = image(width, height, 0)
    else:
        dtype = np.uint16 if depth == 16 else np.uint8
        pix = np.zeros((height, width, samples), dtype)
        off = 0
        for x0, y0, dx, dy in _ADAM7:
            w = max(0, -(-(width - x0) // dx))
            h = max(0, -(-(height - y0) // dy))
            if w and h:
                part, off = image(w, h, off)
                pix[y0::dy, x0::dx] = part
    return _convert(pix, ctype, depth, palette, trns, path)


def _convert(pix: np.ndarray, ctype: int, depth: int, palette, trns,
             path: str) -> np.ndarray:
    """(H, W, samples) raw samples -> cv2's channels, RGB(A) order."""
    top = (1 << depth) - 1
    if ctype == 0:
        grey = pix[..., 0]
        return grey * np.uint8(255 // top) if depth < 8 else grey
    if ctype == 3:
        index = pix[..., 0]
        if index.max(initial=0) >= len(palette):
            raise ValueError(f"{path}: a palette index past PLTE's "
                             f"{len(palette)} entries")
        rgb = palette[index]
        if trns is None:
            return rgb
        alpha = np.full(256, 255, np.uint8)
        alpha[:len(trns)] = np.frombuffer(trns, np.uint8)[:256]
        return np.concatenate([rgb, alpha[index][..., None]], -1)
    if ctype == 2:
        if trns is None:
            return pix
        key = np.array(struct.unpack(">HHH", trns[:6]), pix.dtype)
        alpha = np.where((pix == key).all(-1), 0, top).astype(pix.dtype)
        return np.concatenate([pix, alpha[..., None]], -1)
    if ctype == 4:
        return pix[..., [0, 0, 0, 1]]
    return pix
