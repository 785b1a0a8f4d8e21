"""YUV -> RGB conversion of decoded video frames (``csrc/yuv_rgb.cu``).

The JAX package reads frames through cv2, whose FFMPEG capture converts
each decoded frame with swscale to BGR24 and then to RGB: full-range
planes (MJPEG's yuvj420p and yuvj422p, and a video stream that says it is
full range) as they are, a video decoder's limited-range planes (MPEG-4
part 2, H.264) with luma offset 16 and wider coefficients
(``limited=True``); the chroma coefficients from the row of swscale's
ff_yuv2rgb_coeffs that the stream's colour matrix selects (``matrix``: the
matrix_coefficients of H.264's VUI or of MPEG-4 part 2's colour
description; BT.601 where there is none: ``coefficients``). swscale takes
one of two routes by the chroma layout:

  4:2:0, 4:2:2   its unscaled yuv2rgb converter: nearest chroma, 16-bit
                 fixed point (a monochrome H.264 stream's frames come as
                 4:2:0 planes whose chroma is 128, and go this way too);
  4:4:4          chroma that is not subsampled makes swscale interpolate
                 chroma in full (SWS_FULL_CHR_H_INT) and leave the unscaled
                 converter for its scaler at scale 1 and yuv2rgb_write_full:
                 30-bit fixed point with rounding, whose 32-bit sums wrap
                 before the clip (``full_chroma``).

Samples deeper than 8 bits (``bit_depth`` 9-14: an H.264 High 10, High
4:2:2 or High 4:4:4 stream's, int16 planes) take swscale's scaler at
scale 1 in every layout, since its unscaled converter reads 8-bit planes
only (``deep_rgb``): each sample to 15 bits (hScale16To15); 4:4:4 then
yuv2rgb_write_full as above; 4:2:0 and 4:2:2 a bicubic chroma filter
(swscale's initFilter: 14-bit horizontal and 12-bit vertical taps, B 0, C
0.6) that moves the chroma across from the siting the stream gives
(``chroma_loc``, which cv2 passes on: H.264's left siting by default, a
quarter chroma sample) to the centre siting of swscale's half-width RGB
chroma, and for 4:2:0 interpolates it to every row, then the x86
packed output, yuv2bgr24_X: 16-bit pmulhw products with a rounder of 4
(rows above the last two), and the C output on a frame's last two rows,
8-bit values through ff_yuv2rgb_c_init_tables' lookup tables
(``_deep_rows``). swscale's 2-tap vertical route (4:2:0 frames of 7 or 8
rows) and odd widths (full chroma interpolation) raise.

``yuv_rgb_plain`` is that arithmetic in PyTorch, bit for bit on every (Y,
U, V) input that the tests sweep (tests/test_torch_video_decode.py,
tests/test_torch_video_mpeg4.py, tests/test_torch_video_h264.py,
tests/test_torch_video_h264_chroma.py, tests/test_torch_video_h264_depth.py);
``yuv_rgb`` takes it for CPU planes and launches the CUDA kernel for CUDA
ones.

The planes: ``y`` (H, W); ``u`` and ``v`` (ceil(H / 2) or H, ceil(W / 2) or
W: 4:2:0, 4:2:2 or 4:4:4), each a 2-D view whose rows may be pitched but
whose columns are contiguous, uint8 at 8 bits and int16 deeper; ``u`` and
``v`` share their strides.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .build import check, library

# swscale's luma term (ff_yuv2rgb_c_init_tables: yCoeff, yOffset): full
# range (8 Y * 8192) >> 16, which is Y itself; limited range, the offset
# 16: ((8 Y - 128) * 9539) >> 16
LIMITED_CY = 9539

# swscale's ff_yuv2rgb_coeffs rows (crv, cbu, -cgu, -cgv in 16.16) by the
# matrix_coefficients value that cv2 passes to sws_getCoefficients, which
# takes BT.601's row for every value it does not list
_SWS_ROWS = {1: (117489, 138438, 13975, 34925),     # BT.709
             4: (104448, 132798, 24759, 53109),     # FCC
             7: (117579, 136230, 16907, 35559),     # SMPTE 240M
             9: (110013, 140363, 12277, 42626),     # BT.2020 NCL
             10: (110013, 140363, 12277, 42626)}    # BT.2020 CL
_BT601_ROW = (104597, 132201, 25675, 53279)


def coefficients(matrix: int = 2, limited: bool = True
                 ) -> tuple[int, int, int, int]:
    """(crv, cgu, cgv, cbu) of the conversion for a stream's
    matrix_coefficients: ff_yuv2rgb_c_init_tables' 13-bit rounding of the
    row, (c * 8192 + 32768) >> 16, each first scaled by 224 / 255
    (truncated) for full range. BT.601 gives (11485, -2819, -5850, 14516)
    in full range and (13075, -3209, -6660, 16525) in limited range."""
    crv, cbu, cgu, cgv = _SWS_ROWS.get(int(matrix), _BT601_ROW)
    row = (crv, -cgu, -cgv, cbu)
    if not limited:     # C's division, truncated toward zero
        row = tuple((abs(c) * 224 // 255) * (1 if c >= 0 else -1)
                    for c in row)
    return tuple((c * 8192 + 32768) >> 16 for c in row)


def _check_planes(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                  bit_depth: int = 8) -> tuple[int, int]:
    """The chroma's vertical and horizontal shifts ((1, 1) for 4:2:0, (0,
    1) for 4:2:2, (0, 0) for 4:4:4); raises on planes that do not fit each
    other or their ``bit_depth`` (uint8 at 8, int16 at 9-14)."""
    if not 8 <= bit_depth <= 14:
        raise ValueError(f"yuv_rgb: a bit depth of {bit_depth}")
    dtype = torch.uint8 if bit_depth == 8 else torch.int16
    for p in (y, u, v):
        if p.dtype != dtype or p.dim() != 2:
            raise ValueError(f"yuv_rgb: 2-D {dtype} planes at {bit_depth} "
                             f"bits, not {p.dtype} {tuple(p.shape)}")
        if p.stride(1) != 1:
            raise ValueError("yuv_rgb: each plane's columns must be "
                             "contiguous")
    h, w = y.shape
    if h < 1 or w < 1:
        raise ValueError(f"yuv_rgb: an empty {h}x{w} frame")
    if u.shape != v.shape or u.stride() != v.stride():
        raise ValueError("yuv_rgb: U and V must share their shape and "
                         "strides")
    for shifts in ((1, 1), (0, 1), (0, 0)):
        if u.shape == (-(-h >> shifts[0]), -(-w >> shifts[1])):
            return shifts
    raise ValueError(f"yuv_rgb: chroma {tuple(u.shape)} is not 4:2:0, "
                     f"4:2:2 or 4:4:4 of a {h}x{w} frame")


def full_chroma(y: torch.Tensor, cu: torch.Tensor, cv: torch.Tensor,
                limited: bool, crv: int, cgu: int, cgv: int, cbu: int,
                bit_depth: int = 8) -> torch.Tensor:
    """swscale's yuv2rgb_write_full on samples that its scaler carried at
    scale 1 (Y << (17 - bit_depth), U << (17 - bit_depth) - (128 << 9):
    Y << 9 and (U - 128) << 9 at 8 bits): the luma coefficient and offset
    of ff_yuv2rgb_c_init_tables (9539 and 16 << 9 limited, 8192 and 0
    full), the rounding 1 << 21, each sum as its 32 bits hold it (the C
    code adds in unsigned arithmetic, and a wrapped sum clips to 0), >>
    22."""
    cy, oy = (LIMITED_CY, 16 << 9) if limited else (8192, 0)
    s = 17 - bit_depth
    yt = ((y.to(torch.int64) << s) - oy) * cy + (1 << 21)
    u9 = (cu.to(torch.int64) << s) - (128 << 9)
    v9 = (cv.to(torch.int64) << s) - (128 << 9)

    def out(x):
        x = ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
        return (x >> 22).clamp_(0, 255)

    return torch.stack([out(yt + v9 * crv), out(yt + v9 * cgv + u9 * cgu),
                        out(yt + u9 * cbu)], -1).to(torch.uint8)


def _cdiv(a: int, b: int) -> int:
    """C's integer division, truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


@functools.lru_cache(maxsize=64)
def sws_filter(src_w: int, dst_w: int, x_inc: int, src_pos: int,
               dst_pos: int, one: int, align: int
               ) -> tuple[tuple[tuple[int, ...], ...], tuple[int, ...]]:
    """swscale's initFilter (libswscale/utils.c) for SWS_BICUBIC with its
    default parameters (B 0, C 0.6) at the same size or enlarging: the
    integer taps of each of the ``dst_w`` outputs, which sum to ``one``
    (1 << 14 across, 1 << 12 down), and the first source sample each reads
    (src_pos + j past the source's last sample has a zero tap). Positions
    are swscale's chroma positions (1/256 of a sample, +128, shifted by the
    subsampling); ``align`` is x86's filterAlign (4 across, 2 down)."""
    if x_inc > 1 << 16:
        raise ValueError("sws_filter: a smaller destination")
    fone = 1 << 54                       # src_w / dst_w < 2: av_log2 0
    if abs(x_inc - 0x10000) < 10 and src_pos == dst_pos:     # unscaled
        size, rows, pos = 1, [[fone] for _ in range(dst_w)], list(
            range(dst_w))
    else:
        size = max(min(5, src_w - 2), 1)
        xdst = ((dst_pos * x_inc) >> 7) - ((src_pos * 0x10000) >> 7)
        c = int(0.6 * (1 << 24))
        rows, pos = [], []
        for _ in range(dst_w):
            xx = _cdiv(xdst - (size - 2) * (1 << 16), 1 << 17)
            pos.append(xx)
            row = []
            for _ in range(size):
                d = abs(xx * (1 << 17) - xdst) << 13   # 1 << 30: a sample
                dd = (d * d) >> 30
                ddd = (dd * d) >> 30
                if d >= 1 << 31:
                    row.append(0)
                elif d < 1 << 30:
                    row.append((12 * (1 << 24) - 6 * c) * ddd
                               + (-18 * (1 << 24) + 6 * c) * dd
                               + 6 * (1 << 24) * (1 << 30))
                else:
                    row.append(-6 * c * ddd + 30 * c * dd - 48 * c * d
                               + 24 * c * (1 << 30))
                xx += 1
            rows.append(row)
            xdst += 2 * x_inc
    # drop near-zero taps from the left and count those on the right
    cut, min_size = 0.002 * fone, 0
    for i in range(dst_w - 1, -1, -1):
        n, acc = size, 0
        for _ in range(size):
            acc += abs(rows[i][0])
            if acc > cut or (i < dst_w - 1 and pos[i] >= pos[i + 1]):
                break
            rows[i] = rows[i][1:] + [0]
            pos[i] += 1
        acc = 0
        for j in range(size - 1, 0, -1):
            acc += abs(rows[i][j])
            if acc > cut:
                break
            n -= 1
        min_size = max(min_size, n)
    if min_size == 1 and align == 2:
        align = 1
    out_size = (min_size + align - 1) & ~(align - 1)
    rows = [[r[j] if j < size else 0 for j in range(out_size)] for r in rows]
    for i, r in enumerate(rows):        # the borders: taps past an edge
        if pos[i] < 0:                  # onto the edge sample
            for j in range(1, out_size):
                left = max(j + pos[i], 0)
                r[left] += r[j]
                r[j] = 0
            pos[i] = 0
        if pos[i] + out_size > src_w:
            shift = pos[i] + min(out_size - src_w, 0)
            acc = 0
            for j in range(out_size - 1, -1, -1):
                if pos[i] + j >= src_w:
                    acc += r[j]
                    r[j] = 0
            for j in range(out_size - 1, -1, -1):
                r[j] = 0 if j < shift else r[j - shift]
            pos[i] -= shift
            r[src_w - 1 - pos[i]] += acc
    taps = []
    for r in rows:                      # normalised, the error carried
        total = _cdiv(sum(r) + one // 2, one) or 1
        err, row = 0, []
        for c in r:
            c += err
            q = _cdiv(c + (total >> 1) if c >= 0 else c - (total >> 1), total)
            row.append(q)
            err = c - q * total
        taps.append(tuple(row))
    return tuple(taps), tuple(pos)


_A9 = "ROADMAP.md queue A9 lists it"


def chroma_siting(chroma_loc: int) -> tuple[int, int]:
    """(src_h_chr_pos, src_v_chr_pos) that cv2 hands swscale for a frame
    of chroma siting ``chroma_loc`` (AVChromaLocation: 1 left, 2 centre,
    3 top left, 4 top, 5 bottom left, 6 bottom; 0 unspecified, which cv2
    leaves to swscale's default, the centre): av_chroma_location_enum_to_pos,
    in 1/256 of a luma sample."""
    if not 1 <= chroma_loc <= 6:
        return 128, 128
    t = chroma_loc - 1
    return (t & 1) * 128, ((t >> 1) ^ (t < 4)) * 128


def deep_filters(h: int, w: int, v_shift: int, chroma_loc: int = 1):
    """The chroma taps and first samples of the high-depth 4:2:0 and 4:2:2
    route at h x w (even w), from the frame's ``chroma_siting`` to the
    centre of swscale's half-width RGB chroma: across, at the same width
    (left siting, H.264's default: a quarter chroma sample); down, 4:2:0's
    ceil(h / 2) rows to h, 4:2:2's one tap (cv2 moves no chroma
    vertically that is not subsampled so). Positions as swscale's
    get_local_pos takes them: (pos + 128) >> the subsampling. Raises where
    swscale takes a route this module does not follow."""
    if w % 2:
        raise NotImplementedError(
            f"yuv_rgb: a {h}x{w} frame deeper than 8 bits: swscale "
            f"interpolates the chroma of odd widths in full; {_A9}")
    cw, ch = w // 2, -(-h >> v_shift)
    x, y = chroma_siting(chroma_loc)
    across = sws_filter(cw, cw, ((cw << 16) + (cw >> 1)) // cw,
                        (x + 128) >> 1, 128, 1 << 14, 4)
    down = sws_filter(ch, h, ((ch << 16) + (h >> 1)) // h,
                      (y + 128) >> 1 if v_shift else 128, 128, 1 << 12, 2)
    if len(down[0][0]) == 2:
        raise NotImplementedError(
            f"yuv_rgb: a {h}-row frame deeper than 8 bits: swscale's "
            f"2-tap vertical route; {_A9}")
    return across, down



def lut_params(matrix: int, limited: bool) -> tuple[int, ...]:
    """(crv, cbu, cgu, cgv, cy, oy, yoffs) of ff_yuv2rgb_c_init_tables'
    24-bit tables, which swscale's C packed output reads: the chroma
    coefficients of the matrix's row in 16.16 over cy (1 << 16, 255 / 219
    of it limited), the luma offset oy and the table offset yoffs; a
    table entry i is clip((i cy - (384 << 16) - 512 cy - oy + 0x8000) >>
    16, 0, 255)."""
    crv, cbu, cgu, cgv = _SWS_ROWS.get(int(matrix), _BT601_ROW)
    cgu, cgv = -cgu, -cgv
    cy, oy = 1 << 16, 0
    if limited:
        cy, oy = (cy * 255) // 219, 16 << 16
    else:
        crv, cbu, cgu, cgv = (_cdiv(c * 224, 255) for c in (crv, cbu, cgu,
                                                            cgv))
    crv, cbu, cgu, cgv = (_cdiv((c << 16) + 0x8000, cy) for c in (crv, cbu,
                                                                  cgu, cgv))
    return crv, cbu, cgu, cgv, cy, oy, (326 if limited else 384) + 512


def _deep_rows(y15, ch, cv, taps_v, pos_v, limited, matrix):
    """RGB of the scaler's 15-bit luma (H, W) and horizontally filtered
    chroma (rows of ch, cv) through the vertical chroma taps and the two
    packed outputs (module docstring)."""
    h, w = y15.shape
    tv = torch.tensor(taps_v, dtype=torch.int32, device=y15.device)
    pv = torch.tensor(pos_v, dtype=torch.int64, device=y15.device)
    n = tv.shape[1]
    rows = [(pv + j).clamp_(max=ch.shape[0] - 1) for j in range(n)]
    crv, cgu, cgv, cbu = coefficients(matrix, limited)
    cy, oy = (LIMITED_CY, 128) if limited else (8192, 0)
    cols = torch.arange(w, device=y15.device) >> 1
    out = torch.empty((h, w, 3), dtype=torch.int32, device=y15.device)
    # rows above the last two: yuv2bgr24_X (pmulhw) or _1 (one tap: >> 4)
    if n == 1:
        yv, uv, vv = y15 >> 4, ch[rows[0]] >> 4, cv[rows[0]] >> 4
    else:
        yv = 4 + (y15 >> 4)
        uv = 4 + sum((ch[r] * tv[:, j:j + 1]) >> 16
                     for j, r in enumerate(rows))
        vv = 4 + sum((cv[r] * tv[:, j:j + 1]) >> 16
                     for j, r in enumerate(rows))
    uc, vc = uv - 1024, vv - 1024
    yt = ((yv - oy) * cy) >> 16
    r = ((vc * crv) >> 16)[:, cols]
    g = (((uc * cgu) >> 16) + ((vc * cgv) >> 16))[:, cols]
    b = ((uc * cbu) >> 16)[:, cols]
    out[:] = torch.stack([yt + r, yt + g, yt + b], -1)
    # the last two rows: the C output's 8-bit values through the tables
    last = slice(max(h - 2, 0), h)
    crv2, cbu2, cgu2, cgv2, cy2, oy2, yoffs = lut_params(matrix, limited)
    y8 = (y15[last] + 64) >> 7
    if n == 1:
        u8 = (ch[rows[0][last]] + 64) >> 7
        v8 = (cv[rows[0][last]] + 64) >> 7
    else:
        u8 = ((1 << 18) + sum(ch[r[last]].to(torch.int64) * tv[last, j:j + 1]
                              for j, r in enumerate(rows))) >> 19
        v8 = ((1 << 18) + sum(cv[r[last]].to(torch.int64) * tv[last, j:j + 1]
                              for j, r in enumerate(rows))) >> 19
    u8, v8 = u8.clamp(0, 255), v8.clamp(0, 255)
    base = -(384 << 16) - 512 * cy2 - oy2 + 0x8000

    def table(i):
        return ((base + i.to(torch.int64) * cy2) >> 16).clamp_(0, 255)

    out[last] = torch.stack([
        table(yoffs - (crv2 >> 9) + ((v8 * crv2) >> 16)[:, cols] + y8),
        table(yoffs - (cgu2 >> 9) + ((u8 * cgu2) >> 16)[:, cols]
              - (cgv2 >> 9) + ((v8 * cgv2) >> 16)[:, cols] + y8),
        table(yoffs - (cbu2 >> 9) + ((u8 * cbu2) >> 16)[:, cols] + y8)],
        -1).to(torch.int32)
    return out.clamp_(0, 255).to(torch.uint8)


def deep_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
             limited: bool, matrix: int, bit_depth: int,
             chroma_loc: int = 1) -> torch.Tensor:
    """swscale's conversion of planes deeper than 8 bits (module
    docstring), their chroma sited at ``chroma_loc``."""
    v_shift, h_shift = _check_planes(y, u, v, bit_depth)
    h, w = y.shape
    if not h_shift:
        return full_chroma(y, u, v, limited, *coefficients(matrix, limited),
                           bit_depth)
    (taps_h, pos_h), (taps_v, pos_v) = deep_filters(h, w, v_shift,
                                                    chroma_loc)
    y15 = y.to(torch.int32) << (15 - bit_depth)
    th = torch.tensor(taps_h, dtype=torch.int32, device=y.device)
    ph = torch.tensor(pos_h, dtype=torch.int64, device=y.device)
    cw = u.shape[1]

    def across(c):
        c = c.to(torch.int32)
        acc = sum(c[:, (ph + j).clamp(max=cw - 1)] * th[:, j]
                  for j in range(th.shape[1]))
        return (acc >> (bit_depth - 1)).clamp_(max=32767)

    return _deep_rows(y15, across(u), across(v), taps_v, pos_v, limited,
                      matrix)


def yuv_rgb_plain(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                  limited: bool = False, matrix: int = 2,
                  bit_depth: int = 8, chroma_loc: int = 1) -> torch.Tensor:
    """(H, W, 3) uint8 RGB of the planes, as cv2 converts them: full range
    (a JPEG's), or limited range with ``limited`` and the colour matrix
    ``matrix``, by the route of the planes' chroma layout and bit depth
    (module docstring); deeper than 8 bits, the chroma sited at
    ``chroma_loc`` (``chroma_siting``; 8-bit routes do not read it)."""
    if bit_depth != 8:
        return deep_rgb(y, u, v, limited, matrix, bit_depth, chroma_loc)
    v_shift, h_shift = _check_planes(y, u, v)
    h, w = y.shape
    crv, cgu, cgv, cbu = coefficients(matrix, limited)
    if not h_shift:
        return full_chroma(y, u, v, limited, crv, cgu, cgv, cbu)
    rows = torch.arange(h, device=y.device) >> v_shift
    cols = torch.arange(w, device=y.device) >> h_shift
    cu = u.to(torch.int32)[rows][:, cols] * 8 - 1024
    cv = v.to(torch.int32)[rows][:, cols] * 8 - 1024
    yt = y.to(torch.int32)
    if limited:
        yt = ((yt * 8 - 128) * LIMITED_CY) >> 16
    r = yt + ((cv * crv) >> 16)
    g = yt + ((cu * cgu) >> 16) + ((cv * cgv) >> 16)
    b = yt + ((cu * cbu) >> 16)
    return torch.stack([r, g, b], -1).clamp_(0, 255).to(torch.uint8)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = library("yuv_rgb")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.yuv_rgb.argtypes = [ptr, i, ptr, ptr, i, i, i, i, i, i, i, i, i,
                            i, ptr, ptr]
    lib.yuv_rgb.restype = ctypes.c_int
    lib.yuv_rgb_deep.argtypes = [ptr] * 7
    lib.yuv_rgb_deep.restype = ctypes.c_int
    return lib


# the fields of csrc/yuv_rgb.cu's Deep, in order
_DEEP_FIELDS = ("height", "width", "c_height", "c_width", "y_pitch",
                "c_pitch", "depth", "v_shift", "h_shift", "limited", "crv",
                "cgu", "cgv", "cbu", "lut_crv", "lut_cbu", "lut_cgu",
                "lut_cgv", "lut_cy", "lut_oy", "lut_yoffs", "taps_h",
                "taps_v")
_DEEP_TABLES: dict = {}     # the filter tables on a card, by frame shape


def _deep_launch(y, u, v, limited, matrix, bit_depth, chroma_loc, out,
                 stream):
    """csrc/yuv_rgb.cu's yuv_rgb_deep on the planes: the chroma filters
    of deep_filters, uploaded once per device, frame shape and siting."""
    v_shift, h_shift = _check_planes(y, u, v, bit_depth)
    h, w = y.shape
    taps_h = taps_v = 1
    filt = out                  # not read at 4:4:4
    if h_shift:
        key = (y.device, h, w, v_shift, chroma_loc)
        if key not in _DEEP_TABLES:
            (th, ph), (tv, pv) = deep_filters(h, w, v_shift, chroma_loc)
            flat = [c for r in th for c in r] + list(ph) + [
                c for r in tv for c in r] + list(pv)
            _DEEP_TABLES[key] = (len(th[0]), len(tv[0]), torch.tensor(
                flat, dtype=torch.int32, device=y.device))
        taps_h, taps_v, filt = _DEEP_TABLES[key]
    crv, cgu, cgv, cbu = coefficients(matrix, limited)
    lcrv, lcbu, lcgu, lcgv, lcy, loy, lyoffs = lut_params(matrix, limited)
    args = dict(height=h, width=w, c_height=u.shape[0], c_width=u.shape[1],
                y_pitch=y.stride(0), c_pitch=u.stride(0), depth=bit_depth,
                v_shift=v_shift, h_shift=h_shift, limited=int(limited),
                crv=crv, cgu=cgu, cgv=cgv, cbu=cbu, lut_crv=lcrv,
                lut_cbu=lcbu, lut_cgu=lcgu, lut_cgv=lcgv, lut_cy=lcy,
                lut_oy=loy, lut_yoffs=lyoffs, taps_h=taps_h, taps_v=taps_v)
    packed = (ctypes.c_int * len(_DEEP_FIELDS))(*(args[f]
                                                  for f in _DEEP_FIELDS))
    return _library().yuv_rgb_deep(y.data_ptr(), u.data_ptr(), v.data_ptr(),
                                   ctypes.addressof(packed), filt.data_ptr(),
                                   out.data_ptr(), stream)


def yuv_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
            limited: bool = False, matrix: int = 2, bit_depth: int = 8,
            chroma_loc: int = 1) -> torch.Tensor:
    """(H, W, 3) uint8 RGB of the planes (module docstring), full or
    ``limited`` range with the colour ``matrix``, of samples ``bit_depth``
    bits deep whose chroma is sited at ``chroma_loc``: ``yuv_rgb_plain``
    for CPU planes, the kernel on the current stream for CUDA ones (or an
    error). ``yuv_rgb.launches`` counts kernel launches."""
    v_shift, h_shift = _check_planes(y, u, v, bit_depth)
    if all(p.device.type == "cpu" for p in (y, u, v)):
        return yuv_rgb_plain(y, u, v, limited, matrix, bit_depth,
                             chroma_loc)
    if not (y.device.type == "cuda" and u.device == y.device
            and v.device == y.device):
        raise ValueError(f"yuv_rgb: planes on {y.device}, {u.device}, "
                         f"{v.device}")
    h, w = y.shape
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    crv, cgu, cgv, cbu = coefficients(matrix, limited)
    if bit_depth != 8:
        with torch.cuda.device(y.device):
            err = _deep_launch(y, u, v, limited, matrix, bit_depth,
                               chroma_loc, out, stream)
        check(err, "yuv_rgb_deep kernel")
        yuv_rgb.launches += 1
        return out
    with torch.cuda.device(y.device):
        err = _library().yuv_rgb(y.data_ptr(), y.stride(0), u.data_ptr(),
                                 v.data_ptr(), u.stride(0), v_shift, h_shift,
                                 h, w, int(limited), crv, cgu, cgv, cbu,
                                 out.data_ptr(), stream)
    check(err, "yuv_rgb kernel")
    yuv_rgb.launches += 1
    return out


yuv_rgb.launches = 0
