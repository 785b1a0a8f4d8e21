"""AutoAugment on the device (counterpart of auformer/ops/augment_device.py):
the reference's per-frame PIL ImageNet policy (autoaugment.py / ops.py,
aff2compdataset.py:72-74) as tensor ops on uint8 clips, so training
augments inside the step (``--device_augment``).

Two forms, both plain PyTorch (as the JAX package's are plain XLA):

  * the per-op plain versions (``invert`` ... ``rotate``, ``apply_op``) on
    (..., H, W, 3) uint8: the formulas the stages are held to;
  * the staged path that training runs (``augment_clips_device``): one
    policy per clip and per-frame probability and sign draws for its two
    slots, from the step's ``torch.Generator``; then each slot is four
    frame-parallel stages over the flat (B*T) frame axis (``_slot_apply``):
    one affine warp (shear, translate, rotate), one 256-entry LUT per frame
    and channel (invert, posterize, solarize, brightness, contrast,
    autocontrast, equalize), and the color and sharpness blends, each the
    identity where the frame's op is another.

Everything after the draws is a deterministic function of (x, op, m).
Deliberate differences from the JAX package:

  * Enhance factors (ROADMAP C1): the JAX code passes factor = +-magnitude
    to brightness, contrast, color and sharpness (augment_device.py:276-277
    and ``_slot_apply``); here the factor is 1 + magnitude * sign, as the
    host path (data/transforms.py:74-80) and the upstream reference use.
  * Shear and autocontrast (ROADMAP C9): the JAX code resamples shear with
    the a = -0.5 cubic rounded half to even (augment_device.py:347,
    :442-444) and builds the autocontrast table in f32; here both follow
    PIL, as the host path (data/transforms.py) does: the a = -1 cubic in
    Horner form in f64 on clamped taps, truncated, at the table's f64
    magnitude, and ``int(ix * scale + offset)`` in f64. Both equal the
    host op bit for bit.
  * The rotation's cos/sin are computed in f64 and rounded to f32 (the same
    bits on the CPU and the card); XLA's f32 cos/sin differ from them by an
    ulp at some angles, which moves a nearest sample at a pixel edge.
  * Gathers instead of one-hot contractions (a TPU MXU trick).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..core.mesh import draw_rows

FILL = 128.0

# AutoAugment magnitude tables (reference autoaugment.py:63-78; the JAX
# package's data/transforms.py:29-44)
_RANGES = {
    "shearX": np.linspace(0, 0.3, 10),
    "shearY": np.linspace(0, 0.3, 10),
    "translateX": np.linspace(0, 150 / 331, 10),
    "translateY": np.linspace(0, 150 / 331, 10),
    "rotate": np.linspace(0, 30, 10),
    "color": np.linspace(0.0, 0.9, 10),
    "posterize": np.round(np.linspace(8, 4, 10), 0).astype(int),
    "solarize": np.linspace(256, 0, 10),
    "contrast": np.linspace(0.0, 0.9, 10),
    "sharpness": np.linspace(0.0, 0.9, 10),
    "brightness": np.linspace(0.0, 0.9, 10),
    "autocontrast": [0] * 10,
    "equalize": [0] * 10,
    "invert": [0] * 10,
}

# the ImageNet sub-policies (reference autoaugment.py:19-49; the JAX
# package's data/transforms.py:95-121): (p1, op1, m1, p2, op2, m2)
IMAGENET_POLICIES = [
    (0.4, "posterize", 8, 0.6, "rotate", 9),
    (0.6, "solarize", 5, 0.6, "autocontrast", 5),
    (0.8, "equalize", 8, 0.6, "equalize", 3),
    (0.6, "posterize", 7, 0.6, "posterize", 6),
    (0.4, "equalize", 7, 0.2, "solarize", 4),
    (0.4, "equalize", 4, 0.8, "rotate", 8),
    (0.6, "solarize", 3, 0.6, "equalize", 7),
    (0.8, "posterize", 5, 1.0, "equalize", 2),
    (0.2, "rotate", 3, 0.6, "solarize", 8),
    (0.6, "equalize", 8, 0.4, "posterize", 6),
    (0.8, "rotate", 8, 0.4, "color", 0),
    (0.4, "rotate", 9, 0.6, "equalize", 2),
    (0.0, "equalize", 7, 0.8, "equalize", 8),
    (0.6, "invert", 4, 1.0, "equalize", 8),
    (0.6, "color", 4, 1.0, "contrast", 8),
    (0.8, "rotate", 8, 1.0, "color", 2),
    (0.8, "color", 8, 0.8, "solarize", 7),
    (0.4, "sharpness", 7, 0.6, "invert", 8),
    (0.6, "shearX", 5, 1.0, "equalize", 9),
    (0.4, "color", 0, 0.6, "equalize", 3),
    (0.4, "equalize", 7, 0.2, "solarize", 4),
    (0.6, "solarize", 5, 0.6, "autocontrast", 5),
    (0.6, "invert", 4, 1.0, "equalize", 8),
    (0.6, "color", 4, 1.0, "contrast", 8),
    (0.8, "equalize", 8, 0.6, "equalize", 3),
]

_SMOOTH_K = np.array([[1, 1, 1], [1, 5, 1], [1, 1, 1]], np.float32) / 13.0


# -- plain versions of the ops ------------------------------------------------

def invert(img: torch.Tensor) -> torch.Tensor:
    return 255 - img


def posterize(img: torch.Tensor, bits: int) -> torch.Tensor:
    """Keep the top ``bits`` bits (ImageOps.posterize)."""
    return img & ((0xFF << (8 - bits)) & 0xFF)


def solarize(img: torch.Tensor, threshold) -> torch.Tensor:
    return torch.where(img.int() < threshold, img, 255 - img)


def _per_channel(img: torch.Tensor, fn) -> torch.Tensor:
    """Apply ``fn`` to every (H, W) uint8 channel plane of (..., H, W, C)."""
    flat = img.reshape(-1, *img.shape[-3:])
    out = torch.stack([torch.stack([fn(fr[..., c]) for c in
                                    range(fr.shape[-1])], -1) for fr in flat])
    return out.reshape(img.shape)


def equalize(img: torch.Tensor) -> torch.Tensor:
    """PIL ImageOps.equalize: per-channel histogram equalization with the
    step = (pixels - count of the last nonzero bin) // 255 rule."""
    def eq_channel(ch):
        h = torch.bincount(ch.reshape(-1).long(), minlength=256)
        last = int(torch.nonzero(h).max())
        step = (int(h.sum()) - int(h[last])) // 255
        if step <= 0:
            return ch
        csum = torch.cumsum(h, 0)
        lut = (torch.cat([csum.new_zeros(1), csum[:-1]]) + step // 2) // step
        return lut.clamp(0, 255).to(torch.uint8)[ch.long()]
    return _per_channel(img, eq_channel)


def _autocontrast_lut(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """PIL ImageOps.autocontrast(cutoff=0)'s table for channels of range
    [lo, hi] (f64, any shape S): ``int(ix * scale + offset)`` with
    ``scale = 255 / (hi - lo)`` and ``offset = -lo * scale`` in f64,
    clipped to [0, 255]; the identity where hi <= lo. (S..., 256) int32."""
    ix = torch.arange(256, dtype=torch.float64, device=lo.device)
    # a tensor over a tensor: ``255.0 / t`` would multiply by t's
    # reciprocal, which is not the correctly rounded quotient
    span = torch.clamp(hi - lo, min=1.0)[..., None]
    scale = torch.full_like(span, 255.0) / span
    offset = -lo[..., None] * scale
    lut = torch.clamp(torch.trunc(ix * scale + offset), 0, 255).int()
    return torch.where((hi > lo)[..., None], lut, ix.int())


def autocontrast(img: torch.Tensor) -> torch.Tensor:
    """PIL ImageOps.autocontrast(cutoff=0): per-channel remap of [lo, hi]
    to [0, 255] (``_autocontrast_lut``)."""
    def ac_channel(ch):
        lut = _autocontrast_lut(ch.min().double(), ch.max().double())
        return lut.to(torch.uint8)[ch.long()]
    return _per_channel(img, ac_channel)


def _blend(degenerate, img_f: torch.Tensor, factor) -> torch.Tensor:
    """PIL Image.blend: the float interpolation truncated to uint8."""
    out = degenerate + factor * (img_f - degenerate)
    return torch.floor(torch.clamp(out, 0, 255)).to(torch.uint8)


def _gray_L(img: torch.Tensor) -> torch.Tensor:
    """PIL convert('L'): (R*19595 + G*38470 + B*7471 + 0x8000) >> 16."""
    r, g, b = (img[..., i].int() for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).float()


def brightness(img: torch.Tensor, factor) -> torch.Tensor:
    return _blend(0.0, img.float(), factor)


def contrast(img: torch.Tensor, factor) -> torch.Tensor:
    """degenerate = the uniform mean of the L channel (+0.5 int round)."""
    mean = torch.floor(_gray_L(img).mean(dim=(-2, -1), keepdim=True) + 0.5)
    return _blend(mean[..., None], img.float(), factor)


def color(img: torch.Tensor, factor) -> torch.Tensor:
    """degenerate = grayscale replicated over RGB."""
    return _blend(_gray_L(img)[..., None], img.float(), factor)


def _smooth(f: torch.Tensor) -> torch.Tensor:
    """PIL's SMOOTH filter of (N, H, W, C) f32, rounded half-up; the border
    pixels keep their values (PIL filters the interior only)."""
    n, h, w, c = f.shape
    per_c = f.permute(0, 3, 1, 2).reshape(n * c, 1, h, w)
    k = _device_tables(f.device)["smooth"]
    sm = F.pad(F.conv2d(per_c, k), (1, 1, 1, 1))
    interior = torch.zeros((h, w), dtype=torch.bool, device=f.device)
    interior[1:-1, 1:-1] = True
    deg = torch.where(interior, sm, per_c)
    return torch.floor(deg.reshape(n, c, h, w).permute(0, 2, 3, 1) + 0.5)


def sharpness(img: torch.Tensor, factor) -> torch.Tensor:
    """degenerate = PIL's SMOOTH filter, border pixels unfiltered."""
    f = img.float().reshape(-1, *img.shape[-3:])
    return _blend(_smooth(f), f, factor).reshape(img.shape)


def _rotation(degrees: torch.Tensor):
    """(cos, sin) of ``degrees`` as f32, computed in f64."""
    ang = torch.deg2rad(degrees.double())
    return torch.cos(ang).float(), torch.sin(ang).float()


def _affine_sample(img: torch.Tensor, coeffs) -> torch.Tensor:
    """PIL Image.transform(AFFINE, coeffs), nearest: out(x, y) =
    in(a x + b y + c, d x + e y + f) at pixel centres, gray fill."""
    a, b, c, d, e, f = coeffs
    h, w = img.shape[-3], img.shape[-2]
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=img.device),
        torch.arange(w, dtype=torch.float32, device=img.device),
        indexing="ij")
    sx = a * (xs + 0.5) + b * (ys + 0.5) + c
    sy = d * (xs + 0.5) + e * (ys + 0.5) + f
    ix = torch.floor(sx).long()
    iy = torch.floor(sy).long()
    inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    out = img[..., iy.clamp(0, h - 1), ix.clamp(0, w - 1), :]
    return torch.where(inside[..., None], out,
                       torch.full_like(out, int(FILL)))


def _shear(img: torch.Tensor, magnitude, dim: int) -> torch.Tensor:
    """PIL's affine BICUBIC shear along ``dim`` (2: x, 1: y) by the f64
    ``magnitude`` (``_axis_resample``)."""
    h, w, c = img.shape[-3:]
    flat = img.reshape(-1, h, w, c)
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float64, device=img.device),
        torch.arange(w, dtype=torch.float64, device=img.device),
        indexing="ij")
    m = float(magnitude)
    src = ((xs + 0.5) + m * (ys + 0.5) if dim == 2
           else m * (xs + 0.5) + (ys + 0.5))
    t = flat.shape[0]
    out = _axis_resample(flat, src.expand(t, h, w),
                         torch.ones(t, dtype=torch.bool, device=img.device),
                         dim)
    return torch.clamp(out, 0, 255).to(torch.uint8).reshape(img.shape)


def shear_x(img, magnitude):
    return _shear(img, magnitude, 2)


def shear_y(img, magnitude):
    return _shear(img, magnitude, 1)


def translate_x(img, frac):
    return _affine_sample(img, (1.0, 0.0, frac * img.shape[-2], 0.0, 1.0,
                                0.0))


def translate_y(img, frac):
    return _affine_sample(img, (1.0, 0.0, 0.0, 0.0, 1.0,
                                frac * img.shape[-3]))


def rotate(img, degrees):
    """PIL rotate(angle): counter-clockwise about the centre, nearest, gray
    fill (the reference composites onto (128,)*4, ops.py:45-50)."""
    h, w = img.shape[-3], img.shape[-2]
    cos, sin = _rotation(torch.tensor(float(degrees)))
    cx, cy = w / 2.0, h / 2.0
    coeffs = (cos, -sin, cx - cos * cx + sin * cy,
              sin, cos, cy - sin * cx - cos * cy)
    return _affine_sample(img, [torch.as_tensor(v, dtype=torch.float32,
                                                device=img.device)
                                for v in coeffs])


OP_FNS = {
    "invert": lambda img, m: invert(img),
    "posterize": lambda img, m: posterize(img, int(m)),
    "solarize": lambda img, m: solarize(img, m),
    "equalize": lambda img, m: equalize(img),
    "autocontrast": lambda img, m: autocontrast(img),
    "brightness": brightness,
    "contrast": contrast,
    "color": color,
    "sharpness": sharpness,
    "shearX": shear_x,
    "shearY": shear_y,
    "translateX": translate_x,
    "translateY": translate_y,
    "rotate": rotate,
}

SIGNED_OPS = {"brightness", "contrast", "color", "sharpness",
              "shearX", "shearY", "translateX", "translateY", "rotate"}
ENHANCE_OPS = {"brightness", "contrast", "color", "sharpness"}


def apply_op(img: torch.Tensor, op: str, magnitude, sign=1.0):
    """One op of the vocabulary at ``magnitude`` with ``sign``; the enhance
    family takes the factor 1 + magnitude * sign (ROADMAP C1)."""
    m = magnitude * sign if op in SIGNED_OPS else magnitude
    if op in ENHANCE_OPS:
        m = 1.0 + m
    return OP_FNS[op](img, m)


# -- the staged path ----------------------------------------------------------

OP_IDS = {"none": 0, "shearX": 1, "shearY": 2, "translateX": 3,
          "translateY": 4, "rotate": 5, "invert": 6, "posterize": 7,
          "solarize": 8, "brightness": 9, "contrast": 10,
          "autocontrast": 11, "equalize": 12, "color": 13,
          "sharpness": 14}
_ENHANCE_IDS = tuple(OP_IDS[name] for name in sorted(ENHANCE_OPS))


@functools.lru_cache(maxsize=1)
def _policy_tables():
    """(policies, 2) read-only numpy tables: op id, probability, magnitude
    and signedness of each slot."""
    n = len(IMAGENET_POLICIES)
    op = np.zeros((n, 2), np.int64)
    prob = np.zeros((n, 2), np.float32)
    mag = np.zeros((n, 2), np.float32)
    signed = np.zeros((n, 2), np.float32)
    for i, (p1, o1, m1, p2, o2, m2) in enumerate(IMAGENET_POLICIES):
        for s, (p, o, m) in enumerate([(p1, o1, m1), (p2, o2, m2)]):
            op[i, s] = OP_IDS[o]
            prob[i, s] = p
            mag[i, s] = float(_RANGES[o][m])
            signed[i, s] = 1.0 if o in SIGNED_OPS else 0.0
    for table in (op, prob, mag, signed):
        table.setflags(write=False)
    return op, prob, mag, signed


@functools.lru_cache(maxsize=None)
def _device_tables(device: torch.device) -> dict:
    """The staged path's constant tables on ``device``, made once per
    device: the SMOOTH kernel (1, 1, 3, 3), the enhance op ids, the
    table's shear magnitudes in f64 and the four policy tables. A step
    then makes no host-to-device copy, so it can be captured in a CUDA
    graph. Read-only."""
    device = torch.device(device)
    return {"smooth": torch.as_tensor(_SMOOTH_K, device=device
                                      ).reshape(1, 1, 3, 3),
            "enhance": torch.tensor(_ENHANCE_IDS, device=device),
            "shear": torch.tensor(_RANGES["shearX"], dtype=torch.float64,
                                  device=device),
            "policies": tuple(torch.tensor(np.array(a), device=device)
                              for a in _policy_tables())}


def _table_f64(m: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(T,) f32 magnitudes -> f64: a value equal in f32 to +-an entry of
    ``table`` (f64) takes that entry's f64 value, as the host path's table
    gives it; any other value its own."""
    hit = m.abs()[:, None] == table.float()[None, :]
    entry = (hit.double() * table[None, :]).sum(-1) * torch.sign(m.double())
    return torch.where(hit.any(-1), entry, m.double())


def _axis_resample(img: torch.Tensor, shift: torch.Tensor,
                   bicubic: torch.Tensor, dim: int) -> torch.Tensor:
    """Resample (T, H, W, C) uint8 along ``dim`` (1: H, 2: W) as PIL's
    affine transform does where the other coordinate is an exact pixel
    centre: output pixel (t, y, x) samples the source coordinate
    ``shift[t, y, x]`` (f64, pixel edges at integers). Where
    ``bicubic[t]`` (shear), PIL's BICUBIC: the four taps around
    shift - 0.5, clamped to the image, and the a = -1 cubic in Horner form,
    ``v2 + d (p2 + d (p3 + d p4))`` with p2 = v3 - v1,
    p3 = 2 (v1 - v2) + v3 - v4 and p4 = -v1 + v2 - v3 + v4, in f64 (the
    2-D cubic's other axis, at fraction 0, returns its middle tap). Else
    nearest (translate): the same form at fraction 0, the tap
    floor(shift). FILL where ``shift`` lies outside [0, size). f64 values,
    to be clamped and truncated."""
    size = img.shape[dim]
    bc = bicubic[:, None, None]
    s = torch.where(bc, shift - 0.5, shift)
    base = torch.floor(s)
    d = torch.where(bc, s - base, torch.zeros_like(s))[..., None]
    taps = []
    for k in range(-1, 3):
        tap = (base + k).clamp(0, size - 1).long()
        taps.append(torch.gather(img, dim, tap[..., None].expand(img.shape)
                                 ).int())
    v1, v2, v3, v4 = taps
    p2 = (v3 - v1).double()
    p3 = (2 * (v1 - v2) + v3 - v4).double()
    p4 = (v2 - v1 - v3 + v4).double()
    out = v2.double() + d * (p2 + d * (p3 + d * p4))
    inside = ((shift >= 0) & (shift < size))[..., None]
    return torch.where(inside, out, torch.full_like(out, FILL))


def _geo_stage(x: torch.Tensor, op: torch.Tensor,
               m: torch.Tensor) -> torch.Tensor:
    """Stage 1: the affine ops. shearX/translateX resample each row,
    shearY/translateY each column (``_axis_resample``: PIL's bicubic for
    shear, nearest for translate), rotate gathers nearest in 2D; frames
    whose op is not affine pass through."""
    t, h, w, c = x.shape
    xf = x.float()
    ys = torch.arange(h, dtype=torch.float32, device=x.device)
    xs = torch.arange(w, dtype=torch.float32, device=x.device)
    zero = torch.zeros_like(m)
    is_h = (op == 1) | (op == 3)
    is_v = (op == 2) | (op == 4)
    is_rot = op == 5
    bicubic_h = op == 1
    bicubic_v = op == 2

    # translate (f32, as the JAX package) and shear (f64 from the table's
    # f64 magnitude, in the order of PIL's affine map), each axis's
    # source coordinate: horizontal sx = (x + 0.5) + b (y + 0.5) + c,
    # vertical sy = d (x + 0.5) + (y + 0.5) + f
    shear = _table_f64(m, _device_tables(x.device)["shear"])
    xs64, ys64 = xs.double()[None, None, :], ys.double()[None, :, None]
    c_h = torch.where(op == 3, m * w, zero)
    sx = torch.where(bicubic_h[:, None, None],
                     (xs64 + 0.5) + shear[:, None, None] * (ys64 + 0.5),
                     ((xs[None, None, :] + 0.5) + c_h[:, None, None])
                     .double())
    out_h = _axis_resample(x, sx, bicubic_h, 2)
    f_v = torch.where(op == 4, m * h, zero)
    sy = torch.where(bicubic_v[:, None, None],
                     shear[:, None, None] * (xs64 + 0.5) + (ys64 + 0.5),
                     ((ys[None, :, None] + 0.5) + f_v[:, None, None])
                     .double())
    out_v = _axis_resample(x, sy, bicubic_v, 1)

    # rotate: nearest 2D gather through flat (y * w + x) indices
    cos, sin = _rotation(m)
    cx, cy = w / 2.0, h / 2.0
    gx = xs[None, None, :] + 0.5
    gy = ys[None, :, None] + 0.5
    rc, rs = cos[:, None, None], sin[:, None, None]
    sxr = rc * gx - rs * gy + (cx - cos * cx + sin * cy)[:, None, None]
    syr = rs * gx + rc * gy + (cy - sin * cx - cos * cy)[:, None, None]
    ixr = torch.floor(sxr).long()
    iyr = torch.floor(syr).long()
    rin = (ixr >= 0) & (ixr < w) & (iyr >= 0) & (iyr < h)
    flat = (iyr.clamp(0, h - 1) * w + ixr.clamp(0, w - 1)).reshape(t, -1, 1)
    rot = torch.gather(xf.reshape(t, h * w, c), 1,
                       flat.expand(t, h * w, c)).reshape(t, h, w, c)
    rot = torch.where(rin[..., None], rot, torch.full_like(rot, FILL))

    sel = lambda mask: mask[:, None, None, None]  # noqa: E731
    out = torch.where(sel(is_rot), rot, torch.where(sel(is_v), out_v, out_h))
    # nearest paths are exact integers; bicubic truncates, as PIL does
    out_u8 = torch.clamp(out, 0, 255).to(torch.uint8)
    return torch.where(sel(is_h | is_v | is_rot), out_u8, x)


def _lut_stage(x: torch.Tensor, op: torch.Tensor,
               m: torch.Tensor) -> torch.Tensor:
    """Stage 2: every 256-entry LUT op, ``m`` the op's magnitude (the
    factor for brightness and contrast). One (T, C, 256) table from
    per-frame statistics, applied with one gather."""
    t, ch = x.shape[0], x.shape[-1]
    dev = x.device
    iota = torch.arange(256, dtype=torch.int32, device=dev)
    iota_f = iota.float()
    mcol = m[:, None]
    sel = lambda k: (op == k)[:, None]  # noqa: E731

    # per-frame LUTs (T, 256), the same for every channel
    lut = iota[None].expand(t, 256)
    lut = torch.where(sel(6), 255 - iota[None], lut)
    bits = m.to(torch.int32).clamp(1, 8)
    mask = torch.bitwise_left_shift(torch.full_like(bits, 0xFF),
                                    8 - bits) & 0xFF
    lut = torch.where(sel(7), iota[None] & mask[:, None], lut)
    lut = torch.where(sel(8), torch.where(iota_f[None] < mcol, iota[None],
                                          255 - iota[None]), lut)
    bri = torch.floor(torch.clamp(mcol * iota_f[None], 0, 255)).int()
    lut = torch.where(sel(9), bri, lut)
    # contrast: degenerate = round(mean of the gray-L plane); the sum of
    # at most 2**24 integers is exact in f32 in any order
    gmean = torch.floor(_gray_L(x).mean(dim=(1, 2)) + 0.5)
    con = torch.floor(torch.clamp(
        gmean[:, None] + mcol * (iota_f[None] - gmean[:, None]),
        0, 255)).int()
    lut = torch.where(sel(10), con, lut)
    lut3 = lut[:, None, :].expand(t, ch, 256)

    # autocontrast: per-channel [lo, hi] -> [0, 255], PIL's f64 rule
    ac = _autocontrast_lut(x.amin(dim=(1, 2)).double(),
                           x.amax(dim=(1, 2)).double())         # (T, C, 256)
    lut3 = torch.where((op == 11)[:, None, None], ac, lut3)

    # equalize: per-channel histogram LUT (identity where step == 0); the
    # frame/channel/value index also applies the table below
    base = (torch.arange(t, device=dev)[:, None] * ch
            + torch.arange(ch, device=dev)[None, :]) * 256        # (T, C)
    index = base[:, None, None, :] + x.long()                    # (T,H,W,C)
    # counts by index_add_: bincount syncs with the host on CUDA (it
    # reads the input's max), which a CUDA graph cannot capture
    flat = index.reshape(-1)
    hist = torch.zeros(t * ch * 256, dtype=torch.int64, device=dev
                       ).index_add_(0, flat, flat.new_ones(()).expand_as(flat)
                                    ).reshape(t, ch, 256)
    last_idx = torch.where(hist > 0, iota.long(), -1).amax(dim=-1)
    last_count = torch.gather(hist, -1, last_idx[..., None])[..., 0]
    step = (hist.sum(-1) - last_count) // 255                      # (T, C)
    csum = torch.cumsum(hist, -1)
    shifted = torch.cat([torch.zeros_like(csum[..., :1]), csum[..., :-1]],
                        -1)
    eq = torch.clamp((shifted + step[..., None] // 2)
                     // step[..., None].clamp(min=1), 0, 255)
    eq = torch.where((step > 0)[..., None], eq.int(), iota[None, None])
    lut3 = torch.where((op == 12)[:, None, None], eq, lut3)
    return lut3.reshape(-1)[index].to(torch.uint8)


def _color_stage(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """Stage 3: ImageEnhance.Color with a per-frame factor (1.0 is the
    exact identity: the blend returns floor(v) == v)."""
    f = x.float()
    return _blend(_gray_L(x)[..., None], f, factor[:, None, None, None])


def _sharp_stage(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """Stage 4: ImageEnhance.Sharpness with a per-frame factor (1.0 is the
    exact identity)."""
    f = x.float()
    return _blend(_smooth(f), f, factor[:, None, None, None])


def _slot_apply(x: torch.Tensor, op: torch.Tensor,
                m: torch.Tensor) -> torch.Tensor:
    """One policy slot (op (T,) int64, m (T,) f32 signed magnitude) on
    (T, H, W, 3) uint8 frames: four stages, at most one of which is not
    the identity for a frame. The enhance ops take the factor 1 + m (C1)."""
    m = torch.where(torch.isin(op, _device_tables(op.device)["enhance"]),
                    1.0 + m, m)
    one = torch.ones_like(m)
    x = _geo_stage(x, op, m)
    x = _lut_stage(x, op, m)
    x = _color_stage(x, torch.where(op == OP_IDS["color"], m, one))
    return _sharp_stage(x, torch.where(op == OP_IDS["sharpness"], m, one))


def policy_draws(b: int, t: int, generator: torch.Generator,
                 device, mesh=None) -> tuple[torch.Tensor, ...]:
    """(op1, m1, op2, m2), each (b, t): one ImageNet sub-policy per clip,
    then for each slot a per-frame probability draw (the op or 0 = none)
    and a per-frame sign for the signed ops, all from ``generator``; under
    a ``mesh`` (core/mesh.py), this rank's rows of the global batch's
    draws (``draw_rows``)."""
    op_t, prob_t, mag_t, signed_t = _device_tables(device)["policies"]

    def rand(shape):
        return torch.rand(shape, generator=generator, device=device)

    idx = draw_rows(lambda s: torch.randint(0, op_t.shape[0], s,
                                            generator=generator,
                                            device=device), (b,), mesh)
    draws = draw_rows(rand, (2, b, t), mesh, dim=1)
    signs = torch.where(draw_rows(rand, (2, b, t), mesh, dim=1) < 0.5,
                        1.0, -1.0)
    out = []
    for s in range(2):
        active = draws[s] < prob_t[idx, s][:, None]
        op = torch.where(active, op_t[idx, s][:, None], 0)
        m = mag_t[idx, s][:, None] * torch.where(
            signed_t[idx, s][:, None] > 0, signs[s], 1.0)
        out += [op, m]
    return tuple(out)


def augment_clips_device(clips: torch.Tensor, generator: torch.Generator,
                         mesh=None) -> torch.Tensor:
    """(B, T, H, W, 3) uint8 -> augmented (the train-time path under
    ``cfg.device_augment``): the draws of ``policy_draws`` (of the global
    batch under a ``mesh``), then both slots over the flat (B*T) frame
    axis."""
    b, t = clips.shape[:2]
    op1, m1, op2, m2 = policy_draws(b, t, generator, clips.device, mesh)
    x = clips.reshape((b * t,) + clips.shape[2:])
    x = _slot_apply(x, op1.reshape(-1), m1.reshape(-1))
    x = _slot_apply(x, op2.reshape(-1), m2.reshape(-1))
    return x.reshape(clips.shape)
