"""Host AutoAugment (counterpart of the training half of
auformer/data/transforms.py): the reference's per-frame ImageNet policy
and whole-clip flip (autoaugment.py:5-112, ops.py:5-95,
aff2compdataset.py:72-74), without PIL.

Every op equals the JAX package's PIL op (``_apply_op``) bit for bit, on
uint8 (N, H, W, 3) frames that share the op and its signed magnitude:

  * invert, posterize, solarize, brightness: one 256-entry table;
  * autocontrast, equalize, contrast: one table per frame and channel
    from each frame's statistics, applied per channel plane. autocontrast
    maps
    ``int(ix * scale + offset)`` in f64 (``ImageOps.autocontrast``);
  * color, contrast, brightness, sharpness: ``Image.blend`` in f32 as
    separate multiply and add steps (PIL's ``ImagingBlend`` is plain f32
    C; a fused multiply-add rounds differently); sharpness's degenerate is
    PIL's SMOOTH filter as shifted f32 sums in PIL's order;
  * shearX / shearY: PIL's affine BICUBIC, the a = -1 cubic in Horner form
    on the four clamped taps of the source point ``(x + 0.5, y + 0.5)``
    mapped and moved by -0.5, in f64, clamped and truncated; fill 128 where
    the mapped centre falls outside the image. One axis of the 2-D cubic
    is an exact pixel centre, which returns its middle tap;
  * translateX / translateY: PIL's nearest scale path, the source
    coordinate accumulated in f64 as PIL steps it;
  * rotate: PIL's nearest affine in 16.16 fixed point, its matrix built as
    ``Image.rotate`` builds it, cached per (angle, H, W); gray fill as the
    reference's RGBA composite gives it.

The draws are the JAX package's, in its order, from the caller's
``random.Random``: the sub-policy, then per frame for each slot a
probability draw and, when the slot fires, a sign (for every op, signed
or not), then one flip draw. Seeded alike, the port's clips equal the JAX
package's byte for byte.

Training augments each batch in worker processes (``AugmentPool``), not
clip by clip in the loader's threads: numpy releases the GIL only inside
its loops, and the eager train step takes and releases the GIL at each of
its ~2,300 launches per step, so loader threads that augment in-process
(or ship every clip through a pipe) stretch the step several-fold
(chip_smoke's ``host_aug`` line times the loop both ways).
"""
from __future__ import annotations

import functools
import hashlib
import math
import multiprocessing
import os
import random
import threading
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import shared_memory

import numpy as np

from ..ops.augment_device import IMAGENET_POLICIES, SIGNED_OPS, _RANGES

FILL = 128
# PIL's SMOOTH kernel, each weight divided by 13 in f32 (ImageFilter.SMOOTH)
_K1 = np.float32(1) / np.float32(13)
_K5 = np.float32(5) / np.float32(13)


# -- tables -------------------------------------------------------------------

def _planes(frames: np.ndarray) -> np.ndarray:
    """(N, H, W, C) -> contiguous (N, C, H * W) channel planes."""
    n, c = frames.shape[0], frames.shape[-1]
    return np.ascontiguousarray(frames.reshape(n, -1, c).transpose(0, 2, 1))


def _histograms(planes: np.ndarray) -> np.ndarray:
    """(N, C, 256) int64 counts of each plane's values."""
    return np.stack([[np.bincount(p, minlength=256) for p in frame]
                     for frame in planes])


def _plane_tables(frames: np.ndarray, planes: np.ndarray,
                  lut: np.ndarray) -> np.ndarray:
    """(N, C, 256) uint8 tables applied to each frame's channel planes:
    the (N, H, W, C) frames' new values."""
    out = np.empty_like(planes)
    for i, frame in enumerate(planes):
        for c, plane in enumerate(frame):
            np.take(lut[i, c], plane, out=out[i, c])
    res = np.empty_like(frames)
    res.reshape(out.shape[0], -1, out.shape[1])[...] = out.transpose(0, 2, 1)
    return res


_IOTA = np.arange(256)


def invert(frames: np.ndarray) -> np.ndarray:
    return 255 - frames


def posterize(frames: np.ndarray, bits: int) -> np.ndarray:
    return frames & np.uint8(~(2 ** (8 - bits) - 1) & 0xFF)


def solarize(frames: np.ndarray, threshold) -> np.ndarray:
    lut = np.where(_IOTA < threshold, _IOTA, 255 - _IOTA).astype(np.uint8)
    return lut[frames]


def autocontrast(frames: np.ndarray) -> np.ndarray:
    """Each channel's [lo, hi] onto [0, 255]: ``int(ix * scale + offset)``
    with ``scale = 255 / (hi - lo)`` and ``offset = -lo * scale`` in f64;
    the identity where hi <= lo."""
    planes = _planes(frames)
    lo = planes.min(-1).astype(np.int64)                     # (N, C)
    hi = planes.max(-1).astype(np.int64)
    span = np.maximum(hi - lo, 1)[..., None]
    scale = 255.0 / span
    offset = -lo[..., None] * scale
    lut = np.clip(np.trunc(_IOTA * scale + offset), 0, 255)
    lut = np.where((hi > lo)[..., None], lut, _IOTA)
    return _plane_tables(frames, planes, lut.astype(np.uint8))


def equalize(frames: np.ndarray) -> np.ndarray:
    """``ImageOps.equalize``: per channel, step = (pixels - the count of
    the last used value) // 255, the table (step // 2 + the count below
    each value) // step clipped to 255; the identity where step is 0."""
    planes = _planes(frames)
    hist = _histograms(planes)
    last = 255 - (hist[..., ::-1] > 0).argmax(-1)
    step = (hist.sum(-1) - np.take_along_axis(hist, last[..., None],
                                              -1)[..., 0]) // 255
    below = np.cumsum(hist, -1) - hist
    safe = np.maximum(step, 1)[..., None]
    lut = np.minimum((safe // 2 + below) // safe, 255)
    lut = np.where((step > 0)[..., None], lut, _IOTA)
    return _plane_tables(frames, planes, lut.astype(np.uint8))


# -- blends -------------------------------------------------------------------

def _blend(degenerate, frames: np.ndarray, factor) -> np.ndarray:
    """``Image.blend(degenerate, frames, factor)``: ``d + f * (x - d)`` in
    f32 (the factor rounded to f32 as PIL takes it), clipped, truncated."""
    f = np.float32(factor)
    out = frames.astype(np.float32)
    out -= degenerate
    out *= f
    out += degenerate
    np.clip(out, 0, 255, out=out)
    return out.astype(np.uint8)


def _gray(frames: np.ndarray) -> np.ndarray:
    """PIL's convert('L'): (R 19595 + G 38470 + B 7471 + 0x8000) >> 16, as
    (N, H, W) int32."""
    x = frames.astype(np.int32)
    return (x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471
            + 0x8000) >> 16


def brightness(frames: np.ndarray, factor) -> np.ndarray:
    """A function of the value alone: one table of the blend toward 0."""
    return _blend(np.float32(0), _IOTA.astype(np.uint8), factor)[frames]


def contrast(frames: np.ndarray, factor) -> np.ndarray:
    """The blend toward each frame's mean gray level,
    ``int(sum / pixels + 0.5)`` in f64, as one table per frame."""
    gray = _gray(frames)
    n = frames.shape[0]
    mean = np.floor(gray.reshape(n, -1).sum(-1) / gray[0].size + 0.5)
    lut = _blend(mean.astype(np.float32)[:, None],
                 np.broadcast_to(_IOTA.astype(np.uint8), (n, 256)), factor)
    return _plane_tables(frames, _planes(frames), np.broadcast_to(
        lut[:, None], (n, frames.shape[-1], 256)))


def color(frames: np.ndarray, factor) -> np.ndarray:
    """The blend toward the gray level replicated over RGB."""
    return _blend(_gray(frames).astype(np.float32)[..., None], frames,
                  factor)


def _smooth(frames: np.ndarray) -> np.ndarray:
    """PIL's SMOOTH filter (3x3, weights 1 and a centre 5, over 13) as f32
    shifted sums in PIL's order, per row ((left k + centre k) + right k),
    the row below first, rounded half up; the border keeps its values."""
    f = frames.astype(np.float32)
    h, w = f.shape[1], f.shape[2]
    out = f.copy()

    def row(r: np.ndarray, centre) -> np.ndarray:
        s = r[:, :, 0:w - 2] * _K1
        s += r[:, :, 1:w - 1] * centre
        s += r[:, :, 2:w] * _K1
        return s

    ss = row(f[:, 2:h], _K1)
    ss += row(f[:, 1:h - 1], _K5)
    ss += row(f[:, 0:h - 2], _K1)
    np.clip(ss, 0, 255, out=ss)
    out[:, 1:h - 1, 1:w - 1] = np.floor(ss.astype(np.float64) + 0.5)
    return out


def sharpness(frames: np.ndarray, factor) -> np.ndarray:
    return _blend(_smooth(frames), frames, factor)


# -- geometry -----------------------------------------------------------------

def _resample(frames: np.ndarray, index, valid) -> np.ndarray:
    """Output pixel p of each frame takes source pixel ``index[p]`` (flat
    y * W + x) where ``valid[p]``, else FILL."""
    n, h, w, c = frames.shape
    out = frames.reshape(n, h * w, c)[:, index]
    out[:, ~valid] = FILL
    return out.reshape(frames.shape)


def _bicubic(frames: np.ndarray, src: np.ndarray, axis: int) -> np.ndarray:
    """PIL's affine BICUBIC where one coordinate is an exact pixel centre:
    output (y, x) samples the source coordinate ``src[y, x]`` (f64, pixel
    edges at integers) along ``axis`` (2: x, 1: y). The four taps around
    ``src - 0.5`` clamp to the image; ``v = p1 + d (p2 + d (p3 + d p4))``
    with p1 = v2, p2 = v3 - v1, p3 = 2 (v1 - v2) + v3 - v4 and
    p4 = -v1 + v2 - v3 + v4 (the a = -1 cubic), clamped to [0, 255] and
    truncated; FILL where ``src`` lies outside the image."""
    n, h, w, c = frames.shape
    size = frames.shape[axis]
    s = src - 0.5
    x0 = np.floor(s)
    d = (s - x0).reshape(-1, 1)
    ys, xs = np.mgrid[0:h, 0:w]
    taps = []
    for k in range(-1, 3):
        tap = np.clip(x0.astype(np.intp) + k, 0, size - 1)
        flat = ys * w + tap if axis == 2 else tap * w + xs
        taps.append(frames.reshape(n, h * w, c)[:, flat.reshape(-1)]
                    .astype(np.int16))
    v1, v2, v3, v4 = taps
    p2 = (v3 - v1).astype(np.float64)
    p3 = (2 * (v1 - v2) + v3 - v4).astype(np.float64)
    p4 = (-v1 + v2 - v3 + v4).astype(np.float64)
    v = p4
    v *= d
    v += p3
    v *= d
    v += p2
    v *= d
    v += v2
    np.clip(v, 0, 255, out=v)
    out = v.astype(np.uint8)
    out[:, ~((src >= 0) & (src < size)).reshape(-1)] = FILL
    return out.reshape(frames.shape)


def shear_x(frames: np.ndarray, m: float) -> np.ndarray:
    """AFFINE (1, m, 0, 0, 1, 0): source x = (x + 0.5) + m (y + 0.5)."""
    h, w = frames.shape[1:3]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    return _bicubic(frames, (xs + 0.5) + m * (ys + 0.5), 2)


def shear_y(frames: np.ndarray, m: float) -> np.ndarray:
    """AFFINE (1, 0, 0, m, 1, 0): source y = m (x + 0.5) + (y + 0.5)."""
    h, w = frames.shape[1:3]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    return _bicubic(frames, m * (xs + 0.5) + (ys + 0.5), 1)


def _read_only(*arrays: np.ndarray) -> tuple:
    """The arrays, made read-only: cached maps are shared by threads."""
    for a in arrays:
        a.setflags(write=False)
    return arrays


def _coord_table(start: float, n: int) -> np.ndarray:
    """PIL's nearest scale path along one axis: the source coordinate
    starts at ``start`` and steps by 1.0 in f64; its index is -1 below 0,
    else truncated."""
    out = np.empty(n, np.intp)
    v = start
    for i in range(n):
        out[i] = -1 if v < 0.0 else int(v)
        v += 1.0
    return out


@functools.lru_cache(maxsize=256)
def _translate_map(dx: float, dy: float, h: int, w: int):
    xin = _coord_table(dx + 0.5, w)
    yin = _coord_table(dy + 0.5, h)
    valid = (((xin >= 0) & (xin < w))[None, :]
             & ((yin >= 0) & (yin < h))[:, None]).reshape(-1)
    index = (np.clip(yin, 0, h - 1)[:, None] * w
             + np.clip(xin, 0, w - 1)[None, :]).reshape(-1)
    return _read_only(index, valid)


def translate_x(frames: np.ndarray, dx: float) -> np.ndarray:
    """AFFINE (1, 0, dx, 0, 1, 0), nearest: source x = x + dx."""
    return _resample(frames, *_translate_map(dx, 0.0, *frames.shape[1:3]))


def translate_y(frames: np.ndarray, dy: float) -> np.ndarray:
    return _resample(frames, *_translate_map(0.0, dy, *frames.shape[1:3]))


def _fix(v: float) -> int:
    """PIL's 16.16 fixed point: floor(v * 65536 + 0.5)."""
    return math.floor(v * 65536.0 + 0.5)


@functools.lru_cache(maxsize=256)
def _rotate_map(angle: float, h: int, w: int):
    """``Image.rotate(angle)``'s matrix (cos and sin rounded to 15 digits,
    about the centre) and PIL's fixed-point nearest sampling: the row's
    start FIX(a2 + a0 / 2 + a1 / 2) + y FIX(a1), stepped by FIX(a0) along
    the row, the source index the value >> 16."""
    rad = -math.radians(angle)
    a0, a1 = round(math.cos(rad), 15), round(math.sin(rad), 15)
    a3, a4 = round(-math.sin(rad), 15), round(math.cos(rad), 15)
    cx, cy = w / 2, h / 2
    a2 = a0 * -cx + a1 * -cy + 0.0 + cx
    a5 = a3 * -cx + a4 * -cy + 0.0 + cy
    for x, y in ((0, 0), (w, h), (0, h), (w, 0)):
        if not (abs(x * a0 + y * a1 + a2) < 32768.0
                and abs(x * a3 + y * a4 + a5) < 32768.0):
            raise ValueError(f"a {w}x{h} frame leaves PIL's fixed-point "
                             "rotation")
    ys, xs = np.mgrid[0:h, 0:w].astype(np.int64)
    xin = (_fix(a2 + a0 * 0.5 + a1 * 0.5) + ys * _fix(a1)
           + xs * _fix(a0)) >> 16
    yin = (_fix(a5 + a3 * 0.5 + a4 * 0.5) + ys * _fix(a4)
           + xs * _fix(a3)) >> 16
    valid = ((xin >= 0) & (xin < w) & (yin >= 0) & (yin < h)).reshape(-1)
    index = (np.clip(yin, 0, h - 1) * w + np.clip(xin, 0, w - 1)
             ).reshape(-1)
    return _read_only(index, valid)


def rotate(frames: np.ndarray, degrees: float) -> np.ndarray:
    """Counter-clockwise about the centre, nearest, gray fill. The angle is
    taken mod 360, and 0 returns the frames (``Image.rotate``); the table's
    angles (|a| <= 30) take no other shortcut of PIL's."""
    angle = float(degrees) % 360.0
    if angle == 0:
        return frames.copy()
    return _resample(frames, *_rotate_map(angle, *frames.shape[1:3]))


# -- the policy ---------------------------------------------------------------

# ImageEnhance's ops: the factor is 1 + magnitude * sign
_ENHANCE = {"color": color, "contrast": contrast, "sharpness": sharpness,
            "brightness": brightness}


def apply_op(frames: np.ndarray, op: str, magnitude, sign: int
             ) -> np.ndarray:
    """One op at ``magnitude`` with the sign ``_apply_op`` would draw, on
    (N, H, W, 3) uint8 frames; a new array."""
    if op in _ENHANCE:
        return _ENHANCE[op](frames, 1 + magnitude * sign)
    if op == "shearX":
        return shear_x(frames, magnitude * sign)
    if op == "shearY":
        return shear_y(frames, magnitude * sign)
    if op == "translateX":
        return translate_x(frames, magnitude * frames.shape[2] * sign)
    if op == "translateY":
        return translate_y(frames, magnitude * frames.shape[1] * sign)
    if op == "rotate":
        return rotate(frames, magnitude * sign)
    if op == "posterize":
        return posterize(frames, int(magnitude))
    if op == "solarize":
        return solarize(frames, magnitude)
    if op == "autocontrast":
        return autocontrast(frames)
    if op == "equalize":
        return equalize(frames)
    if op == "invert":
        return invert(frames)
    raise ValueError(op)


def imagenet_policy(clip: np.ndarray, rng: random.Random) -> np.ndarray:
    """One sub-policy for the clip, its two slots applied frame by frame
    in place to channels 0:3 of the uint8 (T, H, W, C) clip (a mask
    channel passes through). All draws come first, in the JAX package's
    order; then each slot runs once over the frames that drew it, per sign
    for the signed ops."""
    p1, op1, m1, p2, op2, m2 = IMAGENET_POLICIES[
        rng.randint(0, len(IMAGENET_POLICIES) - 1)]
    signs = np.zeros((2, clip.shape[0]), np.int64)   # 0: the slot idles
    for t in range(clip.shape[0]):
        if rng.random() < p1:
            signs[0, t] = rng.choice([-1, 1])
        if rng.random() < p2:
            signs[1, t] = rng.choice([-1, 1])
    for slot, (op, m) in enumerate(((op1, m1), (op2, m2))):
        groups = (-1, 1) if op in SIGNED_OPS else (None,)
        for sign in groups:
            fired = (signs[slot] != 0 if sign is None
                     else signs[slot] == sign)
            if fired.any():
                clip[fired, :, :, 0:3] = apply_op(
                    clip[fired, :, :, 0:3], op, _RANGES[op][m], sign or 1)
    return clip


def random_clip_flip(clip: np.ndarray, p: float,
                     rng: random.Random) -> np.ndarray:
    """Whole-clip horizontal flip, every channel (clip_transforms.py:111)."""
    if rng.random() < p:
        clip = np.take(clip, np.arange(clip.shape[2] - 1, -1, -1), axis=2)
    return clip


def train_augment(clip: np.ndarray, rng: random.Random) -> np.ndarray:
    """The reference's training pipeline: ImageNetPolicy, then
    RandomClipFlip at p = 0.5 (aff2compdataset.py:72-74)."""
    return random_clip_flip(imagenet_policy(clip, rng), 0.5, rng)


# an AugmentPool worker's view of the pool's shared batch
_WORKER_BATCH: dict = {}


def _attach_batch(name: str, clips: int, clip_bytes: int) -> None:
    """A worker's initializer: map the pool's shared batch, and run at the
    lowest priority (niceness 19), so that the training process's threads,
    which launch the step, keep their cores."""
    os.nice(19)
    shm = shared_memory.SharedMemory(name=name)
    _WORKER_BATCH["shm"] = shm
    _WORKER_BATCH["clips"] = np.ndarray((clips, clip_bytes), np.uint8,
                                        shm.buf)


def _augment_span(start: int, seeds: tuple, shape: tuple) -> None:
    """``train_augment`` of clips ``start``.. of the shared batch, clip
    ``start + j`` with ``Random(seeds[j])``, in place."""
    for j, seed in enumerate(seeds):
        clip = _WORKER_BATCH["clips"][start + j, :math.prod(shape)
                                      ].reshape(shape)
        out = train_augment(clip, random.Random(seed))
        if out is not clip:
            clip[...] = out


class AugmentPool:
    """``train_augment`` of a batch of clips in ``workers`` spawned
    processes, clip b with ``random.Random(seeds[b])``: byte-equal to the
    calls in-process. The batch travels through shared memory, not pipes:
    the caller copies it into the shared batch (numpy holds no GIL for the
    copy), the workers augment spans of it in place, and the caller copies
    it out; only (start, seeds, shape) is pickled, a few times per batch.
    The training process's GIL then stays free for the eager step, which
    takes it at each of its ~2,300 launches. The shared batch holds
    ``clips`` clips of up to ``clip_bytes`` bytes (a larger batch goes in
    parts). The workers start at construction; ``close`` stops them and
    frees the memory. As with any spawned process, a script that trains
    this way keeps its work under ``if __name__ == "__main__":`` (each
    worker imports the script's main module)."""

    def __init__(self, workers: int, clips: int, clip_bytes: int):
        self.workers = max(1, int(workers))
        self._shm = shared_memory.SharedMemory(
            create=True, size=max(1, int(clips)) * int(clip_bytes))
        self._batch = np.ndarray((max(1, int(clips)), int(clip_bytes)),
                                 np.uint8, self._shm.buf)
        self._lock = threading.Lock()
        self._pool = ProcessPoolExecutor(
            self.workers, mp_context=multiprocessing.get_context("spawn"),
            initializer=_attach_batch,
            initargs=(self._shm.name,) + self._batch.shape)
        # one task per worker spawns them all now, not in the first batch
        for f in [self._pool.submit(math.prod, ())
                  for _ in range(self.workers)]:
            f.result()

    def augment_batch(self, clips: np.ndarray, seeds) -> np.ndarray:
        """(B, T, H, W, C) uint8 -> a new augmented batch."""
        capacity, clip_bytes = self._batch.shape
        shape = clips.shape[1:]
        if math.prod(shape) > clip_bytes:
            raise ValueError(f"a clip of shape {shape} does not fit the "
                             f"pool's {clip_bytes} bytes")
        out = np.empty_like(clips)
        with self._lock:
            for first in range(0, len(clips), capacity):
                part = clips[first:first + capacity]
                view = self._batch[:len(part), :math.prod(shape)].reshape(
                    part.shape)
                np.copyto(view, part)
                # two spans per worker even out the policies' costs
                span = -(-len(part) // (2 * self.workers))
                for f in [self._pool.submit(
                        _augment_span, start,
                        tuple(seeds[first + start:first + start + span]),
                        shape) for start in range(0, len(part), span)]:
                    f.result()
                np.copyto(out[first:first + len(part)], view)
        return out

    def close(self) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)
        del self._batch          # the buffer's last export
        self._shm.close()
        self._shm.unlink()


# -- a digest that ties the port to PIL where PIL is not installed ------------

def digest_seeds(per_policy: int = 2) -> list[int]:
    """The first ``per_policy`` seeds s (counting from 0) whose
    ``random.Random(s)`` draws each sub-policy: every one occurs."""
    seeds: dict[int, list[int]] = {i: [] for i in
                                   range(len(IMAGENET_POLICIES))}
    s = 0
    while any(len(v) < per_policy for v in seeds.values()):
        p = random.Random(s).randint(0, len(IMAGENET_POLICIES) - 1)
        if len(seeds[p]) < per_policy:
            seeds[p].append(s)
        s += 1
    return sorted(x for v in seeds.values() for x in v)


def digest_clip(seed: int, frames: int = 8, size: int = 112) -> np.ndarray:
    """A uint8 (frames, size, size, C) clip from ``seed``: uniform noise in
    odd frames, noisy gradients in even ones, a mask channel (C = 4) for
    odd seeds."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    base = np.stack([xx * 255 // size, yy * 255 // size,
                     (xx + yy) * 127 // size], -1)
    clip = rs.randint(0, 256, (frames, size, size, 3 + seed % 2))
    smooth = np.clip(base + rs.randint(-12, 13, (frames, size, size, 3)),
                     0, 255)
    clip[0::2, ..., 0:3] = smooth[0::2]
    return clip.astype(np.uint8)


def augment_digest(augment=train_augment) -> str:
    """SHA-256 over ``augment(clip, random.Random(seed))`` of the
    ``digest_clip`` of each ``digest_seeds`` seed, in order."""
    h = hashlib.sha256()
    for seed in digest_seeds():
        h.update(np.ascontiguousarray(
            augment(digest_clip(seed), random.Random(seed))).tobytes())
    return h.hexdigest()
