"""auformer_torch's colour surface, JPEG recompression, PIL's HSV pair and
the invertible compose (data/transforms.py) against the JAX package's PIL
versions (auformer/data/transforms.py): uint8 for uint8 under the same
seeds of ``random`` and ``np.random``."""
import random

import numpy as np
import pytest
import torch
from PIL import Image

from auformer.data import transforms as jax_tf
from auformer.ops.preprocess import CLIP_MEAN, CLIP_STD
from auformer_torch.data import transforms as tf

def _frames(seed: int, n: int = 3, h: int = 20, w: int = 24,
            c: int = 3) -> np.ndarray:
    """uint8 (n, h, w, c): noise, a gradient, and grey and saturated
    pixels (the HSV conversions' special cases)."""
    rs = np.random.RandomState(seed)
    out = rs.randint(0, 256, (n, h, w, c)).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    out[0, ..., :3] = np.stack([xx * 255 // w, yy * 255 // h,
                                (xx + yy) * 127 // (h + w)], -1)
    out[:, :4, :4, :3] = rs.randint(0, 256, (n, 4, 4, 1))      # grey
    out[:, -4:, -4:, :3] = rs.choice([0, 255], (n, 4, 4, 3))   # saturated
    return out


def _pil_hsv(rgb):
    return np.array(Image.fromarray(rgb.reshape(256, -1, 3))
                    .convert("HSV")).reshape(rgb.shape)


def _pil_rgb(hsv):
    return np.array(Image.fromarray(hsv.reshape(256, -1, 3), "HSV")
                    .convert("RGB")).reshape(hsv.shape)


@pytest.mark.parametrize("direction", ["to_hsv", "to_rgb"])
def test_hsv_pair_equals_pil_on_every_input(direction):
    """All 2^24 inputs, 2^20 at a time."""
    port, pil = ((tf._rgb_to_hsv, _pil_hsv) if direction == "to_hsv"
                 else (tf._hsv_to_rgb, _pil_rgb))
    for start in range(0, 1 << 24, 1 << 20):
        colours = tf.all_colours(start, start + (1 << 20))
        want = pil(colours)
        got = port(colours)
        bad = np.flatnonzero((got != want).any(-1))
        assert bad.size == 0, (direction, colours[bad[:5]], got[bad[:5]],
                               want[bad[:5]])


def test_pil_hsv_tables_hash_to_the_digests_chip_smoke_checks():
    """PIL's two tables hash to ``PIL_HSV_DIGESTS``, which chip_smoke.py
    holds the port's against on a machine without PIL."""
    assert tf.hsv_digests(_pil_hsv, _pil_rgb) == tf.PIL_HSV_DIGESTS


@pytest.mark.parametrize("name,factors", [
    ("brightness", (0.0, 0.55, 1.0, 1.37, 2.2)),
    ("contrast", (0.0, 0.4, 1.0, 1.3, 2.5)),
    ("saturation", (0.0, 0.7, 1.0, 1.25, 3.0)),
    ("hue", (-0.5, -0.21, -0.003, 0.0, 0.02, 0.33, 0.5))])
def test_adjust_ops_match_jax(name, factors):
    frames = _frames(1)
    for f in factors:
        for frame in frames:
            want = getattr(jax_tf, f"adjust_{name}")(frame, f)
            got = getattr(tf, f"adjust_{name}")(frame, f)
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {f}")


@pytest.mark.parametrize("name,arg", [
    ("Brightness", 1.4), ("Contrast", 0.6), ("Saturation", 1.8),
    ("Hue", -0.3), ("Hue", 0.5), ("Rescale", 1 / 255.0)])
def test_intensity_classes_match_jax(name, arg):
    frame = _frames(2)[1]
    want = getattr(jax_tf, name)(arg)(frame)
    got = getattr(tf, name)(arg)(frame)
    assert type(got) is np.ndarray and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,amp", [
    ("RandomBrightness", 0.3), ("RandomContrast", 0.4),
    ("RandomSaturation", 0.5), ("RandomHue", 0.2)])
def test_random_classes_draw_as_jax(name, amp):
    """One seed gives JAX's factor, from an explicit ``random.Random`` and
    from the module (``rng=None``); the ops then agree."""
    frame = _frames(3)[0]
    for seed in (0, 7):
        want = getattr(jax_tf, name)(amp, rng=random.Random(seed))
        got = getattr(tf, name)(amp, rng=random.Random(seed))
        random.seed(seed)
        got_module = getattr(tf, name)(amp)
        key = [k for k in vars(want)][0]
        assert vars(got) == vars(want) == vars(got_module), key
        np.testing.assert_array_equal(got(frame), want(frame))


def test_hue_outside_its_range_raises():
    for bad in (-0.51, 0.6):
        with pytest.raises(ValueError, match="not in"):
            jax_tf.Hue(bad)
        with pytest.raises(ValueError, match="not in"):
            tf.Hue(bad)


@pytest.mark.parametrize("seed,amps", [
    (0, {}), (1, {}), (2, dict(brightness=0, hue=0.3)),
    (3, dict(contrast=0, saturation=0.5)), (4, dict(hue=0.5))])
@pytest.mark.parametrize("channels", [3, 4])
def test_random_color_augment_matches_jax(seed, amps, channels):
    """Per-frame draws in JAX's order from the same seed; a mask channel
    passes through."""
    clip = _frames(seed, n=4, c=channels)
    random.seed(seed)
    want = jax_tf.random_color_augment(clip.copy(), **amps)
    after_jax = random.random()
    got = tf.random_color_augment(clip.copy(), rng=random.Random(seed),
                                  **amps)
    random.seed(seed)
    got_module = tf.random_color_augment(clip.copy(), **amps)
    assert random.random() == after_jax     # as many draws as JAX
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_module, want)
    if channels == 4:
        np.testing.assert_array_equal(got[..., 3], clip[..., 3])


@pytest.mark.parametrize("seed,amps", [
    (0, dict(brightness=0.3, contrast=0.3, hue=0.1, saturation=0.4)),
    (5, dict()), (6, dict(hue=0.7, saturation=0.2))])
def test_random_color_augment_class_matches_jax(seed, amps):
    frame = _frames(seed)[2]
    want = jax_tf.RandomColorAugment(**amps, rng=random.Random(seed))
    got = tf.RandomColorAugment(**amps, rng=random.Random(seed))
    assert vars(got) == vars(want)
    np.testing.assert_array_equal(got(frame), want(frame))


@pytest.mark.parametrize("channels,probability,seed", [
    (3, 1.1, 0), (4, 1.1, 1), (3, 0.2, 2), (4, 0.5, 4)])
def test_jpeg_compression_matches_jax(channels, probability, seed):
    """libjpeg encodes and decodes here: the port's clip is JAX's (PIL's)
    bit for bit, with JAX's draws from numpy's stream; the mask channel
    passes through."""
    clip = _frames(seed, n=3, h=32, w=40, c=channels)
    np.random.seed(seed)
    want = jax_tf.jpeg_compression(clip.copy(), probability)
    after_jax = np.random.random()
    got = tf.jpeg_compression(clip.copy(), probability,
                              np.random.RandomState(seed))
    np.random.seed(seed)
    got_global = tf.jpeg_compression(clip.copy(), probability)
    assert np.random.random() == after_jax
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_global, want)
    if channels == 4:
        np.testing.assert_array_equal(got[..., 3], clip[..., 3])
    if probability > 1:
        assert (got[..., :3] != clip[..., :3]).any()


def test_numpy_to_tensor_and_normalize_match_jax():
    clip = _frames(8, n=4, h=16, w=16)
    want = jax_tf.NumpyToTensor()(clip)
    got = tf.NumpyToTensor()(clip)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert tuple(got.shape) == (3, 4, 16, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tf.NumpyToTensor()(got, invert=True),
                                  jax_tf.NumpyToTensor()(want, invert=True))
    jn = jax_tf.Normalize(CLIP_MEAN[:3], CLIP_STD[:3])
    pn = tf.Normalize(CLIP_MEAN[:3], CLIP_STD[:3])
    norm = jn(want)
    np.testing.assert_array_equal(pn(got).numpy(), norm)
    np.testing.assert_array_equal(pn(want), norm)
    np.testing.assert_array_equal(pn(torch.from_numpy(norm), True).numpy(),
                                  jn(norm, True))
    np.testing.assert_array_equal(pn(norm, True), jn(norm, True))


def test_compose_invert_roundtrip():
    """tests/test_transforms.py's round trips, through tensors."""
    clip = _frames(9, n=2, h=8, w=8)
    to_tensor = tf.NumpyToTensor()
    np.testing.assert_array_equal(to_tensor(to_tensor(clip), invert=True),
                                  clip)
    pipe = tf.ComposeWithInvert([tf.NumpyToTensor(),
                                 tf.Normalize(CLIP_MEAN[:3], CLIP_STD[:3])])
    fwd = pipe(clip.copy())
    assert isinstance(fwd, torch.Tensor)
    back = pipe(fwd, invert=True)
    assert back.dtype == np.uint8
    np.testing.assert_array_equal(back, clip)
    jax_pipe = jax_tf.ComposeWithInvert([
        jax_tf.NumpyToTensor(), jax_tf.Normalize(CLIP_MEAN[:3],
                                                 CLIP_STD[:3])])
    np.testing.assert_array_equal(fwd.numpy(), jax_pipe(clip.copy()))


def test_amp_to_db_matches_jax():
    feats = (np.random.RandomState(10).rand(1, 64, 50) ** 4
             * 10).astype(np.float32)
    np.testing.assert_allclose(tf.AmpToDB()(feats), jax_tf.AmpToDB()(feats),
                               rtol=0, atol=1e-5)
    assert tf.AmpToDB()(feats, invert=True) is feats


def test_random_clip_flip_class_matches_jax():
    clip = _frames(11, n=2, h=6, w=7)
    flips = 0
    for seed in range(6):
        random.seed(seed)
        want = jax_tf.RandomClipFlip()(clip.copy())
        got = tf.RandomClipFlip(rng=random.Random(seed))(clip.copy())
        random.seed(seed)
        got_module = tf.RandomClipFlip()(clip.copy())
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_module, want)
        flips += not np.array_equal(got, clip)
    assert 0 < flips < 6
    assert tf.RandomClipFlip(p=1.1)(clip, invert=True) is clip
