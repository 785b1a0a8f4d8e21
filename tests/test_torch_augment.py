"""auformer_torch device AutoAugment against the JAX package.

The same numpy frames go through the port's ops and stages and the JAX
package's ``auformer/ops/augment_device.py`` on the CPU. Tolerances, in
uint8 levels:

  * LUT ops (invert, posterize, solarize, equalize, brightness, contrast)
    and the nearest warps (translate): exact;
  * blends (color, sharpness): +-1 level (float blend rounding);
  * rotate: exact on at least 99.9 % of the pixels. The port takes cos and
    sin in f64 rounded to f32 (the same bits on the CPU and the card);
    XLA's f32 cos/sin differ from those by an ulp at some angles, which
    moves a nearest sample that lies on a pixel edge.

shearX, shearY and autocontrast are held against the host path
(``auformer.data.transforms``, PIL), exactly, and the tests record ROADMAP
C9: the JAX package's device shear (the a = -0.5 cubic, rounded half to
even) lies levels away from PIL's (a = -1, truncated), and its f32
autocontrast table one level away on some pixels. The enhance family is
held against PIL with factor 1 + m, and the test records ROADMAP C1: the
JAX package's device path passes factor m instead.
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from auformer.data import transforms as host
from auformer.ops import augment_device as J
from auformer_torch.ops import augment_device as P

OPS = [name for name in P.OP_IDS if name != "none"]
# a signed magnitude per op from its table (rotate 26.67 degrees, ...)
MAGS = {"shearX": float(P._RANGES["shearX"][6]),
        "shearY": -float(P._RANGES["shearY"][9]), "translateX": 0.3,
        "translateY": -0.45, "rotate": 26.666666, "invert": 0.0,
        "posterize": 5.0, "solarize": 142.22, "brightness": 0.6,
        "contrast": -0.3, "autocontrast": 0.0, "equalize": 0.0,
        "color": 0.7, "sharpness": -0.5}
BLENDS = {"color", "sharpness"}
PIL_OPS = {"shearX", "shearY", "autocontrast"}   # held to PIL: C9


@pytest.fixture(scope="module")
def frames():
    """(8, 40, 40, 3) uint8: gradients + noise, a constant frame (flat
    histograms, lo == hi) and a two-level frame."""
    rs = np.random.RandomState(5)
    yy, xx = np.mgrid[0:40, 0:40]
    base = np.stack([xx * 6 % 256, yy * 6 % 256, (xx + yy) * 3 % 256], -1)
    out = np.clip(base[None] + rs.randint(0, 40, (8, 40, 40, 3)), 0,
                  255).astype(np.uint8)
    out[5] = 77
    out[6] = np.where(rs.rand(40, 40, 1) < 0.5, 10, 240).astype(np.uint8)
    return out


def _diff(a, b):
    return np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))


def _check(name, got, want):
    d = _diff(got, want)
    if name == "rotate":
        assert (d > 0).mean() <= 1e-3, f"rotate: {(d > 0).sum()} pixels"
    elif name in BLENDS:
        assert d.max() <= 1, f"{name}: max diff {d.max()}"
    else:
        assert d.max() == 0, f"{name}: max diff {d.max()}"


def _host_op(frame, name, magnitude, sign):
    """The JAX package's host (PIL) op with its random sign forced."""
    rng = random.Random(0)
    rng.choice = lambda seq: sign
    return np.asarray(host._apply_op(Image.fromarray(frame), name,
                                     magnitude, rng))


def _check_c9(name, got, jax_out, frame, m):
    """A shear or autocontrast frame: the port's equals PIL's at the
    table's magnitude ``m`` (its sign the op's), and the JAX package's
    device op still misses PIL (C9): shear by levels, autocontrast by one
    level where it misses."""
    pil = _host_op(frame, name, abs(m), -1 if m < 0 else 1)
    np.testing.assert_array_equal(np.asarray(got), pil)
    d = _diff(jax_out, pil)
    if name == "autocontrast":
        assert d.max() <= 1
    else:
        assert d.max() > 1, "C9 no longer differs"
    return d.max()


@pytest.mark.parametrize("name", OPS)
def test_plain_ops_match_jax(frames, name):
    """Each plain op on the whole (8, H, W, 3) batch at its magnitude;
    the enhance ops at factor 1 + m on both sides; shearX, shearY and
    autocontrast against PIL frame by frame (C9)."""
    m = MAGS[name]
    arg = 1.0 + m if name in P.ENHANCE_OPS else m
    got = P.OP_FNS[name](torch.from_numpy(frames), arg)
    want = J.OP_FNS[name](jnp.asarray(frames), arg)
    if name in PIL_OPS:
        misses = [_check_c9(name, g, w, f, m) for g, w, f in
                  zip(got.numpy(), np.asarray(want), frames)]
        assert max(misses) > 0, "C9 no longer differs"
    else:
        _check(name, got.numpy(), want)


@pytest.mark.parametrize("sign", [-1.0, 1.0])
@pytest.mark.parametrize("name", sorted(P.ENHANCE_OPS))
def test_enhance_ops_take_one_plus_m_as_the_host_path(frames, name, sign):
    """apply_op's enhance factor is 1 + m * sign, as PIL's host path: +-1
    level. The JAX device path's factor m * sign (ROADMAP C1) lands
    outside that tolerance, levels away on average."""
    m = abs(MAGS[name])
    for frame in frames[:4]:
        want = _host_op(frame, name, m, sign)
        got = P.apply_op(torch.from_numpy(frame), name, m, sign).numpy()
        assert _diff(got, want).max() <= 1
        jax_c1 = np.asarray(J.apply_op(jnp.asarray(frame), name, m, sign))
        assert _diff(jax_c1, want).mean() > 2, "C1 no longer differs"


def _op_arrays(frames):
    """Every op (and none) twice over the frames, the signed ops with both
    signs: (T,) op, (T,) m."""
    names = ["none"] + OPS
    n = len(frames)
    order = [names[i % len(names)] for i in range(2 * len(names))]
    op = np.array([P.OP_IDS[name] for name in order], np.int64)
    m = np.array([MAGS.get(name, 0.0) * (-1.0 if i >= len(names)
                                          and name in P.SIGNED_OPS else 1.0)
                  for i, name in enumerate(order)], np.float32)
    x = frames[np.arange(len(op)) % n]
    return x, op, m


def _stage_inputs(frames):
    x, op, m = _op_arrays(frames)
    return (x, op, m, torch.from_numpy(x), torch.from_numpy(op),
            torch.from_numpy(m))


@pytest.mark.parametrize("stage", ["_geo_stage", "_lut_stage"])
def test_geo_and_lut_stages_match_jax(frames, stage):
    """Stage by stage on (x, op, m) arrays that cover all 14 ops and both
    signs, each frame judged by its op's tolerance."""
    x, op, m, xt, opt, mt = _stage_inputs(frames)
    got = getattr(P, stage)(xt, opt, mt).numpy()
    want = np.asarray(getattr(J, stage)(jnp.asarray(x),
                                        jnp.asarray(op.astype(np.int32)),
                                        jnp.asarray(m)))
    _check_frames(op, m, x, got, want, {
        "_geo_stage": {"shearX", "shearY"},
        "_lut_stage": {"autocontrast"}}[stage])


def _check_frames(op, m, x, got, want, pil_ops=PIL_OPS):
    """Each frame by its op's rule: against the JAX package's frame (a
    frame the stage passes through included), or for the shear and
    autocontrast that the stage runs, ``pil_ops``, against PIL's (C9), the
    magnitude the table's value with the sign of ``m``."""
    names = {v: k for k, v in P.OP_IDS.items()}
    for i, o in enumerate(op):
        name = names[int(o)]
        if name in pil_ops:
            _check_c9(name, got[i], want[i], x[i],
                      abs(MAGS[name]) * (-1 if m[i] < 0 else 1))
        else:
            _check(name, got[i], want[i])


@pytest.mark.parametrize("name", ["color", "sharpness"])
def test_blend_stages_match_jax(frames, name):
    x, op, m, xt, opt, mt = _stage_inputs(frames)
    factor = np.where(op == P.OP_IDS[name], 1.0 + m, 1.0).astype(np.float32)
    stage = "_color_stage" if name == "color" else "_sharp_stage"
    got = getattr(P, stage)(xt, torch.from_numpy(factor)).numpy()
    want = np.asarray(getattr(J, stage)(jnp.asarray(x),
                                        jnp.asarray(factor)))
    assert _diff(got, want).max() <= 1
    keep = factor == 1.0                     # the exact identity
    np.testing.assert_array_equal(got[keep], x[keep])


def test_slot_apply_matches_jax(frames):
    """The port's slot at m equals the JAX slot at m for every op but the
    enhance family, and at 1 + m for that (C1); shear and autocontrast
    equal PIL (C9)."""
    x, op, m, xt, opt, mt = _stage_inputs(frames)
    enhance = np.isin(op, [P.OP_IDS[n] for n in P.ENHANCE_OPS])
    got = P._slot_apply(xt, opt, mt).numpy()
    want = np.asarray(J._slot_apply(jnp.asarray(x),
                                    jnp.asarray(op.astype(np.int32)),
                                    jnp.asarray(np.where(enhance, 1.0 + m,
                                                         m))))
    _check_frames(op, m, x, got, want)


def test_slot_apply_equals_the_plain_ops(frames):
    """Within the port: each frame of the staged slot equals apply_op of
    its op on that frame at the table's magnitude (blends +-1, rotate
    exact here: both take the same cos/sin)."""
    x, op, m, xt, opt, mt = _stage_inputs(frames)
    got = P._slot_apply(xt, opt, mt).numpy()
    names = {v: k for k, v in P.OP_IDS.items()}
    for i, o in enumerate(op):
        name = names[int(o)]
        if name == "none":
            np.testing.assert_array_equal(got[i], x[i])
            continue
        sign = 1.0 if m[i] >= 0 else -1.0
        mag = abs(MAGS[name] if name in PIL_OPS else float(m[i]))
        want = P.apply_op(xt[i], name, mag, sign).numpy()
        d = _diff(got[i], want)
        assert d.max() <= (1 if name in BLENDS else 0), name


def test_policy_tables_match_jax():
    for got, want in zip(P._policy_tables(), J._policy_tables()):
        np.testing.assert_array_equal(got, want)


def test_augment_clips_device_draws(frames):
    """One policy per clip (both slots' ops from one table row), ops only
    from that row or none, signed magnitudes only for signed ops; the same
    generator seed gives the same clips, and a clip whose frames all
    drew "none" stays unchanged."""
    clips = torch.from_numpy(np.stack([frames] * 6))          # (6, 8, ...)
    gen = torch.Generator().manual_seed(3)
    op1, m1, op2, m2 = P.policy_draws(6, 8, gen, "cpu")
    op_t, _, mag_t, signed_t = P._policy_tables()
    for b in range(6):
        rows = [r for r in range(len(op_t))
                if set(op1[b].tolist()) <= {0, op_t[r, 0]}
                and set(op2[b].tolist()) <= {0, op_t[r, 1]}]
        assert rows
        for op, mm, s in ((op1, m1, 0), (op2, m2, 1)):
            on = op[b] > 0
            mags = {abs(float(v)) for v in mm[b]}
            assert any(np.isclose(float(mag_t[r, s]), list(mags)).all()
                       for r in rows)
            if not any(signed_t[r, s] for r in rows):
                assert (mm[b][on] >= 0).all()
    a = P.augment_clips_device(clips, torch.Generator().manual_seed(3))
    b = P.augment_clips_device(clips, torch.Generator().manual_seed(3))
    assert a.dtype == torch.uint8 and a.shape == clips.shape
    assert torch.equal(a, b)
    idle = (op1 == 0).all(1) & (op2 == 0).all(1)
    assert torch.equal(a[idle], clips[idle])
