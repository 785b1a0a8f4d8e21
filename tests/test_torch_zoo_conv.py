"""The convolution families of the model zoo in auformer_torch against the
JAX package, on the CPU: van, emonet, i3d, mc3d and tsav.

Each model takes one seeded state dict in the reference ``.pth`` layout:
the port loads it with ``load_state_dict``, JAX through
``convert_checkpoint`` + ``merge_into`` over the model's abstract init
(``tests/test_torch_zoo.py``). Both run the same numpy input in f32 at
64x64 (emonet needs a multiple of 64), T=4 for the 3-d models, B=2. Then
the TF-SAME convolution and -inf pool against flax at odd and even sizes;
the new module kinds in bf16 against flax with ``dtype=bfloat16``, each
beside an f32 control that must miss; van and emonet through
``SingleFrameSweep`` against JAX's; and ROADMAP.md C5 (tsav's 22 columns).
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from auformer import infer as jax_infer
from auformer import sweep as jax_sweep_module
from auformer.core.config import Config as JaxConfig
from auformer.data.fixtures import generate_synthetic_dataset
from auformer.losses import SUITES as JAX_SUITES
from auformer.nn import emonet as jemonet
from auformer.nn import i3d as ji3d
from auformer.nn import mc3d as jmc3d
from auformer.nn import tsav as jtsav
from auformer.nn import van as jvan
from auformer_torch.core.config import Config
from auformer_torch.core.weights import (Exporter, load_weights,
                                         state_dict_from_jax)
from auformer_torch.data import Aff2TestDataset
from auformer_torch import infer as tinfer
from auformer_torch.infer import make_infer_fn, model_inputs, run_inference
from auformer_torch.losses import SUITES
from auformer_torch.nn import blocks, build_model, emonet, example_batch
from auformer_torch.nn import mc3d, tsav, van
from auformer_torch.nn.registry import (compute_autocast, output_table,
                                        prepare_inference)
from auformer_torch.ops.preprocess import normalize_clip
from auformer_torch.sweep import SingleFrameSweep, make_sweep
from test_torch_modules import randomize
from test_torch_zoo import jax_variables, seeded_state_dict

IMAGE = 64
BATCH = 2
# f32 logits, port against JAX: the same arithmetic in another order
TOL = dict(rtol=1e-4, atol=1e-5)

# id -> (model_name, modality, task, frames per clip)
MODELS = {
    "van": ("van", "V", "AU", 1),
    "emonet": ("emonet", "V", "AU", 1),
    "i3d": ("i3d", "V", "AU", 4),
    "mc3d": ("mc3d", "V", "AU", 4),
    "tsav": ("tsav", "A;V", "AU", 4),
}


def conv_config(case: str, **kw) -> dict:
    name, modality, task, t = MODELS[case]
    return {**dict(model_name=name, modality=modality, task=task, n_frames=t,
                   dilation=1, image_size=IMAGE, compute_dtype="float32"),
            **kw}


_SIDES: dict = {}


def sides(case: str):
    """(cfg, sd, port model, JAX variables, inputs, JAX output), built once
    per case for every test of the module."""
    if case not in _SIDES:
        cfg = conv_config(case)
        model = build_model(Config(**cfg))
        sd = seeded_state_dict(model, seed=40 + sorted(MODELS).index(case))
        load_weights(model, sd)
        jmodel, variables = jax_variables(cfg, sd)
        x = example_batch(Config(**cfg), batch_size=BATCH,
                          rng=np.random.RandomState(41))
        want = np.asarray(jax.jit(functools.partial(
            jmodel.apply, train=False))(variables, x))
        _SIDES[case] = (cfg, sd, model.eval(), variables, x, want)
    return _SIDES[case]


@pytest.mark.parametrize("case", sorted(MODELS))
def test_conv_model_matches_jax(case):
    """f32 logits of the port's forward against JAX's: (B, 21), or tsav's
    (B, 22), within TOL. emonet's f32 forward is itself farther than TOL
    from exact at these weights: its hourglass sums residuals to |x| ~ 40,
    and the port's f32 logits (|x| up to 20) lie 3.7e-4 (max abs,
    1.2e-5 norm-relative) from its own f64 forward. For emonet the port's
    f32 and f64 logits are each held within twice that f32 noise of JAX's,
    and the f32 noise itself within 2e-5 of the logits' scale."""
    _, _, model, _, x, want = sides(case)
    xt = {k: torch.from_numpy(v) for k, v in x.items()}
    with torch.inference_mode():
        got = model(xt)
    assert got.shape == (BATCH, 22 if case == "tsav" else 21)
    assert got.dtype == torch.float32
    if case != "emonet":
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        return
    exact = copy.deepcopy(model).double()
    with torch.inference_mode():
        got64 = exact({k: v.double() for k, v in xt.items()}).numpy()
    noise = np.abs(got.numpy() - got64).max()
    assert noise <= 2e-5 * np.abs(got64).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2 * noise)
    np.testing.assert_allclose(got64, want, rtol=0, atol=2 * noise)


@pytest.mark.parametrize("case", sorted(MODELS))
def test_state_dict_from_jax_inverts_the_converter(case):
    cfg, sd, _, variables, _, _ = sides(case)
    back = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables),
                               cfg["model_name"])
    assert set(back) == set(sd)
    for key, value in sd.items():
        np.testing.assert_array_equal(back[key].numpy(), value, err_msg=key)


def test_rgb_only_models_refuse_the_mask():
    for name in ("i3d", "mc3d"):
        with pytest.raises(ValueError, match="RGB-only"):
            build_model(Config(model_name=name, modality="V;M"))
    with pytest.raises(ValueError, match="divisible by 64"):
        build_model(Config(model_name="emonet", modality="V"))(
            {"clip": torch.zeros(1, 1, 96, 96, 3)})


def test_drop_path_keeps_or_drops_whole_samples():
    """VAN's stochastic depth (auformer/nn/van.py:26-33): in train mode each
    sample is kept, scaled by 1 / (1 - p), or zeroed whole, the draw from
    the generator ``set_dropout_generator`` hands it (the same seed, the
    same samples); without one it raises; in eval it is the identity."""
    model = van.VAN(drop_path_rate=0.5)
    rates = [m.p for m in model.modules() if isinstance(m, blocks.DropPath)]
    assert len(rates) == sum(van.DEPTHS) and rates[0] == 0.0
    assert rates[-1] == 0.5
    drop = blocks.DropPath(0.5).train()
    x = torch.ones(64, 3, 2, 2)
    with pytest.raises(RuntimeError, match="generator"):
        drop(x)
    outs = []
    for _ in range(2):
        blocks.set_dropout_generator(drop, torch.Generator().manual_seed(3))
        outs.append(drop(x))
    assert torch.equal(outs[0], outs[1])
    per_sample = outs[0].reshape(64, -1)
    assert set(per_sample.unique().tolist()) == {0.0, 2.0}
    assert (per_sample == per_sample[:, :1]).all()
    assert torch.equal(drop.eval()(x), x)


# -- TF-SAME padding -----------------------------------------------------------

# (T, H, W) sizes, odd and even, and (kernel, stride) of the I3D stem, its
# spatial pools, the inception pool and the 5a pool
SAME_SIZES = ((4, 8, 8), (5, 7, 9))
SAME_OPS = (((7, 7, 7), (2, 2, 2)), ((1, 3, 3), (1, 2, 2)),
            ((3, 3, 3), (1, 1, 1)), ((2, 2, 2), (2, 2, 2)))


def test_same_pads_match_lax():
    """The I3D stem at 16x112x112 pads (2, 3) on every axis, the
    (1,3,3)/(1,2,2) pools at 56 pad (0, 1): as lax.padtype_to_pads."""
    assert blocks.same_pads((16, 112, 112), (7, 7, 7), (2, 2, 2)) == \
        [(2, 3)] * 3
    assert blocks.same_pads((8, 56, 56), (1, 3, 3), (1, 2, 2)) == \
        [(0, 0), (0, 1), (0, 1)]
    for size in SAME_SIZES:
        for kernel, stride in SAME_OPS:
            want = jax.lax.padtype_to_pads(size, kernel, stride, "SAME")
            assert blocks.same_pads(size, kernel, stride) == \
                [tuple(p) for p in want]


@pytest.mark.parametrize("size", SAME_SIZES)
@pytest.mark.parametrize("op", range(len(SAME_OPS)))
def test_same_conv_and_pool_match_flax(size, op):
    """``ConvSame`` against flax's ``padding="SAME"`` convolution and
    ``max_pool_same`` against the JAX package's, on a signed input (the
    pool's -inf padding shows where a zero pad would win)."""
    kernel, stride = SAME_OPS[op]
    rs = np.random.RandomState(50 + op)
    x = rs.randn(2, *size, 3).astype(np.float32)
    jconv = fnn.Conv(4, kernel, strides=stride, padding="SAME",
                     use_bias=False)
    variables = jconv.init(jax.random.PRNGKey(op), x)
    want = np.asarray(jconv.apply(variables, x)).transpose(0, 4, 1, 2, 3)
    conv = blocks.ConvSame(3, 4, kernel, stride)
    e = Exporter(variables)
    e.conv3d("", "")
    load_weights(conv, e.sd)
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    with torch.no_grad():
        np.testing.assert_allclose(conv(xt).numpy(), want, **TOL)
    want = np.asarray(ji3d.max_pool_same(x, kernel, stride))
    np.testing.assert_array_equal(
        blocks.max_pool_same(xt, kernel, stride).numpy(),
        want.transpose(0, 4, 1, 2, 3))


@pytest.mark.parametrize("size", SAME_SIZES)
@pytest.mark.parametrize("op", range(len(SAME_OPS)))
def test_separable_max_pool_matches_max_pool3d(size, op):
    """``max_pool3d_separable`` (the deterministic route of
    ``max_pool_same`` on CUDA) against ``F.max_pool3d``, on the input
    padded with -inf to SAME and on the pool's own padding, on a tie-rich
    integer input: equal values, and with an integer upstream gradient
    (exact sums) equal input gradients, so each window's gradient goes to
    the same element."""
    kernel, stride = SAME_OPS[op]
    rs = np.random.RandomState(60 + op)
    x = rs.randint(-3, 3, (2, 3, *size)).astype(np.float32)
    same = blocks._torch_pad(blocks.same_pads(size, kernel, stride))
    g = None
    for pad, padding in ((same, (0, 0, 0)),
                         ([0] * 6, tuple(k // 2 for k in kernel))):
        outs = []
        for pool in (F.max_pool3d, blocks.max_pool3d_separable):
            xt = torch.from_numpy(x).requires_grad_()
            y = pool(F.pad(xt, pad, value=float("-inf")), kernel, stride,
                     padding)
            if g is None or g.shape != y.shape:
                g = torch.from_numpy(
                    rs.randint(-4, 5, y.shape).astype(np.float32))
            y.backward(g)
            outs.append((y.detach(), xt.grad))
        (want_y, want_g), (got_y, got_g) = outs
        assert torch.equal(got_y, want_y)
        assert torch.equal(got_g, want_g)


# -- bf16: the new module kinds against flax with dtype=bfloat16 ---------------

def _zero_conv_biases(tree):
    """Convolution and dense biases set to 0: the port adds a bias before
    its one rounding, flax after (tests/test_torch_train.py::DENSE_BIASES,
    ROADMAP.md's documented departure). BatchNorm biases stay."""
    if not isinstance(tree, dict):
        return tree
    return {k: (np.zeros_like(v) if k == "bias" and "kernel" in tree
                else _zero_conv_biases(v)) for k, v in tree.items()}


# name -> (flax module of a dtype, port module, exporter mapper, port input
# shape (NC...), apply kwargs). Every input arrives in bf16 (a post-ReLU
# activation). Measured, bf16 / the f32 control, norm-relative to flax's
# bf16 result: every bf16 case 0 (bit-equal); the controls conv3d_bn
# 4.0e-3, r2plus1d 3.9e-3, instance_norm_convblock 6.3e-3, lka 5.1e-3,
# layer_scale_van_block 2.8e-3.
BF16_CASES = {
    # Conv3d -> BN -> ReLU, twice, with a strided downsample (mc3d)
    "conv3d_bn": (
        lambda d: jmc3d.BasicBlock3D(32, True, 2, True, d),
        lambda: mc3d.BasicBlock3D(16, 32, True, 2, True),
        lambda e: e.mc3d_block("m", "m"), (2, 16, 4, 8, 8), {"train": False}),
    # R(2+1)D: spatial conv, BN, ReLU, temporal conv, twice, downsample
    "r2plus1d": (
        lambda d: jtsav.R2Plus1DBlock(16, 32, 2, True, d),
        lambda: tsav.R2Plus1DBlock(16, 32, 2, True),
        lambda e: e.r2plus1d_block("m", "m"), (2, 16, 4, 8, 8),
        {"train": False}),
    # EmoNet's InstanceNorm ConvBlock with its 1x1 downsample
    "instance_norm_convblock": (
        lambda d: jemonet.ConvBlock(64, 128, d),
        lambda: emonet.ConvBlock(64, 128),
        lambda e: e.emonet_convblock("m", "m"), (2, 64, 8, 8), {}),
    # large-kernel attention: DW 5x5, dilated DW 7x7, 1x1, gating
    "lka": (
        lambda d: jvan.LKA(32, d), lambda: van.LKA(32),
        lambda e: [e.conv2d(f"{c}", f"m/{c}") for c in
                   ("conv0", "conv_spatial", "conv1")],
        (2, 32, 12, 12), {}),
    # a whole VAN block: BN, attention, MLP, the f32 layer scales
    "layer_scale_van_block": (
        lambda d: jvan.VanBlock(32, 4.0, dtype=d),
        lambda: van.VanBlock(32, 4.0),
        lambda e: e.van_block("m", "m"), (2, 32, 8, 8), {"train": False}),
}
BF16_TOL = 1e-3


@pytest.fixture
def f32_gelu(monkeypatch):
    """GELU in f32, rounded once, on the JAX side: the port's documented
    departure (tests/test_torch_zoo.py::pallas_attention does the same for
    the tanh form)."""
    gelu = jax.nn.gelu
    monkeypatch.setattr(jax.nn, "gelu", lambda x, approximate=True: gelu(
        x.astype(jnp.float32), approximate=approximate).astype(x.dtype))


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("name", sorted(BF16_CASES))
def test_bf16_conv_modules_match_flax(name, f32_gelu):
    """Each new module kind in eval mode under the port's inference casts
    (``compute_autocast``, Conv2d / Conv3d weights rounded once by
    ``prepare_inference``) against the flax module with dtype=bfloat16 run
    op by op; the port's f32 forward is the control that must miss."""
    jmake, tmake, export, shape, kwargs = BF16_CASES[name]
    x = np.abs(np.random.RandomState(60).randn(*shape)).astype(np.float32)
    xj = np.moveaxis(x, 1, -1)                  # channels last for flax
    variables = randomize(jax.eval_shape(functools.partial(
        jmake(jnp.float32).init, **kwargs), jax.random.PRNGKey(0), xj), 61)
    variables = {"params": _zero_conv_biases(variables["params"]),
                 "batch_stats": variables.get("batch_stats", {})}
    e = Exporter({"params": {"m": variables["params"]},
                  "batch_stats": {"m": variables["batch_stats"]}})
    export(e)
    sd = {k[2:] if k.startswith("m.") else k: v for k, v in e.sd.items()}
    want = jmake(jnp.bfloat16).apply(
        variables, jnp.asarray(xj, jnp.bfloat16), **kwargs)
    want = np.moveaxis(np.asarray(want.astype(jnp.float32)), -1, 1)
    outs = {}
    for dtype in ("bfloat16", "float32"):
        cfg = Config(compute_dtype=dtype)
        module = tmake()
        load_weights(module, sd)
        prepare_inference(cfg, module, torch.device("cpu"))
        xt = torch.from_numpy(x)
        if dtype == "bfloat16":
            xt = xt.bfloat16()
        with torch.inference_mode(), compute_autocast(cfg, "cpu"):
            outs[dtype] = module(xt).float().numpy()
    err, control = _rel(outs["bfloat16"], want), _rel(outs["float32"], want)
    assert err <= BF16_TOL < control, (err, control)


# -- serving: van and emonet through SingleFrameSweep --------------------------

@pytest.mark.parametrize("case", ["van", "emonet"])
def test_single_frame_sweep_matches_jax(case):
    """5 frames at 64x64 in buckets of 4 (the last padded with black
    frames), against JAX's SingleFrameSweep and the port's own clip
    forward."""
    cfg, _, model, variables, _, _ = sides(case)
    frames = np.random.RandomState(62).randint(
        0, 256, (5, IMAGE, IMAGE, 3)).astype(np.uint8)
    want = np.asarray(jax_sweep_module.SingleFrameSweep(
        JaxConfig(use_pallas=False, **cfg), variables).sweep_video(
            frames, batch=4))
    sweep = make_sweep(Config(**cfg), copy.deepcopy(model), device="cpu")
    assert isinstance(sweep, SingleFrameSweep)
    sweep.bucket_quantum = 4
    got = sweep.sweep_video(frames, batch=4)
    assert got.shape == (5, 21)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    clip_path = make_infer_fn(Config(**cfg), copy.deepcopy(model),
                              device="cpu")({"clip": frames[:, None]})
    np.testing.assert_allclose(got, clip_path.numpy(), rtol=2e-3, atol=2e-4)


# -- C5: tsav's 22 columns -----------------------------------------------------

@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("zoo_conv_serve")
    root, labels = str(base / "root"), str(base / "labels")
    generate_synthetic_dataset(root, labels, n_videos=2, frames_per_video=10,
                               image_size=32, splits=["test", "train"])
    return dict(root=root, lmdb_label_dir=labels,
                cache_dir=str(base / "cache"), batch_size=4, host_threads=2)


def test_tsav_output_maps_to_21_columns(dirs, tmp_path):
    """ROADMAP.md C5. JAX's run_inference writes each batch into a
    (rows, 21) matrix and raises on tsav's (B, 22); its loss suite reads
    columns 19 and 20 as VA, which for tsav are the 8th EX logit and
    valence. The port maps tsav's [12 AU | 8 EX | 2 VA] to [0:12 | 12:19 |
    20:22] in one place (``output_table``), which its run_inference, loss
    suite (through the train and eval steps) and evaluation read."""
    cfg = conv_config("tsav", image_size=32)
    _, _, model, variables, _, _ = sides("tsav")
    with pytest.raises(ValueError, match="broadcast"):
        jax_infer.run_inference(JaxConfig(use_pallas=False, **dirs, **cfg),
                                variables, result_path=str(tmp_path / "jax"))

    pcfg = Config(**dirs, **cfg)
    dataset = Aff2TestDataset(pcfg)
    got = run_inference(pcfg, copy.deepcopy(model), dataset=dataset,
                        result_path=str(tmp_path / "port"), device="cpu")
    assert got.shape == (len(dataset), 21)
    # the module's own 22 columns (JAX's, test_conv_model_matches_jax)
    rows = 0
    for batch in tinfer.testset_loader(pcfg, model, dataset):
        x = model_inputs(batch)
        with torch.inference_mode():
            want = model({"clip": normalize_clip(torch.from_numpy(
                x["clip"])), "audio_features": torch.from_numpy(
                    x["audio_features"])}).numpy()
        assert want.shape == (len(batch["Index"]), 22)
        idx = np.asarray(batch["Index"])
        np.testing.assert_allclose(got[idx, :19], want[:, :19], **TOL)
        np.testing.assert_allclose(got[idx, 19:21], want[:, 20:22], **TOL)
        rows += len(idx)
    assert rows == int(dataset.test_ids.sum()) > 0

    out = np.random.RandomState(63).randn(4, 22).astype(np.float32)
    va = np.random.RandomState(64).uniform(-1, 1, (4, 2)).astype(np.float32)
    jax_va = float(JAX_SUITES["tsav"].get_va_loss(jnp.asarray(out),
                                                  jnp.asarray(va)))
    as_read = out.copy()
    as_read[:, 12:] = 0.0
    as_read[:, 19:21] = out[:, 19:21]   # the 8th EX logit and valence
    assert jax_va == float(JAX_SUITES["tsav"].get_va_loss(
        jnp.asarray(as_read), jnp.asarray(va)))
    table = output_table(torch.from_numpy(out)).numpy()
    np.testing.assert_array_equal(table, np.concatenate(
        [out[:, :12], out[:, 12:19], out[:, 20:22]], axis=1))
    port_va = float(SUITES["tsav"].get_va_loss(torch.from_numpy(table),
                                                torch.from_numpy(va)))
    np.testing.assert_allclose(port_va, float(JAX_SUITES["tsav"].get_va_loss(
        jnp.asarray(table), jnp.asarray(va))), rtol=1e-6)
    assert port_va != jax_va
