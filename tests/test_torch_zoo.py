"""The model zoo of auformer_torch against the JAX package, on the CPU.

Each of the seven zoo models the port serves (vformer, sformer under tasks
AU and VA, tformer, dsformer, vggformer, audio and the resnet baseline)
takes one seeded state dict in the reference ``.pth`` layout: the port
loads it with ``load_state_dict``, JAX through ``convert_checkpoint`` +
``merge_into`` over the model's abstract init tree (a parameter the
checkpoint did not cover would stay abstract and fail the forward). Both
run the same numpy input in f32 at 64x64, where every spatial transformer
sees more than one token (16 in the ResFormer trunk, 4 in the VGG trunk).
Then the five heads of ``nn/heads.py`` the registry does not build, and
one bf16 test over the new module kinds against flax with
``dtype=bfloat16``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auformer.core.config import Config as JaxConfig
from auformer.core.torch_import import convert_checkpoint, merge_into
from auformer.nn import blocks as jblocks
from auformer.nn import build_model as jax_build_model
from auformer.nn import example_batch as jax_example_batch
from auformer.nn import heads as jheads
from auformer.nn import vformer as jvformer
from auformer.nn import vggformer as jvggformer
from auformer_torch.core.config import Config
from auformer_torch.core.weights import (Exporter, load_weights,
                                         state_dict_from_jax)
from auformer_torch.nn import build_model, example_batch, heads
from auformer_torch.nn import vformer, vggformer
from auformer_torch.nn.registry import compute_autocast, prepare_inference
from auformer_torch.ops.attention import fused_attention
from test_torch_modules import assert_close, randomize

IMAGE = 64
BATCH = 2
# f32 logits, port against JAX: the same arithmetic in another order
TOL = dict(rtol=1e-4, atol=1e-5)

# id -> (model_name, modality, task, frames per clip)
MODELS = {
    "vformer": ("vformer", "V", "AU", 2),
    "sformer_au": ("sformer", "V", "AU", 1),
    "sformer_va": ("sformer", "V", "VA", 1),
    "tformer": ("tformer", "V", "AU", 2),
    "dsformer": ("dsformer", "V;M", "AU", 1),
    "vggformer": ("vggformer", "V", "AU", 2),
    "audio": ("audio", "A", "AU", 2),
    "resnet": ("resnet", "V", "AU", 1),
}


def zoo_config(case: str, **kw) -> dict:
    name, modality, task, t = MODELS[case]
    return {**dict(model_name=name, modality=modality, task=task, n_frames=t,
                   dilation=1, image_size=IMAGE, compute_dtype="float32"),
            **kw}


def seeded_state_dict(model: torch.nn.Module, seed: int) -> dict:
    """numpy weights for every key of the port's (= reference .pth)
    layout: kernels ~ N(0, 1/fan_in), norm scales ~ 1 + noise, running
    variances in [1, 1.3), embeddings ~ N(0, 1), the rest ~ N(0, 0.01)."""
    rs = np.random.RandomState(seed)
    sd = {}
    for key, t in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        shape = tuple(t.shape)
        name = key.rsplit(".", 1)[-1]
        if name == "running_var":
            v = 1.0 + 0.3 * rs.rand(*shape)
        elif name == "weight" and len(shape) == 1:
            v = 1.0 + 0.1 * rs.randn(*shape)
        elif name == "weight":
            v = rs.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        elif name in ("pos_embedding", "cls_token"):
            v = rs.randn(*shape)
        else:
            v = 0.1 * rs.randn(*shape)
        sd[key] = v.astype(np.float32)
    return sd


def jax_variables(cfg: dict, sd: dict):
    jcfg = JaxConfig(use_pallas=False, **cfg)
    model = jax_build_model(jcfg)
    abstract = jax.eval_shape(
        functools.partial(model.init, train=False),
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jax_example_batch(jcfg, batch_size=2))
    return model, merge_into(dict(abstract),
                             convert_checkpoint(cfg["model_name"], sd))


_SIDES: dict = {}


def sides(case: str):
    """(cfg, sd, port model, JAX model, JAX variables, inputs, JAX
    logits), built once per case for every test of the module."""
    if case not in _SIDES:
        cfg = zoo_config(case)
        model = build_model(Config(**cfg))
        sd = seeded_state_dict(model, seed=sorted(MODELS).index(case))
        load_weights(model, sd)
        jmodel, variables = jax_variables(cfg, sd)
        x = example_batch(Config(**cfg), batch_size=BATCH,
                          rng=np.random.RandomState(5))
        want = np.asarray(jax.jit(functools.partial(
            jmodel.apply, train=False))(variables, x))
        _SIDES[case] = (cfg, sd, model.eval(), jmodel, variables, x, want)
    return _SIDES[case]


@pytest.mark.parametrize("case", sorted(MODELS))
def test_zoo_model_matches_jax(case):
    """(B, 21) f32 logits of the port's forward against JAX's."""
    _, _, model, _, _, x, want = sides(case)
    with torch.inference_mode():
        got = model({k: torch.from_numpy(v) for k, v in x.items()})
    assert got.shape == (BATCH, 21) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if case == "audio":
        assert not got[:, 12:].any()          # the AU slice alone


@pytest.mark.parametrize("case", sorted(MODELS))
def test_state_dict_from_jax_inverts_the_converter(case):
    cfg, sd, _, _, variables, _, _ = sides(case)
    back = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables),
                               cfg["model_name"])
    assert set(back) == set(sd)
    for key, value in sd.items():
        np.testing.assert_array_equal(back[key].numpy(), value, err_msg=key)


def test_example_batch_matches_jax():
    for case in MODELS:
        cfg = zoo_config(case)
        got = example_batch(Config(**cfg), batch_size=3)
        want = jax_example_batch(JaxConfig(**cfg), batch_size=3)
        assert {k: v.shape for k, v in got.items()} == \
            {k: v.shape for k, v in want.items()}, case
    single = zoo_config("sformer_au", n_frames=16)
    assert example_batch(Config(**single), 2)["clip"].shape[1] == 1


def test_unknown_names_fall_back_to_the_resnet_baseline():
    """As the reference's dispatch (train.py:315); the first convolution
    takes the clip's channels, as JAX's shape-inferred one does."""
    for modality, channels in (("V", 3), ("V;M", 4), ("M", 1)):
        model = build_model(Config(model_name="no_such_model",
                                   modality=modality))
        assert type(model).__name__ == "ImageResNetModel"
        assert model.base_model.conv1.in_channels == channels
    with pytest.raises(ValueError, match="V;M"):
        build_model(Config(model_name="dsformer", modality="V"))


# the convolution families (tests/test_torch_zoo_conv.py): id -> (model,
# modality, task, frames per clip)
CONV_MODELS = {"van": ("van", "V", "AU", 1),
               "emonet": ("emonet", "V", "AU", 1),
               "i3d": ("i3d", "V", "AU", 4), "mc3d": ("mc3d", "V", "AU", 4),
               "tsav": ("tsav", "A;V", "AU", 4)}


@pytest.mark.parametrize("case", sorted(MODELS) + sorted(CONV_MODELS))
def test_prepare_inference_rounds_every_conv_and_linear(case):
    """Under bf16 every Conv2d, Conv3d and Linear weight of the model is
    rounded once; every other parameter and statistic stays f32; the zoo
    has no other convolution kind."""
    name, modality, task, t = {**MODELS, **CONV_MODELS}[case]
    cfg = Config(model_name=name, modality=modality, task=task, n_frames=t,
                 image_size=IMAGE, compute_dtype="bfloat16")
    model = prepare_inference(cfg, build_model(cfg), torch.device("cpu"))
    convs = (torch.nn.Conv2d, torch.nn.Conv3d)
    kinds = {type(m) for m in model.modules() if not list(m.children())}
    assert not any(k.__name__.startswith("Conv")
                   and not issubclass(k, convs) for k in kinds)
    rounded = {f"{n}.weight" for n, m in model.named_modules()
               if isinstance(m, convs + (torch.nn.Linear,))}
    for name, t in model.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            want = torch.bfloat16 if name in rounded else torch.float32
            assert t.dtype == want, name


# -- the heads the registry does not build -------------------------------------

def carry(jmodule, tmodule, x_jax, export, seed, **init_kw):
    """``test_torch_modules.carry`` with the JAX module's variables drawn
    over its abstract init (no eager init): randomized, then exported into
    the port module."""
    abstract = jax.eval_shape(functools.partial(jmodule.init, **init_kw),
                              jax.random.PRNGKey(0), x_jax)
    variables = randomize(abstract, seed)
    e = Exporter(variables)
    export(e)
    load_weights(tmodule, e.sd)
    return variables, tmodule.eval()

HEAD_CASES = {
    "va_former": (lambda: jheads.VAFormerHead(input_dim=64, emb_dim=32),
                  lambda: heads.VAFormerHead(input_dim=64, emb_dim=32),
                  lambda e: e.va_former("", "")),
    "au_multihead": (lambda: jheads.AUMultihead(64),
                     lambda: heads.AUMultihead(64),
                     lambda e: e.au_multihead("", "")),
    "au_multihead_inter": (lambda: jheads.AUMultihead(64, inter=True),
                           lambda: heads.AUMultihead(64, inter=True),
                           lambda e: e.au_multihead("", "")),
    "exp_head": (lambda: jheads.EXPHead(64), lambda: heads.EXPHead(64),
                 lambda e: e.dense_head("", "")),
    "va_head": (lambda: jheads.VAHead(64), lambda: heads.VAHead(64),
                lambda e: e.dense_head("", "")),
    "multitask": (lambda: jheads.MultiTaskHead(64),
                  lambda: heads.MultiTaskHead(64),
                  lambda e: e.multitask_head("", "")),
}


@pytest.mark.parametrize("name", sorted(HEAD_CASES))
def test_head_matches_jax(name):
    jmake, tmake, export = HEAD_CASES[name]
    x = np.random.RandomState(14).randn(4, 64).astype(np.float32)
    jmod, tmod = jmake(), tmake()
    v, tmod = carry(jmod, tmod, x, export, 15, train=False)
    got = tmod(torch.from_numpy(x))
    want = jax.jit(functools.partial(jmod.apply, train=False))(v, x)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_close(g, w)


def test_video_model_fc_matches_jax():
    """VideoModel with the torch model's optional ``fc`` (num_classes)."""
    x = np.random.RandomState(20).randn(2, 2, 32, 32, 3).astype(np.float32)
    jmod = jvformer.VideoModel(num_channels=3, n_frames=2, num_classes=21)
    tmod = vformer.VideoModel(num_channels=3, n_frames=2, num_classes=21)

    def export(e):
        e.resformer("s_former", "s_former")
        e.tformer("t_former", "t_former")
        e.linear("fc", "fc")
    v, tmod = carry(jmod, tmod, x, export, 21, train=False)
    with torch.inference_mode():
        got = tmod(torch.from_numpy(x))
    assert got.shape == (2, 21)
    assert_close(got, jax.jit(functools.partial(jmod.apply, train=False))(
        v, x))


def test_vgg_conv_trunk_matches_jax():
    """The no-transformer VGG ablation: resnet50 trunk, 1x1 conv, mean."""
    x = np.random.RandomState(22).randn(2, 32, 32, 3).astype(np.float32)
    jmod, tmod = jvggformer.VGGConvTrunk(), vggformer.VGGConvTrunk()

    def export(e):
        e.vgg_trunk("VGG_model", "VGG_model")
        e.conv2d("conv", "conv")
    v, tmod = carry(jmod, tmod, x, export, 23, train=False)
    with torch.inference_mode():
        got = tmod(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    assert_close(got, jax.jit(functools.partial(jmod.apply, train=False))(
        v, x))


@pytest.mark.parametrize("name", ["exp_head", "va_head"])
def test_inter_heads_take_the_inter_embedding(name):
    """EXP and VA heads with ``inter``: the 64-dim embedding of the head
    before them goes in front of their own hidden layer."""
    jcls = {"exp_head": jheads.EXPHead, "va_head": jheads.VAHead}[name]
    tcls = {"exp_head": heads.EXPHead, "va_head": heads.VAHead}[name]
    rs = np.random.RandomState(16)
    x = rs.randn(4, 64).astype(np.float32)
    inter = rs.randn(4, 64).astype(np.float32)
    jmod, tmod = jcls(64, inter=True), tcls(64, inter=True)
    variables = carry(jmod, tmod, x, lambda e: e.dense_head("", ""), 17,
                      inter_emb=inter, train=False)[0]
    got = tmod(torch.from_numpy(x), torch.from_numpy(inter))
    want = jax.jit(functools.partial(jmod.apply, train=False))(
        variables, x, inter)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert_close(g, w)
    with pytest.raises(ValueError, match="inter"):
        tmod(torch.from_numpy(x))


# -- bf16: the new module kinds against flax with dtype=bfloat16 ---------------

def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# name -> (flax module of a dtype, port module, exporter mapper, input
# shape, input arrives in bf16, norm-relative tolerance). Measured, bf16 /
# the f32 control, norm-relative to flax's bf16 result: bottleneck 0 /
# 3.9e-3, N=16 transformer 1.3e-3 / 4.3e-3, VA head 3.5e-4 / 3.0e-3, MLP
# head 0 / 4.1e-3.
BF16_CASES = {
    # conv -> BN -> relu, three times, with a strided downsample
    "bottleneck": (
        lambda d: jvggformer.Bottleneck(64, 2, True, d),
        lambda: vggformer.Bottleneck(128, 64, 2, True),
        lambda e: e.bottleneck("m", "m"), (4, 128, 8, 8), True, 2e-3),
    # the VGG trunk's N=16 spatial transformer (dim 512, MLP 512)
    "spatial_n16": (
        lambda d: jblocks.Transformer(512, 1, 8, 32, 512, dtype=d),
        lambda: vggformer.Transformer(512, 1, 8, 32, 512),
        lambda e: e.transformer("m", "m"), (8, 16, 512), True, 3e-3),
    # the VA head: BN, 2 token linears, an N=2 transformer, 2 logits
    "va_former": (
        lambda d: jheads.VAFormerHead(dtype=d),
        lambda: heads.VAFormerHead(),
        lambda e: e.va_former("m", "m"), (16, 512), True, 1e-3),
    # BN -> Linear -> BN -> Linear
    "mlp_head": (
        lambda d: jvformer.MLPHead(dtype=d),
        lambda: vformer.MLPHead(),
        lambda e: e.mlp_head("m", "m"), (16, 512), True, 2e-3),
}


@pytest.fixture
def pallas_attention(monkeypatch):
    """The JAX attention through the Pallas kernel in interpret mode, and
    GELU in f32 rounded once (the port's one documented departure), as
    ``tests/test_torch_train.py::jax_bf16_reference`` runs them."""
    from test_torch_train import _kernel_attention
    calls = []

    def kernel(q, k, v, scale, mask=None, use_pallas=False):
        calls.append(q.shape)
        return _kernel_attention(q, k, v, scale)
    monkeypatch.setattr(jblocks, "fused_attention", kernel)
    monkeypatch.setattr(jblocks, "tanh_gelu", lambda x: jax.nn.gelu(
        x.astype(jnp.float32), approximate=True).astype(x.dtype))
    return calls


@pytest.mark.parametrize("name", sorted(BF16_CASES))
def test_bf16_new_modules_match_flax(name, pallas_attention):
    """Each new module kind in eval mode under the port's inference casts
    (``compute_autocast``, Conv2d and Linear weights rounded once by
    ``prepare_inference``) against the flax module with dtype=bfloat16 run
    op by op; the port's f32 forward is the control that must miss. Linear
    biases are zero (the port adds a bias before its one rounding, flax
    after, tests/test_torch_train.py::DENSE_BIASES)."""
    jmake, tmake, export, shape, in_bf16, tol = BF16_CASES[name]
    rs = np.random.RandomState(18)
    x = rs.randn(*shape).astype(np.float32)
    if name == "bottleneck":
        x = np.abs(x)                          # a post-ReLU activation
    nhwc = x.ndim == 4
    xj = x.transpose(0, 2, 3, 1) if nhwc else x
    kwargs = {"train": False} if name != "spatial_n16" else {}
    variables = randomize(jax.eval_shape(functools.partial(
        jmake(jnp.float32).init, **kwargs), jax.random.PRNGKey(0), xj), 19)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: (np.zeros_like(v) if p[-1].key == "bias"
                      and any(getattr(k, "key", "") in ("fc1", "fc2",
                                                        "to_out")
                              for k in p[:-1]) else v),
        variables["params"])
    variables = {"params": params,
                 "batch_stats": variables.get("batch_stats", {})}
    e = Exporter({"params": {"m": params},
                  "batch_stats": {"m": variables["batch_stats"]}})
    export(e)
    want = jmake(jnp.bfloat16).apply(
        variables, jnp.asarray(xj, jnp.bfloat16 if in_bf16 else jnp.float32),
        **kwargs)
    want = want[0] if isinstance(want, tuple) else want
    want = np.asarray(want.astype(jnp.float32))
    if nhwc:
        want = want.transpose(0, 3, 1, 2)
    outs = {}
    for dtype in ("bfloat16", "float32"):
        cfg = Config(compute_dtype=dtype)
        module = tmake()
        load_weights(module, {k[2:]: v for k, v in e.sd.items()})
        prepare_inference(cfg, module, torch.device("cpu"))
        xt = torch.from_numpy(x)
        if in_bf16 and dtype == "bfloat16":
            xt = xt.bfloat16()
        with torch.inference_mode(), compute_autocast(cfg, "cpu"):
            out = module(xt)
        outs[dtype] = (out[0] if isinstance(out, tuple) else out).float()
    err = _rel(outs["bfloat16"].numpy(), want)
    control = _rel(outs["float32"].numpy(), want)
    assert err <= tol < control, (err, control)
    if name == "va_former":
        assert pallas_attention and all(s[2] == 2 for s in pallas_attention)


def test_new_attention_sites_pass_the_kernel_check(monkeypatch):
    """The new sites' strided q, k, v views (the fused QKV of the N=2 VA
    head, the N=16 VGG spatial transformer and the 1536-wide T-Former)
    satisfy ``check_kernel_inputs``, as they reach the kernel on the card."""
    from auformer_torch.nn import blocks as tblocks
    from auformer_torch.ops.attention import check_kernel_inputs
    seen = []

    def spy(q, k, v, scale, mask=None):
        check_kernel_inputs(q, k, v)
        seen.append(tuple(q.shape))
        return fused_attention(q, k, v, scale)
    monkeypatch.setattr(tblocks, "fused_attention", spy)
    for dim, heads_, dim_head, n in ((128, 8, 32, 2), (512, 8, 32, 16),
                                     (1536, 8, 64, 17)):
        for dtype in (torch.float32, torch.bfloat16):
            att = tblocks.Attention(dim, heads_, dim_head).to(dtype)
            with torch.inference_mode():
                att(torch.randn(3, n, dim, dtype=dtype))
    assert seen == [(3, 8, 2, 32)] * 2 + [(3, 8, 16, 32)] * 2 + \
        [(3, 8, 17, 64)] * 2
