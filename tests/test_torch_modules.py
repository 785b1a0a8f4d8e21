"""auformer_torch modules against their JAX counterparts.

Each JAX module is initialized, its every parameter and BatchNorm statistic
is redrawn from a numpy seed, and the tree is carried into the port's module
by ``core/weights.py::Exporter`` (the mappers behind
``state_dict_from_jax``). Both run the same numpy input in fp32 on the CPU.
"""
import jax
import numpy as np
import pytest
import torch

from auformer.nn import blocks as jblocks
from auformer.nn import heads as jheads
from auformer.nn import resnet as jresnet
from auformer.nn import vformer as jvformer
from auformer.ops import preprocess as jpreprocess
from auformer_torch.core.weights import Exporter, load_weights
from auformer_torch.nn import blocks, heads, resnet, vformer
from auformer_torch.ops import attention as tatt
from auformer_torch.ops import preprocess

RTOL, ATOL = 1e-4, 1e-5


def randomize(variables, seed):
    """Redraw every leaf: kernels ~ N(0, 1/fan_in), norm scales ~ 1 + noise,
    other params ~ N(0, 0.1^2) (positional embeddings N(0, 1)), running
    means ~ N(0, 0.1^2) and running variances in [1, 1.3)."""
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = np.shape(leaf)
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
            v = rs.randn(*shape) / np.sqrt(fan_in)
        elif name == "scale":
            v = 1.0 + 0.1 * rs.randn(*shape)
        elif name == "var":
            v = 1.0 + 0.3 * rs.rand(*shape)
        elif name in ("pos_embedding", "cls_token"):
            v = rs.randn(*shape)
        else:
            v = 0.1 * rs.randn(*shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(variables))


def carry(jmodule, tmodule, x_jax, export, seed, **init_kw):
    """Init + randomize the JAX module, export into the port module."""
    variables = randomize(
        jmodule.init(jax.random.PRNGKey(0), x_jax, **init_kw), seed)
    e = Exporter(variables)
    export(e)
    load_weights(tmodule, e.sd)
    return variables, tmodule.eval()


def assert_close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("heads_,dim_head", [(8, 8), (1, 64)])
def test_transformer(heads_, dim_head):
    """(1, 64) drops the output projection (project_out rule)."""
    dim, depth, mlp = 64, 2, 128
    x = np.random.RandomState(0).randn(3, 12, dim).astype(np.float32)
    jmod = jblocks.Transformer(dim, depth, heads_, dim_head, mlp)
    tmod = blocks.Transformer(dim, depth, heads_, dim_head, mlp)
    v, tmod = carry(jmod, tmod, x, lambda e: e.transformer("", ""), 1)
    assert_close(tmod(torch.from_numpy(x)), jmod.apply(v, x))


@pytest.mark.parametrize("heads_,dim_head", [(8, 8), (4, 32), (1, 64)])
def test_attention_copies_no_head_layout(monkeypatch, heads_, dim_head):
    """``Attention.forward`` hands ``fused_attention`` the head split of
    its own to_qkv output (views of that storage, which the kernel's input
    check accepts), merges the heads of the result as a view, and still
    matches the JAX module."""
    dim, depth, mlp = 64, 1, 128
    x = np.random.RandomState(4).randn(3, 17, dim).astype(np.float32)
    jmod = jblocks.Transformer(dim, depth, heads_, dim_head, mlp)
    tmod = blocks.Transformer(dim, depth, heads_, dim_head, mlp)
    variables, tmod = carry(jmod, tmod, x,
                            lambda e: e.transformer("", ""), 6)
    attn = tmod.layers[0][0].fn.fn
    seen = {}
    attn.to_qkv.register_forward_hook(
        lambda m, i, o: seen.__setitem__("qkv", o))
    if not isinstance(attn.to_out, torch.nn.Identity):
        attn.to_out.register_forward_pre_hook(
            lambda m, i: seen.__setitem__("merged", i[0]))

    def spy(q, k, v, scale, mask=None):
        seen["qkv_views"] = (q, k, v)
        tatt.check_kernel_inputs(q, k, v)
        seen["out"] = tatt.fused_attention(q, k, v, scale, mask)
        return seen["out"]

    monkeypatch.setattr(blocks, "fused_attention", spy)
    got = tmod(torch.from_numpy(x))
    qkv = seen["qkv"]
    q, k, v = seen["qkv_views"]
    step = heads_ * dim_head * qkv.element_size()
    assert q.data_ptr() == qkv.data_ptr()
    assert (k.data_ptr() - q.data_ptr(), v.data_ptr() - q.data_ptr()) == (
        step, 2 * step)
    assert all(t.untyped_storage().data_ptr()
               == qkv.untyped_storage().data_ptr() for t in (q, k, v))
    if "merged" in seen:
        assert seen["merged"].data_ptr() == seen["out"].data_ptr()
    assert_close(got, jmod.apply(variables, x))


def test_resnet18_32px():
    x = np.random.RandomState(2).randn(2, 32, 32, 3).astype(np.float32)
    jmod = jresnet.ResNet18()
    tmod = resnet.ResNet18(in_channels=3)
    v, tmod = carry(jmod, tmod, x, lambda e: e.resnet18("", ""), 3,
                    train=False)
    got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert_close(got, jmod.apply(v, x, train=False))


def test_resformer_trunk_32px():
    """2x2 layer3 map -> 4 spatial tokens, flattened row-major over (h, w)."""
    x = np.random.RandomState(4).randn(2, 32, 32, 3).astype(np.float32)
    jmod = jresnet.ResFormerTrunk()
    tmod = resnet.ResFormerTrunk(in_channels=3)
    v, tmod = carry(jmod, tmod, x, lambda e: e.resformer("", ""), 5,
                    train=False)
    got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert_close(got, jmod.apply(v, x, train=False))


def test_tformer():
    kw = dict(num_patches=4, dim=64, depth=2, heads=8, mlp_dim=128,
              dim_head=8)
    x = np.random.RandomState(6).randn(2, 4, 64).astype(np.float32)
    jmod = jvformer.TFormer(**kw)
    tmod = vformer.TFormer(**kw)
    v, tmod = carry(jmod, tmod, x, lambda e: e.tformer("", ""), 7)
    assert_close(tmod(torch.from_numpy(x)), jmod.apply(v, x))


def test_au_former_head():
    kw = dict(input_dim=64, emb_dim=32, mlp_dim=64)
    x = np.random.RandomState(8).randn(4, 64).astype(np.float32)
    jmod = jheads.AUFormerHead(**kw)
    tmod = heads.AUFormerHead(**kw)
    v, tmod = carry(jmod, tmod, x, lambda e: e.au_former("", ""), 9,
                    train=False)
    logits, tokens = tmod(torch.from_numpy(x))
    jlogits, jtokens = jmod.apply(v, x, train=False)
    assert_close(logits, jlogits)
    assert_close(tokens, jtokens)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_normalize_clip(channels):
    clip = np.random.RandomState(12).randint(
        0, 256, (2, 3, 8, 8, channels)).astype(np.uint8)
    got = preprocess.normalize_clip(torch.from_numpy(clip))
    assert_close(got, jpreprocess.normalize_clip(clip))
    back = preprocess.denormalize_clip(got)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jpreprocess.denormalize_clip(
            jpreprocess.normalize_clip(clip))))
    np.testing.assert_array_equal(back.numpy(), clip)


def test_normalize_spec_batch():
    feats = np.random.RandomState(13).randn(2, 1, 64, 20).astype(np.float32)
    assert_close(preprocess.normalize_spec_batch(torch.from_numpy(feats)),
                 jpreprocess.normalize_spec_batch(feats))


def test_random_flip_clips_flips_whole_clips():
    """One draw per clip, the same for all its frames (the draws come from
    a torch.Generator, so they are not JAX's bits)."""
    clip = torch.arange(16 * 2 * 2 * 3 * 1, dtype=torch.float32).reshape(
        16, 2, 2, 3, 1)
    gen = torch.Generator().manual_seed(0)
    out = preprocess.random_flip_clips(clip, gen)
    flipped = [bool(torch.equal(out[i], clip[i].flip(2))) for i in range(16)]
    kept = [bool(torch.equal(out[i], clip[i])) for i in range(16)]
    assert all(f != k for f, k in zip(flipped, kept))
    assert 0 < sum(flipped) < 16


def test_former_au_head():
    x = np.random.RandomState(10).randn(2, 12, 64).astype(np.float32)
    jmod = jheads.FormerAUHead(emb_dim=64)
    tmod = heads.FormerAUHead(emb_dim=64)
    v, tmod = carry(jmod, tmod, x, lambda e: e.former_au_head("", ""), 11)
    assert_close(tmod(torch.from_numpy(x)), jmod.apply(v, x))
