"""auformer_torch training against the JAX package, on the CPU.

  * the attention gradient (``_FusedAttention``'s recomputing backward)
    against ``auformer.ops.attention._pallas_attention_bwd``, f32 and bf16;
  * train-mode BatchNorm running statistics against flax (biased variance);
  * ``make_optimizer`` against optax over 65 steps: the x0.1 / x0.01
    boundaries at epochs 30 and 60, warmup, global-norm clip, L2, frozen
    leaves;
  * one avformer train step (image 32, T=16, B=4, dropout 0, left-right
    symmetric clips so the random flip is the identity) against
    ``make_train_step(..., mesh=None)``: loss, fusion-head gradients,
    parameters and BatchNorm statistics after 3 steps, a 5-step loss
    trajectory;
  * bf16: each kind of module of the step under autocast against the flax
    module with dtype=bfloat16 (outputs, dtypes and gradients, with an f32
    control that must miss the tolerance), and one bf16 step against
    JAX's;
  * ``train_lib.train`` on the port's fixtures with ``device="cpu"``:
    checkpoints, curves, scores, resume, determinism; the checkpoint loads
    into the JAX package and into the port's ``test_aff2``;
  * the entry point's own runs are in tests/test_torch_train_entry.py,
    whose fixtures the train loop tests share (one intra-op thread from
    the first train loop on).

One synthetic reference-layout state dict
(``tests/test_torch_import.py::synthetic_avformer_sd``) loads into both
packages; the JAX step is compiled once per module.
"""
import functools
import json
import os
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from jax.experimental import pallas as pl

from auformer.core.config import Config as JaxConfig
from auformer.core.torch_import import (convert_avformer, convert_checkpoint,
                                        load_torch_state_dict, merge_into)
from auformer.nn import blocks as jblocks
from auformer.nn import build_model as jax_build_model
from auformer.nn import example_batch, loss_suite as jax_loss_suite
from auformer.nn.heads import AUFormerHead, FormerAUHead
from auformer.nn.resnet import BasicBlock
from auformer.nn.vformer import TFormer
from auformer.ops import attention as jattention
from auformer.ops.attention import _pallas_attention_bwd
from auformer.parallel import step as jstep
from auformer_torch import train as train_entry
from auformer_torch import train_lib
from auformer_torch.core.config import Config
from auformer_torch.core.prng import key_seq, setup_seed
from auformer_torch.core.weights import (Exporter, load_weights,
                                         state_dict_from_jax)
from auformer_torch.nn import build_model, loss_suite
from auformer_torch.nn.blocks import (Attention, BatchNorm1d, BatchNorm2d,
                                      Dropout, set_dropout_generator)
from auformer_torch.ops.attention import (attention_backward_reference,
                                          attention_reference,
                                          fused_attention)
from auformer_torch.parallel import step as tstep
from test_torch_import import synthetic_avformer_sd  # noqa: F401 (fixture)
from test_torch_train_entry import (  # noqa: F401 (fixtures)
    _argv, fixture_dirs, one_intra_op_thread)

ATTN_TOL = {torch.float32: (1e-5, 1e-6),
            # one bf16 ulp where the f32 sums round differently
            torch.bfloat16: (1e-2, 1e-3)}
STEP_CFG = dict(model_name="avformer", modality="A;V", task="AU",
                n_frames=16, image_size=32, compute_dtype="float32",
                dropout_rate=0.0, batch_size=4, learning_rate=1e-3)
# the loss, the fusion-head gradients and the parameters at the full f32
# forward's tolerance (rtol 2e-3 / atol 2e-4, tests/test_torch_slice.py):
# the two packages' convolutions sum in different orders
LOSS_TOL = GRAD_TOL = (2e-3, 2e-4)
# BatchNorm statistics after 3 steps: batch means and biased variances of
# activations that agree to the forward's tolerance
STATS_TOL = (1e-3, 1e-4)


# -- the attention gradient ---------------------------------------------------

SITES = {"fusion_head": (4, 12, 32), "spatial": (4, 49, 32),
         "temporal": (2, 17, 64)}


def _qkv(site, seed, dtype):
    b, n, d = SITES[site]
    rs = np.random.RandomState(seed)
    q, k, v, g = (torch.from_numpy(rs.randn(b, 8, n, d).astype(np.float32))
                  .to(dtype) for _ in range(4))
    return q, k, v, g, d ** -0.5


def _jnp(t):
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("site", sorted(SITES))
def test_attention_backward_matches_jax(site, dtype):
    q, k, v, g, scale = _qkv(site, 1, dtype)
    got = attention_backward_reference(q, k, v, g, scale)
    want = _pallas_attention_bwd(scale, (_jnp(q), _jnp(k), _jnp(v)), _jnp(g))
    rtol, atol = ATTN_TOL[dtype]
    for a, b in zip(got, want):
        assert a.dtype == dtype
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32),
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_function_routes_autograd_through_the_backward(dtype):
    """Attention.forward on a grad-requiring input: the output's grad_fn is
    the Function's, its result a view of (B, N, H, D) storage, and the
    to_qkv gradient equals autograd through attention_reference."""
    torch.manual_seed(0)
    attn = Attention(256, heads=8, dim_head=32).to(dtype)
    x = torch.randn(4, 12, 256).to(dtype)
    qkv = attn.to_qkv(x).reshape(4, 12, 3, 8, 32)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    out = fused_attention(q, k, v, attn.scale)
    assert type(out.grad_fn).__name__ == "_FusedAttentionBackward"
    assert out.transpose(1, 2).is_contiguous()
    out.float().square().sum().backward()
    got = attn.to_qkv.weight.grad.clone()

    attn.to_qkv.weight.grad = None
    qkv = attn.to_qkv(x).reshape(4, 12, 3, 8, 32)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    attention_reference(q, k, v, attn.scale).float().square().sum().backward()
    rtol, atol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(),
                               attn.to_qkv.weight.grad.float(),
                               rtol=rtol * 10, atol=atol * 10)
    assert got.abs().sum() > 0


def test_attention_function_under_autocast():
    """bf16 autocast on f32 weights: q, k, v reach the Function as one
    dtype (bf16) and the gradient reaches the f32 weight."""
    torch.manual_seed(1)
    attn = Attention(64, heads=8, dim_head=8)
    x = torch.randn(2, 12, 64)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        out = attn(x)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert attn.to_qkv.weight.grad.dtype == torch.float32
    assert attn.to_qkv.weight.grad.abs().sum() > 0


# -- BatchNorm and dropout ----------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 3), (6, 5, 7, 8)])
def test_batchnorm_running_stats_match_flax(shape):
    """One train-mode forward from mean 0 / var 1: flax's update uses the
    biased batch variance; so does the port's (torch's own would not)."""
    x = np.random.RandomState(2).randn(*shape).astype(np.float32) * 2 + 0.5
    nhwc = x if x.ndim == 2 else x.transpose(0, 2, 3, 1)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), nhwc)
    y, stats = bn.apply(variables, nhwc, mutable=["batch_stats"])
    port = (BatchNorm1d if x.ndim == 2 else BatchNorm2d)(shape[1]).train()
    got = port(torch.from_numpy(x))
    got = got if x.ndim == 2 else got.permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y),
                               rtol=1e-5, atol=1e-5)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(stats["batch_stats"][key]),
                                   rtol=1e-6, atol=1e-7)
    if x.ndim == 2:   # the numbers checked by hand against flax
        assert not np.allclose(
            port.running_var.numpy(),
            0.9 + 0.1 * x.var(axis=0, ddof=1), rtol=1e-4)


def test_dropout_draws_from_the_generator():
    drop = Dropout(0.5).train()
    x = torch.ones(64, 64)
    with pytest.raises(RuntimeError, match="generator"):
        drop(x)
    set_dropout_generator(drop, torch.Generator().manual_seed(4))
    a = drop(x)
    set_dropout_generator(drop, torch.Generator().manual_seed(4))
    torch.manual_seed(99)                     # the global RNG plays no part
    assert torch.equal(drop(x), a)
    assert set(a.unique().tolist()) == {0.0, 2.0}
    assert torch.equal(drop.eval()(x), x)
    assert torch.equal(Dropout(0.0).train()(x), x)


def test_key_seq_is_reproducible():
    a, b = key_seq(setup_seed(5)), key_seq(setup_seed(5))
    draws = [torch.rand(3, generator=a()) for _ in range(3)]
    assert all(torch.equal(d, torch.rand(3, generator=b())) for d in draws)
    assert not torch.equal(draws[0], draws[1])


# -- the optimizer ------------------------------------------------------------

class _Tiny(torch.nn.Module):
    """Three top-level parts named as avformer's."""

    def __init__(self):
        super().__init__()
        self.audio_model = torch.nn.Linear(3, 2)
        self.video_model = torch.nn.Linear(3, 2)
        self.au_head = torch.nn.Linear(3, 2)


@pytest.mark.parametrize("grad_clip,warmup", [(-1.0, 0), (0.5, 3)])
def test_make_optimizer_matches_optax(grad_clip, warmup):
    """65 Adam steps with given gradients, one step per epoch: the rate
    drops x0.1 at step 30 and x0.01 at step 60; warmup over the first
    steps; the global-norm clip over the trainable leaves only; L2 weight
    decay into the gradient; frozen leaves never move."""
    kw = dict(model_name="avformer", learning_rate=1e-2, weight_decay=0.05,
              lr_schedule=True, steps_per_epoch=1, grad_clip=grad_clip,
              n_warmup_steps=warmup)
    cfg = Config(**kw)
    torch.manual_seed(3)
    model = _Tiny()
    state = tstep.create_train_state(cfg, model)
    assert [n for n, p in model.named_parameters() if p.requires_grad] == [
        "au_head.weight", "au_head.bias"]

    def tree(get):
        return {part: {"kernel": get(getattr(model, part).weight),
                       "bias": get(getattr(model, part).bias)}
                for part in ("audio_model", "video_model", "au_head")}

    params = tree(lambda p: jnp.asarray(p.detach().numpy().copy()))
    frozen = tree(lambda p: p.detach().clone())
    tx = jstep.make_optimizer(JaxConfig(**kw), params)
    opt_state = tx.init(params)
    rs = np.random.RandomState(4)
    for i in range(65):
        g = {part: {"kernel": rs.randn(2, 3).astype(np.float32),
                    "bias": rs.randn(2).astype(np.float32)}
             for part in params}
        for part in ("audio_model", "video_model", "au_head"):
            mod = getattr(model, part)
            if mod.weight.requires_grad:
                mod.weight.grad = torch.from_numpy(g[part]["kernel"])
                mod.bias.grad = torch.from_numpy(g[part]["bias"])
        expected_lr = 1e-2 * (0.01 if i >= 60 else 0.1 if i >= 30 else 1.0) \
            * (min(1.0, (i + 1) / warmup) if warmup else 1.0)
        assert tstep.learning_rate(cfg, state.step) == pytest.approx(
            expected_lr)
        state.apply_gradients()
        updates, opt_state = tx.update(g, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        for part in ("audio_model", "video_model", "au_head"):
            for name in ("weight", "bias"):
                got = getattr(getattr(model, part), name).detach().numpy()
                want = params[part]["kernel" if name == "weight" else name]
                np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                           atol=1e-6, err_msg=f"{i} {part}")
    assert state.step == 65
    for part in ("audio_model", "video_model"):
        assert torch.equal(getattr(model, part).weight,
                           frozen[part]["kernel"])


# -- one avformer train step against JAX's --------------------------------------

@pytest.fixture(scope="module")
def jax_setup(synthetic_avformer_sd):
    """JAX model, the synthetic weights as its variables, its train step
    (compiled on first use) and a grad function of its loss."""
    cfg = JaxConfig(use_pallas=False, **STEP_CFG)
    model = jax_build_model(cfg)
    abstract = jax.eval_shape(
        functools.partial(model.init, train=False),
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        example_batch(cfg, batch_size=2))
    variables = merge_into(dict(abstract),
                           convert_avformer(synthetic_avformer_sd))
    suite = jax_loss_suite(model)
    step = jstep.make_train_step(cfg, model, suite, mesh=None, donate=False)

    @jax.jit
    def loss_and_grads(variables, batch):
        x = jstep.prep_batch(batch, train=False)
        x = {k: x[k] for k in model.modes}
        labels = jstep._labels_of(batch)

        def loss_fn(params):
            out, _ = model.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                x, train=True, rngs={"dropout": jax.random.PRNGKey(0)},
                mutable=["batch_stats"])
            return jstep.task_loss(suite, cfg.task, out, labels)[0]
        return jax.value_and_grad(loss_fn)(variables["params"])
    return cfg, model, variables, step, loss_and_grads


def _symmetric_batch(seed):
    """B=4 batch: left-right symmetric uint8 clips (the random flip is the
    identity), host features, labels with ignored rows and cells."""
    rs = np.random.RandomState(seed)
    half = rs.randint(0, 256, (4, 16, 32, 16, 3)).astype(np.uint8)
    clip = np.concatenate([half, half[:, :, :, ::-1]], axis=3)
    au = rs.randint(0, 2, (4, 12)).astype(np.int8)
    au[1, 0] = -1                                 # an ignored row
    au[2, 5] = -1                                 # an ignored cell (kept)
    return {"clip": clip,
            "audio_features": rs.randn(4, 1, 64, 1001).astype(np.float32),
            "AU": au, "EX": rs.randint(-1, 7, (4, 1)).astype(np.int8),
            "VA": rs.uniform(-1, 1, (4, 2)).astype(np.float32)}


def _port_model(sd):
    torch.manual_seed(0)
    model = build_model(Config(**STEP_CFG), dtype=torch.float32)
    load_weights(model, sd)
    return model


def _tensors(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def test_train_step_gradients_match_jax(jax_setup, synthetic_avformer_sd):
    """The loss and every fusion-head gradient of one train-mode forward;
    the frozen streams get none."""
    cfg_j, _, variables, _, loss_and_grads = jax_setup
    batch = _symmetric_batch(10)
    want_loss, grads = loss_and_grads(variables, batch)
    e = Exporter({"params": jax.tree_util.tree_map(np.asarray, grads)})
    e.former_au_head("au_head", "au_head")

    cfg = Config(**STEP_CFG)
    model = _port_model(synthetic_avformer_sd)
    tstep.make_optimizer(cfg, model)              # freezes the streams
    x = tstep.prep_batch(_tensors(batch), train=False)
    model.train()
    out = tstep._forward(cfg, model, x)
    loss, _ = tstep.task_loss(loss_suite(model), "AU", out,
                              tstep._labels_of(_tensors(batch)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), *LOSS_TOL)
    named = dict(model.named_parameters())
    assert set(e.sd) == {n for n, p in named.items() if p.requires_grad}
    for key, want in e.sd.items():
        got = named[key].grad
        np.testing.assert_allclose(got.numpy(), want.numpy(), *GRAD_TOL,
                                   err_msg=key)
    assert all(p.grad is None for n, p in named.items()
               if not p.requires_grad)
    qkv = named["au_head.corr_transformer.layers.0.0.fn.fn.to_qkv.weight"]
    assert qkv.grad.abs().sum() > 0


def _check_adam_params(pairs, steps):
    """The trained parameters (``pairs``: key -> (port, JAX)) after
    ``steps`` Adam steps: 99.9 % of all their elements within GRAD_TOL,
    every element within 2 lr per step. Adam's normalised update is about
    +-lr for ANY nonzero gradient, so an element whose gradient lies within
    the tolerance of 0 may step either way."""
    rtol, atol = GRAD_TOL
    close = []
    for key, (got, want) in pairs.items():
        diff = np.abs(got - want)
        close.append((diff <= atol + rtol * np.abs(want)).reshape(-1))
        assert diff.max() <= 2 * steps * STEP_CFG["learning_rate"], key
    assert np.concatenate(close).mean() >= 0.999


def test_train_steps_match_jax(jax_setup, synthetic_avformer_sd):
    """5 steps of make_train_step on both sides (different batches): the
    loss of every step, and after 3 steps every parameter (the frozen ones
    unchanged, the fusion head's as ``_check_adam_params``) and every
    BatchNorm statistic."""
    _, _, variables, step_j, _ = jax_setup
    state_j = jstep.create_train_state(JaxConfig(use_pallas=False,
                                                 **STEP_CFG),
                                       jax_setup[1], variables)
    cfg = Config(**STEP_CFG)
    model = _port_model(synthetic_avformer_sd)
    state = tstep.create_train_state(cfg, model)
    step = tstep.make_train_step(cfg, model, loss_suite(model))
    losses, losses_j = [], []
    for i in range(5):
        batch = _symmetric_batch(20 + i)
        metrics = step(state, _tensors(batch),
                       torch.Generator().manual_seed(i))
        state_j, metrics_j = step_j(state_j, batch, jax.random.PRNGKey(i))
        losses.append(float(metrics["loss"]))
        losses_j.append(float(metrics_j["loss"]))
        if i == 2:
            after = state_dict_from_jax(jax.tree_util.tree_map(
                np.asarray, {"params": state_j.params,
                             "batch_stats": state_j.batch_stats}))
            port = model.state_dict()
            trained = {}
            for key, want in after.items():
                got = port[key].numpy()
                if key.startswith(("audio_model", "video_model")) \
                        and "running_" not in key:
                    np.testing.assert_array_equal(
                        got, synthetic_avformer_sd[key], err_msg=key)
                if key.startswith("au_head"):
                    trained[key] = (got, want.numpy())
                    continue
                tol = STATS_TOL if "running_" in key else GRAD_TOL
                np.testing.assert_allclose(got, want.numpy(), *tol,
                                           err_msg=key)
            _check_adam_params(trained, 3)
    assert state.step == 5
    np.testing.assert_allclose(losses, losses_j, *LOSS_TOL)


# -- bf16: the JAX modules' casts -----------------------------------------------

def _kernel_attention(q, k, v, scale):
    """The Pallas attention kernel in interpret mode, as
    tests/test_attention.py runs it on the CPU: one program over every
    (batch*head) row. On the CPU the JAX package's dispatch takes the XLA
    path instead, which rounds P to bf16 before P.V; the TPU kernel (and
    the port's CUDA kernel) keeps P in f32."""
    b, h, n, d = q.shape
    spec = pl.BlockSpec((b * h, n, d), lambda i: (0, 0, 0))
    out = pl.pallas_call(
        functools.partial(jattention._attn_kernel, scale=scale),
        out_shape=jax.ShapeDtypeStruct((b * h, n, d), q.dtype), grid=(1,),
        in_specs=[spec] * 3, out_specs=spec, interpret=True)(
            *(t.reshape(b * h, n, d) for t in (q, k, v)))
    return out.reshape(b, h, n, d)


@functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
def _kernel_attention_ad(q, k, v, scale):
    return _kernel_attention(q, k, v, scale)


_kernel_attention_ad.defvjp(
    lambda q, k, v, scale: (_kernel_attention(q, k, v, scale), (q, k, v)),
    _pallas_attention_bwd)


@pytest.fixture
def jax_bf16_reference(monkeypatch):
    """The JAX modules as the bf16 comparisons run them: attention through
    the Pallas kernel and its custom_vjp backward (the TPU path), and the
    one elementwise chain where the port deliberately departs, GELU,
    evaluated in f32 and rounded once as the port's is (the JAX CPU
    backend rounds each of its primitives to bf16)."""
    monkeypatch.setattr(jblocks, "fused_attention",
                        lambda q, k, v, scale, mask=None, use_pallas=False:
                        _kernel_attention_ad(q, k, v, scale))
    monkeypatch.setattr(jblocks, "tanh_gelu", lambda x: jax.nn.gelu(
        x.astype(jnp.float32), approximate=True).astype(x.dtype))


# The other departure: a Linear's bias. flax's bf16 Dense rounds x.W to
# bf16 and then adds the bias rounded to bf16, two roundings; the port's
# fused bias add rounds once. With the Linear biases zero the second
# rounding is exact and the two agree; their gradients are still compared.
DENSE_BIASES = ("to_out.0.bias", "net.0.bias", "net.3.bias")


@pytest.fixture(scope="module")
def bf16_weights():
    """Reference-layout weights from the port's own initialisation (well
    conditioned: bf16 rounding moves the outputs by ~1e-3, not chaotically
    as the 0.1-scale synthetic weights do), Linear biases zero; and the
    JAX variables made from them."""
    torch.manual_seed(11)
    model = build_model(Config(**STEP_CFG), dtype=torch.float32)
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    for key in sd:
        if key.endswith(DENSE_BIASES):
            sd[key] = np.zeros_like(sd[key])
    return sd, convert_avformer(sd)


def _tree_rel(got: dict, want: dict, keys) -> float:
    """||got - want|| / ||want|| over the leaves ``keys``."""
    num = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in keys)
    return (num / sum(float(np.sum(want[k] ** 2)) for k in keys)) ** 0.5


class Bf16Case(NamedTuple):
    port: str                 # the port's module path in avformer
    jax: Callable             # dtype -> the flax module
    jax_path: tuple           # its variables' path in avformer's
    shape: tuple              # input shape
    out_shape: tuple          # output shape (of the cotangent)
    in_bf16: bool             # the input arrives in the compute dtype
    train: bool               # train-mode BatchNorm
    mapper: str | None        # Exporter mapper of the gradients; None:
    #                           forward only
    out_tol: float            # norm-relative, against JAX's bf16 result
    grad_tol: float | None


BF16_CASES = {
    # conv + train-mode BatchNorm with a downsample, bf16 in and out
    "resnet_block": Bf16Case(
        "audio_model.audio_model.resnet.layer2.0",
        lambda d: BasicBlock(128, 2, True, d),
        ("audio_model", "audio_model", "resnet", "layer2", "block0"),
        (8, 64, 8, 8), (8, 128, 4, 4), True, True, "resnet_block",
        1e-3, 2e-2),
    # train-mode BatchNorm1d over a B=64 batch, the f32 TokenProjection
    # and residual stream, the f32 TokenLogits
    "au_former": Bf16Case(
        "video_model.au_head", lambda d: AUFormerHead(input_dim=512, dtype=d),
        ("video_model", "au_head"), (64, 512), (64, 12), True, True,
        "au_former", 2e-3, 3e-3),
    # the trainable fusion head: f32 tokens in, f32 logits out
    "fusion_head": Bf16Case(
        "au_head", lambda d: FormerAUHead(emb_dim=256, dropout=0.0, dtype=d),
        ("au_head",), (16, 12, 256), (16, 12), False, False,
        "former_au_head", 1e-3, 2e-3),
    # a bf16 residual stream (the trunk's side); frozen in training, so
    # forward only
    "t_former": Bf16Case(
        "video_model.video_model.t_former",
        lambda d: TFormer(num_patches=16, dtype=d),
        ("video_model", "video_model", "t_former"), (8, 16, 512), (8, 512),
        True, False, None, 3e-3, None),
}


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_bf16(case: Bf16Case, variables, x, ct):
    """JAX's bf16 module, op by op (no jit: every flax module rounds where
    its dtype says, with no fusion keeping excess precision): the output
    and the parameter gradients of sum(out * ct), in the port's names and
    layouts (a 4-d input is NCHW to the port, NHWC to flax)."""
    nhwc = x.ndim == 4
    if nhwc:
        x = x.transpose(0, 2, 3, 1)
    module = case.jax(jnp.bfloat16)
    params, stats = variables["params"], variables["batch_stats"]
    for key in case.jax_path:
        params, stats = params[key], stats.get(key, {})
    xj = jnp.asarray(x).astype(jnp.bfloat16 if case.in_bf16 else jnp.float32)
    kwargs = {"train": True} if case.train else {}

    def f(p):
        out, _ = module.apply({"params": p, "batch_stats": stats}, xj,
                              mutable=["batch_stats"], **kwargs)
        out = out[0] if isinstance(out, tuple) else out
        if nhwc:
            out = out.transpose(0, 3, 1, 2)
        return jnp.sum(out.astype(jnp.float32) * ct), out
    if case.mapper is None:
        return f(params)[1], {}
    (_, out), grads = jax.value_and_grad(f, has_aux=True)(params)
    exporter = Exporter({"params": {"m": jax.tree_util.tree_map(np.asarray,
                                                                grads)},
                         "batch_stats": {"m": stats}})
    getattr(exporter, case.mapper)("m", "m")
    return out, {k[2:]: v.numpy() for k, v in exporter.sd.items()
                 if "running_" not in k}


def _port_run(case: Bf16Case, sd, x, ct, autocast: bool):
    """The port's module from ``sd``, under bf16 autocast or in f32: the
    output and the parameter gradients of sum(out * ct)."""
    model = build_model(Config(**STEP_CFG), dtype=torch.float32)
    load_weights(model, sd)
    module = model.get_submodule(case.port).train(case.train)
    xt = torch.from_numpy(x)
    if case.in_bf16 and autocast:
        xt = xt.bfloat16()
    with torch.autocast("cpu", dtype=torch.bfloat16, enabled=autocast):
        out = module(xt)
    out = out[0] if isinstance(out, tuple) else out
    if case.mapper is not None:
        (out.float() * torch.from_numpy(ct)).sum().backward()
    return out, {n: p.grad.numpy() for n, p in module.named_parameters()
                 if p.grad is not None}


@pytest.mark.parametrize("name", sorted(BF16_CASES))
def test_bf16_modules_match_flax(name, bf16_weights, jax_bf16_reference):
    """Each kind of module of the step under bf16 autocast against the flax
    module with dtype=bfloat16 on the same inputs: the output's dtype, the
    output and the gradients within the case's tolerance, and the f32 port
    (the control) outside it, so the tolerance tells the JAX modules' casts
    from none. A Linear's bias gradient is held to 5e-2 apart: flax sums
    its bf16 cotangent in bf16 (up to 2.4e-2 from the port's here), the
    port in f32."""
    case = BF16_CASES[name]
    sd, variables = bf16_weights
    rs = np.random.RandomState(12)
    x = rs.randn(*case.shape).astype(np.float32)
    if name == "resnet_block":
        x = np.abs(x)                           # a post-ReLU activation
    ct = rs.randn(*case.out_shape).astype(np.float32)
    want, want_grads = _jax_bf16(case, variables, x, ct)
    got, grads = _port_run(case, sd, x, ct, autocast=True)
    control, control_grads = _port_run(case, sd, x, ct, autocast=False)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    want = np.asarray(want.astype(jnp.float32))
    err = _rel(got.detach().float().numpy(), want)
    control_err = _rel(control.detach().numpy(), want)
    assert err <= case.out_tol < control_err, (err, control_err)
    if case.mapper is None:
        return
    assert set(grads) == set(want_grads)
    biases = [k for k in want_grads if k.endswith(DENSE_BIASES)]
    rest = [k for k in want_grads if k not in biases]
    err = _tree_rel(grads, want_grads, rest)
    control_err = _tree_rel(control_grads, want_grads, rest)
    assert err <= case.grad_tol < control_err, (err, control_err)
    for key in biases:
        assert _rel(grads[key], want_grads[key]) <= 5e-2, key


def test_bf16_train_step_matches_jax(bf16_weights, jax_bf16_reference):
    """One bf16 avformer train-mode forward and backward against JAX's
    (compute_dtype=bfloat16): loss within 1e-2, the fusion head's gradients
    within 1e-1 (norm-relative). At this level the frozen streams'
    train-mode BatchNorm (B=4 rows in AU_BN1, large means in the trunk)
    amplifies bf16 rounding noise: an f32 step lands as close to JAX's bf16
    one (here: logits 2.6e-2 and gradients 2.6e-2 from JAX's in f32, 3.3e-2
    and 3.7e-2 in bf16), so this test holds the bf16 path end to end, and
    the module cases above are the ones that tell the casts apart."""
    sd, variables = bf16_weights
    cfg_j = JaxConfig(use_pallas=False,
                      **{**STEP_CFG, "compute_dtype": "bfloat16"})
    model_j = jax_build_model(cfg_j)
    suite_j = jax_loss_suite(model_j)
    batch = _symmetric_batch(13)

    def loss_fn(params):
        x = jstep.prep_batch(batch, train=False)
        out, _ = model_j.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            {k: x[k] for k in model_j.modes}, train=True,
            rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        return jstep.task_loss(suite_j, "AU", out, jstep._labels_of(batch))[0]
    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        variables["params"])
    exporter = Exporter({"params": jax.tree_util.tree_map(np.asarray, grads)})
    exporter.former_au_head("au_head", "au_head")

    cfg = Config(**{**STEP_CFG, "compute_dtype": "bfloat16"})
    model = build_model(cfg, dtype=torch.float32)
    load_weights(model, sd)
    tstep.make_optimizer(cfg, model)
    model.train()
    out = tstep._forward(cfg, model, tstep.prep_batch(_tensors(batch),
                                                      train=False))
    loss, _ = tstep.task_loss(loss_suite(model), "AU", out,
                              tstep._labels_of(_tensors(batch)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-2)
    named = dict(model.named_parameters())
    want = {k: v.numpy() for k, v in exporter.sd.items()}
    assert _tree_rel({k: named[k].grad.numpy() for k in want}, want,
                     list(want)) <= 1e-1


def test_prep_batch_device_audio_matches_jax():
    """--device_audio: the step's features from left-aligned raw windows
    (reflect_end_patch + the left-aligned frontend) equal JAX's."""
    rs = np.random.RandomState(30)
    n_valid = np.array([441000, 300000], np.int32)
    raw = (rs.randn(2, 1, 441000) * 0.1).astype(np.float32)
    raw[1, :, 300000:] = 0.0
    batch = {"audio": raw, "audio_len": n_valid,
             "clip": np.zeros((2, 2, 8, 8, 3), np.uint8)}
    got = tstep.prep_batch(_tensors(batch), train=False, device_audio=True)
    want = jstep.prep_batch(batch, train=False, device_audio=True)
    np.testing.assert_allclose(got["audio_features"].numpy(),
                               np.asarray(want["audio_features"]),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["clip"].numpy(), np.asarray(want["clip"]),
                               rtol=1e-6, atol=1e-6)


# -- the train loop -----------------------------------------------------------

@pytest.fixture(scope="module")
def trained(fixture_dirs):
    """Two runs of 2 epochs x 3 steps with one seed (train_lib.train with
    a step cap; the entry point's parse + device="cpu")."""
    base, root, labels = fixture_dirs
    runs = []
    for exp in ("exp_a", "exp_b"):
        cfg = train_entry.parse_opt(_argv(base, root, labels, exp))
        runs.append(train_lib.train(cfg, max_steps_per_epoch=3,
                                    device="cpu"))
    return base, runs


def test_train_writes_checkpoints_curves_and_scores(trained):
    base, runs = trained
    state, history = runs[0]
    pretrain = base / "exp_a" / "pretrain"
    assert (pretrain / "latest.pth").is_file()
    assert (pretrain / "best.pth").is_file()
    curves = json.loads((base / "exp_a" / "curves.json").read_text())
    assert curves["current_epoch"] == 2
    assert [h["epoch"] for h in history] == [0, 1]
    assert [h["steps"] for h in history] == [3, 3]
    assert state.step == 6
    for h in history:
        assert np.isfinite(h["loss"])
        assert set(h["scores"]) == {"EX", "AU", "VA", "loss"}
        assert h["scores"]["loss"] > 0
    latest = torch.load(pretrain / "latest.pth", weights_only=True)
    for key, value in state.model.state_dict().items():
        assert torch.equal(latest[key], value.cpu()), key


def test_train_is_deterministic_for_one_seed(trained):
    _, ((state_a, hist_a), (state_b, hist_b)) = trained
    assert [h["loss"] for h in hist_a] == [h["loss"] for h in hist_b]
    assert [h["score"] for h in hist_a] == [h["score"] for h in hist_b]
    sd_b = state_b.model.state_dict()
    for key, value in state_a.model.state_dict().items():
        assert torch.equal(value, sd_b[key]), key


def test_resume_reads_latest(trained, fixture_dirs):
    """--resume loads latest.pth and starts at --start_epoch."""
    base, root, labels = fixture_dirs
    cfg = train_entry.parse_opt(_argv(base, root, labels, "exp_a",
                                      "--resume", "--start_epoch", "2",
                                      "--epochs", "3"))
    latest = torch.load(base / "exp_a" / "pretrain" / "latest.pth",
                        weights_only=True)
    state, history = train_lib.train(cfg, max_steps_per_epoch=1,
                                      device="cpu")
    assert [h["epoch"] for h in history] == [2]
    log = (base / "exp_a" / "avformer_A;V_log.txt").read_text()
    assert "resumed from latest checkpoint" in log
    # only the fusion head moved in the one step after loading
    for key, value in state.model.state_dict().items():
        if key.startswith("video_model.video_model.s_former.conv1"):
            assert torch.equal(value, latest[key])


def test_checkpoint_loads_into_jax(trained):
    """latest.pth through the JAX package's own .pth path
    (load_torch_state_dict + convert_checkpoint + merge_into over the
    abstract init tree): every leaf concrete and equal to the file."""
    base, _ = trained
    path = str(base / "exp_a" / "pretrain" / "latest.pth")
    cfg = JaxConfig(use_pallas=False, **STEP_CFG)
    model = jax_build_model(cfg)
    abstract = jax.eval_shape(
        functools.partial(model.init, train=False),
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        example_batch(cfg, batch_size=2))
    merged = merge_into(dict(abstract),
                        convert_checkpoint("avformer",
                                           load_torch_state_dict(path)))
    leaves = jax.tree_util.tree_leaves(merged)
    assert all(isinstance(leaf, np.ndarray) for leaf in leaves)
    back = state_dict_from_jax(merged)
    saved = torch.load(path, weights_only=True)
    assert set(back) == {k for k in saved
                         if not k.endswith("num_batches_tracked")}
    for key, value in back.items():
        assert torch.equal(value, saved[key]), key


def test_checkpoint_loads_into_test_aff2(trained, fixture_dirs, tmp_path,
                                         monkeypatch, capsys):
    """The port's test_aff2 reads the trained .pth from
    experiments/avformer/pretrain and sweeps the fixture's test video."""
    from auformer_torch import test_aff2
    base, root, labels = fixture_dirs
    pretrain = tmp_path / "experiments" / "avformer" / "pretrain"
    pretrain.mkdir(parents=True)
    os.symlink(base / "exp_a" / "pretrain" / "latest.pth",
               pretrain / "latest.pth")
    monkeypatch.chdir(tmp_path)
    out = test_aff2.main(["--root", root, "--lmdb_label_dir", labels,
                          "--cache_dir", str(base / "cache"),
                          "--image_size", "32", "--compute_dtype",
                          "float32"], device="cpu")
    assert "Loading weight from" in capsys.readouterr().out
    assert np.isfinite(out).all() and out[:, :12].any()
