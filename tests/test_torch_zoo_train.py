"""Training the model zoo in auformer_torch against the JAX package, on the
CPU.

One fp32 train step (``parallel/step.py::make_train_step``, dropout 0, no
augmentation, left-right symmetric clips so that the random flip is the
identity) of vformer (its spatial transformer trains: the attention
backward at the spatial site), sformer, i3d, mc3d, tsav, van and emonet,
each from one seeded reference-layout state dict, against JAX's loss,
gradients and BatchNorm statistics of the same step; and ``prep_batch``
and ``device_batch_keys`` for every kind of model input. Small size: 64x64
(emonet needs a multiple of 64), T=2, B=4. This file steps emonet, mc3d,
van and vformer; tests/test_torch_zoo_train_more.py steps the others and
runs the train entry point.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from auformer.core.config import Config as JaxConfig
from auformer.core.torch_import import convert_checkpoint, merge_into
from auformer.nn import build_model as jax_build_model
from auformer.nn import example_batch as jax_example_batch
from auformer.nn import loss_suite as jax_loss_suite
from auformer.parallel import step as jstep
from auformer_torch import train_lib
from auformer_torch.core.config import Config
from auformer_torch.core.weights import load_weights, state_dict_from_jax
from auformer_torch.nn import build_model, loss_suite
from auformer_torch.parallel import step as tstep
from test_torch_zoo import seeded_state_dict

IMAGE = 64
BATCH = 4
# the loss, the gradients and the statistics at the f32 forward's
# tolerances (tests/test_torch_train.py): the two packages' convolutions
# sum in different orders. A gradient's atol is taken relative to its
# tensor's largest element.
LOSS_TOL = (2e-3, 2e-4)
GRAD_REL, GRAD_ATOL = 2e-3, 2e-4
STATS_TOL = (1e-3, 1e-4)

# id -> (model_name, modality, task, frames per clip)
STEP_MODELS = {
    "vformer": ("vformer", "V", "AU", 2),
    "sformer": ("sformer", "V", "AU", 1),
    "i3d": ("i3d", "V", "AU", 2),
    "mc3d": ("mc3d", "V", "AU", 2),
    "tsav": ("tsav", "A;V", "AU", 2),
    "van": ("van", "V", "AU", 1),
    "emonet": ("emonet", "V", "AU", 1),
}
# the cases of this file; tests/test_torch_zoo_train_more.py runs the others
# on another test worker
STEP_CASES = ("emonet", "mc3d", "van", "vformer")


def step_config(case: str) -> dict:
    name, modality, task, t = STEP_MODELS[case]
    return dict(model_name=name, modality=modality, task=task, n_frames=t,
                dilation=1, image_size=IMAGE, compute_dtype="float32",
                dropout_rate=0.0, batch_size=BATCH, learning_rate=1e-3)


def symmetric_batch(cfg: dict, seed: int) -> dict:
    """uint8 clips whose frames are left-right symmetric, host features
    where the model takes them, labels with an ignored row and cell."""
    rs = np.random.RandomState(seed)
    t, channels = cfg["n_frames"], 4 if cfg["modality"] == "V;M" else 3
    half = rs.randint(0, 256, (BATCH, t, IMAGE, IMAGE // 2, channels))
    batch = {"clip": np.concatenate([half, half[:, :, :, ::-1]],
                                    axis=3).astype(np.uint8)}
    if cfg["model_name"] in ("tsav", "audio", "avformer"):
        batch["audio_features"] = rs.randn(BATCH, 1, 64, 1001).astype(
            np.float32)
    au = rs.randint(0, 2, (BATCH, 12)).astype(np.int8)
    au[1, 5] = -1
    batch.update(AU=au, EX=rs.randint(-1, 7, (BATCH, 1)).astype(np.int8),
                 VA=rs.uniform(-1, 1, (BATCH, 2)).astype(np.float32))
    return batch


def jax_step_reference(cfg: dict, sd: dict, batch: dict):
    """JAX's loss, gradients and new BatchNorm statistics of one train-mode
    forward and backward (no flip, no dropout) from the state dict ``sd``,
    as a reference-layout state dict; and its gradients again at weights
    moved by 1e-6 of themselves (seeded), the scale of its own f32
    conditioning."""
    jcfg = JaxConfig(use_pallas=False, **cfg)
    model = jax_build_model(jcfg)
    abstract = jax.eval_shape(
        functools.partial(model.init, train=False),
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jax_example_batch(jcfg, batch_size=2))
    suite = jax_loss_suite(model)

    @jax.jit
    def loss_grads(variables, batch):
        x = jstep.prep_batch(batch, train=False)
        x = {k: x[k] for k in model.modes}

        def loss_fn(params):
            out, mut = model.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                x, train=True, rngs={"dropout": jax.random.PRNGKey(0)},
                mutable=["batch_stats"])
            loss = jstep.task_loss(suite, cfg["task"], out,
                                   jstep._labels_of(batch))[0]
            return loss, mut["batch_stats"]
        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            variables["params"])
        return loss, grads, stats

    def run(weights):
        variables = merge_into(dict(abstract), convert_checkpoint(
            cfg["model_name"], weights))
        loss, grads, stats = jax.tree_util.tree_map(
            np.asarray, loss_grads(variables, batch))
        return float(loss), state_dict_from_jax(
            {"params": grads, "batch_stats": stats}, cfg["model_name"])

    rs = np.random.RandomState(72)
    moved = {k: (v * (1 + 1e-6 * rs.randn(*v.shape))).astype(np.float32)
             for k, v in sd.items()}
    loss, want = run(sd)
    return loss, want, run(moved)[1]


@pytest.fixture
def stable_flax_variance(monkeypatch):
    """flax's train-mode BatchNorm with the two-pass batch variance that
    torch computes. flax's default (``use_fast_variance``) takes
    E[x^2] - E[x]^2 in f32, which at B=2 loses up to 5 % of the variance
    of the fc BatchNorm's features whose mean is many times their spread
    (mc3d here), and so moves every gradient upstream of it by ~2e-3
    relative (ROADMAP.md: a documented difference of the port)."""
    from flax.linen import normalization
    compute = normalization._compute_stats
    monkeypatch.setattr(
        normalization, "_compute_stats",
        lambda *a, **kw: compute(*a, **dict(kw, use_fast_variance=False)))


def check_train_step(case: str) -> None:
    """The port's make_train_step against JAX: the loss, every gradient
    (captured before the Adam step) and every BatchNorm statistic after
    the step; every parameter trains (only avformer freezes any)."""
    cfg = step_config(case)
    probe = build_model(Config(**cfg))
    sd = seeded_state_dict(probe, seed=70 + sorted(STEP_MODELS).index(case))
    batch = symmetric_batch(cfg, seed=71)
    want_loss, want, moved = jax_step_reference(cfg, sd, batch)

    pcfg = Config(**cfg)
    model = build_model(pcfg)
    load_weights(model, sd)
    state = tstep.create_train_state(pcfg, model)
    step = tstep.make_train_step(pcfg, model, loss_suite(model))
    grads = {}
    apply = state.apply_gradients

    def capture():
        grads.update({n: p.grad.detach().clone()
                      for n, p in model.named_parameters()})
        apply()
    state.apply_gradients = capture
    metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                   torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(metrics["loss"]), want_loss, *LOSS_TOL)
    assert state.step == 1
    params = dict(model.named_parameters())
    assert all(p.requires_grad for p in params.values())
    assert set(grads) == set(params)
    for key, got in grads.items():
        ref = want[key].numpy()
        bound = (GRAD_REL * np.linalg.norm(ref) + GRAD_ATOL * np.sqrt(ref.size)
                 + 3 * np.linalg.norm(ref - moved[key].numpy()))
        assert np.linalg.norm(got.numpy() - ref) <= bound, key
    stats = {k: v for k, v in model.state_dict().items()
             if "running_" in k}
    assert stats
    for key, got in stats.items():
        np.testing.assert_allclose(got.numpy(), want[key].numpy(),
                                   *STATS_TOL, err_msg=key)


@pytest.mark.parametrize("case", STEP_CASES)
def test_zoo_train_step_matches_jax(case, stable_flax_variance):
    check_train_step(case)


# -- prep_batch and the batch keys for every kind of model input ---------------

# id -> (model_name, modality, clip channels or None, keys the model reads)
INPUT_KINDS = {
    "rgb_mask_clip": ("dsformer", "V;M", 4, {"clip"}),
    "mask_clip": ("vformer", "M", 1, {"clip"}),
    "audio_only": ("audio", "A", None, {"audio_features"}),
    "clip_and_audio": ("tsav", "A;V", 3, {"clip", "audio_features"}),
}


@pytest.mark.parametrize("kind", sorted(INPUT_KINDS))
def test_prep_batch_serves_every_input_kind(kind):
    """``device_batch_keys`` is the model's inputs and the labels; a train
    ``prep_batch`` under ``--device_augment`` normalises a 4- or
    1-channel clip without augmenting it (as JAX's), so it equals JAX's
    eval normalisation up to the whole-clip flip, and augments an RGB
    clip; audio features pass as they are; the model's train forward
    takes the result."""
    name, modality, channels, keys = INPUT_KINDS[kind]
    t = 1 if name == "dsformer" else 2
    cfg = Config(model_name=name, modality=modality, n_frames=t,
                 image_size=32, compute_dtype="float32", dropout_rate=0.0,
                 device_augment=True)
    model = build_model(cfg)
    assert train_lib.device_batch_keys(model, cfg) == keys | {"AU", "EX",
                                                               "VA"}
    rs = np.random.RandomState(73)
    batch = {}
    if channels:
        batch["clip"] = rs.randint(0, 256, (BATCH, t, 32, 32, channels)
                                   ).astype(np.uint8)
    if "audio_features" in keys:
        batch["audio_features"] = rs.randn(BATCH, 1, 64, 1001).astype(
            np.float32)
    x = tstep.prep_batch({k: torch.from_numpy(v) for k, v in batch.items()},
                         train=True,
                         generator=torch.Generator().manual_seed(1),
                         device_augment=True)
    if channels:
        want = np.asarray(jstep.prep_batch(batch, train=False)["clip"])
        got = x["clip"].numpy()
        assert got.shape == want.shape
    if channels == 3:
        assert not np.allclose(got, want) and not np.allclose(
            got, want[:, :, :, ::-1])
    elif channels:
        flipped = np.all(np.isclose(got, want[:, :, :, ::-1], atol=1e-6),
                         axis=(1, 2, 3, 4))
        same = np.all(np.isclose(got, want, atol=1e-6), axis=(1, 2, 3, 4))
        assert np.all(same | flipped)
    if "audio_features" in keys:
        np.testing.assert_array_equal(x["audio_features"].numpy(),
                                      batch["audio_features"])
    model.train()
    out = tstep._forward(cfg, model, x)
    assert out.shape == (BATCH, 21) and torch.isfinite(out).all()
