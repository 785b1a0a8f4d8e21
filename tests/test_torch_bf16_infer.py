"""auformer_torch's bf16 inference against the JAX package's, on the CPU.

JAX's bf16 inference keeps f32 parameters under module ``dtype=bfloat16``
(auformer/nn/registry.py). The port runs its modules under
``compute_autocast`` with f32 parameters, as its train step does, with the
convolution and Linear weights rounded to bf16 once beforehand
(``prepare_inference``: the casts autocast would make at each call). Each
comparison is norm-relative to JAX's bf16 result and holds the port's f32
forward as a control that must miss the tolerance, so a tolerance tells
the JAX modules' casts from none:

  * each kind of module in eval mode (resnet block, AU former, fusion head,
    t_former), as ``tests/test_torch_train.py::test_bf16_modules_match_flax``
    holds them in train mode;
  * the whole clip forward (``make_infer_fn``) and the whole sweep
    (``AvformerSweep.sweep_video_device_audio``, the phase-mel route) on
    ``synthetic_avformer_sd``, 32x32 frames, T=4, dilation 2.

The JAX side runs op by op (under ``jit`` XLA keeps f32 between a
convolution and its BatchNorm), its attention through the Pallas kernel in
interpret mode, with the port's two documented departures neutralised as
in the train test: GELU in f32 rounded once, Linear biases zero.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auformer import sweep as jax_sweep_module
from auformer.core.config import Config as JaxConfig
from auformer.core.torch_import import convert_avformer, merge_into
from auformer.nn import build_model as jax_build_model
from auformer.nn import example_batch
from auformer.ops.preprocess import normalize_clip as jax_normalize_clip
from auformer_torch.core.config import Config
from auformer_torch.core.weights import load_weights
from auformer_torch.infer import make_infer_fn
from auformer_torch.nn import build_model
from auformer_torch.nn.registry import compute_autocast
from auformer_torch.sweep import AvformerSweep
from test_torch_import import synthetic_avformer_sd  # noqa: F401 (fixture)
from test_torch_train import (BF16_CASES, DENSE_BIASES, STEP_CFG,  # noqa: F401
                              _jax_bf16, _rel, bf16_weights,
                              jax_bf16_reference)

CFG = dict(model_name="avformer", modality="A;V", task="AU", n_frames=4,
           dilation=2, image_size=32)
# norm-relative to JAX's bf16 logits: the port in bf16 lands at 2.6e-3
# (clip) and 2.9e-3 (sweep), its f32 forward at 5.1e-3 and 7.2e-3; the
# whole model cast to bf16 (parameters and BatchNorm statistics included,
# no autocast) lands at 7.2e-3 (clip) and 8.7e-3 (a 20-frame sweep)
LOGITS_TOL = 4e-3
# eval mode, per module: 5.6e-5 / 7.1e-4 / 7.5e-4 / 1.8e-3 in bf16, the f32
# controls at 3.4e-3 / 3.2e-3 / 2.1e-3 / 4.9e-3; the train-mode cases of
# test_torch_train hold the same modules at the same tolerances
MODULE_TOL = {"resnet_block": 1e-3, "au_former": 2e-3, "fusion_head": 1e-3,
              "t_former": 3e-3}


@pytest.mark.parametrize("name", sorted(BF16_CASES))
def test_bf16_modules_match_flax_in_eval(name, bf16_weights,
                                         jax_bf16_reference):
    """Each kind of module in eval mode under the port's inference casts
    against the flax module with dtype=bfloat16 (f32 parameters)."""
    case = BF16_CASES[name]._replace(train=False, mapper=None)
    sd, variables = bf16_weights
    rs = np.random.RandomState(21)
    x = rs.randn(*case.shape).astype(np.float32)
    if name == "resnet_block":
        x = np.abs(x)                           # a post-ReLU activation
    want, _ = _jax_bf16(case, variables, x,
                        np.zeros(case.out_shape, np.float32))
    want = np.asarray(want.astype(jnp.float32))
    model = build_model(Config(**STEP_CFG))
    load_weights(model, sd)
    module = model.get_submodule(case.port).eval()
    outs = {}
    for dtype in ("bfloat16", "float32"):
        xt = torch.from_numpy(x)
        if case.in_bf16 and dtype == "bfloat16":
            xt = xt.bfloat16()
        with torch.inference_mode(), compute_autocast(
                Config(compute_dtype=dtype), "cpu"):
            out = module(xt)
        outs[dtype] = out[0] if isinstance(out, tuple) else out
    assert all(p.dtype == torch.float32 for p in module.parameters())
    err = _rel(outs["bfloat16"].float().numpy(), want)
    control = _rel(outs["float32"].numpy(), want)
    assert err <= MODULE_TOL[name] < control, (err, control)


@pytest.fixture(scope="module")
def weights(synthetic_avformer_sd):
    """``synthetic_avformer_sd`` with the Linear biases zero and the
    t_former's positional embedding cut to T=4 (+ the class token)."""
    sd = {}
    for key, value in synthetic_avformer_sd.items():
        if key.endswith(DENSE_BIASES):
            value = np.zeros_like(value)
        elif key.endswith("t_former.pos_embedding"):
            value = value[:, :CFG["n_frames"] + 1]
        sd[key] = value
    return sd


def _jax_variables(cfg, sd):
    model = jax_build_model(cfg)
    abstract = jax.eval_shape(
        functools.partial(model.init, train=False),
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        example_batch(cfg, batch_size=2))
    return model, merge_into(dict(abstract), convert_avformer(sd))


def _port_model(dtype, sd):
    cfg = Config(**CFG, compute_dtype=dtype)
    model = build_model(cfg)
    load_weights(model, sd)
    return cfg, model


def _assert_inference_dtypes(model, dtype):
    """prepare_inference: convolution and Linear weights rounded to the
    compute dtype once, every other parameter and statistic f32."""
    rounded = {f"{name}.weight" for name, m in model.named_modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))}
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        want = (torch.bfloat16 if dtype == "bfloat16" and name in rounded
                else torch.float32)
        assert t.dtype == want, name


def test_bf16_clip_forward_matches_jax(weights, jax_bf16_reference):
    """make_infer_fn in bf16 (f32 parameters under autocast) against JAX's
    bf16 model on uint8 clips and host audio features; the f32 port
    misses the tolerance."""
    rs = np.random.RandomState(3)
    clip = rs.randint(0, 256, (4, 4, 32, 32, 3)).astype(np.uint8)
    feats = rs.randn(4, 1, 64, 1001).astype(np.float32)
    model, variables = _jax_variables(
        JaxConfig(use_pallas=False, compute_dtype="bfloat16", **CFG),
        weights)
    want = np.asarray(model.apply(
        variables, {"clip": jax_normalize_clip(clip),
                    "audio_features": feats}, train=False).astype(
                        jnp.float32))[:, :12]
    got = {}
    for dtype in ("bfloat16", "float32"):
        cfg, port = _port_model(dtype, weights)
        out = make_infer_fn(cfg, port, device="cpu")(
            {"clip": clip, "audio_features": feats})
        assert out.dtype == torch.float32
        _assert_inference_dtypes(port, dtype)
        got[dtype] = out[:, :12].numpy()
    err, control = _rel(got["bfloat16"], want), _rel(got["float32"], want)
    assert err <= LOGITS_TOL < control, (err, control)


def test_bf16_sweep_matches_jax(weights, jax_bf16_reference):
    """The phase-mel sweep in bf16 against JAX's bf16 AvformerSweep on a
    12-frame video with an 11 s wav (short windows at the start, windows
    cut by the end of the file at the end), one bucket."""
    rs = np.random.RandomState(4)
    frames = rs.randint(0, 256, (12, 32, 32, 3)).astype(np.uint8)
    wav = (rs.randn(11 * 44100) * 0.1).astype(np.float32)
    ts = np.array([1, 2, 30, 60, 150, 240, 280, 300, 310, 320, 326,
                   330]) * 1000.0 / 30.0
    _, variables = _jax_variables(
        JaxConfig(use_pallas=False, compute_dtype="bfloat16", **CFG),
        weights)
    sweep = jax_sweep_module.AvformerSweep(
        JaxConfig(use_pallas=False, compute_dtype="bfloat16", **CFG),
        variables)
    with jax.disable_jit():
        want = sweep.sweep_video_device_audio(frames, wav, ts, batch=16)
    got = {}
    for dtype in ("bfloat16", "float32"):
        cfg, port = _port_model(dtype, weights)
        got[dtype] = AvformerSweep(cfg, port, device="cpu"
                                   ).sweep_video_device_audio(frames, wav,
                                                              ts, batch=16)
        _assert_inference_dtypes(port, dtype)
    err, control = _rel(got["bfloat16"], want), _rel(got["float32"], want)
    assert err <= LOGITS_TOL < control, (err, control)
