"""The auformer_torch slice end to end against the JAX package.

avformer clip-batch inference: uint8 clips + raw 441000-sample audio ->
(B, 21) logits. One synthetic state dict in the reference ``.pth`` layout
(tests/test_torch_import.py::synthetic_avformer_sd) loads into the port with
``load_state_dict`` and into JAX through ``convert_avformer`` +
``merge_into``; both packages then run the same numpy inputs in fp32.
"""
import functools
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auformer.core.config import Config as JaxConfig
from auformer.core.torch_import import convert_avformer, merge_into
from auformer.nn import build_model as jax_build_model
from auformer.nn import example_batch
from auformer.ops.audio import audio_frontend as jax_frontend
from auformer.ops.preprocess import normalize_clip as jax_normalize_clip
from auformer_torch.core.config import Config
from auformer_torch.core.weights import (load_reference_state_dict,
                                         load_weights, state_dict_from_jax)
from auformer_torch.infer import make_infer_fn, run_inference
from auformer_torch.nn import build_model
from auformer_torch.ops.attention import fused_attention
from auformer_torch.ops.audio_kernel import mel_frontend
from test_torch_import import synthetic_avformer_sd  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 2e-3, 2e-4   # as the JAX package's own full-forward parity
CFG = dict(model_name="avformer", modality="A;V", task="AU", n_frames=16,
           image_size=32, compute_dtype="float32")


@pytest.fixture(scope="module")
def jax_variables(synthetic_avformer_sd):
    """convert_avformer + merge_into over the model's abstract init tree:
    a parameter the checkpoint does not cover would stay abstract and
    fail the forward."""
    cfg = JaxConfig(use_pallas=False, **CFG)
    model = jax_build_model(cfg)
    abstract = jax.eval_shape(
        functools.partial(model.init, train=False),
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        example_batch(cfg, batch_size=2))
    return model, merge_into(dict(abstract),
                             convert_avformer(synthetic_avformer_sd))


@pytest.fixture(scope="module")
def port_model(synthetic_avformer_sd):
    model = build_model(Config(**CFG))
    load_weights(model, synthetic_avformer_sd)
    return model


@pytest.fixture(scope="module")
def inputs():
    rs = np.random.RandomState(7)
    clip = rs.randint(0, 256, (2, 16, 32, 32, 3)).astype(np.uint8)
    audio = (rs.randn(2, 441000) * 0.1).astype(np.float32)
    audio[1, :200_000] = 0.0                 # a left-padded short window
    flen = np.array([1001, 1 + 241_000 // 441], np.int32)
    return clip, audio, flen


def test_reference_state_dict_loads_with_load_state_dict(
        synthetic_avformer_sd):
    model = build_model(Config(**CFG))
    missing, unexpected = model.load_state_dict(
        {k: torch.from_numpy(v) for k, v in synthetic_avformer_sd.items()},
        strict=False)
    assert not unexpected
    assert all(k.endswith("num_batches_tracked") for k in missing)
    key = "video_model.video_model.s_former.spatial_transformer.layers.0.0.fn.fn.to_qkv.weight"
    np.testing.assert_array_equal(model.state_dict()[key].numpy(),
                                  synthetic_avformer_sd[key])


def test_load_reference_state_dict_strips_ddp_prefix(
        synthetic_avformer_sd, tmp_path):
    """A DDP checkpoint saved under ``state_dict`` loads into the port."""
    path = tmp_path / "best.pth"
    torch.save({"epoch": 3, "state_dict": {
        f"module.{k}": torch.from_numpy(v)
        for k, v in synthetic_avformer_sd.items()}}, path)
    sd = load_reference_state_dict(str(path))
    assert set(sd) == set(synthetic_avformer_sd)
    model = build_model(Config(**CFG))
    load_weights(model, sd)
    key = "au_head.AU_linear_last7.weight"
    np.testing.assert_array_equal(model.state_dict()[key].numpy(),
                                  synthetic_avformer_sd[key])


def test_state_dict_from_jax_inverts_convert_avformer(
        synthetic_avformer_sd, jax_variables):
    _, variables = jax_variables
    back = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables))
    assert set(back) == set(synthetic_avformer_sd)
    for key, value in synthetic_avformer_sd.items():
        np.testing.assert_array_equal(back[key].numpy(), value, err_msg=key)


def test_avformer_forward_matches_jax(jax_variables, port_model, inputs):
    """Raw audio + uint8 clips -> (B, 21): the JAX side runs
    audio_frontend(mel_bf16=True), normalize_clip and model.apply in fp32;
    the port runs make_infer_fn on the CPU."""
    model, variables = jax_variables
    clip, audio, flen = inputs

    @jax.jit
    def jax_forward(variables, clip, audio, flen):
        x = {"clip": jax_normalize_clip(clip),
             "audio_features": jax_frontend(audio, flen, mel_bf16=True)}
        return model.apply(variables, x, train=False)

    want = np.asarray(jax_forward(variables, clip, audio, flen))
    infer = make_infer_fn(Config(**CFG), port_model, device="cpu")
    before = fused_attention.launches, mel_frontend.launches
    got = infer({"clip": clip, "audio": audio, "feature_len": flen})
    assert got.shape == (2, 21) and got.dtype == torch.float32
    assert (fused_attention.launches, mel_frontend.launches) == before
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert not got[:, 12:].any()             # EX/VA slices stay zero


def test_precomputed_audio_features_take_the_same_path(port_model, inputs):
    clip, audio, flen = inputs
    infer = make_infer_fn(Config(**CFG), port_model, device="cpu")
    from auformer_torch.ops.audio import audio_frontend
    feats = audio_frontend(torch.from_numpy(audio), torch.from_numpy(flen))
    raw = infer({"clip": clip, "audio": audio, "feature_len": flen})
    pre = infer({"clip": clip, "audio_features": feats.numpy()})
    torch.testing.assert_close(pre, raw, rtol=0, atol=0)


def test_run_inference_writes_submission(port_model, inputs, tmp_path):
    clip, audio, _ = inputs
    batches = [
        {"clip": clip, "audio": audio, "Index": np.array([0, 1]),
         "video_id": np.array(["vid_a", "vid_a"])},
        {"clip": clip[:1], "audio": audio[:1], "Index": np.array([2]),
         "video_id": np.array(["vid_b"])},          # padded to batch 2
    ]
    cfg = Config(batch_size=2, **CFG)
    out = run_inference(cfg, port_model, batches, str(tmp_path),
                        device="cpu")
    assert out.shape == (3, 21)
    np.testing.assert_allclose(out[2], out[0], rtol=1e-5, atol=1e-6)
    lines = (tmp_path / "au" / "vid_a.txt").read_text().splitlines()
    assert lines[0].startswith("AU1,AU2,AU4")
    assert len(lines) == 3 and set(lines[1]) <= set("01,")
    assert len((tmp_path / "au" / "vid_b.txt").read_text().splitlines()) == 2
    with open(tmp_path / "inference.pkl", "rb") as f:
        np.testing.assert_array_equal(pickle.load(f)["predictions"], out)


def test_entry_points_refuse_to_run_on_the_cpu_unasked(port_model):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_infer_fn(Config(**CFG), port_model)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_inference(Config(**CFG), port_model, [], "unused")


def test_unported_models_raise():
    """No model of the JAX package's zoo is left unported: every name of
    its registry builds."""
    for name in ("avformer", "vformer", "vggformer", "emonet", "tformer",
                 "sformer", "dsformer", "i3d", "mc3d", "van", "audio",
                 "tsav", "resnet"):
        modality = {"dsformer": "V;M", "i3d": "V", "mc3d": "V"}.get(
            name, CFG["modality"])
        model = build_model(Config(**dict(CFG, model_name=name,
                                          modality=modality)))
        assert hasattr(model, "modes") and hasattr(model, "loss_key"), name


def test_port_imports_no_jax_and_no_auformer():
    """Nor cv2, PIL, sklearn, optax, orbax, tensorstore, zstandard or
    matplotlib, which the card's machine lacks: the port decodes and
    encodes JPEGs with its own native reader, scores with its own numpy
    metrics, steps with torch's Adam, checkpoints with torch.save and reads
    the JAX package's orbax checkpoints with its own OCDBT reader and zstd
    decoder."""
    code = (
        "import sys, auformer_torch, auformer_torch.infer, "
        "auformer_torch.core.weights, auformer_torch.ops, auformer_torch.nn, "
        "auformer_torch.nn.avformer, auformer_torch.ops.build, "
        "auformer_torch.sweep, auformer_torch.ops.phase_mel, "
        "auformer_torch.ops.audio_host, auformer_torch.data, "
        "auformer_torch.data.native, auformer_torch.data.fixtures, "
        "auformer_torch.data.wav_arena, auformer_torch.data.transforms, "
        "auformer_torch.serve, auformer_torch.test_aff2, "
        "auformer_torch.losses, auformer_torch.metrics, "
        "auformer_torch.parallel.step, auformer_torch.ops.augment_device, "
        "auformer_torch.core.checkpointing, auformer_torch.core.prng, "
        "auformer_torch.core.observability, auformer_torch.train_lib, "
        "auformer_torch.train, auformer_torch.packed, "
        "auformer_torch.postprocess, auformer_torch.data.ingest, "
        "auformer_torch.data.png, auformer_torch.data.container, "
        "auformer_torch.data.video, "
        "auformer_torch.data.utils, auformer_torch.nn.sformer, "
        "auformer_torch.nn.dual_sformer, auformer_torch.nn.tformer, "
        "auformer_torch.nn.vggformer, auformer_torch.nn.resnet_image, "
        "auformer_torch.nn.van, auformer_torch.nn.emonet, "
        "auformer_torch.nn.i3d, auformer_torch.nn.mc3d, "
        "auformer_torch.nn.tsav, auformer_torch.core.mesh, "
        "auformer_torch.parallel.multiproc, auformer_torch.dryrun, "
        "auformer_torch.core.ocdbt, auformer_torch.core.orbax_reader, "
        "auformer_torch.quickstart\n"
        "auformer_torch.core.orbax_reader.read_orbax_checkpoint("
        "'tests/data/orbax/ocdbt')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'auformer', 'cv2', 'PIL', 'sklearn', "
        "'optax', 'orbax', 'tensorstore', 'zstandard', 'matplotlib'))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_a_dataset_whose_reader_does_not_build_raises(tmp_path):
    """A dataset whose native reader cannot be built raises with the
    compiler's error, in a fresh process (a built reader is kept per
    process): no fallback decoder, no black frames."""
    from auformer.data.fixtures import generate_synthetic_dataset

    root, labels = str(tmp_path / "root"), str(tmp_path / "labels")
    generate_synthetic_dataset(root, labels, n_videos=1, frames_per_video=4,
                               image_size=32, splits=["test"])
    src = tmp_path / "src"
    src.mkdir()
    (src / "framestore.h").write_text("")
    (src / "framestore_reader.cpp").write_text("#error broken reader\n")
    code = (
        "import sys, pathlib\n"
        "from auformer_torch.data import native\n"
        f"native.SRC_DIR = pathlib.Path({str(src)!r})\n"
        f"native.BUILD_DIR = pathlib.Path({str(tmp_path / 'build')!r})\n"
        "from auformer_torch.core.config import Config\n"
        "from auformer_torch.data import Aff2TestDataset\n"
        f"cfg = Config(root={root!r}, lmdb_label_dir={labels!r}, "
        f"cache_dir={str(tmp_path / 'cache')!r}, image_size=32)\n"
        "try:\n"
        "    Aff2TestDataset(cfg)\n"
        "except RuntimeError as e:\n"
        "    assert 'broken reader' in str(e), e\n"
        "    sys.exit(7)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 7, proc.stderr + proc.stdout
