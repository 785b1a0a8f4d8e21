"""The zoo's dense sweeps and serving in auformer_torch against the JAX
package, on the CPU.

``VformerSweep`` against JAX's and against the port's own clip forward;
``SingleFrameSweep`` against JAX's for sformer and the resnet baseline, and
for vggformer at ``n_frames == 1`` (at any other ``n_frames`` the port's
``make_sweep`` refuses it: ROADMAP.md C4); ``run_inference_sweep`` for
vformer and sformer (task VA: the VA head and the VA writer) over the JAX
package's synthetic test split, matrix and files; ``sweep_stream`` for
vformer through a decode thread and a ``DecodeWorker``, neither reading a
wav; ``run_inference`` of the audio model against JAX's.

Small size: 32x32 frames, T=4, dilation 2 for the temporal models, bucket
8, fp32. One seeded reference-layout state dict per model loads into the
port and, through ``convert_checkpoint`` + ``merge_into``, into JAX
(tests/test_torch_zoo.py), which runs its single-device sweeps (its entry
points would otherwise shard over the tests' 8 virtual CPU devices), no
Pallas. Logits are held at rtol 2e-3 / atol 2e-4, as the port's avformer
sweep is (tests/test_torch_sweep.py).
"""
import os
import pickle

import numpy as np
import pytest
import torch

from auformer import sweep as jax_sweep_module
from auformer.core.config import Config as JaxConfig
from auformer.data.fixtures import generate_synthetic_dataset
from auformer.infer import run_inference as jax_run_inference
from auformer.infer import run_inference_sweep as jax_run_sweep
from auformer_torch import serve
from auformer_torch.core.config import Config
from auformer_torch.core.weights import load_weights
from auformer_torch.data import Aff2TestDataset
from auformer_torch.infer import (make_infer_fn, run_inference,
                                  run_inference_sweep)
from auformer_torch.nn import build_model
from auformer_torch.sweep import (SingleFrameSweep, VformerSweep,
                                  make_sweep)
from test_torch_zoo import jax_variables, seeded_state_dict

RTOL, ATOL = 2e-3, 2e-4
BUCKET = 8
VFORMER = dict(model_name="vformer", modality="V", task="AU", n_frames=4,
               dilation=2, image_size=32, compute_dtype="float32")
SINGLE = dict(modality="V", task="AU", n_frames=1, dilation=1,
              image_size=32, compute_dtype="float32")


def both_sides(cfg: dict, seed: int = 0):
    """(JAX variables, the port's model) on one seeded state dict."""
    model = build_model(Config(**cfg))
    sd = seeded_state_dict(model, seed)
    load_weights(model, sd)
    return jax_variables(cfg, sd)[1], model


@pytest.fixture(scope="module")
def frames():
    return np.random.RandomState(3).randint(0, 256, (20, 32, 32, 3)
                                            ).astype(np.uint8)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("zoo_serve")
    root, labels = str(base / "root"), str(base / "labels")
    generate_synthetic_dataset(root, labels, n_videos=3, frames_per_video=12,
                               image_size=32, splits=["test", "train"])
    return dict(root=root, lmdb_label_dir=labels,
                cache_dir=str(base / "cache"), batch_size=8, host_threads=2)


@pytest.fixture(scope="module")
def vformer_side():
    """JAX's single-device VformerSweep and the port's model on one seeded
    state dict."""
    variables, model = both_sides(VFORMER)
    return dict(variables=variables, model=model,
                sweep=jax_sweep_module.VformerSweep(
                    JaxConfig(use_pallas=False, **VFORMER), variables))


def test_vformer_sweep_matches_jax_and_the_clip_path(vformer_side, frames):
    """20 frames in buckets of 8 (the last padded): the port's sweep
    against JAX's, and against the port's clip forward on the windows the
    sweep gathers (black frames out of range)."""
    want = np.asarray(vformer_side["sweep"].sweep_video(frames,
                                                        batch=BUCKET))
    sweep = VformerSweep(Config(**VFORMER), vformer_side["model"],
                         device="cpu")
    assert sweep.out_dim == 21 and not sweep.needs_audio
    got = sweep.sweep_video(frames, batch=BUCKET)
    assert got.shape == (20, 21) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

    idx = sweep.window_indices(len(frames))
    padded = np.concatenate([frames, np.zeros_like(frames[:1])])
    infer = make_infer_fn(Config(**VFORMER), vformer_side["model"],
                          device="cpu")
    clip_path = infer({"clip": padded[idx]}).numpy()
    np.testing.assert_allclose(got, clip_path, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["sformer", "resnet"])
def test_single_frame_sweep_matches_jax(name, frames):
    """11 frames in buckets of 8 (the pad tail), against JAX's
    SingleFrameSweep and the port's own clip forward."""
    cfg = dict(SINGLE, model_name=name)
    variables, model = both_sides(cfg)
    want = jax_sweep_module.SingleFrameSweep(
        JaxConfig(use_pallas=False, **cfg), variables).sweep_video(
            frames[:11], batch=BUCKET)
    sweep = make_sweep(Config(**cfg), model, device="cpu")
    assert isinstance(sweep, SingleFrameSweep)
    got = sweep.sweep_video(frames[:11], batch=BUCKET)
    assert got.shape == (11, 21)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    clip_path = make_infer_fn(Config(**cfg), model, device="cpu")(
        {"clip": frames[:11, None]}).numpy()
    np.testing.assert_allclose(got, clip_path, rtol=RTOL, atol=ATOL)


def test_vggformer_sweep_is_single_frame_only(frames):
    """ROADMAP.md C4: JAX's make_sweep sends vggformer to SingleFrameSweep
    whatever n_frames is (auformer/sweep.py:762,840), where its TFormer
    folds n_frames frames into one row. The port's raises unless
    n_frames == 1, and there it equals JAX's SingleFrameSweep."""
    temporal = Config(**dict(SINGLE, model_name="vggformer", n_frames=16))
    with pytest.raises(ValueError, match="temporal.*run_inference"):
        make_sweep(temporal, build_model(temporal), device="cpu")
    cfg = dict(SINGLE, model_name="vggformer")
    variables, model = both_sides(cfg)
    want = jax_sweep_module.SingleFrameSweep(
        JaxConfig(use_pallas=False, **cfg), variables).sweep_video(
            frames[:6], batch=BUCKET)
    got = make_sweep(Config(**cfg), model, device="cpu").sweep_video(
        frames[:6], batch=BUCKET)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name,exc,match", [
    ("tformer", NotImplementedError, "use run_inference"),
    ("dsformer", NotImplementedError, "use run_inference"),
    ("audio", NotImplementedError, "use run_inference"),
])
def test_models_without_a_sweep_raise(name, exc, match):
    """The models JAX gives no sweep raise as JAX does."""
    cfg = Config(**dict(SINGLE, model_name=name,
                        modality="V;M" if name == "dsformer" else "V"))
    with pytest.raises(exc, match=match):
        make_sweep(cfg, torch.nn.Identity(), device="cpu")
    with pytest.raises(exc, match=match):
        jax_sweep_module.make_sweep(JaxConfig(**cfg.asdict()), {})


def _read(result_dir: str, task_dir: str, video_id: str) -> str:
    with open(os.path.join(result_dir, task_dir, f"{video_id}.txt")) as f:
        return f.read()


@pytest.mark.parametrize("name", ["vformer", "sformer"])
def test_run_inference_sweep_matches_jax(name, dirs, vformer_side, tmp_path,
                                         monkeypatch):
    """Both packages' run_inference_sweep over the synthetic test split
    (the port's through sweep_stream on a decode thread): the (rows, 21)
    matrix within the tolerance, the submission files identical. sformer
    runs task VA: its VA head writes the VA columns and the VA files."""
    if name == "vformer":
        cfg, variables = VFORMER, vformer_side["variables"]
        model, jsweep = vformer_side["model"], vformer_side["sweep"]
        task_dirs = ("au",)
    else:
        cfg = dict(SINGLE, model_name="sformer", task="VA")
        variables, model = both_sides(cfg)
        jsweep = jax_sweep_module.SingleFrameSweep(
            JaxConfig(use_pallas=False, **cfg), variables)
        task_dirs = ("au", "va")
    monkeypatch.setattr(jax_sweep_module, "make_sweep",
                        lambda *a, **k: jsweep)
    want = jax_run_sweep(JaxConfig(use_pallas=False, **dirs, **cfg),
                         variables, result_path=str(tmp_path / "jax"),
                         bucket=BUCKET)
    pcfg = Config(**dirs, **cfg)
    dataset = Aff2TestDataset(pcfg)
    got = run_inference_sweep(pcfg, model, result_path=str(tmp_path / "port"),
                              bucket=BUCKET, device="cpu", dataset=dataset)
    assert got.shape == want.shape == (len(dataset), 21)
    test_idx = np.nonzero(dataset.test_ids)[0]
    assert np.abs(got[test_idx]).min() > 0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    with open(tmp_path / "port" / "inference.pkl", "rb") as f:
        np.testing.assert_array_equal(pickle.load(f)["predictions"], got)
    videos = {os.path.dirname(dataset.image_path[i]) for i in test_idx}
    assert len(videos) == 2
    for video_id in videos:
        for task_dir in task_dirs:
            assert _read(str(tmp_path / "port"), task_dir, video_id) == \
                _read(str(tmp_path / "jax"), task_dir, video_id)
    assert not os.path.exists(tmp_path / "port" / "expr")


def test_vformer_sweep_stream_reads_no_wav(dirs, vformer_side, monkeypatch):
    """sweep_stream of a sweep without audio through a decode thread and
    through a DecodeWorker: no wav is read (the thread's reader raises if
    called; the worker replies None), and both yield the sweep's logits of
    the decoded frames; sweep_serve_benchmark takes the same sweep."""
    cfg = Config(**dirs, **VFORMER)
    dataset = Aff2TestDataset(cfg)
    sweep = VformerSweep(cfg, vformer_side["model"], device="cpu")

    def no_wav(*args, **kwargs):
        raise AssertionError("sweep_stream read a wav for a visual sweep")
    monkeypatch.setattr(serve, "read_video_wav", no_wav)
    thread = list(serve.sweep_stream(cfg, vformer_side["model"],
                                     dataset=dataset, bucket=BUCKET,
                                     sweep=sweep, decode_worker=False,
                                     device="cpu"))
    assert len(thread) == 2
    for vid_idx, video_id, logits in thread:
        frames = serve.decode_video_frames(dataset, vid_idx, 32, 32)
        assert logits.shape == (len(vid_idx), 21)
        np.testing.assert_array_equal(
            logits, sweep.sweep_video(frames, batch=BUCKET))

    worker = serve.DecodeWorker(cfg)
    try:
        nr = np.unique(dataset.video_db_nr[dataset.test_ids > 0])[0]
        worker.request(nr, want_wav=False)
        assert worker.result()[2] is None
        stats = {}
        through_worker = list(serve.sweep_stream(
            cfg, vformer_side["model"], dataset=dataset, bucket=BUCKET,
            sweep=sweep, decode_worker=worker, stats=stats, device="cpu"))
        assert stats["clips"] == 24
    finally:
        worker.close()
    for (gi, gv, gl), (ti, tv, tl) in zip(through_worker, thread):
        np.testing.assert_array_equal(gi, ti)
        assert gv == tv
        np.testing.assert_array_equal(gl, tl)
    result = serve.sweep_serve_benchmark(cfg, vformer_side["model"],
                                         dataset=dataset, bucket=BUCKET,
                                         sweep=sweep, decode_worker=False,
                                         device="cpu")
    assert result["clips"] == 24 and result["clips_per_sec"] > 0


def test_run_inference_audio_matches_jax(dirs, tmp_path):
    """The audio model's clip path over the synthetic test split (host
    features from the dataset, B=8 with a padded last batch) against the
    JAX package's run_inference; the AU files identical, EX/VA zero."""
    cfg = dict(model_name="audio", modality="A", task="AU", n_frames=4,
               dilation=2, image_size=32, compute_dtype="float32")
    variables, model = both_sides(cfg)
    want = jax_run_inference(JaxConfig(use_pallas=False, **dirs, **cfg),
                             variables, result_path=str(tmp_path / "jax"))
    pcfg = Config(**dirs, **cfg)
    dataset = Aff2TestDataset(pcfg)
    got = run_inference(pcfg, model,
                        result_path=str(tmp_path / "port"), device="cpu",
                        dataset=dataset)
    assert got.shape == want.shape and not got[:, 12:].any()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    test_idx = np.nonzero(dataset.test_ids)[0]
    for video_id in {os.path.dirname(dataset.image_path[i])
                     for i in test_idx}:
        assert _read(str(tmp_path / "port"), "au", video_id) == \
            _read(str(tmp_path / "jax"), "au", video_id)
