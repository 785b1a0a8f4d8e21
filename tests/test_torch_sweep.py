"""auformer_torch dense sweep (sweep.py, infer.py::run_inference_sweep)
against the JAX package's ``AvformerSweep`` and ``run_inference_sweep``.

Small size: 32x32 frames, n_frames 4, dilation 2 (label frame 8), a 20
frame video with an 11 s wav, bucket 8 (three buckets, the last padded),
fp32. One JAX ``AvformerSweep`` per module (random ``init_model`` weights,
no Pallas); the port loads the same weights through
``state_dict_from_jax``. Logits are held at rtol 2e-3 / atol 2e-4, as the
port's clip path is held against JAX (tests/test_torch_slice.py).
"""
import contextlib
import dataclasses
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from auformer import sweep as jax_sweep_module
from auformer.core.config import Config as JaxConfig
from auformer.nn import init_model
from auformer.ops import phase_mel as jax_phase_mel
from auformer_torch.core.config import Config
from auformer_torch.core.weights import load_weights, state_dict_from_jax
from auformer_torch.infer import make_infer_fn, run_inference_sweep
from auformer_torch.nn import build_model
from auformer_torch.ops.attention import fused_attention
from auformer_torch.ops.audio_kernel import mel_frontend
from auformer_torch.ops.phase_mel import (phase_mel_table, phase_plan,
                                          phase_window_features)
from auformer_torch.sweep import (AvformerSweep, SweepBase,
                                  default_sweep_bucket, make_sweep)

RTOL, ATOL = 2e-3, 2e-4
CFG = dict(model_name="avformer", modality="A;V", task="AU", n_frames=4,
           dilation=2, image_size=32, compute_dtype="float32")
BUCKET = 8
N = 20
SLEN = 441000
# 30 fps frame numbers: short windows at the start, windows truncated by
# the end of the 11 s file at the end
FRAME_NR = np.array([1, 2, 4, 30, 60, 100, 150, 200, 240, 250, 260, 280,
                     300, 301, 302, 303, 310, 320, 326, 330])


@contextlib.contextmanager
def _forced_per_window_route():
    """The JAX dispatch reads ``phase_plan`` from its module at call time."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_phase_mel, "phase_plan", lambda *a, **k: None)
        yield


@pytest.fixture(scope="module")
def video():
    rs = np.random.RandomState(5)
    return dict(
        frames=rs.randint(0, 256, (N, 32, 32, 3)).astype(np.uint8),
        wav=(rs.randn(11 * 44100) * 0.1).astype(np.float32),
        ts=FRAME_NR * 1000.0 / 30.0,
        feats=rs.randn(N, 1, 64, 1001).astype(np.float32))


@pytest.fixture(scope="module")
def jax_side(video):
    """JAX's sweep and its logits on the feature-fed, phase and forced
    per-window routes."""
    cfg = JaxConfig(use_pallas=False, **CFG)
    _, variables = init_model(cfg)
    sweep = jax_sweep_module.AvformerSweep(cfg, variables)
    f, w, ts = video["frames"], video["wav"], video["ts"]
    out = dict(
        sweep=sweep, variables=variables,
        fed=sweep.sweep_video(f, video["feats"], batch=BUCKET),
        phase=sweep.sweep_video_device_audio(f, w, ts, batch=BUCKET))
    with _forced_per_window_route():
        out["per_window"] = sweep.sweep_video_device_audio(f, w, ts,
                                                           batch=BUCKET)
    return out


@pytest.fixture(scope="module")
def port_model(jax_side):
    model = build_model(Config(**CFG))
    load_weights(model, state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_side["variables"])))
    return model


@pytest.fixture(scope="module")
def port_sweep(port_model):
    return AvformerSweep(Config(**CFG), port_model, device="cpu")


def _bare(cls, cfg):
    sweep = object.__new__(cls)
    sweep.cfg = cfg
    return sweep


@pytest.mark.parametrize("n", [5, 13, 47, 48, 49, 1280, 1281, 5000])
def test_bucket_machinery_matches_jax(n):
    """window_indices, _bucket_size and _buckets at the full-width window
    (T=16, dilation 3, label frame 48) and at the test size."""
    frames = np.arange(n, dtype=np.uint8).reshape(n, 1, 1, 1).repeat(3, -1)
    for port_cfg, jax_cfg in ((Config(), JaxConfig()),
                              (Config(**CFG), JaxConfig(**CFG))):
        port = _bare(AvformerSweep, port_cfg)
        ref = _bare(jax_sweep_module.AvformerSweep, jax_cfg)
        np.testing.assert_array_equal(port.window_indices(n),
                                      ref.window_indices(n))
        for batch in (BUCKET, 512, 2048):
            assert port._bucket_size(n, batch) == ref._bucket_size(n, batch)
            got = list(port._buckets(n, frames, batch))
            want = list(ref._buckets(n, frames, batch))
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g[:3] == w[:3]
                np.testing.assert_array_equal(g[3], w[3])
                np.testing.assert_array_equal(g[4], w[4])
    pad = SweepBase._pad_rows(np.arange(3)[:, None], 5)
    np.testing.assert_array_equal(
        pad, jax_sweep_module.SweepBase._pad_rows(np.arange(3)[:, None], 5))


def test_black_feature_matches_jax(port_sweep, jax_side):
    """The trunk output of a black frame, which out-of-range window slots
    take."""
    got = port_sweep.black_feature(32)
    assert got.shape == (512,) and got.dtype == np.float32
    np.testing.assert_allclose(got, jax_side["sweep"].black_feature(32),
                               rtol=RTOL, atol=ATOL)


def test_sweep_video_matches_jax(port_sweep, jax_side, video):
    got = port_sweep.sweep_video(video["frames"], video["feats"],
                                 batch=BUCKET)
    assert got.shape == (N, 12) and got.dtype == np.float32
    np.testing.assert_allclose(got, jax_side["fed"], rtol=RTOL, atol=ATOL)


def test_phase_route_matches_jax(port_sweep, jax_side, video):
    """The default device-audio route: 30 fps timestamps take the
    phase-mel tables, with 11 attention launches per bucket on a CUDA
    device (none counted on the CPU) and no mel kernel."""
    before = fused_attention.launches, mel_frontend.launches
    got = port_sweep.sweep_video_device_audio(
        video["frames"], video["wav"], video["ts"], batch=BUCKET)
    assert (fused_attention.launches, mel_frontend.launches) == before
    np.testing.assert_allclose(got, jax_side["phase"], rtol=RTOL, atol=ATOL)


def test_per_window_route_matches_jax(port_sweep, jax_side, video):
    """``max_phases = 0`` forces the per-window left-aligned route, as
    JAX's plan returning None does; both routes agree too."""
    port_sweep.max_phases = 0
    try:
        got = port_sweep.sweep_video_device_audio(
            video["frames"], video["wav"], video["ts"], batch=BUCKET)
    finally:
        port_sweep.max_phases = AvformerSweep.max_phases
    np.testing.assert_allclose(got, jax_side["per_window"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got, jax_side["phase"], rtol=RTOL, atol=ATOL)


def test_shared_audio_sweep_matches_jax(port_sweep, jax_side, video):
    """The opt-in approximate mode (one power mel per video, windows
    snapped to the hop grid): its column plan equals JAX's exactly, its
    logits within the tolerance."""
    f, w, ts = video["frames"], video["wav"], video["ts"]
    np.testing.assert_array_equal(
        port_sweep.shared_audio_plan(ts, len(w)),
        jax_side["sweep"].shared_audio_plan(ts, len(w)))
    got = port_sweep.sweep_video_shared_audio(f, w, ts, batch=BUCKET)
    assert got.shape == (N, 12) and got.dtype == np.float32
    np.testing.assert_allclose(
        got, jax_side["sweep"].sweep_video_shared_audio(f, w, ts,
                                                        batch=BUCKET),
        rtol=RTOL, atol=ATOL)


def test_sweep_matches_the_clip_path(port_model, port_sweep, video):
    """Every label frame: the port's sweep on the phase route equals the
    port's clip path (make_infer_fn) on the window's clip, assembled from
    window_indices with black frames out of range, and the same phase-mel
    features."""
    cfg = Config(**CFG)
    starts, n_valid = port_sweep.audio_window_plan(video["ts"],
                                                   len(video["wav"]))
    phases, base, sel = phase_plan(starts.astype(np.int64) - SLEN, n_valid)
    ext = np.zeros(len(video["wav"]) + 2 * SLEN + 512, np.float32)
    ext[SLEN:SLEN + len(video["wav"])] = video["wav"]
    ext = torch.from_numpy(ext)
    feats = phase_window_features(
        ext, phase_mel_table(ext, np.unique(phases)),
        *(torch.from_numpy(a) for a in (starts, n_valid, base, sel)))
    idx = port_sweep.window_indices(N)
    padded = np.concatenate([video["frames"],
                             np.zeros((1, 32, 32, 3), np.uint8)])
    want = make_infer_fn(cfg, port_model, device="cpu")(
        {"clip": padded[idx], "audio_features": feats.numpy()})
    got = port_sweep.sweep_video_device_audio(
        video["frames"], video["wav"], video["ts"], batch=BUCKET)
    np.testing.assert_allclose(got, want[:, :12].numpy(), rtol=RTOL,
                               atol=ATOL)


def _synthetic_videos(cfg, strict: bool):
    """The JAX package's synthetic test split as run_inference_sweep items:
    frames decoded and wavs read by its serving helpers, host features by
    its dataset under ``strict``."""
    from auformer.data.testset import Aff2TestDataset
    from auformer.serve import decode_video_frames, read_video_wav

    dataset = Aff2TestDataset(cfg)
    test_idx = np.nonzero(dataset.test_ids)[0]
    items = []
    for nr in np.unique(dataset.video_db_nr[test_idx]):
        rows = test_idx[dataset.video_db_nr[test_idx] == nr]
        video_id = os.path.dirname(dataset.image_path[rows[0]])
        item = dict(video_id=video_id, Index=rows,
                    frames=decode_video_frames(dataset, rows, 32, 32))
        if strict:
            item["audio_features"] = np.stack([
                dataset.get_audio_feature(video_id, int(i))[0]
                for i in rows])
        else:
            item["wav"] = read_video_wav(dataset.audio_dir, video_id)
            item["timestamps_ms"] = np.asarray(dataset.time_stamps)[rows]
        items.append(item)
    return dataset, test_idx, items


@pytest.mark.parametrize("strict", [False, True])
def test_run_inference_sweep_matches_jax(port_model, jax_side, tmp_path,
                                         monkeypatch, strict):
    """The JAX package's synthetic fixtures through both packages'
    run_inference_sweep: identical AU files, inference.pkl within the
    tolerance. JAX runs the module's single-device sweep (its default would
    shard over the tests' 8 virtual CPU devices)."""
    from auformer.data.fixtures import generate_synthetic_dataset
    from auformer.infer import run_inference_sweep as jax_run

    root, labels = str(tmp_path / "root"), str(tmp_path / "labels")
    generate_synthetic_dataset(root, labels, n_videos=2,
                               frames_per_video=10, image_size=32,
                               splits=["test"])
    jcfg = JaxConfig(root=root, lmdb_label_dir=labels,
                     cache_dir=str(tmp_path / "cache"), batch_size=8,
                     use_pallas=False, host_threads=1, strict_parity=strict,
                     **CFG)
    monkeypatch.setattr(jax_sweep_module, "make_sweep",
                        lambda *a, **k: jax_side["sweep"])
    want = jax_run(jcfg, jax_side["variables"],
                   result_path=str(tmp_path / "jax"), bucket=BUCKET)
    dataset, test_idx, items = _synthetic_videos(jcfg, strict)

    cfg = dataclasses.replace(Config(**CFG), strict_parity=strict)
    got = run_inference_sweep(cfg, port_model, items,
                              result_path=str(tmp_path / "port"),
                              bucket=BUCKET, device="cpu")
    assert got.shape == (test_idx.max() + 1, 21) and not got[:, 12:].any()
    np.testing.assert_allclose(got[test_idx, :12], want[test_idx, :12],
                               rtol=RTOL, atol=ATOL)
    with open(tmp_path / "port" / "inference.pkl", "rb") as f:
        np.testing.assert_array_equal(pickle.load(f)["predictions"], got)
    for item in items:
        name = f"{item['video_id']}.txt"
        port_txt = (tmp_path / "port" / "au" / name).read_text()
        assert port_txt == (tmp_path / "jax" / "au" / name).read_text()
        assert len(port_txt.splitlines()) == len(item["Index"]) + 1


def test_entry_points_refuse_to_run_on_the_cpu_unasked(port_model):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is valid")
    cfg = Config(**CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        AvformerSweep(cfg, port_model)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_inference_sweep(cfg, port_model, [], "unused")
    assert default_sweep_bucket("cpu") == 512
    assert default_sweep_bucket("cuda") == 2048


def test_unported_sweeps_raise(port_model):
    with pytest.raises(NotImplementedError, match="A7"):
        AvformerSweep(Config(**CFG), port_model, mesh=object(),
                      device="cpu")
    with pytest.raises(NotImplementedError, match="A6"):
        make_sweep(Config(**dict(CFG, model_name="vformer")), port_model,
                   device="cpu")
