"""auformer_torch's dataset-fed inference against the JAX package's, on the
CPU: the serving helpers (serve.py), ``sweep_stream`` through a decode
thread and through a ``DecodeWorker`` process, ``run_inference`` and
``run_inference_sweep`` over an ``Aff2TestDataset``, and the ``test_aff2``
entry points of both packages.

The JAX package's synthetic fixture (32x32 JPEGs, three videos of 12
frames: two in the test split with a train video between them), T=4,
dilation 2, fp32, bucket 8. One JAX ``AvformerSweep`` for the module
(random ``init_model`` weights, no Pallas; single-device, as the JAX entry
points would otherwise shard over the tests' 8 virtual CPU devices); the
port loads the same weights through ``state_dict_from_jax``. Logits are
held at rtol 2e-3 / atol 2e-4, the AU submission files must be identical.

Under ``strict_parity`` the JAX dataset decodes with cv2 and the port with
its native reader; on this fixture the two decodes are equal
(``test_strict_parity_decodes_agree``), so the strict case is held at the
same tolerance.
"""
import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

from auformer import serve as jax_serve
from auformer import sweep as jax_sweep_module
from auformer.core.config import Config as JaxConfig
from auformer.data.fixtures import generate_synthetic_dataset
from auformer.data.testset import Aff2TestDataset as JaxTestset
from auformer.infer import run_inference as jax_run_inference
from auformer.infer import run_inference_sweep as jax_run_sweep
from auformer.nn import init_model
from auformer_torch import serve
from auformer_torch.core.config import Config
from auformer_torch.core.weights import load_weights, state_dict_from_jax
from auformer_torch.data import Aff2TestDataset
from auformer_torch.infer import run_inference, run_inference_sweep
from auformer_torch.nn import build_model

RTOL, ATOL = 2e-3, 2e-4
CFG = dict(model_name="avformer", modality="A;V", task="AU", n_frames=4,
           dilation=2, image_size=32, compute_dtype="float32",
           host_threads=2)
BUCKET = 8


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("serve")
    root, labels = str(base / "root"), str(base / "labels")
    generate_synthetic_dataset(root, labels, n_videos=3, frames_per_video=12,
                               image_size=32, splits=["test", "train"])
    return dict(root=root, lmdb_label_dir=labels,
                cache_dir=str(base / "cache"))


def _cfgs(dirs, **kw):
    return (JaxConfig(use_pallas=False, batch_size=8, **dirs, **CFG, **kw),
            Config(batch_size=8, **dirs, **CFG, **kw))


@pytest.fixture(scope="module")
def jax_side(dirs):
    jcfg, _ = _cfgs(dirs)
    _, variables = init_model(jcfg)
    return dict(variables=variables,
                sweep=jax_sweep_module.AvformerSweep(jcfg, variables))


@pytest.fixture(scope="module")
def port_model(jax_side):
    model = build_model(Config(**CFG))
    load_weights(model, state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_side["variables"])))
    return model


@pytest.fixture
def single_device_jax_sweep(jax_side, monkeypatch):
    """JAX's entry points build their sweep through ``make_sweep``: hand
    them the module's single-device sweep, after checking that the weights
    they pass are the module's."""
    def make_sweep(cfg, variables, mesh=None):
        for got, want in zip(jax.tree_util.tree_leaves(variables),
                             jax.tree_util.tree_leaves(
                                 jax_side["variables"])):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        return jax_side["sweep"]
    monkeypatch.setattr(jax_sweep_module, "make_sweep", make_sweep)


def _test_videos(dataset):
    test_idx = np.nonzero(dataset.test_ids)[0]
    return [(os.path.dirname(dataset.image_path[rows[0]]), rows)
            for rows in (test_idx[dataset.video_db_nr[test_idx] == nr]
                         for nr in np.unique(dataset.video_db_nr[test_idx]))]


def _assert_same_outputs(got, want, got_dir, want_dir, videos):
    """Predictions within the tolerance, the AU files identical."""
    assert got.shape == want.shape and not got[:, 12:].any()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    with open(os.path.join(got_dir, "inference.pkl"), "rb") as f:
        np.testing.assert_array_equal(pickle.load(f)["predictions"], got)
    for video_id, rows in videos:
        name = os.path.join("au", f"{video_id}.txt")
        with open(os.path.join(got_dir, name)) as f:
            txt = f.read()
        with open(os.path.join(want_dir, name)) as f:
            assert txt == f.read(), video_id
        assert len(txt.splitlines()) == len(rows) + 1


def test_decode_video_frames_and_read_video_wav_match_jax(dirs):
    jcfg, cfg = _cfgs(dirs)
    want_ds, got_ds = JaxTestset(jcfg), Aff2TestDataset(cfg)
    videos = _test_videos(got_ds)
    assert [v for v, _ in videos] == ["vid000", "vid002"]
    for video_id, rows in videos:
        np.testing.assert_array_equal(
            serve.decode_video_frames(got_ds, rows, 32, 32),
            jax_serve.decode_video_frames(want_ds, rows, 32, 32))
        got = serve.read_video_wav(dirs["root"], video_id + "_left")
        assert got.dtype == np.float32 and got.ndim == 1 and len(got) > 1
        np.testing.assert_array_equal(
            got, jax_serve.read_video_wav(dirs["root"], video_id + "_left"))
    np.testing.assert_array_equal(serve.read_video_wav(dirs["root"], "none"),
                                  np.zeros(1, np.float32))


@pytest.fixture(scope="module")
def jax_stream(dirs, jax_side):
    jcfg, _ = _cfgs(dirs)
    return list(jax_serve.sweep_stream(
        jcfg, jax_side["variables"], dataset=JaxTestset(jcfg), bucket=BUCKET,
        sweep=jax_side["sweep"], decode_worker=False))


@pytest.fixture(scope="module")
def port_thread_stream(dirs, port_model):
    _, cfg = _cfgs(dirs)
    stats = {}
    out = list(serve.sweep_stream(cfg, port_model,
                                  dataset=Aff2TestDataset(cfg),
                                  bucket=BUCKET, decode_worker=False,
                                  stats=stats, device="cpu"))
    assert stats["clips"] == 24 and stats["decode_worker"] is None
    return out


@pytest.mark.parametrize("decode", ["thread", "worker"])
def test_sweep_stream_matches_jax(dirs, port_model, jax_stream,
                                  port_thread_stream, decode):
    """Every test video once, in video order, with its rows and id; the
    worker process yields exactly what the decode thread does."""
    _, cfg = _cfgs(dirs)
    got = port_thread_stream
    if decode == "worker":
        worker = serve.DecodeWorker(cfg)
        try:
            stats = {}
            got = list(serve.sweep_stream(
                cfg, port_model, dataset=Aff2TestDataset(cfg), bucket=BUCKET,
                decode_worker=worker, stats=stats, device="cpu"))
            assert stats["decode_worker"] is worker
            assert stats["decode_seconds"] > 0 and stats["clips"] == 24
        finally:
            worker.close()
        assert not worker._proc.is_alive()
        for (gi, gv, gl), (ti, tv, tl) in zip(got, port_thread_stream):
            np.testing.assert_array_equal(gi, ti)
            assert gv == tv
            np.testing.assert_array_equal(gl, tl)
    assert [v for _, v, _ in got] == [v for _, v, _ in jax_stream]
    assert len(got) == 2
    for (gi, _, gl), (wi, _, wl) in zip(got, jax_stream):
        np.testing.assert_array_equal(gi, wi)
        assert gl.shape == (12, 12) and gl.dtype == np.float32
        np.testing.assert_allclose(gl, np.asarray(wl), rtol=RTOL, atol=ATOL)


def test_unported_serving_paths_raise(dirs, port_model):
    """Both routes shard by video under a core.mesh.Mesh (A7,
    tests/test_torch_multiproc.py); anything else as ``mesh`` raises."""
    from auformer_torch.packed import packed_sweep_stream
    _, cfg = _cfgs(dirs)
    with pytest.raises(TypeError, match="Mesh"):
        next(serve.sweep_stream(cfg, port_model, mesh=object(),
                                device="cpu"))
    with pytest.raises(TypeError, match="Mesh"):
        next(packed_sweep_stream(cfg, port_model, mesh=object(),
                                 device="cpu"))


@pytest.mark.parametrize("device_audio", [False, True])
def test_run_inference_matches_jax(dirs, jax_side, port_model, tmp_path,
                                   device_audio):
    """Dataset-fed clip path, B=8 (the last batch padded): host features
    from the loader, or under device_audio its left-aligned raw windows
    turned into features on the device."""
    jcfg, cfg = _cfgs(dirs, device_audio=device_audio)
    want = jax_run_inference(jcfg, jax_side["variables"],
                             result_path=str(tmp_path / "jax"),
                             dataset=JaxTestset(jcfg))
    dataset = Aff2TestDataset(cfg)
    got = run_inference(cfg, port_model, result_path=str(tmp_path / "port"),
                        dataset=dataset, device="cpu")
    assert got.shape == (36, 21)
    _assert_same_outputs(got, want, str(tmp_path / "port"),
                         str(tmp_path / "jax"), _test_videos(dataset))


def test_stream_predictions_match_run_inference(dirs, port_model, tmp_path):
    """The clip path's serving loop (one batch ahead) yields what
    dataset-fed run_inference writes, in order with the video ids;
    serve_benchmark counts every test clip."""
    _, cfg = _cfgs(dirs)
    want = run_inference(cfg, port_model, result_path=str(tmp_path),
                         dataset=Aff2TestDataset(cfg), device="cpu")
    dataset = Aff2TestDataset(cfg)
    got = list(serve.stream_predictions(cfg, port_model, dataset,
                                        device="cpu"))
    assert [len(i) for i, _, _ in got] == [8, 8, 8]
    idx = np.concatenate([i for i, _, _ in got])
    np.testing.assert_array_equal(idx, np.nonzero(dataset.test_ids)[0])
    assert sum((v for _, _, v in got), []) == [
        os.path.dirname(dataset.image_path[i]) for i in idx]
    np.testing.assert_allclose(np.concatenate([o for _, o, _ in got]),
                               want[idx], rtol=1e-6, atol=1e-6)
    assert serve.serve_benchmark(cfg, port_model, dataset,
                                 device="cpu")["clips"] == 24


def test_strict_parity_decodes_agree(dirs):
    """JAX's strict_parity dataset decodes with cv2, the port with its
    native reader (libjpeg here): the same frames on this fixture."""
    jcfg, cfg = _cfgs(dirs, strict_parity=True)
    want_ds, got_ds = JaxTestset(jcfg), Aff2TestDataset(cfg)
    assert want_ds.native_image is None and got_ds.native_image is not None
    rows = np.arange(len(got_ds))
    np.testing.assert_array_equal(
        serve.decode_video_frames(got_ds, rows, 32, 32),
        jax_serve.decode_video_frames(want_ds, rows, 32, 32))


@pytest.mark.parametrize("strict", [False, True])
def test_run_inference_sweep_matches_jax(dirs, jax_side, port_model,
                                         tmp_path, single_device_jax_sweep,
                                         strict):
    """Dataset-fed dense sweep: sweep_stream (phase-mel audio from the
    wav), or under strict_parity per-window host features."""
    jcfg, cfg = _cfgs(dirs, strict_parity=strict)
    want = jax_run_sweep(jcfg, jax_side["variables"],
                         result_path=str(tmp_path / "jax"),
                         dataset=JaxTestset(jcfg), bucket=BUCKET)
    dataset = Aff2TestDataset(cfg)
    got = run_inference_sweep(cfg, port_model,
                              result_path=str(tmp_path / "port"),
                              bucket=BUCKET, device="cpu", dataset=dataset)
    assert got.shape == (36, 21)
    _assert_same_outputs(got, want, str(tmp_path / "port"),
                         str(tmp_path / "jax"), _test_videos(dataset))


def test_test_aff2_entry_points_match(tmp_path, jax_side,
                                      single_device_jax_sweep, monkeypatch):
    """``python -m auformer_torch.test_aff2`` and the root ``test_aff2.py``,
    each in a working directory of its own holding one .pth written from
    the JAX weights, over one ``--data_backend synthetic`` fixture (the
    first entry point materializes it): the same submission."""
    import test_aff2 as jax_main
    from auformer_torch import test_aff2 as port_main

    data = tmp_path / "data"
    argv = ["--data_backend", "synthetic", "--root", str(data / "root"),
            "--lmdb_label_dir", str(data / "labels"),
            "--cache_dir", str(data / "cache"), "--image_size", "32",
            "--n_frames", "4", "--dilation", "2", "--compute_dtype",
            "float32", "--no_pallas", "--host_threads", "2"]
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    jax_side["variables"]))
    for side in ("jax", "port"):
        pretrain = tmp_path / side / "experiments" / "avformer" / "pretrain"
        pretrain.mkdir(parents=True)
        torch.save({k: torch.as_tensor(v) for k, v in sd.items()},
                   pretrain / "weights.pth")
    monkeypatch.delenv("AUFORMER_SWEEP", raising=False)
    monkeypatch.chdir(tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["test_aff2.py", *argv])
    jax_main.main()
    monkeypatch.chdir(tmp_path / "port")
    got = port_main.main(argv, device="cpu")
    with open(tmp_path / "jax" / "results" / "inference.pkl", "rb") as f:
        want = pickle.load(f)["predictions"]
    assert got.shape == (192, 21) and got[144:, :12].any()
    _assert_same_outputs(got, want, str(tmp_path / "port" / "results"),
                         str(tmp_path / "jax" / "results"),
                         [("vid003", range(144, 192))])
