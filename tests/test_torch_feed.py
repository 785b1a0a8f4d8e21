"""auformer_torch's training feed against the JAX package's, on the CPU.

The port's fixtures (four videos of 40, 40, 40 and 20 frames at 32x32:
train, train, val, test; masks; wavs of each video's length + 0.5 s), read
by both packages at T=4, dilation 3:

  * the wav arena: ``build_wav_arena`` and ``WavArena.window`` against
    JAX's, on every fixture index, a missing video, past the end of a wav,
    a wav that is not there and over the cap; ``gather_arena_windows``
    against JAX's and against the dataset's own raw windows, bitwise;
  * frame-dedup batches: dataset samples, ``assemble_batch`` (A;V and
    V;M) and the ``DataLoader``'s batches against JAX's, bitwise; the
    expander's clips against the dense clips;
  * ``device_batch_keys`` against JAX's;
  * one f32 train step fed dedup + arena against the dense + raw-window
    step (rel 1e-6), and against JAX's ``make_train_step(with_arena=True)``
    with its expander (the tolerance of tests/test_torch_train.py);
  * ``train_lib.train`` with ``--frame_dedup --locality_run 8
    --device_audio`` against the dense raw-window run on the same sampler
    (history and scores); ``--profile_dir`` writes one trace of steps
    10-15.

JAX compiles one train step here; the rest of its calls are single ops.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from auformer import train_lib as jax_train_lib
from auformer.core.config import Config as JaxConfig
from auformer.core.torch_import import convert_avformer
from auformer.data import BlockShuffleSampler as JaxBlockShuffle
from auformer.data import DataLoader as JaxLoader
from auformer.data.dataset import Aff2CompDataset as JaxDataset
from auformer.data.wav_arena import build_wav_arena as jax_build_wav_arena
from auformer.nn import build_model as jax_build_model
from auformer.nn import loss_suite as jax_loss_suite
from auformer.parallel import step as jstep
from auformer_torch import train as train_entry
from auformer_torch import train_lib
from auformer_torch.core.config import Config
from auformer_torch.data import (Aff2CompDataset, BlockShuffleSampler,
                                 DataLoader)
from auformer_torch.data.fixtures import generate_synthetic_dataset
from auformer_torch.data.wav_arena import build_wav_arena
from auformer_torch.nn import build_model, loss_suite
from auformer_torch.parallel import step as tstep

CFG = dict(task="AU", n_frames=4, dilation=3, image_size=32, host_threads=2)
CAP_MB = 256
# the f32 step against JAX's: tests/test_torch_train.py's LOSS_TOL
LOSS_TOL = (2e-3, 2e-4)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread for this file: its train loops run loader and
    prefetch threads beside torch's intra-op pool, and with several test
    workers on one machine a full pool per worker oversubscribes the cores
    (an epoch that takes 5 s alone took minutes beside five other
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture_dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("feed")
    root, labels = str(base / "root"), str(base / "labels")
    generate_synthetic_dataset(root, labels, n_videos=4,
                               frames_per_video=[40, 40, 40, 20],
                               image_size=32, n_threads=2)
    return base, root, labels


def _cfgs(fixture_dirs, **kw):
    base, root, labels = fixture_dirs
    paths = dict(root=root, lmdb_label_dir=labels,
                 cache_dir=str(base / "cache"))
    kw = {"modality": "A;V", "device_audio": True, **kw}
    return (JaxConfig(use_pallas=False, **paths, **CFG, **kw),
            Config(**paths, **CFG, **kw))


def _datasets(fixture_dirs, **kw):
    cfg_j, cfg = _cfgs(fixture_dirs, **kw)
    got, want = Aff2CompDataset(cfg), JaxDataset(cfg_j)
    modes = ["clip", "audio_features"]
    if "A" not in cfg.modality.split(";"):
        modes = ["clip"]
    got.set_modes(modes)
    want.set_modes(modes)
    return got, want


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, list):
            assert got[k] == v, k
            continue
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                      err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k


def _tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items() if k != "Index"}


# indices across the videos: starts (black window frames), a video's last
# frame, the val and test videos
INDICES = [0, 1, 2, 7, 39, 40, 41, 79, 80, 100, 119, 120, 139]


# -- the wav arena ----------------------------------------------------------

def test_wav_arena_matches_jax(fixture_dirs):
    """The packed arena, its table and zero region equal JAX's, and so does
    every window: each fixture index, a missing video, a window cut by the
    wav's end and one past it."""
    got_ds, want_ds = _datasets(fixture_dirs)
    got, want = build_wav_arena(got_ds, CAP_MB), jax_build_wav_arena(
        want_ds, CAP_MB)
    np.testing.assert_array_equal(got.arena, want.arena)
    assert got.table == want.table and len(got.table) == 4
    assert (got.zero_ofs, got.sample_len) == (want.zero_ofs, want.sample_len)
    assert not got.arena[got.zero_ofs:].any()
    assert got.arena.shape[0] == got.zero_ofs + got.sample_len
    args = (got_ds.sample_rate, got_ds.audio_shift_samples)
    cases = [(os.path.dirname(got_ds.image_path[i]), got_ds.time_stamps[i])
             for i in range(len(got_ds))]
    cases += [("no_such_video", 500.0), ("vid000", 3000.0),
              ("vid000", 60000.0)]
    for vid, ts in cases:
        assert got.window(vid, ts, *args) == want.window(vid, ts, *args), \
            (vid, ts)
    base, wav_n = got.table["vid000"]
    assert got.window("vid000", 3000.0, *args) == (base, wav_n)  # cut
    assert got.window("vid000", 60000.0, *args) == (got.zero_ofs,
                                                    got.sample_len)


def test_wav_arena_over_the_cap_is_none(fixture_dirs):
    got_ds, want_ds = _datasets(fixture_dirs)
    assert build_wav_arena(got_ds, 1.0) is None
    assert jax_build_wav_arena(want_ds, 1.0) is None


def test_wav_arena_without_a_wav(fixture_dirs, tmp_path):
    """A video whose wav is not there stays out of the table; its samples
    take the zero region in both packages, as the raw-window path reads
    zeros."""
    got_ds, want_ds = _datasets(fixture_dirs)
    for name in os.listdir(got_ds.video_dir):
        if name.endswith(".wav") and name != "vid001.wav":
            os.symlink(os.path.join(got_ds.video_dir, name), tmp_path / name)
    got_ds.video_dir = want_ds.video_dir = str(tmp_path)
    got, want = build_wav_arena(got_ds, CAP_MB), jax_build_wav_arena(
        want_ds, CAP_MB)
    np.testing.assert_array_equal(got.arena, want.arena)
    assert got.table == want.table and "vid001" not in got.table
    got_ds.set_audio_arena(got)
    sample = got_ds[50]                                     # vid001
    assert (int(sample["audio_ofs"]), int(sample["audio_len"])) == (
        got.zero_ofs, got.sample_len)
    buf, n_valid = got_ds.get_audio_window("vid001", 50)
    assert n_valid == got.sample_len and not buf.any()


def test_gather_matches_jax_and_host_windows(fixture_dirs):
    """The windows gathered from the arena equal JAX's gather and the
    dataset's raw windows (get_audio_window), bitwise."""
    got_ds, _ = _datasets(fixture_dirs)
    plan = build_wav_arena(got_ds, CAP_MB)
    host, ofs, n_valid = [], [], []
    for i in INDICES:
        vid = os.path.dirname(got_ds.image_path[i])
        buf, n = got_ds.get_audio_window(vid, i)
        o, nv = plan.window(vid, got_ds.time_stamps[i], got_ds.sample_rate,
                            got_ds.audio_shift_samples)
        assert nv == n
        host.append(buf[0])
        ofs.append(o)
        n_valid.append(nv)
    ofs.append(plan.zero_ofs)                       # a missing video's
    n_valid.append(plan.sample_len)
    host.append(np.zeros(plan.sample_len, np.float32))
    ofs, n_valid = np.int32(ofs), np.int32(n_valid)
    got = tstep.gather_arena_windows(torch.from_numpy(plan.arena),
                                     torch.from_numpy(ofs),
                                     torch.from_numpy(n_valid),
                                     plan.sample_len)
    want = jstep.gather_arena_windows(jax.numpy.asarray(plan.arena),
                                      jax.numpy.asarray(ofs),
                                      jax.numpy.asarray(n_valid),
                                      plan.sample_len)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.stack(host))


# -- frame-dedup batches ----------------------------------------------------

@pytest.mark.parametrize("mode", ["arena", "dedup"])
def test_dataset_samples_match_jax(fixture_dirs, mode):
    """Arena samples carry int32 offsets and lengths and no audio; dedup
    samples carry their window's store keys and no clip; both as JAX's."""
    got_ds, want_ds = _datasets(fixture_dirs)
    if mode == "arena":
        got_ds.set_audio_arena(build_wav_arena(got_ds, CAP_MB))
        want_ds.set_audio_arena(jax_build_wav_arena(want_ds, CAP_MB))
    else:
        got_ds.set_frame_dedup(True)
        want_ds.set_frame_dedup(True)
    for i in INDICES:
        got = got_ds[i]
        _assert_same(got, want_ds[i])
        if mode == "arena":
            assert "audio" not in got and "clip" in got
            assert got["audio_ofs"].dtype == got["audio_len"].dtype \
                == np.int32
        else:
            assert "clip" not in got and "audio" in got
            assert len(got["clip_keys"]) == 4


@pytest.mark.parametrize("modality", ["A;V", "V;M"])
def test_assemble_batch_matches_jax(fixture_dirs, modality):
    """The pool and the window map equal JAX's; the pool's slot 0 is black,
    its size a multiple of 64, and frames[clip_idx] equals the dense
    clips (the mask in channel 3 under V;M)."""
    got_ds, want_ds = _datasets(fixture_dirs, modality=modality)
    dense = np.stack([got_ds.get_clip(i) for i in INDICES])
    got_ds.set_frame_dedup(True)
    want_ds.set_frame_dedup(True)
    got = got_ds.assemble_batch([got_ds[i] for i in INDICES])
    want = want_ds.assemble_batch([want_ds[i] for i in INDICES])
    _assert_same(got, want)
    frames, clip_idx = got["frames"], got["clip_idx"]
    assert frames.shape[0] % 64 == 0 and frames.shape[-1] == dense.shape[-1]
    assert clip_idx.shape == (len(INDICES), 4) and clip_idx.dtype == np.int32
    assert not frames[0].any()
    np.testing.assert_array_equal(frames[clip_idx], dense)
    assert len(np.unique(clip_idx)) < clip_idx.size        # shared frames
    if modality == "V;M":
        assert dense[..., 3].any()


def test_dataloader_dedup_batches_match_jax(fixture_dirs):
    """The loader's dedup + arena batches under BlockShuffleSampler equal
    JAX's loader's, and their expanded clips the dense loader's clips."""
    got_ds, want_ds = _datasets(fixture_dirs)
    for ds, build in ((got_ds, build_wav_arena),
                      (want_ds, jax_build_wav_arena)):
        ds.set_frame_dedup(True)
        ds.set_audio_arena(build(ds, CAP_MB))
    ids = np.nonzero(got_ds.train_ids)[0]
    got = list(DataLoader(got_ds, 8, BlockShuffleSampler(ids, 8, seed=3),
                          num_threads=2, drop_last=True))
    want = list(JaxLoader(want_ds, 8, JaxBlockShuffle(ids, 8, seed=3),
                          num_threads=2, drop_last=True))
    assert len(got) == len(want) == len(ids) // 8
    for g, w in zip(got, want):
        _assert_same(g, w)
    got_ds.set_frame_dedup(False)
    dense = list(DataLoader(got_ds, 8, BlockShuffleSampler(ids, 8, seed=3),
                            num_threads=2, drop_last=True))
    for g, d in zip(got, dense):
        assert "clip" not in g and g["clip_idx"].shape == (8, 4)
        np.testing.assert_array_equal(g["frames"][g["clip_idx"]], d["clip"])


def test_expand_dedup_batch(fixture_dirs):
    """The expander's clips equal the dense clips bitwise; a dense batch
    passes unchanged."""
    got_ds, _ = _datasets(fixture_dirs)
    dense = _tensors({"clip": np.stack([got_ds.get_clip(i)
                                        for i in INDICES])})
    got_ds.set_frame_dedup(True)
    batch = _tensors(got_ds.assemble_batch([got_ds[i] for i in INDICES]))
    out = tstep.expand_dedup_batch(batch)
    assert "frames" not in out and "clip_idx" not in out
    assert out["clip"].dtype == torch.uint8
    assert torch.equal(out["clip"], dense["clip"])
    assert set(tstep.expand_dedup_batch(dense)) == {"clip"}
    assert tstep.expand_dedup_batch(dense)["clip"] is dense["clip"]


@pytest.mark.parametrize("arena,dedup", [(False, False), (True, False),
                                         (False, True), (True, True)])
def test_device_batch_keys_match_jax(fixture_dirs, arena, dedup):
    cfg_j, cfg = _cfgs(fixture_dirs)
    model = build_model(cfg, dtype=torch.float32)
    assert train_lib.device_batch_keys(model, cfg, arena=arena,
                                       dedup=dedup) == \
        jax_train_lib.device_batch_keys(model, cfg_j, arena=arena,
                                        dedup=dedup)


# -- the train step ---------------------------------------------------------

STEP_CFG = dict(model_name="avformer", compute_dtype="float32",
                dropout_rate=0.0, batch_size=4, learning_rate=1e-3)


def test_train_step_dedup_arena_equals_dense(fixture_dirs):
    """One f32 step (with the device augmentation) on four fixture samples
    fed dedup + arena gives the dense + raw-window step's loss and
    parameters."""
    _, cfg = _cfgs(fixture_dirs, device_augment=True, **STEP_CFG)
    ds = Aff2CompDataset(cfg)
    ds.set_modes(["clip", "audio_features"])
    idx = [7, 8, 9, 41]
    dense = _tensors(next(iter(DataLoader(ds, 4, idx))))
    plan = build_wav_arena(ds, CAP_MB)
    ds.set_frame_dedup(True)
    ds.set_audio_arena(plan)
    fed = _tensors(next(iter(DataLoader(ds, 4, idx))))
    assert {"frames", "clip_idx", "audio_ofs"} <= set(fed)
    arena = torch.from_numpy(plan.arena)
    results = []
    for batch, arg in ((dense, None), (fed, arena)):
        torch.manual_seed(0)
        model = build_model(cfg, dtype=torch.float32)
        state = tstep.create_train_state(cfg, model)
        step = tstep.make_train_step(cfg, model, loss_suite(model))
        metrics = step(state, batch, torch.Generator().manual_seed(5), arg)
        results.append((float(metrics["loss"]), model.state_dict()))
    (loss_d, sd_d), (loss_f, sd_f) = results
    assert loss_f == pytest.approx(loss_d, rel=1e-6)
    for key, value in sd_d.items():
        torch.testing.assert_close(sd_f[key], value, rtol=1e-6, atol=1e-7)


def test_train_step_matches_jax_with_arena_and_expander():
    """One f32 step fed a frame pool (left-right symmetric frames, so the
    random flip is the identity), a window map, arena offsets and lengths
    against JAX's make_train_step(with_arena=True) with its expander, the
    same weights (the port's initialisation) in both: the losses agree to
    the f32 step tolerance."""
    cfg = Config(modality="A;V", device_audio=True, **CFG, **STEP_CFG)
    cfg_j = JaxConfig(use_pallas=False, modality="A;V", device_audio=True,
                      **CFG, **STEP_CFG)
    torch.manual_seed(2)
    model = build_model(cfg, dtype=torch.float32)
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    variables = convert_avformer(sd)

    rs = np.random.RandomState(40)
    half = rs.randint(0, 256, (64, 32, 16, 3)).astype(np.uint8)
    frames = np.concatenate([half, half[:, :, ::-1]], axis=2)
    frames[0] = 0
    arena = (rs.randn(600000) * 0.1).astype(np.float32)
    arena[-441000:] = 0.0
    batch = {"frames": frames,
             "clip_idx": rs.randint(0, 20, (4, 4)).astype(np.int32),
             "audio_ofs": np.int32([0, 1000, 150000, 159000]),
             "audio_len": np.int32([441000, 30000, 882, 441000]),
             "AU": rs.randint(0, 2, (4, 12)).astype(np.int8),
             "EX": rs.randint(-1, 7, (4, 1)).astype(np.int8),
             "VA": rs.uniform(-1, 1, (4, 2)).astype(np.float32)}

    model_j = jax_build_model(cfg_j)
    state_j = jstep.create_train_state(cfg_j, model_j, variables)
    step_j = jstep.make_train_step(cfg_j, model_j, jax_loss_suite(model_j),
                                   mesh=None, donate=False, with_arena=True)
    batch_j = jstep.expand_dedup_batch(batch, jstep.make_clip_expander())
    _, metrics_j = step_j(state_j, batch_j, jax.random.PRNGKey(0),
                          jax.numpy.asarray(arena))

    state = tstep.create_train_state(cfg, model)
    step = tstep.make_train_step(cfg, model, loss_suite(model))
    metrics = step(state, _tensors(batch), torch.Generator().manual_seed(0),
                   torch.from_numpy(arena))
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(metrics_j["loss"]), *LOSS_TOL)


# -- the train loop ---------------------------------------------------------

def _argv(fixture_dirs, exp, *extra):
    base, root, labels = fixture_dirs
    return ["--root", root, "--lmdb_label_dir", labels,
            "--cache_dir", str(base / "cache"), "--exp_dir", str(base / exp),
            "--image_size", "32", "--n_frames", "4", "--batch_size", "4",
            "--downsample_rate", "2", "--epochs", "1", "--device_augment",
            "--compute_dtype", "float32", "--host_threads", "2",
            "--seed", "7", "--device_audio", "--locality_run", "8", *extra]


def test_entry_point_dedup_arena_matches_dense(fixture_dirs):
    """train.main with --frame_dedup and the default arena against the
    dense raw-window run on the same sampler: the same steps, losses and
    evaluation scores, both checkpoints equal."""
    runs = []
    for exp, extra in (("exp_dense", ("--audio_arena_mb", "0")),
                       ("exp_fed", ("--frame_dedup",))):
        _, history = train_entry.main(_argv(fixture_dirs, exp, *extra),
                                      device="cpu")
        runs.append(history)
    dense, fed = runs
    assert [h["steps"] for h in fed] == [h["steps"] for h in dense]
    assert dense[0]["steps"] >= 5
    for h_d, h_f in zip(dense, fed):
        assert h_f["loss"] == pytest.approx(h_d["loss"], rel=1e-6)
        assert h_f["scores"]["loss"] == pytest.approx(h_d["scores"]["loss"],
                                                      rel=1e-6)
        for task in ("EX", "AU", "VA"):
            assert h_f["scores"][task] == pytest.approx(
                h_d["scores"][task], rel=1e-6)
    base = fixture_dirs[0]
    log = (base / "exp_fed" / "avformer_A;V_log.txt").read_text()
    assert "wav arena: 4 videos" in log
    sd_d, sd_f = (torch.load(base / exp / "pretrain" / "latest.pth",
                             weights_only=True)
                  for exp in ("exp_dense", "exp_fed"))
    for key, value in sd_d.items():
        torch.testing.assert_close(sd_f[key], value, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("steps,traces", [(16, 1), (10, 0)])
def test_profile_dir_traces_steps_10_to_15(fixture_dirs, steps, traces):
    """--profile_dir: a run of 16 steps writes one Chrome trace (steps
    10-15 of the first epoch, the host's activity on the CPU); a run that
    stops before step 10 writes none."""
    base = fixture_dirs[0]
    trace_dir = base / f"trace_{steps}"
    cfg = train_entry.parse_opt(_argv(
        fixture_dirs, f"exp_trace_{steps}", "--batch_size", "2",
        "--model_name", "vformer", "--modality", "V",
        "--profile_dir", str(trace_dir)))
    state, history = train_lib.train(cfg, max_steps_per_epoch=steps,
                                     device="cpu")
    assert history[0]["steps"] == steps
    files = sorted(trace_dir.glob("trace_*.json")) if trace_dir.exists() \
        else []
    assert len(files) == traces
    for f in files:
        events = json.loads(f.read_text())["traceEvents"]
        names = {e.get("name", "") for e in events}
        assert any(n.startswith("aten::") for n in names)
