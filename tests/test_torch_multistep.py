"""auformer_torch's K steps per dispatch (``make_multi_train_step``,
``--steps_per_dispatch K``) on the CPU, against the single step and the
JAX package.

  * (a) ``make_multi_train_step`` at K = 3 equals 3 ``make_train_step``
    calls bit for bit in f32, augmentation and dropout on, the seeds from
    ``key_seq``: losses, parameters, BatchNorm statistics, Adam's moments;
  * (b) it against JAX's ``make_multi_train_step`` on symmetric batches
    (the flip is the identity, dropout 0), at the JAX test's own
    tolerances (tests/test_parallel.py);
  * (c) ``stack_batches`` equals JAX's; the device stacker's dense and
    expanded frame-dedup slots equal the dense stack;
  * (d) ``train()`` at ``--steps_per_dispatch 2`` with a tail equals the
    K = 1 run (history and ``latest.pth`` bit for bit), on the training
    feed's flags;
  * (e) the ``--profile_dir`` window at K = 2 and 4, and JAX's (C7);
  * (f) the step's device constants equal the per-call values they
    replace, and the step makes no host sync (a CUDA graph could not
    capture one).
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from auformer import train_lib as jax_train_lib
from auformer.core.config import Config as JaxConfig
from auformer.core.torch_import import convert_avformer, merge_into
from auformer.data.fixtures import \
    generate_synthetic_dataset as jax_generate_synthetic_dataset
from auformer.nn import build_model as jax_build_model
from auformer.nn import example_batch, loss_suite as jax_loss_suite
from auformer.parallel import step as jstep
from auformer_torch import train as train_entry
from auformer_torch import train_lib
from auformer_torch.core.config import Config
from auformer_torch.core.prng import key_seq, setup_seed
from auformer_torch.core.weights import load_weights, state_dict_from_jax
from auformer_torch.data.fixtures import generate_synthetic_dataset
from auformer_torch.losses import losses as tlosses
from auformer_torch.nn import build_model, loss_suite
from auformer_torch.ops import audio as taudio
from auformer_torch.ops import augment_device as taug
from auformer_torch.ops import preprocess as tpre
from auformer_torch.parallel import step as tstep
from test_torch_import import synthetic_avformer_sd  # noqa: F401 (fixture)
from test_torch_train import LOSS_TOL, STEP_CFG

# tests/test_parallel.py::test_multi_step_matches_sequential: JAX's K
# scanned steps against its K single steps, the loss sequence and the
# BatchNorm statistics. Its step-0 bound, rel 1e-6, holds one package
# against itself; across the packages step 0 is one forward, whose f32
# convolutions sum in different orders (2.0e-5 relative here), so it takes
# the single step's tolerance (tests/test_torch_train.py::LOSS_TOL)
FIRST_LOSS_TOL = LOSS_TOL
LOSS_RTOL = 1e-3
STATS_TOL = (5e-3, 5e-4)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread: the train loops here run loader threads beside
    torch's pool, which beside other test workers oversubscribes the
    cores (tests/test_torch_feed.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed, symmetric=False, b=4, t=16, image=32):
    rs = np.random.RandomState(seed)
    if symmetric:
        half = rs.randint(0, 256, (b, t, image, image // 2, 3))
        clip = np.concatenate([half, half[:, :, :, ::-1]], axis=3)
    else:
        clip = rs.randint(0, 256, (b, t, image, image, 3))
    au = rs.randint(0, 2, (b, 12)).astype(np.int8)
    au[-1, 0] = -1                                # an ignored row
    return {"clip": np.ascontiguousarray(clip.astype(np.uint8)),
            "audio_features": rs.randn(b, 1, 64, 1001).astype(np.float32),
            "AU": au, "EX": rs.randint(-1, 7, (b, 1)).astype(np.int8),
            "VA": rs.uniform(-1, 1, (b, 2)).astype(np.float32)}


def _model(cfg, sd):
    torch.manual_seed(0)
    model = build_model(cfg, dtype=torch.float32)
    load_weights(model, sd)
    return model


def _tensors(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


# -- (a) K steps per dispatch = K single steps -------------------------------

def test_multi_step_equals_single_steps(synthetic_avformer_sd):
    cfg = Config(**{**STEP_CFG, "dropout_rate": 0.2,
                    "device_augment": True})
    batches = [_batch(30 + i) for i in range(3)]
    single = _model(cfg, synthetic_avformer_sd)
    state_1 = tstep.create_train_state(cfg, single)
    step = tstep.make_train_step(cfg, single, loss_suite(single))
    keys = key_seq(setup_seed(3))
    losses_1 = [step(state_1, _tensors(b), keys())["loss"] for b in batches]

    multi = _model(cfg, synthetic_avformer_sd)
    state_k = tstep.create_train_state(cfg, multi)
    step_k = tstep.make_multi_train_step(cfg, multi, loss_suite(multi), 3)
    keys = key_seq(setup_seed(3))
    metrics = step_k(state_k, _tensors(tstep.stack_batches(batches)),
                     [keys.next_seed() for _ in batches])

    assert metrics["loss"].shape == (3,)
    assert torch.equal(metrics["loss"], torch.stack(losses_1))
    assert state_k.step == state_1.step == 3
    want = single.state_dict()
    for key, value in multi.state_dict().items():
        assert torch.equal(value, want[key]), key
    adam_1, adam_k = (s.optimizer.state_dict()["state"]
                      for s in (state_1, state_k))
    assert len(adam_k) == len(adam_1) > 0
    for i, moments in adam_1.items():
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(adam_k[i][name], moments[name]), (i, name)


# -- (b) against JAX's make_multi_train_step ---------------------------------

def test_multi_step_matches_jax(synthetic_avformer_sd):
    k = 2
    cfg_j = JaxConfig(use_pallas=False, **STEP_CFG)
    model_j = jax_build_model(cfg_j)
    abstract = jax.eval_shape(
        functools.partial(model_j.init, train=False),
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        example_batch(cfg_j, batch_size=2))
    variables = merge_into(dict(abstract),
                           convert_avformer(synthetic_avformer_sd))
    state_j = jstep.create_train_state(cfg_j, model_j, variables)
    multi_j = jstep.make_multi_train_step(cfg_j, model_j,
                                          jax_loss_suite(model_j),
                                          mesh=None, donate=False)
    batches = [_batch(40 + i, symmetric=True) for i in range(k)]
    state_j, metrics_j = multi_j(state_j, jstep.stack_batches(batches),
                                 jax.random.PRNGKey(0))

    cfg = Config(**STEP_CFG)
    model = _model(cfg, synthetic_avformer_sd)
    state = tstep.create_train_state(cfg, model)
    step_k = tstep.make_multi_train_step(cfg, model, loss_suite(model), k)
    keys = key_seq(setup_seed(0))
    metrics = step_k(state, _tensors(tstep.stack_batches(batches)),
                     [keys.next_seed() for _ in batches])

    got, want = metrics["loss"].numpy(), np.asarray(metrics_j["loss"])
    np.testing.assert_allclose(got[0], want[0], *FIRST_LOSS_TOL)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert state.step == int(state_j.step) == k
    after = state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": state_j.params,
                     "batch_stats": state_j.batch_stats}))
    port = model.state_dict()
    stats = [key for key in after if "running_" in key]
    assert stats
    for key in stats:
        np.testing.assert_allclose(port[key].numpy(), after[key].numpy(),
                                   *STATS_TOL, err_msg=key)


# -- (c) the stackers --------------------------------------------------------

def test_stack_batches_matches_jax():
    batches = [{**_batch(50 + i, b=2, t=2, image=8),
                "video": np.array(["a", "b"]), "Index": np.arange(2) + i}
               for i in range(3)]
    got, want = tstep.stack_batches(batches), jstep.stack_batches(batches)
    assert list(got) == list(want)
    assert "video" not in got
    for key, value in want.items():
        assert got[key].dtype == value.dtype
        np.testing.assert_array_equal(got[key], value, err_msg=key)
        assert got[key].shape[0] == 3


def _dedup(batch):
    """The batch with its clips as a pool of unique frames (slot 0 black)
    and a (B, T) int32 map into it."""
    clip = batch["clip"]
    b, t = clip.shape[:2]
    frames, idx = np.unique(clip.reshape(b * t, -1), axis=0,
                            return_inverse=True)
    pool = np.concatenate([np.zeros((1,) + clip.shape[2:], np.uint8),
                           frames.reshape((-1,) + clip.shape[2:])])
    out = {k: v for k, v in batch.items() if k != "clip"}
    out.update(frames=pool, clip_idx=(idx.reshape(b, t) + 1).astype(np.int32))
    return out


def test_device_stacker_expands_dedup_batches():
    batches = [_batch(60 + i, b=2, t=3, image=8) for i in range(3)]
    batches[1]["clip"][1, 2] = batches[1]["clip"][0, 0]   # a shared frame
    want = tstep.stack_batches(batches)
    stack = tstep.make_device_stacker()
    for fed in (batches, [_dedup(b) for b in batches]):
        got = stack(*[_tensors(b) for b in fed])
        assert set(got) == set(want)
        for key, value in want.items():
            np.testing.assert_array_equal(got[key].numpy(), value,
                                          err_msg=key)
    with pytest.raises(ValueError, match="differ"):
        stack(_tensors(batches[0]), _tensors(_batch(9, b=3, t=3, image=8)))


# -- (d) the train loop ------------------------------------------------------

@pytest.fixture(scope="module")
def fixture_dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("multistep")
    root, labels = str(base / "root"), str(base / "labels")
    generate_synthetic_dataset(root, labels, n_videos=4,
                               frames_per_video=[40, 40, 40, 20],
                               image_size=32, n_threads=2)
    return base, root, labels


def _argv(fixture_dirs, exp, *extra):
    base, root, labels = fixture_dirs
    return ["--root", root, "--lmdb_label_dir", labels,
            "--cache_dir", str(base / "cache"), "--exp_dir", str(base / exp),
            "--image_size", "32", "--n_frames", "4", "--batch_size", "4",
            "--downsample_rate", "2", "--epochs", "2", "--device_augment",
            "--compute_dtype", "float32", "--host_threads", "2",
            "--seed", "7", *extra]


def test_train_steps_per_dispatch_equals_single_steps(fixture_dirs):
    """Two epochs of 3 steps with the training feed's flags: at K = 2 one
    dispatch and a 1-step tail per epoch, the same run as K = 1."""
    feed = ("--frame_dedup", "--device_audio", "--locality_run", "8")
    runs = []
    for k in (1, 2):
        cfg = train_entry.parse_opt(_argv(
            fixture_dirs, f"exp_k{k}", *feed, "--steps_per_dispatch",
            str(k)))
        runs.append(train_lib.train(cfg, max_steps_per_epoch=3,
                                    device="cpu"))
    (state_1, hist_1), (state_2, hist_2) = runs
    assert [h["steps"] for h in hist_2] == [h["steps"] for h in hist_1] \
        == [3, 3]
    assert state_2.step == state_1.step == 6
    for key in ("loss", "score"):
        assert [h[key] for h in hist_2] == [h[key] for h in hist_1], key
    base = fixture_dirs[0]
    sd_1, sd_2 = (torch.load(base / exp / "pretrain" / "latest.pth",
                             weights_only=True) for exp in ("exp_k1",
                                                            "exp_k2"))
    assert set(sd_1) == set(sd_2)
    for key, value in sd_1.items():
        assert torch.equal(sd_2[key], value), key


# -- (e) the profiler window -------------------------------------------------

@pytest.mark.parametrize("k", [2, 4])
def test_profile_window_under_steps_per_dispatch(fixture_dirs, monkeypatch,
                                                 k):
    """18 steps at K: one trace, opened at the first dispatch at or after
    step 10 and closed at the first at or after step 15."""
    uploads, window = [], []
    to_device, profile = train_lib.to_device, train_lib.profile

    def counting(*args, **kw):
        uploads.append(1)
        return to_device(*args, **kw)

    @__import__("contextlib").contextmanager
    def recording(*args, **kw):
        window.append(len(uploads))
        with profile(*args, **kw) as prof:
            yield prof
        window.append(len(uploads))

    monkeypatch.setattr(train_lib, "to_device", counting)
    monkeypatch.setattr(train_lib, "profile", recording)
    trace_dir = fixture_dirs[0] / f"trace_k{k}"
    cfg = train_entry.parse_opt(_argv(
        fixture_dirs, f"exp_trace_k{k}", "--model_name", "resnet",
        "--modality", "V", "--n_frames", "1", "--batch_size", "2",
        "--epochs", "1", "--steps_per_dispatch", str(k),
        "--profile_dir", str(trace_dir)))
    _, history = train_lib.train(cfg, max_steps_per_epoch=18, device="cpu")
    assert history[0]["steps"] == 18
    assert tuple(window) == train_lib.profile_window(k) \
        == {2: (10, 16), 4: (12, 16)}[k]
    files = sorted(trace_dir.glob("trace_*.json"))
    assert len(files) == 1
    names = {e.get("name", "") for e in
             json.loads(files[0].read_text())["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)


@pytest.mark.parametrize("k,want", [
    (2, [("start", 10), ("stop", 16)]),   # closes only after the epoch
    (4, []),                              # never opens
])
def test_jax_profile_window_under_steps_per_dispatch(tmp_path, monkeypatch,
                                                     k, want):
    """ROADMAP.md C7, not copied: JAX's loop tests ``step_i == 10`` and
    ``== 15`` while step_i moves by K. Its steps are stubbed (the window
    is the loop's), the profiler records the step it is called at."""
    steps, calls = [0], []

    def single(*args, **kw):
        def step(state, batch, rng, *rest):
            steps[0] += 1
            return state, {"loss": jnp.zeros(())}
        return step

    def multi(*args, **kw):
        def step(state, batches, rng, *rest):
            n = jax.tree_util.tree_leaves(batches)[0].shape[0]
            steps[0] += n
            return state, {"loss": jnp.zeros((n,))}
        return step

    def evaluate(*args, **kw):
        def step(params, batch_stats, batch, *rest):
            return jnp.zeros((batch["AU"].shape[0], 21)), jnp.zeros(())
        return step

    monkeypatch.setattr(jax_train_lib, "make_train_step", single)
    monkeypatch.setattr(jax_train_lib, "make_multi_train_step", multi)
    monkeypatch.setattr(jax_train_lib, "make_eval_step", evaluate)
    monkeypatch.setattr(jax.profiler, "start_trace",
                        lambda *a, **kw: calls.append(("start", steps[0])))
    monkeypatch.setattr(jax.profiler, "stop_trace",
                        lambda *a, **kw: calls.append(("stop", steps[0])))
    root, labels = str(tmp_path / "root"), str(tmp_path / "labels")
    jax_generate_synthetic_dataset(root, labels, n_videos=3,
                                   frames_per_video=80, image_size=32,
                                   audio_secs=2.0)
    cfg = JaxConfig(root=root, lmdb_label_dir=labels,
                    cache_dir=str(tmp_path / "cache"),
                    exp_dir=str(tmp_path / "exp"), model_name="resnet",
                    modality="V", task="AU", n_frames=1, image_size=32,
                    batch_size=8, downsample_rate=1, epochs=1,
                    compute_dtype="float32", use_pallas=False,
                    host_threads=2, device_augment=True,
                    steps_per_dispatch=k, profile_dir=str(tmp_path / "tr"))
    jax_train_lib.train(cfg, max_steps_per_epoch=16)
    assert calls == want


# -- (f) graph-safe steps ----------------------------------------------------

@pytest.mark.parametrize("module", ["preprocess", "losses", "audio",
                                    "augment"])
def test_device_constants_equal_per_call_values(module):
    """Each constant the step reads is made once per device (and dtype)
    and equals what the code made at every call before."""
    cpu = torch.device("cpu")
    if module == "preprocess":
        for c in (1, 3, 4):
            for dtype in (torch.float32, torch.bfloat16):
                got = tpre.clip_constants(c, cpu, dtype)
                assert got is tpre.clip_constants(c, cpu, dtype)
                want = (torch.as_tensor(tpre.CLIP_MEAN[:c]).to(dtype),
                        torch.as_tensor(tpre.CLIP_STD[:c]).to(dtype),
                        torch.tensor(1.0 / 255.0, dtype=dtype))
                for a, b in zip(got, want):
                    assert a.dtype == b.dtype and torch.equal(a, b)
        x = torch.from_numpy(_batch(1, b=1, t=2, image=8)["clip"])
        mean, std = (torch.from_numpy(a[:3]) for a in (tpre.CLIP_MEAN,
                                                        tpre.CLIP_STD))
        assert torch.equal(tpre.normalize_clip(x),
                           (x.float() * torch.tensor(1.0 / 255.0) - mean)
                           / std)
    elif module == "losses":
        like = torch.zeros(2)
        for value in (tlosses.AU_POS_WEIGHT, tlosses.EX_CLASS_WEIGHT,
                      np.ones(12), [1.5, 2.0]):
            got = tlosses._const(value, like)
            assert got is tlosses._const(value, like)
            assert torch.equal(got, torch.as_tensor(value,
                                                    dtype=torch.float32))
        num = torch.tensor(3.0)
        for den in (7, 0.3, 0, torch.tensor(4.0), torch.tensor(0.0)):
            want = torch.as_tensor(den, dtype=torch.float32)
            want = torch.where(want > 0, num / want.clamp(min=1e-12),
                               torch.zeros_like(num))
            assert torch.equal(tlosses._safe_div(num, den), want)
    elif module == "audio":
        basis, fb = taudio._frontend_tables(cpu)
        assert basis is taudio._frontend_tables(cpu)[0]
        left = (taudio.N_FFT - taudio.WIN_LENGTH) // 2
        assert torch.equal(basis, torch.from_numpy(taudio._dft_basis(
            taudio.N_FFT, taudio.WIN_LENGTH)[left:left + taudio.WIN_LENGTH]))
        assert torch.equal(fb, torch.from_numpy(taudio.mel_filterbank()))
    else:
        tables = taug._device_tables(cpu)
        assert tables is taug._device_tables(cpu)
        assert torch.equal(tables["smooth"], torch.as_tensor(
            taug._SMOOTH_K).reshape(1, 1, 3, 3))
        assert torch.equal(tables["enhance"],
                           torch.zeros(1, dtype=torch.int64).new_tensor(
                               taug._ENHANCE_IDS))
        for got, want in zip(tables["policies"], taug._policy_tables()):
            want = torch.tensor(np.array(want))
            assert got.dtype == want.dtype and torch.equal(got, want)


# ops that wait for the card: a value read on the host, or an output
# whose size depends on the data
HOST_SYNC_OPS = ("_local_scalar_dense", "nonzero", "bincount", "unique",
                 "masked_select", "repeat_interleave", "item")


class _HostSyncs(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if any(name.startswith(op) or name.startswith("_" + op)
               for op in HOST_SYNC_OPS):
            self.seen.append(func.__name__)
        return func(*args, **(kwargs or {}))


def test_graphed_step_makes_no_host_sync(synthetic_avformer_sd):
    """The body a CUDA graph captures, on the main path's inputs
    (augmentation, dropout, the arena's windows, a dedup batch's gather,
    device audio): no op that reads a value back or sizes its output by
    the data."""
    cfg = Config(**{**STEP_CFG, "dropout_rate": 0.2, "device_augment": True,
                    "device_audio": True, "n_frames": 16})
    model = _model(cfg, synthetic_avformer_sd)
    state = tstep.create_train_state(cfg, model)
    batch = _tensors(_dedup(_batch(70)))
    del batch["audio_features"]
    rs = np.random.RandomState(71)
    arena = torch.from_numpy(rs.randn(cfg.sample_len_frames + 500)
                             .astype(np.float32))
    batch["audio_ofs"] = torch.tensor([0, 100, 250, 500], dtype=torch.int32)
    batch["audio_len"] = torch.tensor([cfg.sample_len_frames, 300_000, 800,
                                       cfg.sample_len_frames],
                                      dtype=torch.int32)
    gen = torch.Generator().manual_seed(5)
    # the update is PyTorch's capturable Adam on the card; on the CPU its
    # step count is a host value
    updates = []
    state.update = lambda: updates.append(len(updates))
    with _HostSyncs() as mode:
        metrics = tstep._step_body(cfg, model, loss_suite(model), state,
                                   batch, gen, arena, graphed=True)
    assert mode.seen == []
    assert updates == [0] and state.step == 0
    assert torch.isfinite(metrics["loss"])
    assert all(p.grad is not None and p.grad.abs().sum() > 0
               for p in state.params)
