"""The train entry point of auformer_torch on the port's fixtures, on the
CPU: it refuses the CPU unless asked, ``--steps_per_dispatch 2`` runs,
the loader's host augmentation trains (and ``--frame_dedup`` stays off
with it), and ``--device_audio`` trains without the wav arena.

The fixtures and the flags are shared with tests/test_torch_train.py,
whose train loop tests (checkpoints, resume, determinism) take them from
here.
"""
import numpy as np
import pytest
import torch

from auformer_torch import train as train_entry
from auformer_torch import train_lib


@pytest.fixture(scope="module")
def one_intra_op_thread():
    """One intra-op thread from the first train loop of a module to its
    end: the loops run loader and prefetch threads beside torch's pool,
    and with several test workers on one machine a full pool per worker
    oversubscribes the cores (tests/test_torch_feed.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture_dirs(tmp_path_factory, one_intra_op_thread):
    from auformer_torch.data.fixtures import generate_synthetic_dataset
    base = tmp_path_factory.mktemp("train")
    root, labels = str(base / "root"), str(base / "labels")
    generate_synthetic_dataset(root, labels, n_videos=4,
                               frames_per_video=[40, 40, 40, 20],
                               image_size=32, n_threads=2)
    return base, root, labels


def _argv(base, root, labels, exp, *extra):
    return ["--root", root, "--lmdb_label_dir", labels,
            "--cache_dir", str(base / "cache"), "--exp_dir", str(base / exp),
            "--image_size", "32", "--batch_size", "4",
            "--downsample_rate", "2", "--epochs", "2",
            "--device_augment", "--compute_dtype", "float32",
            "--host_threads", "2", "--seed", "7", *extra]


def test_entry_point_refuses_the_cpu_unasked(fixture_dirs):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is valid")
    base, root, labels = fixture_dirs
    with pytest.raises(RuntimeError, match="CUDA"):
        train_entry.main(_argv(base, root, labels, "exp_cpu"))


def test_steps_per_dispatch_runs(fixture_dirs):
    """--steps_per_dispatch 2 (ROADMAP.md A13), refused until the K-step
    dispatch was ported: 3 steps are a dispatch of 2 and a 1-step tail
    (tests/test_torch_multistep.py holds them against K = 1)."""
    base, root, labels = fixture_dirs
    cfg = train_entry.parse_opt(_argv(base, root, labels, "exp_spd",
                                      "--steps_per_dispatch", "2",
                                      "--epochs", "1", "--n_frames", "4"))
    state, history = train_lib.train(cfg, max_steps_per_epoch=3,
                                     device="cpu")
    assert state.step == history[0]["steps"] == 3
    assert np.isfinite(history[0]["loss"])


def test_host_augmentation_trains(fixture_dirs):
    """Without --device_augment (the JAX package's default) the loader
    augments each clip on the host: 2 steps; the epoch's aug_seed is
    seed * 100003 + epoch and the evaluation reads plain clips; and
    --frame_dedup stays off, since host augmentation is per sample
    (tests/test_torch_host_augment.py holds the ops against PIL)."""
    from auformer_torch.data import Aff2CompDataset
    base, root, labels = fixture_dirs
    argv = [a for a in _argv(base, root, labels, "exp_host",
                             "--epochs", "1", "--n_frames", "4",
                             "--frame_dedup")
            if a != "--device_augment"]
    cfg = train_entry.parse_opt(argv)
    dataset = Aff2CompDataset(cfg)
    state, history = train_lib.train(cfg, dataset=dataset,
                                     max_steps_per_epoch=2, device="cpu")
    assert state.step == history[0]["steps"] == 2
    assert np.isfinite(history[0]["loss"])
    assert not dataset.aug and dataset.aug_seed == 7 * 100003
    assert not dataset.frame_dedup


def test_device_audio_trains_without_the_arena(fixture_dirs):
    """--device_audio --audio_arena_mb 0: raw windows ride the batch and
    the step computes their features; one step."""
    base, root, labels = fixture_dirs
    cfg = train_entry.parse_opt(_argv(base, root, labels, "exp_audio",
                                      "--device_audio", "--audio_arena_mb",
                                      "0", "--epochs", "1"))
    state, history = train_lib.train(cfg, max_steps_per_epoch=1,
                                      device="cpu")
    assert state.step == 1 and np.isfinite(history[0]["loss"])
