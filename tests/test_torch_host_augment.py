"""auformer_torch's host AutoAugment (``data/transforms.py``) against the
JAX package's PIL path (``auformer/data/transforms.py``), on the CPU.

Everything is exact, byte for byte: each of the 14 ops against PIL's
``_apply_op`` with its sign forced, at every magnitude of the table and
both signs, at 112x112 and 256x256 (emonet's width); ``train_augment`` on
seeded 3- and 4-channel clips covering all 25 sub-policies, with the same
``random.Random`` seeds on both sides; and the SHA-256 digest that
chip_smoke.py checks where PIL is not installed. Then the train loop:
``train.main`` without ``--device_augment`` augments on the host, as the
JAX package does by default, the same for one seed, with or without
``--frame_dedup`` (which host augmentation turns off), and a loader
batch does not depend on the number of loader threads.
"""
import random

import numpy as np
import pytest
import torch
from PIL import Image

from auformer.data import transforms as jax_tf
from auformer_torch import train as train_entry
from auformer_torch import train_lib
from auformer_torch.core.config import Config
from auformer_torch.data import (Aff2CompDataset, DataLoader,
                                 SubsetSequentialSampler)
from auformer_torch.data import transforms as tf
from auformer_torch.data.fixtures import generate_synthetic_dataset
from auformer_torch.ops.preprocess import normalize_clip, random_flip_clips
from auformer_torch.parallel import step as tstep

# SHA-256 of train_augment over the clips of transforms.digest_seeds(),
# computed from PIL (the JAX package's train_augment); chip_smoke.py holds
# the port to the same constant on a machine without PIL
PIL_DIGEST = "ab03ee6ec397065e602c19f69374b3fa813e9743dc9fbcaedd7e47bdac851dd9"


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread: the train loops below run loader threads
    beside torch's pool, which oversubscribes the cores beside other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(size: int) -> np.ndarray:
    """uint8 (6, size, size, 3): two of uniform noise, two noisy
    gradients, a constant frame (lo == hi, one histogram bin) and a
    two-level frame."""
    rs = np.random.RandomState(size)
    yy, xx = np.mgrid[0:size, 0:size]
    base = np.stack([xx * 255 // size, yy * 255 // size,
                     (xx + yy) * 127 // size], -1)
    out = [rs.randint(0, 256, (size, size, 3)) for _ in range(2)]
    out += [np.clip(base + rs.randint(-10, 11, (size, size, 3)), 0, 255)
            for _ in range(2)]
    out.append(np.full((size, size, 3), 77))
    out.append(np.where(rs.rand(size, size, 1) < 0.5, 10, 240)
               * np.ones(3, int))
    return np.stack(out).astype(np.uint8)


def _pil_op(frame, op, magnitude, sign):
    """The JAX package's PIL op with its random sign forced."""
    rng = random.Random(0)
    rng.choice = lambda seq: sign
    return np.asarray(jax_tf._apply_op(Image.fromarray(frame), op,
                                       magnitude, rng))


@pytest.mark.parametrize("size", [112, 256])
@pytest.mark.parametrize("op", sorted(tf._RANGES))
def test_op_matches_pil(op, size):
    """Every magnitude of the op's table at both signs, on all six frames
    at once against PIL frame by frame."""
    x = _frames(size)
    for k, magnitude in enumerate(tf._RANGES[op]):
        for sign in (-1, 1):
            want = np.stack([_pil_op(f, op, magnitude, sign) for f in x])
            got = tf.apply_op(x.copy(), op, magnitude, sign)
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{op} m{k} sign {sign}")


def test_rotation_stays_in_pil_fixed_point():
    """PIL samples a rotation in 16.16 fixed point only while every
    corner maps within +-32768; the table's 20 angles do at 112 and 256,
    and a frame too large for that raises instead of sampling otherwise."""
    for size in (112, 256):
        for magnitude in tf._RANGES["rotate"][1:]:
            for sign in (-1, 1):
                index, valid = tf._rotate_map(
                    float(magnitude * sign) % 360.0, size, size)
                assert index.shape == valid.shape == (size * size,)
    with pytest.raises(ValueError, match="fixed-point"):
        tf._rotate_map(10.0, 70_000, 70_000)


def test_train_augment_matches_jax():
    """240 seeded clips of 3 and 4 channels, ``Random((seed << 32) ^ i)``
    on both sides: every sub-policy and both flips occur, and the clips are
    byte-equal, the mask channel passed through the policy and flipped."""
    policies, flips = set(), set()
    for i in range(240):
        rs = np.random.RandomState(i)
        clip = rs.randint(0, 256, (4, 32, 32, 3 + i % 2)).astype(np.uint8)
        seed = (11 << 32) ^ i
        want = jax_tf.train_augment(clip.copy(), random.Random(seed))
        got = tf.train_augment(clip.copy(), random.Random(seed))
        np.testing.assert_array_equal(got, want, err_msg=str(i))
        policies.add(random.Random(seed).randint(
            0, len(tf.IMAGENET_POLICIES) - 1))
        if i % 2:
            flipped = np.array_equal(got[..., 3], clip[:, :, ::-1, 3])
            assert flipped or np.array_equal(got[..., 3], clip[..., 3])
            flips.add(flipped)
    assert policies == set(range(len(tf.IMAGENET_POLICIES)))
    assert flips == {True, False}


class _Recorder(random.Random):
    """A Random that records its sub-policy and sign draws."""

    def __init__(self, seed):
        super().__init__(seed)
        self.policy, self.signs = None, set()

    def randint(self, a, b):
        self.policy = super().randint(a, b)
        return self.policy

    def choice(self, seq):
        sign = super().choice(seq)
        self.signs.add(sign)
        return sign


def test_digest_ties_the_port_to_pil():
    """The digest clips draw every sub-policy and, in every sub-policy
    with a signed op, both signs; PIL's train_augment over them hashes to
    PIL_DIGEST, and so does the port's."""
    signed = {i for i, p in enumerate(tf.IMAGENET_POLICIES)
              if {p[1], p[4]} & tf.SIGNED_OPS}
    signs: dict[int, set] = {}
    for seed in tf.digest_seeds():
        rng = _Recorder(seed)
        tf.train_augment(tf.digest_clip(seed), rng)
        signs.setdefault(rng.policy, set()).update(rng.signs)
    assert set(signs) == set(range(len(tf.IMAGENET_POLICIES)))
    assert all(signs[i] == {-1, 1} for i in signed)
    assert tf.augment_digest(jax_tf.train_augment) == PIL_DIGEST
    assert tf.augment_digest() == PIL_DIGEST


# -- the dataset and the train loop ------------------------------------------

@pytest.mark.parametrize("channels", [1, 3, 4])
def test_the_step_only_normalizes_and_flips_host_augmented_clips(channels):
    """Without device_augment, prep_batch's train path on a uint8 clip of
    1, 3 or 4 (V;M) channels, as the zoo's models take them, is the
    normalization and the whole-clip flip alone."""
    clip = torch.from_numpy(np.random.RandomState(channels).randint(
        0, 256, (3, 2, 8, 8, channels)).astype(np.uint8))
    got = tstep.prep_batch({"clip": clip}, train=True,
                           generator=torch.Generator().manual_seed(5),
                           device_augment=False)["clip"]
    want = random_flip_clips(normalize_clip(clip),
                             torch.Generator().manual_seed(5))
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def fixture_dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("host_augment")
    root, labels = str(base / "root"), str(base / "labels")
    generate_synthetic_dataset(root, labels, n_videos=4,
                               frames_per_video=[40, 40, 40, 20],
                               image_size=32, n_threads=2)
    return base, root, labels


def test_loader_batch_does_not_depend_on_its_threads(fixture_dirs):
    """With host augmentation on, the first batch is the same at one and
    at four loader threads, in the threads or through an AugmentPool's
    worker processes, and differs from the unaugmented batch."""
    base, root, labels = fixture_dirs
    ds = Aff2CompDataset(Config(root=root, lmdb_label_dir=labels,
                                cache_dir=str(base / "cache"), n_frames=4,
                                image_size=32, modality="V"))
    ids = np.nonzero(ds.train_ids)[0][:8]
    ds.aug_seed = 7 * 100003

    def first(threads: int, aug: bool, pool=None) -> np.ndarray:
        ds.set_aug(aug, pool)
        loader = DataLoader(ds, 8, SubsetSequentialSampler(ids),
                            num_threads=threads, drop_last=True)
        return next(iter(loader))["clip"]

    one = first(1, True)
    np.testing.assert_array_equal(first(4, True), one)
    pool = tf.AugmentPool(2, 8, ds.clip_bytes)
    try:
        np.testing.assert_array_equal(first(4, True, pool), one)
    finally:
        pool.close()
    assert not np.array_equal(first(4, False), one)


def _argv(fixture_dirs, exp, *extra):
    base, root, labels = fixture_dirs
    return ["--root", root, "--lmdb_label_dir", labels,
            "--cache_dir", str(base / "cache"), "--exp_dir", str(base / exp),
            "--image_size", "32", "--n_frames", "4", "--batch_size", "4",
            "--downsample_rate", "2", "--epochs", "1",
            "--compute_dtype", "float32", "--host_threads", "2",
            "--seed", "7", "--device_audio", "--locality_run", "8", *extra]


def test_steps_per_dispatch_with_host_augmentation(fixture_dirs):
    """--steps_per_dispatch 2 with host augmentation: 3 steps (a dispatch
    of 2 and a 1-step tail) give the K = 1 run's losses, bit for bit."""
    runs = []
    for exp, k in (("exp_k1", "1"), ("exp_k2", "2")):
        cfg = train_entry.parse_opt(_argv(fixture_dirs, exp,
                                          "--steps_per_dispatch", k))
        state, history = train_lib.train(cfg, max_steps_per_epoch=3,
                                         device="cpu")
        assert state.step == history[0]["steps"] == 3
        runs.append([h["loss"] for h in history])
    assert runs[0] == runs[1] and np.isfinite(runs[0]).all()


def test_train_main_augments_on_the_host(fixture_dirs, monkeypatch):
    """``train.main`` without --device_augment: augmentation on for the
    epoch (seeded seed * 100003 + epoch) and off for the evaluation; the
    run writes its checkpoint; a second run with the seed gives the same
    losses and scores, and so does a run with --frame_dedup, which trains
    dense under host augmentation."""
    calls = []
    set_aug = Aff2CompDataset.set_aug

    def record(self, on, pool=None):
        calls.append((bool(on), self.aug_seed, type(pool).__name__))
        set_aug(self, on, pool)
    monkeypatch.setattr(Aff2CompDataset, "set_aug", record)
    dedup = []
    set_dedup = Aff2CompDataset.set_frame_dedup
    monkeypatch.setattr(Aff2CompDataset, "set_frame_dedup",
                        lambda self, on: (dedup.append(on),
                                          set_dedup(self, on)))
    runs = []
    for exp, extra in (("exp_a", ()), ("exp_b", ()),
                       ("exp_dedup", ("--frame_dedup",))):
        calls.clear()
        _, history = train_entry.main(_argv(fixture_dirs, exp, *extra),
                                      device="cpu")
        # aug_seed is set just after set_aug(True): the seed recorded at
        # the eval's set_aug(False) is the epoch's; the epoch augments in
        # an AugmentPool's processes
        assert calls == [(True, 0, "AugmentPool"),
                         (False, 7 * 100003, "NoneType")], calls
        assert (fixture_dirs[0] / exp / "pretrain" / "latest.pth").is_file()
        runs.append(history)
    assert dedup == []
    a, b, d = runs
    assert a[0]["steps"] >= 5 and np.isfinite(a[0]["loss"])
    for other in (b, d):
        assert [h["loss"] for h in other] == [h["loss"] for h in a]
        assert [h["scores"] for h in other] == [h["scores"] for h in a]
