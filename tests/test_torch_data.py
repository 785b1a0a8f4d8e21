"""auformer_torch's data layer against the JAX package's, on the CPU.

The JAX package's synthetic fixture (32x32 JPEGs, three videos: two in the
test split, one in train between them) read by both packages: FrameStores
written by either read back byte-equal through the other, the native
readers decode alike (the same C++ decode source and the same libjpeg),
and the split arrays, ``Aff2TestDataset`` items and ``DataLoader`` batches
are equal, host audio features included (the same numpy). The port's own
fixtures (encoded by its native encoder, not cv2) open in the JAX package.
"""
import os
import pickle

import numpy as np
import pytest

from auformer.core.config import Config as JaxConfig
from auformer.data import DataLoader as JaxLoader
from auformer.data import FrameStore as JaxStore
from auformer.data import FrameStoreWriter as JaxWriter
from auformer.data import SubsetSequentialSampler as JaxSeq
from auformer.data import create_dataset_split as jax_split
from auformer.data.fixtures import generate_synthetic_dataset
from auformer.data.native import NativeFrameStore as JaxNative
from auformer.data.testset import Aff2TestDataset as JaxTestset
from auformer.ops import audio_host as jax_audio_host
from auformer_torch.core.config import Config
from auformer_torch.data import (Aff2CompDataset, Aff2TestDataset,
                                 BlockShuffleSampler, DataLoader, FrameStore,
                                 FrameStoreWriter, Prefetcher,
                                 SubsetSequentialSampler, collate,
                                 create_dataset_split, native, shard_indices)
from auformer_torch.data import fixtures as port_fixtures
from auformer_torch.ops import audio_host

CFG = dict(task="AU", n_frames=4, dilation=2, image_size=32, host_threads=2)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("data")
    root, labels = str(base / "root"), str(base / "labels")
    generate_synthetic_dataset(root, labels, n_videos=3, frames_per_video=10,
                               image_size=32, splits=["test", "train"])
    return root, labels, str(base / "cache")


def _cfgs(dirs, **kw):
    root, labels, cache = dirs
    paths = dict(root=root, lmdb_label_dir=labels, cache_dir=cache)
    return (JaxConfig(use_pallas=False, **paths, **CFG, **kw),
            Config(**paths, **CFG, **kw))


def _assert_same(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, (str, int, np.integer)):
            assert got[k] == v, k
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                          err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stores_read_back_through_the_other_package(tmp_path, writer):
    """Several shards, a duplicate key (the last value wins), binary
    values: the other package's Python store and native reader return the
    same bytes."""
    path = str(tmp_path / "store")
    rs = np.random.RandomState(3)
    values = {f"v{i // 7}/{i:05d}.jpg": rs.bytes(int(rs.randint(1, 90)))
              for i in range(40)}
    write = (JaxWriter if writer == "jax" else FrameStoreWriter)
    with write(path, shard_size=256) as w:
        for k, v in values.items():
            w.put(k, b"stale")
            w.put(k, v)
    assert len(os.listdir(path)) > 3                 # several shards
    read = FrameStore if writer == "jax" else JaxStore
    readers = [read(path), (native.NativeFrameStore(path) if writer == "jax"
                            else JaxNative(path))]
    for store in readers:
        assert len(store) == len(values)
        for k, v in values.items():
            assert bytes(store.get(k)) == v
        assert store.get("missing") is None


@pytest.mark.parametrize("store,channels,size", [
    ("croped_jpeg", 3, 32), ("croped_mask", 1, 32), ("croped_jpeg", 3, 16)])
def test_native_decode_matches_jax(dirs, store, channels, size):
    """Every key of the fixture with None, empty and missing keys among
    them, colour and grayscale; at the wrong size every frame stays black
    with ok False in both."""
    path = os.path.join(dirs[1], store)
    keys = sorted(JaxStore(path).keys())
    keys[3:3] = [None, "", "vid009/00001.jpg"]
    got, got_ok = native.NativeFrameStore(path, 3).decode_batch(
        keys, size, size, channels)
    want, want_ok = JaxNative(path, 3).decode_batch(keys, size, size,
                                                    channels)
    np.testing.assert_array_equal(got_ok, want_ok)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (len(keys), size, size, channels)
    assert got_ok.sum() == (len(keys) - 3 if size == 32 else 0)
    assert not got[~got_ok].any()


def test_reader_decoder_is_libjpeg_here():
    """This host has libjpeg, so the port decodes with the JAX package's
    decode source; the library is built under .cache/native, not next to
    the source."""
    assert native.decoder() == "libjpeg"
    lib = native.build()
    assert lib.parent == native.BUILD_DIR and lib.name.startswith(
        "libframestore_libjpeg-")
    assert not list(native.SRC_DIR.glob("*.so"))


def test_create_dataset_split_matches_jax(dirs, tmp_path):
    root = dirs[0]
    got = create_dataset_split(root, save_dir=str(tmp_path / "port"))
    want = jax_split(root, save_dir=str(tmp_path / "jax"))
    assert set(got) == set(want) == {"AU", "EX", "VA", "ALL"}
    for task in want:
        _assert_same(got[task], want[task])
        for name in (f"split_dict_{task}.pkl", f"split_dict_test_{task}.pkl"):
            with open(tmp_path / "port" / name, "rb") as f:
                _assert_same(pickle.load(f), want[task])


@pytest.mark.parametrize("modality,device_audio", [
    ("A;V", False), ("A;V", True), ("V;M", False)])
def test_testset_items_match_jax(dirs, modality, device_audio):
    """Every test row: clip (black history at video starts, the mask
    channel under 'M'), labels, Index, video_id, and the host audio
    features and raw window (or the left-aligned window and its length
    under device_audio), plus get_audio_window."""
    jcfg, cfg = _cfgs(dirs, modality=modality, device_audio=device_audio)
    want_ds, got_ds = JaxTestset(jcfg), Aff2TestDataset(cfg)
    ids = np.nonzero(want_ds.test_ids)[0]
    np.testing.assert_array_equal(np.nonzero(got_ds.test_ids)[0], ids)
    assert len(ids) == 20 and len(got_ds) == len(want_ds) == 30
    for i in ids:
        got, want = got_ds[int(i)], want_ds[int(i)]
        _assert_same(got, want)
        if modality == "A;V":
            vid = want["video_id"]
            w_audio, w_n = want_ds.get_audio_window(vid, int(i))
            g_audio, g_n = got_ds.get_audio_window(vid, int(i))
            assert g_n == w_n
            np.testing.assert_array_equal(g_audio, w_audio)
    first = got_ds[int(ids[0])]["clip"]
    assert not first[:-1].any() and first[-1].any()


def test_host_audio_pipeline_matches_jax(dirs):
    """load_wav windows, the STFT power, the reference features of short
    and full windows: the same float32 values."""
    wav_path = os.path.join(dirs[0], "vid000.wav")
    for offset, n in ((0, 882), (100, 20_000), (0, None)):
        got, sr = audio_host.load_wav(wav_path, offset, n)
        want, _ = jax_audio_host.load_wav(wav_path, offset, n)
        assert sr == 44100
        np.testing.assert_array_equal(got, want)
    rs = np.random.RandomState(1)
    for n in (1000, 44_100, 441_000):
        audio = (rs.randn(1, n) * 0.1).astype(np.float32)
        np.testing.assert_array_equal(audio_host.stft_power(audio),
                                      jax_audio_host.stft_power(audio))
        for g, w in zip(audio_host.reference_audio_features(audio),
                        jax_audio_host.reference_audio_features(audio)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("batch_size,drop_last", [(8, False), (6, True)])
def test_dataloader_batches_match_jax(dirs, batch_size, drop_last):
    jcfg, cfg = _cfgs(dirs, modality="A;V")
    want_ds, got_ds = JaxTestset(jcfg), Aff2TestDataset(cfg)
    ids = np.nonzero(want_ds.test_ids)[0]
    want = list(JaxLoader(want_ds, batch_size, JaxSeq(ids), num_threads=2,
                          drop_last=drop_last))
    loader = DataLoader(got_ds, batch_size, SubsetSequentialSampler(ids),
                        num_threads=2, drop_last=drop_last,
                        prefetch_batches=3)
    got = list(loader)
    assert len(got) == len(want) == len(loader)
    for g, w in zip(got, want):
        _assert_same(g, w)


def test_samplers_prefetcher_and_collate():
    from auformer.data import BlockShuffleSampler as JaxBlock
    from auformer.data import collate as jax_collate
    from auformer.data import shard_indices as jax_shard

    idx = list(range(3, 40))
    got, want = BlockShuffleSampler(idx, 5, seed=7), JaxBlock(idx, 5, seed=7)
    for _ in range(2):                                 # two epochs
        assert list(got) == list(want)
    assert shard_indices(idx, 1, 4) == jax_shard(idx, 1, 4)
    samples = [{"Index": i, "x": np.full(3, i, np.float32)} for i in idx[:4]]
    _assert_same(collate(samples), jax_collate(samples))
    pf = Prefetcher(iter(range(50)), depth=2)
    assert [pf.next() for _ in range(3)] == [0, 1, 2]
    pf.stop()
    assert pf.next() is None


def test_port_fixture_opens_in_the_jax_testset(tmp_path):
    """Frames the port's fixture encodes (native encoder, q90) read and
    decode in the JAX package exactly as in the port, and lie near their
    sources; the split, labels and wavs are the JAX fixture's layout."""
    root, labels = str(tmp_path / "root"), str(tmp_path / "labels")
    port_fixtures.generate_synthetic_dataset(
        root, labels, n_videos=2, frames_per_video=[12, 9], image_size=32,
        splits=["test"], n_threads=3)
    paths = dict(root=root, lmdb_label_dir=labels,
                 cache_dir=str(tmp_path / "cache"), modality="V;M")
    want_ds = JaxTestset(JaxConfig(use_pallas=False, **paths, **CFG))
    got_ds = Aff2TestDataset(Config(**paths, **CFG))
    assert len(want_ds) == 21 and want_ds.test_ids.sum() == 21
    for i in range(21):
        _assert_same(got_ds[i], want_ds[i])
    frames, ok = got_ds.native_image.decode_batch(
        [f"vid001/{t + 1:05d}.jpg" for t in range(9)], 32, 32, 3)
    source = np.stack([port_fixtures.fixture_frame(0, 1, t, 32)
                       for t in range(9)])
    err = np.abs(frames.astype(np.int16) - source)
    assert ok.all() and err.mean() < 6 and err.max() <= 48


@pytest.mark.parametrize("modality", ["A;V", "V;M"])
def test_host_augmented_items_match_jax(dirs, modality):
    """Training's host AutoAugment (set_aug(True), a given aug_seed): every
    item equals the JAX dataset's (PIL), the mask channel under 'M' passed
    through the policy and flipped with the clip; set_aug(False) gives the
    plain clips back."""
    from auformer.data.dataset import Aff2CompDataset as JaxDataset
    jcfg, cfg = _cfgs(dirs, modality=modality)
    want_ds, got_ds = JaxDataset(jcfg), Aff2CompDataset(cfg)
    for ds in (want_ds, got_ds):
        ds.set_aug(True)
        ds.aug_seed = 7 * 100003 + 1
    changed = 0
    for i in range(len(got_ds)):
        got = got_ds[i]
        _assert_same(got, want_ds[i])
        got_ds.set_aug(False)
        changed += not np.array_equal(got_ds[i]["clip"], got["clip"])
        got_ds.set_aug(True)
    assert changed > len(got_ds) // 2


def test_missing_image_store_raises(dirs, tmp_path):
    """Without an image store no clip is assembled: black frames are never
    made up for a store that is not there."""
    root, _, _ = dirs
    cfg = Config(root=root, lmdb_label_dir=str(tmp_path / "none"),
                 cache_dir=str(tmp_path / "cache"), **CFG)
    ds = Aff2TestDataset(cfg)
    with pytest.raises(FileNotFoundError, match="image store"):
        ds[0]
