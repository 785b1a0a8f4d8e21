"""auformer_torch's submission postprocess and decoder-free ingest
(postprocess.py, data/ingest.py, data/utils.py) against the JAX package's,
on the cases of tests/test_inference.py and tests/test_ingest.py."""
import json
import os
import pickle
import shutil

import cv2
import numpy as np
import pytest

from auformer import postprocess as jax_post
from auformer.data import ingest as jax_ingest
from auformer.data import utils as jax_utils
from auformer_torch import postprocess
from auformer_torch.data import FrameStore, utils
from auformer_torch.data import ingest
from auformer_torch.data.video import Video

VIDEOS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "videos")


@pytest.mark.parametrize("source,target", [
    ([1, 2, 4, 5], 7), ([1, 2, 3], 3), ([5], 4), ([3, 9, 10], 2),
    ([1, 4, 6, 7, 20], 25), ([2, 3, 8], 6)])
def test_nearest_interp_matches_jax(source, target):
    assert postprocess.nearest_interp(source, target) == \
        jax_post.nearest_interp(source, target)
    if (source, target) == ([1, 2, 4, 5], 7):
        assert postprocess.nearest_interp(source, target) == \
            [0, 1, 1, 2, 3, 3, 3]


def _sparse_tree(base, name="vidX", detected=(1, 2, 4, 6)):
    """Sparse AU predictions of the detected frames and their aligned jpgs
    (tests/test_inference.py::test_expand_predictions_end_to_end)."""
    pred = base / "pred" / "AU"
    pred.mkdir(parents=True, exist_ok=True)
    rows = ["h"] + [f"row{i}" for i in detected]
    (pred / f"{name}.txt").write_text("\n".join(rows) + "\n")
    frames = base / "aligned" / name
    frames.mkdir(parents=True, exist_ok=True)
    for i in detected:
        (frames / f"{i:05d}.jpg").touch()


def test_expand_predictions_matches_jax(tmp_path):
    """Sparse rows of frames 1, 2, 4, 6 of an 8-frame video, and of a
    ``_left`` video whose count is its base video's: dense files equal to
    JAX's."""
    _sparse_tree(tmp_path)
    _sparse_tree(tmp_path, "vidY_left", (3, 4, 9))
    counts = {"vidX": 8, "vidY": 12}
    for pkg, out in ((postprocess, "port"), (jax_post, "jax")):
        pkg.expand_predictions(str(tmp_path / "pred"),
                               str(tmp_path / "aligned"), counts,
                               out_dir=str(tmp_path / out), tasks=("AU",))
    lines = (tmp_path / "port" / "AU" / "vidX.txt").read_text().split("\n")
    assert lines[:-1] == ["h", "row1", "row2", "row2", "row4", "row4",
                          "row6", "row6", "row6"]
    for name in ("vidX.txt", "vidY_left.txt"):
        assert (tmp_path / "port" / "AU" / name).read_text() == \
            (tmp_path / "jax" / "AU" / name).read_text()
    assert len((tmp_path / "port" / "AU" / "vidY_left.txt").read_text()
               .splitlines()) == 13


def test_video_frame_counts_and_main(tmp_path):
    """Both side-file names (``<video.ext>meta.json`` and
    ``<video>meta.json``) give JAX's counts; ``main`` writes the dense
    tree from them."""
    videos = tmp_path / "videos"
    videos.mkdir()
    for name, ext, meta_name, n in (("vidX", "mp4", "vidX.mp4meta.json", 8),
                                    ("vidY", "avi", "vidYmeta.json", 12)):
        (videos / f"{name}.{ext}").touch()
        (videos / meta_name).write_text(json.dumps(
            {"num_frames": n, "fps": 30.0}))
    got = postprocess.video_frame_counts(str(videos))
    assert got == {"vidX": 8, "vidY": 12}
    assert got == jax_post.video_frame_counts(str(videos))
    _sparse_tree(tmp_path)
    postprocess.main(["--predictions", str(tmp_path / "pred"),
                      "--frames_root", str(tmp_path / "aligned"),
                      "--video_dir", str(videos), "--out_dir",
                      str(tmp_path / "dense"), "--tasks", "AU"])
    assert len((tmp_path / "dense" / "AU" / "vidX.txt").read_text()
               .splitlines()) == 9


@pytest.fixture(scope="module")
def image_tree(tmp_path_factory):
    """tests/test_ingest.py's tree: two videos, frames 2, 1, 10."""
    root = tmp_path_factory.mktemp("tree")
    rs = np.random.RandomState(0)
    for v in ("vidB", "vidA"):
        d = root / v
        d.mkdir()
        for i in (2, 1, 10):
            img = (rs.rand(32, 32, 3) * 255).astype(np.uint8)
            cv2.imwrite(str(d / f"{i:05d}.jpg"), img)
    (root / "notes.txt").write_text("not a video dir")
    return str(root)


def test_iter_image_files_matches_jax(image_tree):
    got = list(ingest.iter_image_files(image_tree))
    assert [k for k, _ in got] == [
        "vidA/00001.jpg", "vidA/00002.jpg", "vidA/00010.jpg",
        "vidB/00001.jpg", "vidB/00002.jpg", "vidB/00010.jpg"]
    assert got == list(jax_ingest.iter_image_files(image_tree))


def test_create_image_store_matches_jax(image_tree, tmp_path):
    """The JPEG bytes as they are, the key list and its pickle, the same
    as the JAX package's store."""
    got_path, want_path = str(tmp_path / "port"), str(tmp_path / "jax")
    keys = ingest.create_image_store(image_tree, got_path)
    assert keys == jax_ingest.create_image_store(image_tree, want_path)
    got, want = FrameStore(got_path), FrameStore(want_path)
    for key in keys:
        assert got.get(key) == want.get(key)
    with open(os.path.join(image_tree, "vidA", "00001.jpg"), "rb") as f:
        assert got.get("vidA/00001.jpg") == f.read()
    with open(got_path + "_keys_cache.p", "rb") as f:
        assert pickle.load(f) == keys


def test_write_label_store_matches_jax(tmp_path):
    labels = {"v/1.jpg": np.array([1, 0] * 6, np.int8),
              "v/2.jpg": np.array([0, 1] * 6, np.int8)}
    ingest.write_label_store(str(tmp_path / "port"), labels)
    jax_ingest.write_label_store(str(tmp_path / "jax"), labels)
    got, want = FrameStore(str(tmp_path / "port")), \
        FrameStore(str(tmp_path / "jax"))
    for key, arr in labels.items():
        assert got.get(key) == want.get(key)
        np.testing.assert_array_equal(np.frombuffer(got.get(key), np.int8),
                                      arr)


def test_data_utils_match_jax(tmp_path):
    for name in ("b.mp4", "a.MKV", "c.txt", "d.png", "e.JPG"):
        (tmp_path / name).touch()
    for fn in ("find_all_video_files", "find_all_image_files"):
        assert getattr(utils, fn)(str(tmp_path)) == \
            getattr(jax_utils, fn)(str(tmp_path))
    inp = np.arange(42).reshape(2, 21)
    for got, want in zip(utils.split_EX_VA_AU(inp),
                         jax_utils.split_EX_VA_AU(inp)):
        np.testing.assert_array_equal(got, want)
    one_hot = np.eye(7)[[3, 0, 6]]
    np.testing.assert_array_equal(utils.ex_from_one_hot(one_hot),
                                  jax_utils.ex_from_one_hot(one_hot))
    data = {"AU": {"original_split": "train"},
            "VA": {"original_split": "test"}}
    assert utils.get_label_str2(data) == jax_utils.get_label_str2(data)
    for name in ("x_left", "x_main", "x"):
        assert utils.get_position(name) == jax_utils.get_position(name)


def _png_tree(tmp_path):
    d = tmp_path / "tree" / "vidA"
    d.mkdir(parents=True)
    cv2.imwrite(str(d / "00001.png"), np.zeros((8, 8, 3), np.uint8))
    return str(tmp_path / "tree")


H264 = os.path.join(os.path.dirname(VIDEOS), "videos_h264",
                    "mbaff_yuv422_176x144.mp4")


def _fragmented_meta(t):
    """probe_video_meta of fragmented.mp4 (mp4v_30.mp4 and an empty moof),
    which the port now reads: the JAX package's meta."""
    ours = ingest.probe_video_meta(shutil.copy(
        os.path.join(VIDEOS, "fragmented.mp4"), t))
    (t / "jax").mkdir()
    assert ours == jax_ingest.probe_video_meta(shutil.copy(
        os.path.join(VIDEOS, "fragmented.mp4"), t / "jax"))


@pytest.mark.parametrize("call,raises", [
    (lambda t: Video(H264, write=False).read_RGB(0, device="cpu"),
     NotImplementedError),
    (lambda t: ingest.extract_timestamps(os.path.join(VIDEOS,
                                                      "matroska.mkv"),
                                         str(t / "ts.txt")), ValueError),
    (_fragmented_meta, None),
    (lambda t: next(Video(H264, write=False).frames(device="cpu")),
     NotImplementedError),
], ids=["read_RGB", "extract_timestamps", "probe_video_meta", "frames"])
def test_decoder_paths_raise_naming_a9(tmp_path, call, raises):
    """What still needs a decoder tool the port does not have (H.264 4:2:2
    coded for fields: NVDEC is refused by the card's container, and the
    port's own software decoder reads 4:2:0 alone in streams coded for
    fields) raises naming A9. The containers the port now reads no longer
    do: matroska.mkv (an EBML ID and 28 zero bytes) raises ValueError as a
    malformed file, and fragmented.mp4's meta is the JAX package's."""
    if raises is None:
        call(tmp_path)
        return
    with pytest.raises(raises, match="A9" if raises is NotImplementedError
                       else "bad element size"):
        call(tmp_path)


def test_png_bytes_copied_without_reencoding(tmp_path):
    """With ``reencode_png=False`` a .png is stored as its bytes, as the
    JAX package stores it."""
    tree = _png_tree(tmp_path)
    keys = ingest.create_image_store(tree, str(tmp_path / "port"),
                                     reencode_png=False)
    jax_ingest.create_image_store(tree, str(tmp_path / "jax"),
                                  reencode_png=False)
    assert keys == ["vidA/00001.png"]
    assert FrameStore(str(tmp_path / "port")).get(keys[0]) == \
        FrameStore(str(tmp_path / "jax")).get(keys[0])
