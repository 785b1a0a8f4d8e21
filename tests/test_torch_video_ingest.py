"""auformer_torch's decoder-free ingest (data/png.py, data/container.py,
data/video.py, data/ingest.py, postprocess.video_frame_counts) against the
JAX package's cv2 paths: PNGs that cv2 and PIL write here, videos that cv2
writes at test time, and the fixtures of tests/data/videos/ with what the
JAX package read from them (expected.json, scripts/make_video_fixtures.py).
"""
import json
import os
import shutil
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from auformer import postprocess as jax_post
from auformer.data import ingest as jax_ingest
from auformer.data.video import Video as JaxVideo
from auformer_torch import postprocess
from auformer_torch.data import FrameStore, ingest
from auformer_torch.data.fixtures import write_png
from auformer_torch.data.native import decode_jpeg
from auformer_torch.data.png import read_png
from auformer_torch.data.video import Video

VIDEOS = Path(__file__).resolve().parent / "data" / "videos"
EXPECTED = json.loads((VIDEOS / "expected.json").read_text())


def _rs(seed=0):
    return np.random.RandomState(seed)


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _grey_sub_byte(path, depth, h=7, w=13):
    """A grey PNG at bit depth 1, 2 or 4 (PIL and cv2 write only depth 1
    grey): rows packed high bits first, filter None."""
    vals = _rs(depth).randint(0, 1 << depth, (h, w)).astype(np.uint8)
    bits = np.unpackbits(vals[..., None], axis=-1)[..., 8 - depth:]
    rows = np.packbits(bits.reshape(h, -1), axis=-1)
    raw = b"".join(b"\0" + r.tobytes() for r in rows)
    Path(path).write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 0, 0, 0,
                                          0))
        + _png_chunk(b"IDAT", zlib.compress(raw)) + _png_chunk(b"IEND", b""))


def _pil(mode, shape, dtype=np.uint8, **save):
    def write(path):
        a = _rs(len(path)).randint(0, 65536 if dtype == np.uint16 else 256,
                                   shape).astype(dtype)
        img = Image.fromarray(a, mode) if mode else Image.fromarray(a)
        img.save(path, **save)
    return write


def _smooth(writer):
    """A blurred-noise RGB frame (a photograph's smoothness) written by PIL
    or cv2, each choosing its own row filters."""
    def write(path):
        rgb = cv2.GaussianBlur(_rs(6).randint(0, 256, (24, 24, 3)).astype(
            np.uint8), (0, 0), 2)
        if writer == "pil":
            Image.fromarray(rgb).save(path)
        else:
            cv2.imwrite(path, rgb[..., ::-1])
    return write


def _palette(colours, **save):
    def write(path):
        rgb = _rs(colours).randint(0, 256, (9, 11, 3)).astype(np.uint8)
        Image.fromarray(rgb).quantize(colours).save(path, **save)
    return write


def _cv2(shape, dtype=np.uint8):
    def write(path):
        top = 65536 if dtype == np.uint16 else 256
        cv2.imwrite(path, _rs(3).randint(0, top, shape).astype(dtype))
    return write


def _ours(shape, dtype=np.uint8, interlace=False, filters=(0, 1, 2, 3, 4)):
    def write(path):
        top = 65536 if dtype == np.uint16 else 256
        write_png(path, _rs(4).randint(0, top, shape).astype(dtype),
                  interlace, filters)
    return write


PNG_KINDS = {
    "cv2_grey8": _cv2((9, 11)), "cv2_bgr8": _cv2((9, 11, 3)),
    "cv2_bgra8": _cv2((9, 11, 4)), "cv2_grey16": _cv2((9, 11), np.uint16),
    "cv2_bgr16": _cv2((9, 11, 3), np.uint16),
    "cv2_bgra16": _cv2((9, 11, 4), np.uint16),
    "pil_L": _pil("L", (9, 11)), "pil_RGB": _pil("RGB", (9, 11, 3)),
    "pil_RGBA": _pil("RGBA", (9, 11, 4)), "pil_LA": _pil("LA", (9, 11, 2)),
    "pil_1": _pil(None, (9, 11), bool),
    "pil_I16": _pil(None, (9, 11), np.uint16),
    "pil_I16_trns": _pil(None, (9, 11), np.uint16, transparency=5),
    "pil_L_trns": _pil("L", (9, 11), transparency=7),
    "pil_RGB_trns": _pil("RGB", (9, 11, 3), transparency=(1, 2, 3)),
    "pil_P1": _palette(2, bits=1), "pil_P2": _palette(4, bits=2),
    "pil_P4": _palette(16, bits=4), "pil_P8": _palette(200),
    "pil_P_trns": _palette(16, transparency=bytes(range(0, 160, 16))),
    "grey2": lambda p: _grey_sub_byte(p, 2),
    "grey4": lambda p: _grey_sub_byte(p, 4),
    "pil_RGB_smooth": _smooth("pil"), "cv2_bgr8_smooth": _smooth("cv2"),
    "ours_rgb8": _ours((13, 11, 3)),
    "ours_rgb8_paeth": _ours((13, 11, 3), filters=(4,)),
    "ours_rgba16_average": _ours((13, 11, 4), np.uint16, filters=(3,)),
    "ours_rgba16_adam7": _ours((13, 11, 4), np.uint16, True),
    "ours_greyalpha8_adam7": _ours((13, 11, 2), interlace=True),
    "ours_grey8_adam7": _ours((1, 9), interlace=True),
}


@pytest.mark.parametrize("kind", sorted(PNG_KINDS))
def test_read_png_matches_cv2(tmp_path, kind):
    """cv2.imread(IMREAD_UNCHANGED) with its BGR(A) channels as RGB(A)."""
    path = str(tmp_path / f"{kind}.png")
    PNG_KINDS[kind](path)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if want.ndim == 3:
        want = want[..., [2, 1, 0, 3][:want.shape[2]]]
    got = read_png(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_writers_row_filters_on_a_smooth_frame(tmp_path):
    """Which row filters read_png undoes depends on the writer: on a
    smooth frame PIL picks Paeth (undone byte by byte) for most rows,
    cv2 Sub (a numpy path) for every row."""
    def row_filters(path):
        data = Path(path).read_bytes()
        idat, off = b"", 8
        while off < len(data):
            n, kind = struct.unpack(">I4s", data[off:off + 8])
            idat += data[off + 8:off + 8 + n] if kind == b"IDAT" else b""
            off += 12 + n
        raw = zlib.decompress(idat)
        return [raw[y * (24 * 3 + 1)] for y in range(24)]
    for writer in ("pil", "cv2"):
        _smooth(writer)(str(tmp_path / f"{writer}.png"))
    assert row_filters(tmp_path / "pil.png").count(4) >= 20
    assert row_filters(tmp_path / "cv2.png") == [1] * 24


def test_read_png_refuses_what_it_cannot_read(tmp_path):
    path = tmp_path / "x.png"
    write_png(str(path), np.zeros((4, 4, 3), np.uint8))
    good = path.read_bytes()
    for bad, match in ((b"GIF89a" + good[6:], "signature"),
                       (good[:40] + bytes([good[40] ^ 1]) + good[41:],
                        "CRC"),
                       (good[:-12], "truncated"),
                       (good[:33] + _png_chunk(b"ABCD", b"") + good[33:],
                        "critical chunk")):
        path.write_bytes(bad)
        with pytest.raises(ValueError, match=match):
            read_png(str(path))


def _image_tree(base: Path, kinds) -> str:
    root = base / "tree"
    for i, kind in enumerate(kinds):
        d = root / f"vid{i % 2}"
        d.mkdir(parents=True, exist_ok=True)
        PNG_KINDS[kind](str(d / f"{i + 1:05d}.png"))
    cv2.imwrite(str(root / "vid0" / "00100.jpg"),
                _rs(9).randint(0, 256, (9, 11, 3)).astype(np.uint8))
    return str(root)


EIGHT_BIT = ["cv2_grey8", "cv2_bgr8", "cv2_bgra8", "pil_L", "pil_RGB",
             "pil_RGBA", "pil_LA", "pil_1", "pil_P1", "pil_P4", "pil_P8",
             "pil_P_trns", "pil_L_trns", "pil_RGB_trns", "grey2",
             "ours_greyalpha8_adam7"]


def test_create_image_store_reencodes_png_as_jax(tmp_path):
    """Every 8-bit PNG kind re-encoded at q95 (alpha dropped, grey kept
    grey) and the .jpg copied: the store equals JAX's byte for byte."""
    tree = _image_tree(tmp_path, EIGHT_BIT)
    keys = ingest.create_image_store(tree, str(tmp_path / "port"))
    jax_keys = jax_ingest.create_image_store(tree, str(tmp_path / "jax"))
    assert keys == jax_keys and len(keys) == len(EIGHT_BIT) + 1
    port, jax = FrameStore(str(tmp_path / "port")), FrameStore(
        str(tmp_path / "jax"))
    for key in keys:
        assert port.get(key) == jax.get(key), key
    assert (tmp_path / "port_keys_cache.p").read_bytes() == \
        (tmp_path / "jax_keys_cache.p").read_bytes()


@pytest.mark.parametrize("channels", [1, 3])
def test_sixteen_bit_png_keeps_its_high_byte_c10(tmp_path, channels):
    """C10: the JAX package hands cv2.imencode a uint16 image, which
    saturates every sample above 255 to white; the port stores the high
    byte of each sample (a smooth 16-bit image, JPEG-compressible)."""
    d = tmp_path / "tree" / "vid0"
    d.mkdir(parents=True)
    yy, xx = np.mgrid[0:32, 0:40]
    planes = [xx * 1600 + 500, yy * 2000 + 300, (xx + yy) * 800 + 900]
    img = np.stack(planes[:channels], -1)[..., ::-1].squeeze()
    cv2.imwrite(str(d / "00001.png"), img.astype(np.uint16))
    tree = str(tmp_path / "tree")
    ingest.create_image_store(tree, str(tmp_path / "port"))
    jax_ingest.create_image_store(tree, str(tmp_path / "jax"))
    key = "vid0/00001.png"
    src = read_png(os.path.join(tree, key))
    assert src.dtype == np.uint16
    high = (src >> 8).astype(np.uint8)
    c = 1 if src.ndim == 2 else 3
    port = decode_jpeg(FrameStore(str(tmp_path / "port")).get(key),
                       *src.shape[:2], c)
    jax = decode_jpeg(FrameStore(str(tmp_path / "jax")).get(key),
                      *src.shape[:2], c)
    assert np.abs(port.astype(int) - high).mean() < 2
    assert jax.min() >= 250 and high.mean() < 160


def test_png_keyed_store_feeds_the_dataset_c11(tmp_path):
    """C11: create_image_store keeps each PNG frame's .png name in its key,
    in both packages, while the split names every frame .jpg: the JAX
    dataset finds no frame of such a store and its clips are black. The
    port's reader takes the split's .jpg keys of a .png-keyed store as
    .png, so its clips equal the JAX dataset's over the same bytes stored
    under .jpg keys."""
    from auformer.core.config import Config as JaxConfig
    from auformer.data.dataset import Aff2CompDataset as JaxDataset
    from auformer.data.fixtures import generate_synthetic_dataset
    from auformer_torch.core.config import Config
    from auformer_torch.data import Aff2CompDataset, FrameStoreWriter
    from auformer_torch.data.fixtures import fixture_frame
    root, labels = str(tmp_path / "root"), tmp_path / "labels"
    generate_synthetic_dataset(root, str(labels), n_videos=1,
                               frames_per_video=6, image_size=32,
                               splits=["train"])
    tree = tmp_path / "aligned"
    (tree / "vid000").mkdir(parents=True)
    for t in range(6):
        write_png(str(tree / "vid000" / f"{t + 1:05d}.png"),
                  fixture_frame(0, 0, t, 32))
    jpg_labels = tmp_path / "jpg_labels"
    shutil.copytree(labels, jpg_labels)
    for d in (labels, jpg_labels):
        shutil.rmtree(d / "croped_jpeg")
    keys = ingest.create_image_store(str(tree), str(labels / "croped_jpeg"))
    packed = FrameStore(str(labels / "croped_jpeg"))
    with FrameStoreWriter(str(jpg_labels / "croped_jpeg")) as w:
        for key in keys:
            w.put(key[:-4] + ".jpg", packed.get(key))
    cfg = dict(root=root, cache_dir=str(tmp_path / "cache"), task="AU",
               n_frames=4, dilation=1, image_size=32, modality="V")
    jax_png = JaxDataset(JaxConfig(use_pallas=False, lmdb_label_dir=str(
        labels), **cfg))
    jax_jpg = JaxDataset(JaxConfig(use_pallas=False, lmdb_label_dir=str(
        jpg_labels), **cfg))
    port = Aff2CompDataset(Config(lmdb_label_dir=str(labels), **cfg))
    assert len(port) == 6
    for i in range(len(port)):
        assert not jax_png.get_clip(i).any()
        want = jax_jpg.get_clip(i)
        assert want[-1].any()
        np.testing.assert_array_equal(port.get_clip(i), want)


@pytest.mark.parametrize("fourcc,ext,fps", [
    ("mp4v", "mp4", 30.0), ("MJPG", "avi", 25.0), ("XVID", "avi", 30.0)])
def test_video_and_ingest_match_jax_on_cv2_files(tmp_path, fourcc, ext, fps):
    """A file cv2 writes now (as tests/test_ingest.py does): meta,
    num_frames, fps, count_frames, probe_video_meta and its side file,
    the timestamps text, video_frame_counts."""
    dirs = {}
    for side in ("port", "jax"):
        d = tmp_path / side
        d.mkdir()
        path = str(d / f"clip.{ext}")
        if not dirs:
            w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps,
                                (48, 32))
            rs = _rs(1)
            for _ in range(17):
                w.write(rs.randint(0, 256, (32, 48, 3)).astype(np.uint8))
            w.release()
            first = path
        else:
            shutil.copy(first, path)
        dirs[side] = (d, path)
    (pd, pp), (jd, jp) = dirs["port"], dirs["jax"]
    v, jv = Video(pp, write=False), JaxVideo(jp, write=False)
    assert v.meta == jv.meta and v.meta["num_frames"] == 17
    assert (v.num_frames, v.fps) == (jv.num_frames, jv.fps)
    assert v.count_frames() == jv.count_frames() == 17
    assert not os.path.exists(os.path.splitext(pp)[0] + "meta.json")
    assert ingest.probe_video_meta(pp) == jax_ingest.probe_video_meta(jp)
    assert sorted(os.listdir(pd)) == sorted(os.listdir(jd))
    assert (Path(os.path.splitext(pp)[0] + "meta.json").read_text()
            == Path(os.path.splitext(jp)[0] + "meta.json").read_text())
    assert (Path(ingest.extract_timestamps(pp)).read_text()
            == Path(jax_ingest.extract_timestamps(jp)).read_text())
    for p in (pp, jp):
        os.remove(os.path.splitext(p)[0] + "meta.json")
    assert postprocess.video_frame_counts(str(pd)) == \
        jax_post.video_frame_counts(str(jd)) == {"clip": 17}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_fixture_video_matches_expected(tmp_path, name):
    """The port on tests/data/videos/ equals what the JAX package read
    there when the fixtures were made; on the tracks with reordering
    composition offsets too, whose timestamps follow the order the decoder
    returns the frames in (decode order: their MPEG-4 has no B-VOPs)."""
    want = EXPECTED[name]
    path = str(VIDEOS / name)
    v = Video(path, write=False)
    assert v.meta == want["meta"]
    assert v.count_frames() == want["count_frames"]
    ts = ingest.extract_timestamps(path, str(tmp_path / "ts.txt"))
    assert Path(ts).read_text() == want["timestamps"]


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_expected_still_what_jax_reads(tmp_path, name):
    """expected.json still holds what the JAX package (cv2) reads."""
    want = EXPECTED[name]
    path = str(VIDEOS / name)
    v = JaxVideo(path, write=False)
    assert v.meta == want["meta"]
    assert v.count_frames() == want["count_frames"]
    v.release()
    ts = jax_ingest.extract_timestamps(path, str(tmp_path / "ts.txt"))
    assert Path(ts).read_text() == want["timestamps"]


def test_ctts_track_still_gives_count_fps_and_size():
    """Composition offsets change neither the count, the rate nor the
    size."""
    v = Video(str(VIDEOS / "ctts.mp4"), write=False)
    assert v.meta == EXPECTED["mp4v_30.mp4"]["meta"]
    assert v.count_frames() == 12


def test_postprocess_main_without_meta_json_matches_jax(tmp_path):
    """python -m auformer_torch.postprocess over videos without a side
    file: the dense files equal JAX's, and both write the same side
    files."""
    outs = {}
    for side, pkg in (("port", postprocess), ("jax", jax_post)):
        base = tmp_path / side
        vdir = base / "videos"
        vdir.mkdir(parents=True)
        for name in ("mp4v_30.mp4", "elst_window.mp4", "xvid_25.avi"):
            shutil.copy(VIDEOS / name, vdir / name)
        for name, detected in (("mp4v_30", (1, 2, 5)),
                               ("xvid_25_left", (3, 4, 9)),
                               ("elst_window", (1, 2))):
            (base / "pred" / "AU").mkdir(parents=True, exist_ok=True)
            rows = ["h"] + [f"row{i}" for i in detected]
            (base / "pred" / "AU" / f"{name}.txt").write_text(
                "\n".join(rows) + "\n")
            frames = base / "aligned" / name
            frames.mkdir(parents=True)
            for i in detected:
                (frames / f"{i:05d}.jpg").touch()
        pkg.main(["--predictions", str(base / "pred"), "--frames_root",
                  str(base / "aligned"), "--video_dir", str(vdir),
                  "--out_dir", str(base / "out"), "--tasks", "AU"])
        outs[side] = {p.name: p.read_text()
                      for p in sorted((base / "out" / "AU").iterdir())}
        outs[side + "_meta"] = {p.name: p.read_text()
                                for p in sorted(vdir.glob("*meta.json"))}
    assert outs["port"] == outs["jax"]
    assert outs["port_meta"] == outs["jax_meta"]
    assert len(outs["port_meta"]) == 3
    assert outs["port"]["mp4v_30.txt"].count("\n") == 13


def _retagged_hvc1(tmp_path) -> str:
    """The B-frame H.264 fixture with its sample entry retagged as HEVC
    (``hvc1``): a ctts track whose output order the port does not read."""
    data = (Path(__file__).parent / "data" / "videos_decode" /
            "ipb_112.mp4").read_bytes()
    at = data.index(b"avc1", data.index(b"stsd"))
    path = tmp_path / "hvc1_ctts.mp4"
    path.write_bytes(data[:at] + b"hvc1" + data[at + 4:])
    return str(path)


@pytest.mark.parametrize("name,call", [
    ("matroska.mkv", "probe"), ("matroska.mkv", "timestamps"),
    ("fragmented.mp4", "timestamps"), ("fragmented.mp4", "count"),
    ("fragmented.mp4", "probe"), ("hvc1_ctts.mp4", "timestamps")])
def test_unread_containers_raise_naming_a9(tmp_path, name, call):
    """The containers the port once refused: matroska.mkv (an EBML ID and
    28 zero bytes) is now read and raises ValueError as a malformed file;
    fragmented.mp4 (mp4v_30.mp4 and an empty moof) gives the JAX package's
    meta, count and timestamps. A ctts track whose output order the port
    does not read (HEVC) still raises naming A9."""
    path = (_retagged_hvc1(tmp_path) if name == "hvc1_ctts.mp4"
            else str(VIDEOS / name))

    def run(pkg, video, out):
        if call == "probe":
            folder = tmp_path / out
            folder.mkdir()
            return pkg.probe_video_meta(shutil.copy(path, folder))
        if call == "timestamps":
            with open(pkg.extract_timestamps(path, str(tmp_path / out))) as f:
                return f.read()
        return video(path, write=False).count_frames()

    if name == "fragmented.mp4":
        assert run(ingest, Video, "port") == run(jax_ingest, JaxVideo, "jax")
        return
    with pytest.raises(ValueError if name == "matroska.mkv"
                       else NotImplementedError,
                       match="bad element size" if name == "matroska.mkv"
                       else "A9"):
        run(ingest, Video, "port")
