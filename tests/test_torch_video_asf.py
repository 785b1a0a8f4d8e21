"""auformer_torch's ASF reader (data/asf.py, its index in
data/container.py) against the JAX package's cv2, on the CPU.

The .wmv files of tests/data/videos_container/ are libavformat 59's (an
XviD stream remuxed with its VOL in the BITMAPINFOHEADER, a WMV2 encode
with WMA audio for meta) and the tests' writer's (``fixtures.write_asf``:
several payloads in a packet and objects split over packets, no Simple
Index, the broadcast flag); regenerate them with ``JAX_PLATFORMS=cpu
python scripts/make_stream_fixtures.py``. For each the port's meta equals
the JAX package's, read here through cv2; its count, timestamps text,
frames, reads and media objects equal cv2's bit for bit; WMV raises naming
ROADMAP.md queue A9 past meta, as do what the port does not follow: reads
after the first in a broadcast file (cv2 flushes and reads on) and the
rate of frames that are not evenly spaced. ``num_frames`` of an hour-long
file reads its header, its first packets and its index only.
"""
import builtins

import pytest
import torch

from auformer.data.video import Video as JaxVideo
from auformer_torch.data import asf, container, fixtures, ingest
from auformer_torch.data.mpegstream import read_es
from auformer_torch.data.video import Video
from test_torch_video_decode import _cv2_packets
from test_torch_video_matroska import (D, DECODED, EXPECTED, _sha,
                                       count_and_timestamps_match,
                                       frames_match, meta_matches)

ASF = sorted(n for n in EXPECTED if n.endswith(".wmv"))
LIVE = "xvid_176_broadcast.wmv"


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread for this file, as in the Matroska tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ASF)
def test_meta_matches_jax(name):
    meta_matches(name)


@pytest.mark.parametrize("name", ASF)
def test_count_and_timestamps_match_cv2(name, tmp_path):
    count_and_timestamps_match(name, tmp_path)


@pytest.mark.parametrize("name", [n for n in ASF if n != LIVE and
                                  EXPECTED[n]["codec"] in DECODED])
def test_frames_and_seeks_match_cv2(name):
    """frames() and read_RGB at expected.json's frames on one Video, cv2's
    seeks by the Simple Index (or, without one, its search of the key
    frames' times) included."""
    frames_match(name)


def test_broadcast_file_reads_on_and_then_raises_naming_a9():
    """A broadcast file has no play duration: cv2's count is floor of
    AV_NOPTS_VALUE ms times the rate, plus a half, and cv2 does not seek.
    Its frames and first read equal cv2's; a later read flushes cv2's
    MPEG-4 decoder mid stream, which the port does not follow."""
    want = EXPECTED[LIVE]
    path = str(D / LIVE)
    v = Video(path, write=False)
    assert v.meta["num_frames"] == int(-2.0 ** 63 * 0.001 * 25.0 + 0.5) < 0
    assert [_sha(f) for f in v.frames(device="cpu")] == \
        want["frames_sha256"]
    (k, first), (k2, _) = want["read_RGB_sha256"][:2]
    assert _sha(v.read_RGB(k, device="cpu")) == first
    with pytest.raises(NotImplementedError, match="A9"):
        v.read_RGB(k2, device="cpu")


@pytest.mark.parametrize("name", [n for n in ASF if EXPECTED[n]["source"]
                                  and EXPECTED[n]["codec"] in DECODED])
def test_remux_frames_are_the_source_files(name):
    import json
    folder, file = EXPECTED[name]["source"].split("/")
    source = json.loads((D.parent / folder / "expected.json").read_text())[
        file]
    assert EXPECTED[name]["frames_sha256"] == source["frames_sha256"]
    assert EXPECTED[name]["count_frames"] == source["count_frames"]


@pytest.mark.parametrize("name", ASF)
def test_objects_equal_cv2_raw_packets(name):
    """Each media object, rebuilt from its fragments, is cv2's raw packet
    byte for byte; an MPEG-4 part 2 stream's first access unit has the
    BITMAPINFOHEADER's VOL (cv2's extradata) ahead of it."""
    path = str(D / name)
    index = container.packet_index(path)
    extra, packets = _cv2_packets(path)
    with open(path, "rb") as f:
        objects = [read_es(f, index["chunks"], p.offset, p.offset + p.size)
                   for p in index["packets"]]
    assert objects == packets
    if index["codec"] == "mpeg4":
        assert index["setup"]["vol"] == extra
        units = [u for _, u in container.access_units(path, index)]
        assert units == [extra + packets[0]] + packets[1:]


@pytest.mark.parametrize("call", ["count", "timestamps", "frames"])
def test_wmv_raises_naming_a9(call, tmp_path):
    """WMV2 gives cv2's meta (its count from the play duration and the WMA
    track's later start); its frames raise."""
    path = str(D / "wmv2_176x144.wmv")
    assert container.meta(path)["codec"] == "WMV2"
    with pytest.raises(NotImplementedError, match="A9"):
        if call == "count":
            Video(path, write=False).count_frames()
        elif call == "timestamps":
            ingest.extract_timestamps(path, str(tmp_path / "ts.txt"))
        else:
            next(Video(path, write=False).frames(device="cpu"))


def _wmv_objects():
    path = str(D / "wmv2_176x144.wmv")
    with open(path, "rb") as f:
        h = asf.read(f, path)
        objects = [read_es(f, h["chunks"], o.start, o.start + o.size)
                   for o in h["objects"]]
    return h, objects, [o.key for o in h["objects"]]


@pytest.mark.parametrize("step", [50, 33])
def test_wmv_rate_comes_from_the_times(tmp_path, step):
    """Without a codec rate, ffmpeg's avg_frame_rate is the frames' times'
    (20 fps for 50 ms; 1000/33 fps, more than 1 % from 30, is not rounded);
    AvgTimePerFrame is read past."""
    h, objects, keys = _wmv_objects()
    path = str(tmp_path / f"step{step}.wmv")
    fixtures.write_asf(path, objects, keys,
                       [step * k for k in range(len(objects))], b"WMV2", 176,
                       144, extradata=h["extradata"], avg_time=333333)
    assert Video(path, write=False).meta == JaxVideo(path, write=False).meta
    assert container.meta(path)["fps"] == 1000 / step


def test_uneven_times_raise_naming_a9(tmp_path):
    """Frames not evenly spaced: ffmpeg averages the probed frames'
    durations, which the port does not follow."""
    h, objects, keys = _wmv_objects()
    path = str(tmp_path / "uneven.wmv")
    fixtures.write_asf(path, objects, keys,
                       [33 * k + k // 3 for k in range(len(objects))],
                       b"WMV2", 176, 144, extradata=h["extradata"])
    with pytest.raises(NotImplementedError, match="evenly spaced.*A9"):
        Video(path, write=False)


def test_num_frames_of_an_hour_reads_head_and_index(tmp_path, monkeypatch):
    """Video.meta of an hour-long ASF file (108,000 objects at 25 fps, a
    few MB in packets of several payloads) reads its header, its first 64
    data packets and the Simple Index at its end, no more than 128 KB,
    and gives cv2's meta."""
    h, objects, keys = _wmv_objects()
    n = 108_000
    objs = objects[:1] + [objects[1][:20]] * (n - 1)
    path = tmp_path / "hour.wmv"
    fixtures.write_asf(str(path), objs, [True] + [False] * (n - 1),
                       [40 * k for k in range(n)], b"WMV2", 176, 144,
                       extradata=h["extradata"], multiple=True)
    reads = [0]

    def counting(p, mode="r", *args, **kwargs):
        f = builtins.open(p, mode, *args, **kwargs)
        real = f.read

        def read(k=-1):
            b = real(k)
            reads[0] += len(b)
            return b
        f.read = read
        return f

    monkeypatch.setattr(container, "open", counting, raising=False)
    meta = Video(str(path), write=False).meta
    monkeypatch.undo()
    assert meta["num_frames"] == 108_000 and meta["fps"] == 25.0
    assert 0 < reads[0] <= 128 * 1024 < path.stat().st_size // 10
    assert meta == JaxVideo(str(path), write=False).meta


@pytest.mark.parametrize("edit,match", [
    (lambda d: d.replace(bytes.fromhex("a1dcab8c47a9cf118ee400c00c205365"),
                         bytes(16)), "File Properties"),
    (lambda d: d[:200], "cut short"),
    (lambda d: d.replace(bytes.fromhex("c0ef19bc4d5bcf11a8fd00805f5c442b"),
                         bytes(16)), "without a video stream")],
    ids=["no_file_properties", "cut_header", "no_video"])
def test_malformed_asf_raises_value_error(tmp_path, edit, match):
    path = tmp_path / "bad.wmv"
    path.write_bytes(edit((D / "xvid_176_asf.wmv").read_bytes()))
    with pytest.raises(ValueError, match=match):
        Video(str(path), write=False)
