"""auformer_torch's Matroska/WebM reader (data/matroska.py, its index in
data/container.py) against the JAX package's cv2, on the CPU.

tests/data/videos_container/ holds files libavformat 59 muxed (remuxes of
streams committed elsewhere, a live file written to a pipe, VP9, AV1 and
HEVC encodes) and files of the tests' own writer
(``fixtures.write_matroska``: BlockGroups, the three lacings, header
stripping, zlib, a TimestampScale of 0.1 ms, V_MS/VFW/FOURCC tracks,
clusters of unknown size); regenerate them with ``JAX_PLATFORMS=cpu python
scripts/make_container_fixtures.py``, which needs gcc, the system's FFmpeg
libraries, cv2 and the JAX package. For every file the port's meta equals
the JAX package's, read here through cv2; its count, timestamps text,
frames and reads at several frames equal expected.json's (cv2's): bit for
bit for H.264 and MPEG-4 part 2, within test_torch_video_decode's
tolerance for MJPEG (the frames of mjpg_112.npz, which every MJPEG remux
holds). The codecs the port does not decode give cv2's meta and raise
naming ROADMAP.md queue A9 for the rest, as do encrypted and bzlib content
and a track without DefaultDuration.
"""
import hashlib
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from auformer import postprocess as jax_postprocess
from auformer.data import ingest as jax_ingest
from auformer.data.video import Video as JaxVideo
from auformer_torch import postprocess
from auformer_torch.data import container, fixtures, ingest, matroska
from auformer_torch.data.utils import VIDEO_EXTS
from auformer_torch.data.video import Video

DATA = Path(__file__).parent / "data"
D = DATA / "videos_container"
EXPECTED = json.loads((D / "expected.json").read_text())
DECODED = ("h264", "mpeg4", "mjpeg")
MJPG_MAX, MJPG_MEAN = 3, 0.1          # test_torch_video_decode.py's
MKV = sorted(n for n in EXPECTED if n.endswith((".mkv", ".webm")))


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread for this file: its conversions are small torch
    ops, and several test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sha(img) -> str | None:
    return None if img is None else hashlib.sha256(
        np.ascontiguousarray(img).tobytes()).hexdigest()


def _source(name: str) -> dict:
    folder, file = EXPECTED[name]["source"].split("/")
    return json.loads((DATA / folder / "expected.json").read_text())[file]


def meta_matches(name: str) -> None:
    """The port's meta = the JAX package's through cv2 = expected.json's."""
    path = str(D / name)
    ours = Video(path, write=False).meta
    assert ours == JaxVideo(path, write=False).meta == EXPECTED[name]["meta"]


def count_and_timestamps_match(name: str, tmp_path) -> None:
    path = str(D / name)
    want = EXPECTED[name]
    if want["codec"] not in DECODED:
        for call in (lambda: Video(path, write=False).count_frames(),
                     lambda: ingest.extract_timestamps(
                         path, str(tmp_path / "ts.txt"))):
            with pytest.raises(NotImplementedError, match="A9"):
                call()
        return
    assert Video(path, write=False).count_frames() == want["count_frames"]
    ts = ingest.extract_timestamps(path, str(tmp_path / "ts.txt"))
    assert Path(ts).read_text() == want["timestamps"]


def frames_match(name: str) -> None:
    """frames() and read_RGB at expected.json's frames, in its order on
    one Video, against cv2's: bit for bit, or for MJPEG within the
    tolerance of the source's cv2 frames."""
    path = str(D / name)
    want = EXPECTED[name]
    v = Video(path, write=False)
    got = list(v.frames(device="cpu"))
    reads = [(k, v.read_RGB(k, device="cpu"))
             for k, _ in want["read_RGB_sha256"]]
    if want["codec"] != "mjpeg":
        assert [_sha(f) for f in got] == want["frames_sha256"]
        assert [[k, _sha(img)] for k, img in reads] == \
            want["read_RGB_sha256"]
        return
    cv2_frames = np.load(DATA / "videos_decode" / "mjpg_112.npz")["frames"]
    assert len(got) == len(cv2_frames) == len(want["frames_sha256"])
    diff = np.abs(np.stack(got).astype(int) - cv2_frames.astype(int))
    assert diff.max() <= MJPG_MAX and diff.mean() <= MJPG_MEAN
    shas = want["frames_sha256"]
    for (k, img), (_, theirs) in zip(reads, want["read_RGB_sha256"]):
        if theirs is None:
            assert img is None
        else:
            np.testing.assert_array_equal(img, got[shas.index(theirs)])


@pytest.mark.parametrize("name", MKV)
def test_meta_matches_jax(name):
    meta_matches(name)


@pytest.mark.parametrize("name", MKV)
def test_count_and_timestamps_match_cv2(name, tmp_path):
    count_and_timestamps_match(name, tmp_path)


@pytest.mark.parametrize("name", [n for n in MKV
                                  if EXPECTED[n]["codec"] in DECODED])
def test_frames_and_seeks_match_cv2(name):
    frames_match(name)


@pytest.mark.parametrize("name", [n for n in MKV if EXPECTED[n]["source"]
                                  and EXPECTED[n]["codec"] in DECODED])
def test_remux_frames_are_the_source_files(name):
    """A remux's cv2 frames, which the port's equal, are its source
    file's, and so are its count and its timestamps where the container
    keeps the source's times."""
    want, source = EXPECTED[name], _source(name)
    assert want["frames_sha256"] == source["frames_sha256"]
    assert want["count_frames"] == source["count_frames"]


@pytest.mark.parametrize("name", [n for n in MKV
                                  if EXPECTED[n]["codec"] not in DECODED])
@pytest.mark.parametrize("call", ["count", "timestamps", "frames"])
def test_undecoded_codecs_raise_naming_a9(name, call, tmp_path):
    """VP9, AV1 and HEVC give cv2's meta (test_meta_matches_jax); what
    needs their frames raises naming A9."""
    path = str(D / name)
    with pytest.raises(NotImplementedError, match="A9"):
        if call == "count":
            Video(path, write=False).count_frames()
        elif call == "timestamps":
            ingest.extract_timestamps(path, str(tmp_path / "ts.txt"))
        else:
            next(Video(path, write=False).frames(device="cpu"))


def test_video_frame_counts_match_jax(tmp_path):
    """postprocess.video_frame_counts over a folder of every .mkv, .webm
    and fragmented .mp4 fixture = the JAX package's table, the meta.json
    side files each writes too."""
    tables = {}
    for side, pkg in (("port", postprocess), ("jax", jax_postprocess)):
        folder = tmp_path / side
        folder.mkdir()
        for name in EXPECTED:
            shutil.copy(D / name, folder / name)
        tables[side] = pkg.video_frame_counts(str(folder))
        tables[side + "_meta"] = {p.name: json.loads(p.read_text())
                                  for p in folder.glob("*meta.json")}
    assert tables["port"] == tables["jax"]
    assert tables["port_meta"] == tables["jax_meta"]
    # every fixture whose extension the folder walk lists (not .ts, .m2ts)
    assert len(tables["port"]) == sum(
        n.rsplit(".", 1)[1] in VIDEO_EXTS for n in EXPECTED)
    assert tables["port"]["h264_ipb_176x144"] == 45   # the audio's length


def _mjpeg_frames():
    index = container.packet_index(str(DATA / "videos_decode" /
                                       "mjpg_112.avi"))
    with open(DATA / "videos_decode" / "mjpg_112.avi", "rb") as f:
        out = []
        for p in index["packets"]:
            f.seek(p.offset)
            out.append(f.read(p.size))
    return out


@pytest.mark.parametrize("encoding,what", [
    ("encrypted", "encrypted"), ("bzlib", "bzlib or LZO")])
def test_unread_content_encodings_raise_naming_a9(tmp_path, encoding, what):
    frames = _mjpeg_frames()
    path = str(tmp_path / "enc.mkv")
    fixtures.write_matroska(path, frames, [True] * len(frames),
                            [33 * k for k in range(len(frames))], "V_MJPEG",
                            112, 112, default_duration=33333333,
                            encoding=encoding, duration=400.0)
    with pytest.raises(NotImplementedError, match=f"(?s){what}.*A9"):
        Video(path, write=False)


def test_rate_without_default_duration_raises_naming_a9(tmp_path):
    """Without DefaultDuration ffmpeg estimates the rate from the first
    packets, which the port does not follow."""
    frames = _mjpeg_frames()
    path = str(tmp_path / "rate.mkv")
    fixtures.write_matroska(path, frames, [True] * len(frames),
                            [33 * k for k in range(len(frames))], "V_MJPEG",
                            112, 112, duration=400.0)
    with pytest.raises(NotImplementedError, match="DefaultDuration.*A9"):
        container.probe(path)


def test_cut_file_gives_its_whole_frames(tmp_path):
    """A file cut short, as a recording that stopped leaves it, gives the
    frames that are whole, as cv2 does (count from the Segment's
    Duration, 5 of the 12 frames read with their timestamps)."""
    data = (D / "mjpg_112.mkv").read_bytes()
    cut = tmp_path / "cut.mkv"
    cut.write_bytes(data[:len(data) // 2])
    v, jv = Video(str(cut), write=False), JaxVideo(str(cut), write=False)
    assert v.meta == jv.meta
    assert v.count_frames() == jv.count_frames() == 5
    ours = ingest.extract_timestamps(str(cut), str(tmp_path / "a.txt"))
    theirs = jax_ingest.extract_timestamps(str(cut), str(tmp_path / "b.txt"))
    assert Path(ours).read_text() == Path(theirs).read_text()


def test_malformed_matroska_raises_value_error(tmp_path):
    """An EBML file of another DocType, and one whose Segment is missing,
    raise ValueError."""
    data = (D / "mjpg_112.mkv").read_bytes()
    other = tmp_path / "other.mkv"
    other.write_bytes(data.replace(b"matroska", b"notamkv!", 1))
    with pytest.raises(ValueError, match="DocType"):
        container.probe(str(other))
    at = data.index(bytes.fromhex("18538067"))
    broken = tmp_path / "broken.mkv"
    broken.write_bytes(data[:at] + bytes.fromhex("1f43b675") + data[at + 4:])
    with pytest.raises(ValueError, match="Segment"):
        container.probe(str(broken))


@pytest.mark.parametrize("num,den,limit,want", [
    (1000000000, 33366666, 30000, (30000, 1001)),
    (1000000000, 33333333, 30000, (30, 1)),
    (1000000000, 40000000, 30000, (25, 1)),
    (1000000000, 41708333, 30000, (24000, 1001)),
    (1000000000, 16683333, 30000, None), (355, 113, 100, None)])
def test_av_reduce_is_the_nearest_bounded_fraction(num, den, limit, want):
    """container._av_reduce = ffmpeg's av_reduce: the rates cv2 reports
    for DefaultDuration 33366666, 33333333, 40000000 and 41708333 ns, and
    the fraction nearest num/den with terms at most ``limit``, as a search
    over every denominator finds it."""
    from fractions import Fraction
    got = container._av_reduce(num, den, limit)
    if want is not None:
        assert got == want
    x = Fraction(num, den)
    best = min(abs(Fraction(min(round(x * d), limit), d) - x)
               for d in range(1, limit + 1))
    assert max(got) <= limit and abs(Fraction(*got) - x) == best


def test_reader_steps_over_other_tracks_and_laces():
    """The tests' writer's files read back: the video track numbered 2
    behind a PCM track, each lacing's frames and their times, the
    header-stripped and zlib frames restored."""
    avi = container.packet_index(str(DATA / "videos_decode" /
                                     "mjpg_112.avi"))
    frames = _mjpeg_frames()
    for name in ("mjpg_112_xiph.mkv", "mjpg_112_ebml.mkv",
                 "mjpg_112_zlib.mkv", "mjpg_112.mkv"):
        index = container.packet_index(str(D / name))
        units = [u for _, u in container.access_units(str(D / name), index)]
        assert [u.rstrip(b"\0") for u in units] == [
            f.rstrip(b"\0") for f in frames]
        assert len(index["packets"]) == len(avi["packets"])
    with open(D / "h264_ipb_176x144_groups.mkv", "rb") as f:
        m = matroska.read(f, "groups")
    assert m["codec_id"] == "V_MPEG4/ISO/AVC" and len(m["frames"]) == 30
    assert sum(fr.key for fr in m["frames"]) == 3
    with open(D / "xvid_176_strip.mkv", "rb") as f:
        m = matroska.read(f, "strip")
    assert m["timestamp_scale"] == 100000 and m["encodings"][0]["algo"] == 3
    units = [u for _, u in container.access_units(str(D /
                                                       "xvid_176_strip.mkv"))]
    assert all(u.startswith(b"\0\0\1") for u in units)


def test_live_file_count_is_cv2s_unknown_duration():
    """A live file has no Duration: cv2's count is the floor of the
    stream's unknown duration (AV_NOPTS_VALUE ticks of 1 ms) times the
    rate, plus a half, a large negative number; cv2 then does not seek
    (expected.json's reads: read_RGB(k) flushes and reads on to the next
    key frame, test_frames_and_seeks_match_cv2)."""
    want = EXPECTED["h264_ipb_176x144_live.mkv"]
    n = Video(str(D / "h264_ipb_176x144_live.mkv"),
              write=False).meta["num_frames"]
    assert n == want["meta"]["num_frames"] == int(
        np.floor(-2.0 ** 63 * 0.001 * 30.0 + 0.5))
