"""auformer_torch's MPEG transport and program stream reader
(data/mpegstream.py, its index in data/container.py) against the JAX
package's cv2, on the CPU.

The .ts, .m2ts and .mpg files of tests/data/videos_container/ are
libavformat 59's (remuxes of committed H.264 and XviD streams, one with an
MP2 track that outlasts the video, the 720p one in AVCHD's 192-byte
packets, the ``mpeg`` and ``vob`` muxers' packs; MPEG-1 and MPEG-2 encodes
for meta) and the tests' writer's (``fixtures.write_mpegts``: PTS that wrap
past 2^33 in mid stream, PES packets that hold two units or half of one,
adaptation-field stuffing); regenerate them with ``JAX_PLATFORMS=cpu
python scripts/make_stream_fixtures.py``. For each the port's meta equals
the JAX package's, read here through cv2; its count, timestamps text,
frames, reads and access units equal cv2's bit for bit; MPEG-1/2 video
raises naming ROADMAP.md queue A9 past meta, as do the reads and times
the port does not follow. ``num_frames`` of an hour-long stream reads the
head and the tail only.
"""
import builtins
import re
import shutil
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from auformer import postprocess as jax_postprocess
from auformer.data.video import Video as JaxVideo
from auformer_torch import postprocess
from auformer_torch.data import container, fixtures, ingest, mpegstream
from auformer_torch.data.utils import VIDEO_EXTS
from auformer_torch.data.video import Video
from test_torch_video_decode import _cv2_packets
from test_torch_video_matroska import (D, DECODED, EXPECTED,
                                       count_and_timestamps_match,
                                       frames_match, meta_matches)

STREAMS = sorted(n for n in EXPECTED if n.endswith((".ts", ".m2ts", ".mpg")))
IPB = D.parent / "videos_h264" / "ipb_main_176x144.mp4"
# what Video.meta may read of a stream: ffmpeg's probe size at the head
# (5,000,000 bytes and a window's slack) and two tail windows of 250,000
HEAD_AND_TAIL = 5_000_000 + (1 << 20) + 2 * 250_000


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread for this file: its conversions are small torch
    ops, and several test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", STREAMS)
def test_meta_matches_jax(name):
    meta_matches(name)


@pytest.mark.parametrize("name", STREAMS)
def test_count_and_timestamps_match_cv2(name, tmp_path):
    count_and_timestamps_match(name, tmp_path)


@pytest.mark.parametrize("name", [n for n in STREAMS
                                  if EXPECTED[n]["codec"] in DECODED])
def test_frames_and_seeks_match_cv2(name):
    """frames() and read_RGB at expected.json's frames on one Video: cv2's
    seeks by the binary search on DTS (read_RGB(0) of a B-pyramid stream
    is frame 12, the 720p AVCHD file's reads are None) included."""
    frames_match(name)


@pytest.mark.parametrize("name", [n for n in STREAMS if EXPECTED[n]["source"]
                                  and EXPECTED[n]["codec"] in DECODED])
def test_remux_frames_are_the_source_files(name):
    """A remux's cv2 frames, which the port's equal, are its source file's,
    and so is its count."""
    folder, file = EXPECTED[name]["source"].split("/")
    import json
    source = json.loads((D.parent / folder / "expected.json").read_text())[
        file]
    assert EXPECTED[name]["frames_sha256"] == source["frames_sha256"]
    assert EXPECTED[name]["count_frames"] == source["count_frames"]


@pytest.mark.parametrize("name", [n for n in STREAMS
                                  if EXPECTED[n]["codec"] in DECODED])
def test_access_units_equal_cv2_raw_packets(name):
    """Each access unit, as ffmpeg's h264 or mpeg4video parser cuts the
    elementary stream, is cv2's raw packet byte for byte."""
    path = str(D / name)
    units = [u for _, u in container.access_units(path)]
    _, packets = _cv2_packets(path)
    assert units == packets


@pytest.mark.parametrize("name", [n for n in STREAMS
                                  if EXPECTED[n]["codec"] not in DECODED])
@pytest.mark.parametrize("call", ["count", "timestamps", "frames"])
def test_undecoded_codecs_raise_naming_a9(name, call, tmp_path):
    """MPEG-1 and MPEG-2 video give cv2's meta; their frames raise."""
    path = str(D / name)
    with pytest.raises(NotImplementedError, match="A9"):
        if call == "count":
            Video(path, write=False).count_frames()
        elif call == "timestamps":
            ingest.extract_timestamps(path, str(tmp_path / "ts.txt"))
        else:
            next(Video(path, write=False).frames(device="cpu"))


def test_audio_past_the_video_sets_the_count():
    """cv2's count of the remux whose MP2 track runs 0.5 s past its 30
    frames is the format's duration from every stream's last PTS in the
    tail (48), and the 29.97 fps program stream's its sequence header's."""
    assert Video(str(D / "h264_ipb_176x144_mp2.ts"),
                 write=False).meta["num_frames"] == 48
    meta = container.meta(str(D / "mpeg2_176x144_ntsc.mpg"))
    assert meta["codec"] == "mpeg2video" and meta["fps"] == 30000 / 1001
    assert container.meta(str(D / "mpeg1_176x144.mpg"))["codec"] == \
        "mpeg1video"


def test_video_frame_counts_match_jax(tmp_path):
    """postprocess.video_frame_counts over a folder of every container
    fixture (the .wmv, .mpg and .ts files among them) and a .mpeg copy =
    the JAX package's table, the meta.json side files each writes too."""
    tables = {}
    for side, pkg in (("port", postprocess), ("jax", jax_postprocess)):
        folder = tmp_path / side
        folder.mkdir()
        for name in EXPECTED:
            shutil.copy(D / name, folder / name)
        shutil.copy(D / "mpeg1_176x144.mpg", folder / "mpeg1_copy.mpeg")
        tables[side] = pkg.video_frame_counts(str(folder))
        tables[side + "_meta"] = {p.name: p.read_text()
                                  for p in folder.glob("*meta.json")}
    assert tables["port"] == tables["jax"]
    assert tables["port_meta"] == tables["jax_meta"]
    assert len(tables["port"]) == 1 + sum(
        n.rsplit(".", 1)[1] in VIDEO_EXTS for n in EXPECTED)
    assert tables["port"]["mpeg1_copy"] == tables["port"]["mpeg1_176x144"]


def _units():
    index = container.packet_index(str(IPB))
    units = [u for _, u in container.access_units(str(IPB), index)]
    scale = round(1 / index["time_base"])
    pts = [p.pts * 90000 // scale for p in index["packets"]]
    dts = [p.dts * 90000 // scale for p in index["packets"]]
    return units, pts, dts


class _Counting:
    """open() for the container modules that counts the bytes read."""

    def __init__(self):
        self.read = 0

    def __call__(self, path, mode="r", *args, **kwargs):
        f = builtins.open(path, mode, *args, **kwargs)
        outer, real = self, f.read

        def read(n=-1):
            b = real(n)
            outer.read += len(b)
            return b
        f.read = read
        return f


def _hour(tmp_path, kind: str) -> Path:
    """An hour of 30 fps H.264 (108,000 units): the first GOP of
    ipb_main_176x144 and then one-slice units of a few bytes."""
    units, pts, dts = _units()
    first = units[:12]
    tiny = b"\x00\x00\x00\x01\x09\xf0\x00\x00\x01\x01\x9a\x00\x10"
    if kind == "ps":         # a pack and a PES a unit: fill them out
        tiny += bytes(160)
    n = 108_000
    allu = first + [tiny] * (n - len(first))
    pts = [9000 + 3000 * k for k in range(n)]
    path = tmp_path / f"hour.{kind}"
    if kind == "ts":
        fixtures.write_mpegts(str(path), allu, pts, [None] * n, pcr=False)
    else:
        fixtures.write_mpegps(str(path), allu, pts, [None] * n)
    return path


@pytest.mark.parametrize("kind", ["ts", "ps"])
def test_num_frames_of_an_hour_reads_head_and_tail(tmp_path, monkeypatch,
                                                   kind):
    """Video.meta of an hour-long stream (108,000 frames at 30 fps, tens
    of MB) reads at most the probe size at the head and two tail windows
    (HEAD_AND_TAIL bytes), as ffmpeg's open does, and gives cv2's count."""
    path = _hour(tmp_path, kind)
    counting = _Counting()
    monkeypatch.setattr(container, "open", counting, raising=False)
    meta = Video(str(path), write=False).meta
    assert meta["num_frames"] == 108_000 and meta["fps"] == 30.0
    assert 0 < counting.read <= HEAD_AND_TAIL
    assert counting.read < path.stat().st_size / 3
    monkeypatch.undo()
    assert meta == JaxVideo(str(path), write=False).meta


def _ts(tmp_path, name: str, edit=None) -> str:
    units, pts, dts = _units()
    path = tmp_path / name
    fixtures.write_mpegts(str(path), units, [90000 + p for p in pts],
                          [90000 + d for d in dts])
    if edit is not None:
        path.write_bytes(edit(path.read_bytes()))
    return str(path)


def _drop_pid(pid: int):
    def edit(data: bytes) -> bytes:
        out = b""
        for k in range(0, len(data), 188):
            p = data[k:k + 188]
            if ((p[1] & 0x1F) << 8 | p[2]) != pid:
                out += p
        return out
    return edit


def _retype(data: bytes) -> bytes:
    """The PMT's stream type 0x1B made 0x0F (AAC): no video stream."""
    at = data.index(b"\x47\x50\x00")
    pmt = bytearray(data[at:at + 188])
    sec = (5 + pmt[4] if pmt[3] & 0x20 else 4) + 1    # past the pointer
    pmt[sec + 12] = 0x0F
    crc = fixtures._crc32_mpeg(bytes(pmt[sec:sec + 17]))
    pmt[sec + 17:sec + 21] = struct.pack(">I", crc)
    return data[:at] + bytes(pmt) + data[at + 188:]


@pytest.mark.parametrize("what,edit,match", [
    ("no_pat", _drop_pid(0), "without a PAT"),
    ("no_pmt", _drop_pid(0x1000), "without the PMT"),
    ("no_video", _retype, "no video stream"),
    ("cut_packet", lambda d: d[:188 * 40] + d[188 * 40 + 100:],
     "cut short")])
def test_malformed_transport_streams_raise_value_error(tmp_path, what, edit,
                                                       match):
    path = _ts(tmp_path, f"{what}.ts", edit)
    with pytest.raises(ValueError, match=match):
        container.packet_index(path)
    with pytest.raises(ValueError, match=match):
        Video(path, write=False)


def test_program_stream_without_video_raises_value_error(tmp_path):
    data = (D / "h264_ipb_176x144_ps.mpg").read_bytes()
    path = tmp_path / "audio_only.mpg"
    path.write_bytes(re.sub(rb"\x00\x00\x01[\xe0-\xef]", b"\x00\x00\x01\xc0",
                            data))
    with pytest.raises(ValueError, match="without a video stream"):
        container.meta(str(path))


def test_unaligned_pes_units_take_ffmpegs_times():
    """In the tests' writer's file a unit that begins in a PES whose times
    went to the unit before it takes none, as ffmpeg's parser gives none,
    and cv2 reports 0 for it; a unit over two PES keeps its own."""
    index = container.packet_index(str(D / "h264_ipb_176x144_pes.ts"))
    starts = [p.offset for p in index["packets"]]
    pes = [x.start for x in index["pes"]]
    # the first unit that begins in each PES takes its times
    first = {min((s for s in starts if s >= a), default=None) for a in pes}
    assert [p.pts is None for p in index["packets"]] == [
        s not in first for s in starts]
    assert sum(p.pts is None for p in index["packets"]) == 6
    stamps = EXPECTED["h264_ipb_176x144_pes.ts"]["timestamps"]
    assert "\n0.000000\n" in stamps.split("\n", 2)[2]


def test_wrap_past_2_33_unwraps_and_refuses_later_seeks():
    """The file whose PTS start 0.5 s before 2^33 counts down past the
    wrap (its times negative, then positive), as ffmpeg's wrap_timestamp
    does; cv2's seeks to frames before the wrap land on its first packet
    (expected.json's reads), later ones the port refuses naming A9."""
    path = str(D / "h264_ipb_176x144_wrap.m2ts")
    index = container.packet_index(path)
    pts = [p.pts for p in index["packets"]]
    assert min(pts) < 0 < max(pts) and index["wraps_down"]
    wrap = mpegstream.Wrap((1 << 33) - 45000)
    assert wrap((1 << 33) - 1) == -1 and wrap(5) == 5
    assert mpegstream.Wrap(1000)((1 << 33) - 1) == (1 << 33) - 1
    with pytest.raises(NotImplementedError, match="wrap.*A9"):
        Video(path, write=False).read_RGB(29, device="cpu")


def test_mpeg4_with_b_vops_without_pts_raises_naming_a9(tmp_path):
    """An MPEG-4 part 2 stream with B-VOPs whose units lack a PTS: ffmpeg
    guesses their times from the last I- or P-VOP, which the port does not
    follow; its count and frames it reads."""
    src = D.parent / "videos_mpeg4" / "ipb_112x96.avi"
    index = container.packet_index(str(src))
    units = [u for _, u in container.access_units(str(src), index)]
    starts = np.cumsum([0] + [len(u) for u in units[:-1]]).tolist()
    path = str(tmp_path / "bvop.ts")
    fixtures.write_mpegts(path, units, [90000 + 3000 * k for k in
                                        range(len(units))],
                          [None] * len(units), stream_type=0x10,
                          splits=[s for k, s in enumerate(starts) if k != 3])
    with pytest.raises(NotImplementedError, match="B-VOPs.*A9"):
        ingest.extract_timestamps(path, str(tmp_path / "ts.txt"))
    assert Video(path, write=False).count_frames() == JaxVideo(
        path, write=False).count_frames()


@pytest.mark.parametrize("rate,fields,want", [
    ((25, 1), 2, (25, 1)), ((30000, 1001), 2, (30000, 1001)),
    ((24000, 1001), 2, (24000, 1001)), ((25, 1), 0, (25, 1)),
    ((30000, 1), 0, (30000, 1)), ((1000, 33), 0, (1000, 33))])
def test_avg_frame_rate_rounds_to_a_standard_rate(rate, fields, want):
    """avg_frame_rate from frames of ffmpeg's duration (rounded down to
    the 90 kHz clock), rounded to a standard rate within 1 %: 23.976 and
    29.97 are found again, 30.30 fps is not moved; an MPEG-4 VOL whose
    fixed increment is absent (a rate of resolution/1 above 1000 fps) has
    no duration, hence none."""
    ticks = mpegstream.frame_ticks(rate, fields)
    if rate == (30000, 1):
        assert ticks == 0 and mpegstream.avg_frame_rate(ticks) is None
        return
    assert mpegstream.avg_frame_rate(ticks) == want


def test_probe_codec_tells_the_program_stream_codecs():
    """ffmpeg's request_probe: a VOP start code is MPEG-4 part 2's, a
    sequence header without one MPEG-1/2's, an SPS H.264's."""
    for name, codec in (("h264_ipb_176x144_ps.mpg", "h264"),
                        ("xvid_176_ps.mpg", "mpeg4"),
                        ("mpeg1_176x144.mpg", "mpeg1video"),
                        ("mpeg2_176x144_ntsc.mpg", "mpeg2video")):
        with open(D / name, "rb") as f:
            assert mpegstream.streams(f, name).head["codec"] == codec
