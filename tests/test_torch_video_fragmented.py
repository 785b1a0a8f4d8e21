"""auformer_torch's fragmented MP4 reader (the ``moof`` boxes in
data/container.py) against the JAX package's cv2, on the CPU, and the
refusals of the other containers the JAX package lists by extension.

The fragmented files of tests/data/videos_container/ are libavformat 59's
(frag_keyframe with and without empty_moov, CMAF with default-base-is-moof
and a sidx, written to a pipe, 720p, MPEG-4 part 2) and the tests' writer's
(``fixtures.write_fragmented_mp4``: two truns a traf, per-sample flags,
signed composition offsets, explicit base offsets; a first-sample flag, no
tfdt and an edit list); regenerate them with ``JAX_PLATFORMS=cpu python
scripts/make_container_fixtures.py``. Each one's meta equals the JAX
package's through cv2, and its count, timestamps, frames and reads equal
expected.json's bit for bit. What the port does not follow raises naming
ROADMAP.md queue A9: the rate of a track in fragments whose samples last
different times, a second trun without its data offset. Stub ASF, MPEG
program and transport stream headers with no stream behind them raise
ValueError.
"""
import struct
from pathlib import Path

import pytest
import torch

from auformer_torch.data import container, fixtures
from auformer_torch.data.video import Video
from test_torch_video_matroska import (D, EXPECTED, count_and_timestamps_match,
                                       frames_match, meta_matches)

FRAG = sorted(n for n in EXPECTED if n.endswith(".mp4"))
IPB = D.parent / "videos_h264" / "ipb_main_176x144.mp4"


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread for this file, as in the Matroska tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", FRAG)
def test_meta_matches_jax(name):
    meta_matches(name)


@pytest.mark.parametrize("name", FRAG)
def test_count_and_timestamps_match_cv2(name, tmp_path):
    count_and_timestamps_match(name, tmp_path)


@pytest.mark.parametrize("name", FRAG)
def test_frames_and_seeks_match_cv2(name):
    frames_match(name)


def _stored(path) -> tuple[list[bytes], list[bool]]:
    """Each packet's bytes as the container stores them, and its sync
    flag."""
    index = container.packet_index(str(path))
    raw = Path(path).read_bytes()
    return ([raw[p.offset:p.offset + p.size] for p in index["packets"]],
            [p.sync for p in index["packets"]])


@pytest.mark.parametrize("name", FRAG)
def test_fragments_hold_the_source_samples(name):
    """Every sample of the source stream, in its decode order and with
    its sync flags, comes out of the fragments (and the moov, for
    frag_keyframe alone), byte for byte."""
    assert _stored(D / name) == _stored(D.parent / EXPECTED[name]["source"])


def _ipb_samples():
    index = container.packet_index(str(IPB))
    raw = IPB.read_bytes()
    at = raw.index(b"avcC")
    avcc = raw[at + 4:at - 4 + int.from_bytes(raw[at - 4:at], "big")]
    data = [raw[p.offset:p.offset + p.size] for p in index["packets"]]
    return index, data, avcc


def test_uneven_durations_raise_naming_a9(tmp_path):
    """ffmpeg estimates the rate of a track whose samples are all in
    fragments and last different times from its first packets, which the
    port does not follow."""
    index, data, avcc = _ipb_samples()
    dts = [p.dts + (k % 3) * 7 for k, p in enumerate(index["packets"])]
    path = str(tmp_path / "uneven.mp4")
    fixtures.write_fragmented_mp4(path, data, [p.sync for p in index[
        "packets"]], dts, dts, 15360, 176, 144, avcc)
    with pytest.raises(NotImplementedError, match="different times.*A9"):
        Video(path, write=False)


def _drop_second_data_offset(moof: bytes) -> bytes:
    """A moof whose traf's second trun loses its data offset."""
    out, seen = [], 0
    for kind, b0, b1 in container._boxes(moof):
        body = moof[b0:b1]
        if kind == b"traf":
            parts = []
            for k2, c0, c1 in container._boxes(body):
                child = body[c0:c1]
                if k2 == b"trun":
                    seen += 1
                    if seen == 2:
                        flags = int.from_bytes(child[1:4], "big") & ~1
                        child = (child[:1] + flags.to_bytes(3, "big")
                                 + child[4:8] + child[12:])
                parts.append(fixtures._box(k2, child))
            body = b"".join(parts)
        out.append(fixtures._box(kind, body))
    return b"".join(out)


def test_second_trun_without_data_offset_raises_naming_a9(tmp_path):
    """Where a second trun of a traf has no data offset, the specification
    runs its data on from the first's and ffmpeg starts it at the traf's
    base: the port follows neither."""
    raw = (D / "h264_ipb_176x144_truns.mp4").read_bytes()
    at = raw.index(b"moof") - 4
    size = int.from_bytes(raw[at:at + 4], "big")
    moof = _drop_second_data_offset(raw[at + 8:at + size])
    path = tmp_path / "truns.mp4"
    path.write_bytes(raw[:at] + fixtures._box(b"moof", moof)
                     + raw[at + size:])
    with pytest.raises(NotImplementedError, match="data offset.*A9"):
        container.packet_index(str(path))


@pytest.mark.parametrize("name,head", [
    ("clip.wmv", bytes.fromhex("3026b2758e66cf11a6d900aa0062ce6c")
     + struct.pack("<QIBB", 30, 0, 1, 2)),
    ("clip.mpg", b"\x00\x00\x01\xba\x44\x00\x04\x00\x04\x01\x01\x89\xc3\xf8"),
    ("clip.ts", b"".join(b"\x47\x40\x00\x10" + bytes(184)
                         for _ in range(3))),
    ("clip.m2ts", b"".join(bytes(4) + b"\x47\x40\x00\x10" + bytes(184)
                           for _ in range(3)))],
    ids=["asf", "mpeg_ps", "mpeg_ts", "m2ts"])
def test_other_video_exts_stubs_raise_value_error(tmp_path, name, head):
    """ASF (.wmv), MPEG program streams (.mpg, .mpeg) and transport
    streams are read (test_torch_video_asf.py, test_torch_video_mpegts.py):
    these stub headers, with no stream behind them, are malformed files and
    raise ValueError from meta, probe and the packet index."""
    path = tmp_path / name
    path.write_bytes(head + bytes(64))
    for call in (lambda: Video(str(path), write=False),
                 lambda: container.probe(str(path)),
                 lambda: container.packet_index(str(path))):
        with pytest.raises(ValueError):
            call()


def test_not_a_video_still_raises_value_error(tmp_path):
    path = tmp_path / "clip.mp4"
    path.write_bytes(b"this is not a video file at all" * 4)
    with pytest.raises(ValueError, match="not an MP4/MOV, AVI or Matroska"):
        container.probe(str(path))
