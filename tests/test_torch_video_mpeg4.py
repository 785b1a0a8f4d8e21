"""auformer_torch's MPEG-4 part 2 frames (data/mpeg4.py, the port's own
decoder data/native/mpeg4_decode.cpp, and the limited-range conversion of
ops/colour.py) against the JAX package's cv2, on the CPU.

Frames, seeks (``read_RGB``), sequential reads, ``count_frames`` and the
timestamps are held to cv2's bit for bit: on the fixtures of
tests/data/videos_mpeg4/ (regenerate with ``JAX_PLATFORMS=cpu python
scripts/make_mpeg4_fixtures.py``, which needs cv2 and the JAX package), on
the MPEG-4 files of tests/data/videos/, and on streams cv2 writes here at
sizes whose width is not a whole number of swscale's SIMD steps. Every tool
the decoder refuses raises naming ROADMAP.md queue A9, on streams whose
headers are edited here, and packed bitstreams decode to cv2's frames.
libxvid's streams in the same directory (the entries of expected.json with
``planes_sha256``) are held in test_torch_video_mpeg4_xvid.py.
"""
import hashlib
import json
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from auformer.data import ingest as jax_ingest
from auformer.data.video import Video as JaxVideo
from auformer_torch.data import container, fixtures, ingest
from auformer_torch.data import mpeg4
from auformer_torch.data.fixtures import (h264_source_yuv,
                                          mpeg4_access_units, write_h264,
                                          write_mpeg4)
from auformer_torch.data.video import Video
from auformer_torch.ops.colour import yuv_rgb, yuv_rgb_plain

D = Path(__file__).parent / "data" / "videos_mpeg4"
VIDEOS = Path(__file__).parent / "data" / "videos"
# the fixtures of cv2's writers and write_mpeg4; libxvid's are held in
# test_torch_video_mpeg4_xvid.py
EXPECTED = {name: entry for name, entry in
            json.loads((D / "expected.json").read_text()).items()
            if "planes_sha256" not in entry}
CASES = [D / name for name in sorted(EXPECTED)] + [
    VIDEOS / name for name in ("mp4v_30.mp4", "xvid_25.avi",
                               "elst_window.mp4", "vfr.mp4")]


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread for this file: its conversions are small torch
    ops, and with several test workers on one machine a full pool per
    worker oversubscribes the cores (the file took 19 s alone and 421 s
    of worker time beside five other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sha(img) -> str | None:
    return None if img is None else hashlib.sha256(
        np.ascontiguousarray(img).tobytes()).hexdigest()


def _same(a, b) -> bool:
    return (a is None and b is None) or (
        a is not None and b is not None and np.array_equal(a, b))


def _against_jax(path: str) -> None:
    v, jv = Video(path, write=False), JaxVideo(path, write=False)
    ours = list(v.frames(device="cpu"))
    theirs = list(jv.frames())
    assert len(ours) == len(theirs) == v.count_frames() == jv.count_frames()
    for k, (a, b) in enumerate(zip(ours, theirs)):
        assert np.array_equal(a, b), f"frame {k}"
    for k in range(len(theirs) + 2):
        assert _same(v.read_RGB(k, device="cpu"), jv.read_RGB(k)), \
            f"read_RGB({k})"
    v.read_RGB(3, device="cpu")
    jv.read_RGB(3)
    for k in range(4, 9):
        assert _same(v.read_RGB(device="cpu"), jv.read_RGB()), \
            f"read_RGB() after 3, {k}"
    jv.release()
    v.release()


@pytest.mark.parametrize("path", CASES, ids=lambda p: p.name)
def test_frames_and_seeks_equal_jax(path):
    """Every frame in display order, every seek from 0 to past the end,
    sequential reads after a seek and the count equal cv2's bit for bit:
    I-, P- and B-VOPs, 4MV, AC prediction, H.263 and MPEG quantisation,
    video packets, vop_coded 0, edit lists, a size that is not whole
    macroblocks."""
    _against_jax(str(path))


@pytest.mark.parametrize("size", [(100, 70), (90, 66)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_widths_off_the_simd_step(tmp_path, size):
    """Display widths that are no multiple of 8 (swscale converts 8 or 16
    pixels a step): cv2's own streams, frames and seeks equal."""
    w, h = size
    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"XVID"), 25,
                             (w, h))
    for t in range(14):
        writer.write(cv2.cvtColor(fixtures.fixture_frame(3, 0, t, 128)[
            t:t + h, 2 * t:2 * t + w], cv2.COLOR_RGB2BGR))
    writer.release()
    _against_jax(path)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_port_matches_expected(tmp_path, name):
    """The port on tests/data/videos_mpeg4/ equals what the JAX package
    read when the fixtures were made: frames, seeks, the count and the
    timestamps (which follow the frames the decoder returns: none for a
    VOP of vop_coded 0, and in an AVI with B-VOPs the decode time of the
    chunk that returned each)."""
    want = EXPECTED[name]
    path = str(D / name)
    v = Video(path, write=False)
    assert [_sha(f) for f in v.frames(device="cpu")] == want["frames_sha256"]
    for k, digest in want["read_RGB_sha256"].items():
        assert _sha(v.read_RGB(int(k), device="cpu")) == digest, k
    assert v.count_frames() == want["count_frames"]
    ts = ingest.extract_timestamps(path, str(tmp_path / "ts.txt"))
    assert Path(ts).read_text() == want["timestamps"]


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_expected_still_what_jax_reads(tmp_path, name):
    """expected.json still holds what the JAX package's cv2 reads."""
    want = EXPECTED[name]
    path = str(D / name)
    v = JaxVideo(path, write=False)
    assert [_sha(f) for f in v.frames()] == want["frames_sha256"]
    for k, digest in want["read_RGB_sha256"].items():
        assert _sha(v.read_RGB(int(k))) == digest, k
    v.release()
    assert v.count_frames() == want["count_frames"]
    ts = jax_ingest.extract_timestamps(path, str(tmp_path / "ts.txt"))
    assert Path(ts).read_text() == want["timestamps"]


def test_vop_not_coded_count_is_cv2s():
    """ROADMAP.md C12: a VOP of vop_coded 0 is a packet that returns no
    frame, and a low-delay stream that ends with one returns its last frame
    again, so cv2's count is not the packet count; the port's is cv2's."""
    path = str(D / "nvop_112x96.mp4")
    packets = container.probe(path, timestamps=False)["packets"]
    assert packets == 24
    assert Video(path, write=False).count_frames() == \
        JaxVideo(path, write=False).count_frames() == 23
    frames = list(Video(path, write=False).frames(device="cpu"))
    assert np.array_equal(frames[-1], frames[-2])


def _limited_range_rgb(y, u, v) -> np.ndarray:
    """swscale's limited-range BT.601 yuv2rgb of 4:2:0 planes (13-bit
    coefficients, offset 16, floors), as tests/test_torch_video_decode.py
    holds it against cv2."""
    y, u, v = (p.astype(np.int64) for p in (y, u, v))
    h, w = y.shape
    cu = np.repeat(np.repeat(u, 2, 0), 2, 1)[:h, :w] * 8 - 1024
    cv = np.repeat(np.repeat(v, 2, 0), 2, 1)[:h, :w] * 8 - 1024
    yt = ((y * 8 - 128) * 9539) >> 16
    rgb = np.stack([yt + ((cv * 13075) >> 16),
                    yt + ((cu * -3209) >> 16) + ((cv * -6660) >> 16),
                    yt + ((cu * 16525) >> 16)], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _sweep(t: int, size: int = 256):
    """Planes whose 2x2 blocks take every (U, V) pair over 4 frames, each
    block's four Y values spread over 0-255."""
    blocks = (size // 2) ** 2
    k = t * blocks + np.arange(blocks)
    uv = k % 65536
    y = np.empty((size, size), np.uint8)
    for j, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        y[dy::2, dx::2] = ((k * 67 + 64 * j) % 256).reshape(size // 2,
                                                             size // 2)
    return (y, (uv // 256).astype(np.uint8).reshape(size // 2, size // 2),
            (uv % 256).astype(np.uint8).reshape(size // 2, size // 2))


def test_limited_range_plain_equals_formula_and_cv2(tmp_path):
    """yuv_rgb_plain (and yuv_rgb on CPU planes) with ``limited`` equals
    swscale's arithmetic and cv2's frames of I_PCM H.264 pictures bit for
    bit, on every (U, V) pair; the full-range default is unchanged."""
    path = str(tmp_path / "sweep.mp4")
    write_h264(path, 256, 256, 4, gop=1, source=_sweep)
    cap = cv2.VideoCapture(path)
    for t in range(4):
        planes = _sweep(t)
        got = yuv_rgb_plain(*map(torch.from_numpy, planes), limited=True)
        assert np.array_equal(got.numpy(), _limited_range_rgb(*planes))
        assert torch.equal(yuv_rgb(*map(torch.from_numpy, planes),
                                   limited=True), got)
        ok, bgr = cap.read()
        assert ok
        assert np.array_equal(got.numpy(),
                              cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
        assert not torch.equal(yuv_rgb_plain(*map(torch.from_numpy,
                                                  planes)), got)
    cap.release()


def test_writer_streams_decode_in_cv2(tmp_path):
    """write_mpeg4's streams as cv2 reads them: a frame for every coded VOP
    in display order (B-VOPs in MP4 and in AVI, MPEG quantisation with
    video packets, vop_coded 0), I-VOPs within the quantiser's error of
    their source, and the port's frames equal cv2's."""
    for name, kw, n in (("b.mp4", {"b_frames": 2}, 14),
                        ("b.avi", {"b_frames": 1, "mpeg_quant": True}, 14),
                        ("q.avi", {"mpeg_quant": True, "resync": 5}, 14),
                        ("n.mp4", {"not_coded": (3,)}, 13)):
        path = str(tmp_path / name)
        order = write_mpeg4(path, 64, 48, 14, gop=7, seed=6, qscale=4, **kw)
        assert sorted(t for t, _ in order) == list(range(14))
        cap = cv2.VideoCapture(path)
        frames = []
        while True:
            ok, bgr = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
        cap.release()
        assert len(frames) == n, name
        shown = sorted(t for t, kind in order if kind != "N")
        for t in (0, 7):                              # the I-VOPs
            src = _limited_range_rgb(*h264_source_yuv(6, t, 48, 64))
            err = np.abs(frames[shown.index(t)].astype(int)
                         - src.astype(int)).mean()
            assert err < 8, (name, t, err)
        ours = list(Video(path, write=False).frames(device="cpu"))
        assert all(np.array_equal(a, b) for a, b in zip(ours, frames))
        assert len(ours) == len(frames)


def _set_bits(data: bytearray, at: int, n: int, value: int) -> None:
    for i in range(n):
        byte, bit = divmod(at + i, 8)
        mask = 0x80 >> bit
        if value >> (n - 1 - i) & 1:
            data[byte] |= mask
        else:
            data[byte] &= ~mask


# bit offsets in write_mpeg4's VOL (after its start code) of the flags a
# refused tool sets; (offset, bits, value)
_VOL_EDITS = {
    "non-rectangular": (26, 2, 1), "interlaced": (76, 1, 1),
    "sprites": (78, 2, 1), "not_8_bit": (80, 1, 1),
    "complexity estimation": (83, 1, 0),
    "data partitioning": (85, 1, 1), "newpred": (86, 1, 1),
    "reduced resolution": (87, 1, 1), "scalability": (88, 1, 1)}
_QUARTER_PEL = (82, 1, 1)     # decoded; refused in a DivX stream
# the signatures (user data) of streams ffmpeg decodes with bug
# workarounds: XviD build 32 and DivX 4
_SIGNATURES = {"XviD": b"XviD0032", "DivX": b"DivX412b1393",
               "DivX quarter-pel": b"DivX503b1393p",
               "XVIX fourcc": b"XviD0069"}


def _stream(tmp_path, tool: str) -> str:
    """An AVI of write_mpeg4's first VOPs with ``tool`` written in."""
    headers, units = mpeg4_access_units(32, 32, 3, gop=3, seed=1)
    head = bytearray(headers)
    vops = [vop for _, _, vop in units]
    fourcc = b"FMP4"
    if tool in _VOL_EDITS or tool == "DivX quarter-pel":
        at = head.index(b"\x00\x00\x01\x20") + 4
        off, n, value = _VOL_EDITS.get(tool, _QUARTER_PEL)
        _set_bits(head, 8 * at + off, n, value)
    elif tool == "S-VOPs":
        vop = bytearray(vops[1])
        vop[4] = vop[4] & 0x3F | 0xC0              # vop_coding_type 3
        vops[1] = bytes(vop)
    elif tool == "short video header":
        head, vops = bytearray(), [b"\x00\x00\x80\x02\x0a" + bytes(16)]
    elif tool == "XVID fourcc":
        fourcc = b"XVID"
    if tool in _SIGNATURES:
        head += b"\x00\x00\x01\xb2" + _SIGNATURES[tool]
    if tool == "XVIX fourcc":
        fourcc = b"XVIX"
    chunks = [bytes(head) + vops[0]] + vops[1:]
    path = tmp_path / "edited.avi"
    path.write_bytes(fixtures._avi(chunks, [True] + [False] * (len(chunks)
                                                             - 1),
                                   fourcc, 512, 15360, 32, 32))
    return str(path)


@pytest.mark.parametrize("tool", sorted(_VOL_EDITS) + [
    "S-VOPs", "short video header", "XviD", "DivX", "XVID fourcc",
    "DivX quarter-pel", "XVIX fourcc"])
@pytest.mark.parametrize("call", ["frames", "read_RGB"])
def test_refused_tools_raise_naming_a9(tmp_path, tool, call):
    """Interlacing, sprites and S-VOPs, data partitioning, the short video
    header, shapes, not_8_bit, newpred, scalability, reduced resolution,
    complexity estimation, and the streams ffmpeg decodes with an
    encoder's bug workarounds (XviD build 32, DivX 4, a quarter-pel DivX
    stream, a bare XVID fourcc, which ffmpeg takes for XviD build 0, and
    the XVIX fourcc): each raises NotImplementedError naming A9 on the
    CPU, before any frame. (Quarter-pel, packed bitstreams and XviD's later
    builds decode: test_torch_video_mpeg4_xvid.py.)"""
    v = Video(_stream(tmp_path, tool), write=False)
    with pytest.raises(NotImplementedError, match="A9"):
        if call == "frames":
            list(v.frames(device="cpu"))
        else:
            v.read_RGB(2, device="cpu")


def test_unedited_stream_decodes(tmp_path):
    """The control for the edits above: the same stream, unedited,
    decodes to three frames."""
    v = Video(_stream(tmp_path, "none"), write=False)
    assert len(list(v.frames(device="cpu"))) == 3


@pytest.mark.parametrize("ext", [".mp4", ".avi"])
def test_delayed_stream_ending_not_coded_equal_jax(tmp_path, ext):
    """A stream with B-VOPs (not low delay) whose last VOP has vop_coded
    0: the last reference comes out at the end with the last packet's
    properties (ffmpeg's skipped_last_frame), so in MP4 it carries that
    packet's presentation time, and in AVI, which has none, 0. Frames,
    count and timestamps equal cv2's."""
    path = str(tmp_path / f"n{ext}")
    order = write_mpeg4(path, 48, 32, 10, gop=4, b_frames=1,
                        not_coded=(9,), seed=2, qscale=6)
    assert order[-1] == (9, "N")
    _against_jax(path)
    ours = ingest.extract_timestamps(path, str(tmp_path / "a.txt"))
    theirs = jax_ingest.extract_timestamps(path, str(tmp_path / "b.txt"))
    assert Path(ours).read_text() == Path(theirs).read_text()


def _packed_avi(tmp_path, signature: bytes, n_vops: bool) -> str:
    """An AVI of write_mpeg4's VOPs (one B-VOP between references) packed
    as DivX packs them: each P-VOP and the B-VOP after it in one chunk,
    then a chunk of an N-VOP (a P-VOP of vop_coded 0, 6 bytes) where
    ``n_vops``, else none; ``signature`` as user data after the VOL."""
    headers, units = mpeg4_access_units(64, 48, 13, gop=6, b_frames=1,
                                        seed=3, qscale=4)
    if signature:
        headers += b"\x00\x00\x01\xb2" + signature

    def n_vop(t):
        w = fixtures._BitList()
        for value, bits in ((0x1B6, 32), (1, 2), (0, 1), (1, 1), (t, 5),
                            (1, 1), (0, 1)):
            w.put(value, bits)
        w.stuff()
        return w.tobytes()
    chunks, sync, k = [], [], 0
    while k < len(units):
        t, kind, vop = units[k]
        data = (headers if kind == "I" else b"") + vop
        if k + 1 < len(units) and units[k + 1][1] == "B":
            chunks.append(data + units[k + 1][2])
            sync.append(False)
            if n_vops:
                chunks.append(n_vop(t))
                sync.append(False)
            k += 2
        else:
            chunks.append(data)
            sync.append(kind == "I")
            k += 1
    path = tmp_path / "packed.avi"
    path.write_bytes(fixtures._avi(chunks, sync, b"FMP4", 512, 15360, 64,
                                   48))
    return str(path)


@pytest.mark.parametrize("signature,n_vops", [
    (b"DivX503b1393p", True), (b"", True), (b"DivX503b1393p", False)],
    ids=["divx-packed", "unsigned", "divx-packed-no-n-vops"])
def test_packed_count_and_timestamps_equal_jax(tmp_path, signature, n_vops):
    """A packed bitstream: the count and the timestamps equal cv2's, the
    decoder reading the headers as ffmpeg does (with DivX's packed flag
    the second VOP of a chunk is decoded in the next chunk's place;
    without it, it is passed over and the N-VOPs return nothing). Neither
    is the packet count or the packets' times. Its frames, read by the
    same rule, and its seeks equal cv2's (DivX 5's bug workarounds act on
    none of them)."""
    path = _packed_avi(tmp_path, signature, n_vops)
    jv = JaxVideo(path, write=False)
    ours = ingest.extract_timestamps(path, str(tmp_path / "a.txt"))
    theirs = jax_ingest.extract_timestamps(path, str(tmp_path / "b.txt"))
    assert Path(ours).read_text() == Path(theirs).read_text()
    assert Video(path, write=False).count_frames() == jv.count_frames() == (
        13 if signature and n_vops else 9)
    index = container.packet_index(path)
    by_packet = [p.pts * index["time_base"] * 1000.0
                 for p in index["packets"]]
    want = [float(x) for x in Path(theirs).read_text().split("\n")[1:] if x]
    assert len(by_packet) != len(want) or not np.allclose(by_packet, want)
    _against_jax(path)


def test_h264_still_raises_and_mpeg4_needs_no_nvdec(monkeypatch):
    """H.264 frames the port's decoder refuses (4:2:2 coded for fields)
    still raise naming A9; H.264 and MPEG-4 frames decode without the
    NVDEC probe (it is never asked) and the GPU default still raises
    without a GPU."""
    from auformer_torch.data import nvdec
    monkeypatch.setattr(nvdec, "caps", lambda *a: pytest.fail("NVDEC"))
    v = Video(str(D.parent / "videos_h264" / "mbaff_yuv422_176x144.mp4"),
              write=False)
    with pytest.raises(NotImplementedError, match="A9"):
        v.read_RGB(0, device="cpu")
    v = Video(str(D.parent / "videos_decode" / "ip_112.mp4"), write=False)
    assert v.read_RGB(0, device="cpu").shape == (112, 112, 3)
    v = Video(str(D / "mp4v_176.mp4"), write=False)
    assert v.read_RGB(0, device="cpu").shape == (144, 176, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            v.read_RGB(0)


def test_decoder_that_does_not_build_raises(monkeypatch):
    """A failed build of the decoder raises with the compiler's output:
    nothing falls back to another decoder."""
    from auformer_torch.data import native
    monkeypatch.setattr(native, "_cxx", lambda: "/nonexistent/c++")
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR / "absent")
    mpeg4._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="MPEG-4 part 2 decoder"):
            list(mpeg4.decode_range(str(D / "mp4v_176.mp4")))
    finally:
        mpeg4._library.cache_clear()


def test_decode_range_from_a_sync_packet():
    """decode_range from the second GOP's I-VOP gives the frames from
    there on, equal to the whole decode's; a packet that is not a sync
    one is refused."""
    path = str(D / "ipb_112x96.mp4")
    index = container.packet_index(path)
    whole = [(k, [p.clone() for p in planes])
             for k, planes, _ in mpeg4.decode_range(path, index)]
    key = next(k for k, p in enumerate(index["packets"])
               if p.sync and k > 0)
    part = list(mpeg4.decode_range(path, index, key, stop=5))
    assert len(part) == 5
    at = [k for k, _ in whole].index(part[0][0])
    for (k, planes), (k2, planes2, _) in zip(whole[at:], part):
        assert k == k2 and all(torch.equal(a, b)
                               for a, b in zip(planes, planes2))
    with pytest.raises(ValueError, match="not a sync packet"):
        next(mpeg4.decode_range(path, index, key + 1))
