"""auformer_torch's H.264 frames (data/h264.py, the port's own decoder
data/native/h264_decode.cpp, and the conversion of ops/colour.py with the
stream's colour matrix and range) against the JAX package's cv2, on the
CPU.

Frames, seeks (``read_RGB``), sequential reads, ``count_frames`` and the
timestamps are held to cv2's bit for bit, and the decoder's Y, U and V
planes to libavcodec's own h264 decoder's, on the x264 streams of
tests/data/videos_h264/ (regenerate with ``JAX_PLATFORMS=cpu python
scripts/make_h264_fixtures.py --x264``, which needs cv2, the JAX package
and the system's libavcodec with libx264): CAVLC and CABAC, with and without
scaling lists, a fake-interlaced stream (frame_mbs_only_flag 0 without
MBAFF) whose frames cv2 reads as progressive, and the MBAFF streams, whose
frames cv2 does not convert (ROADMAP.md C14): theirs are held to swscale's
conversion of libavcodec's planes, their counts and timestamps to cv2's.
What only MBAFF has is tested in test_torch_video_h264_mbaff.py, what only
bit depths above 8 have (the 10-bit streams are among those held here) in
test_torch_video_h264_depth.py. Every tool the decoder refuses raises
naming ROADMAP.md queue A9: on an x264 stream (4:2:2 coded for fields) and
on streams whose headers are written here, where scaling lists in the SPS
or PPS, monochrome, 4:2:2 and the transform bypass flag decode (the other
chroma formats and lossless coding: test_torch_video_h264_chroma.py).
The last part holds MPEG-4 part 2's colour description to cv2 (ROADMAP.md
C13).
"""
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from auformer.data import ingest as jax_ingest
from auformer.data.video import Video as JaxVideo
from auformer_torch.data import bitstream, container, fixtures, h264, ingest
from auformer_torch.data.fixtures import write_mpeg4
from auformer_torch.data.video import Video
from auformer_torch.ops import colour
from auformer_torch.ops.colour import yuv_rgb, yuv_rgb_plain

D = Path(__file__).parent / "data" / "videos_h264"
EXPECTED = json.loads((D / "expected.json").read_text())
REFUSED = sorted(n for n in EXPECTED if "planes_sha256" not in EXPECTED[n])
# the decoded streams; the frames of those cv2 flags interlaced are swscale's
# (expected.json's frames_from; C14), the others' cv2's
DECODED = sorted(n for n in EXPECTED if "planes_sha256" in EXPECTED[n])
INTERLACED = [n for n in DECODED if EXPECTED[n]["frames_from"] == "swscale"]
FULL_WIDTH = ("1280x720", "1920x1080")   # a few seeks: (0, 13, 23, 35)
ONE_GOP = "1920x1080"      # one GOP: any seek past 0 decodes it whole
COLOUR = {"bt709_176x144.mp4": (1, 0), "smpte240m_176x144.mp4": (7, 0),
          "bt2020nc_176x144.mp4": (9, 0), "fcc_176x144.mp4": (4, 0),
          "fullrange_176x144.mp4": (2, 1),
          "fullrange_bt709_176x144.mp4": (1, 1)}


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread for this file: its conversions are small torch
    ops, and several test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sha(img) -> str | None:
    return None if img is None else hashlib.sha256(
        np.ascontiguousarray(img).tobytes()).hexdigest()


# ---- the x264 streams -------------------------------------------------------

def _size(name: str) -> tuple[int, int]:
    """(height, width) from a fixture's name, ``..._<w>x<h>.<ext>``."""
    w, h = name.rsplit("_", 1)[1].split(".")[0].split("x")
    return int(h), int(w)


@pytest.mark.parametrize("name", DECODED)
def test_frames_and_planes_match_cv2(name):
    """Video.frames on the CPU gives expected.json's frames bit for bit at
    the stream's cropped size (1920x1080, not 1088 coded rows), and the
    JAX package's, run here, where they are cv2's; an interlaced stream's
    are swscale's, woven and not deinterlaced, since cv2 returns a buffer
    it never wrote (C14). The decoder's planes are libavcodec's."""
    path = str(D / name)
    want = EXPECTED[name]
    got = list(Video(path, write=False).frames(device="cpu"))
    assert [_sha(f) for f in got] == want["frames_sha256"]
    assert all(f.shape == (*_size(name), 3) for f in got)
    if want["frames_from"] == "cv2":
        theirs = list(JaxVideo(path, write=False).frames())
        assert len(theirs) == len(got)
        assert all(np.array_equal(a, b) for a, b in zip(got, theirs))
    planes = [[_sha(p.numpy()) for p in yuv]
              for _, yuv, _ in h264.decode_range(path)]
    assert planes == [[p["y"], p["u"], p["v"]]
                      for p in want["planes_sha256"]]


@pytest.mark.parametrize("name", DECODED)
def test_seeks_count_and_timestamps_match_cv2(name, tmp_path):
    """read_RGB at the first, middle and last frames, past the end and in
    sequential reads after a seek equal the JAX package's on the same file
    (expected.json's frames where cv2's are not real: C14), and
    expected.json's seeks; count_frames and the timestamps equal the JAX
    package's, which reads them from the container whatever it makes of
    the pixels. The 1920x1080 stream, one GOP, is sought at 0 alone."""
    path = str(D / name)
    want = EXPECTED[name]
    v, jv = Video(path, write=False), JaxVideo(path, write=False)
    n = want["count_frames"]
    assert v.count_frames() == jv.count_frames() == n
    for k, digest in want["read_RGB_sha256"].items():
        if any(w in name for w in FULL_WIDTH) and int(k) not in (0, 13, 23,
                                                                   35):
            continue            # the full-width streams: a few seeks
        if ONE_GOP in name and int(k):
            continue
        assert _sha(v.read_RGB(int(k), device="cpu")) == digest, k
    frames, pos = want["frames_sha256"], 0
    for k in () if ONE_GOP in name else (n - 1, 0, None, None, n // 2, None,
                                         n):
        idx = pos if k is None else k
        ours = _sha(v.read_RGB(k, device="cpu"))
        if want["frames_from"] == "cv2":
            assert ours == _sha(jv.read_RGB(k)), k
        else:
            assert ours == (frames[idx] if idx < n else None), k
        pos = min(idx + 1, n)
    v.release()
    jv.release()
    ts = Path(ingest.extract_timestamps(path, str(tmp_path / "a.txt")))
    jts = Path(jax_ingest.extract_timestamps(path, str(tmp_path / "b.txt")))
    assert ts.read_text() == jts.read_text() == want["timestamps"]


@pytest.mark.parametrize("name", sorted(COLOUR))
def test_colour_matrix_and_range_match_cv2(name):
    """The decoder reports the VUI's matrix_coefficients and
    video_full_range_flag, and yuv_rgb_plain with them gives cv2's frames;
    BT.601 does not (the matrices and ranges differ from it)."""
    path = str(D / name)
    want = EXPECTED[name]["frames_sha256"]
    for k, (_, yuv, got) in enumerate(h264.decode_range(path)):
        assert got == COLOUR[name]
        matrix, full = got
        assert _sha(yuv_rgb_plain(*yuv, limited=not full, matrix=matrix)
                    .numpy()) == want[k]
        assert _sha(yuv_rgb_plain(*yuv, limited=True).numpy()) != want[k]


def test_coefficients_are_swscales():
    """coefficients() rounds swscale's rows as ff_yuv2rgb_c_init_tables
    does: BT.601 gives the 13-bit values the MJPEG (full range) and MPEG-4
    (limited range) paths held to cv2 before, BT.709 its own row, and
    unlisted values BT.601's."""
    assert colour.coefficients(2, False) == (11485, -2819, -5850, 14516)
    assert colour.coefficients(2) == (13075, -3209, -6660, 16525)
    assert colour.coefficients(1) == (14686, -1747, -4366, 17305)
    for m in (0, 3, 5, 6, 8, 11, 255):
        assert colour.coefficients(m) == colour.coefficients(2)


@pytest.mark.parametrize("name", REFUSED)
@pytest.mark.parametrize("call", ["read_RGB", "frames", "frame_tensors"])
def test_refused_streams_raise_naming_a9(name, call, tmp_path):
    """4:2:2 coded for fields (an x264 --interlaced 4:2:2 stream,
    mbaff_yuv422_176x144.mp4, the one x264 stream the decoder refuses)
    raises NotImplementedError naming A9 from each entry point; the count
    and the timestamps, which need no pixels, are still cv2's."""
    path = str(D / name)
    v = Video(path, write=False)
    with pytest.raises(NotImplementedError, match="A9"):
        out = getattr(v, call)(device="cpu")
        if call != "read_RGB":
            next(iter(out))
    assert v.count_frames() == EXPECTED[name]["count_frames"]
    stamps = ingest.extract_timestamps(path, str(tmp_path / "ts.txt"))
    assert Path(stamps).read_text() == EXPECTED[name]["timestamps"]


def test_decode_range_from_a_sync_packet():
    """decode_range from the second IDR picture gives the frames from there
    on, equal to the whole decode's; a packet that is not a sync one is
    refused."""
    path = str(D / "ipb_main_176x144.mp4")
    index = container.packet_index(path)
    whole = [(k, [p.clone() for p in yuv])
             for k, yuv, _ in h264.decode_range(path, index)]
    key = next(k for k, p in enumerate(index["packets"]) if p.sync and k)
    part = list(h264.decode_range(path, index, key, stop=5))
    assert len(part) == 5
    at = [k for k, _ in whole].index(part[0][0])
    for (k, yuv), (k2, yuv2, _) in zip(whole[at:], part):
        assert k == k2 and all(torch.equal(a, b) for a, b in zip(yuv, yuv2))
    with pytest.raises(ValueError, match="not a sync packet"):
        next(h264.decode_range(path, index, key + 1))


def test_output_frames_follow_ffmpegs_delay():
    """h264_output_frames returns each picture on the unit max_num_reorder
    pictures later (the frames of the AVI with B pictures carry those
    units' times), in picture order count order, the last ones at the
    end."""
    path = str(D / "nodeblock_176x144.avi")
    units = [u for _, u in container.access_units(path)]
    frames = bitstream.h264_output_frames(units)
    assert [k for k, _ in frames] == bitstream.h264_output_order(units)
    assert sorted(k for k, _ in frames) == list(range(len(units)))
    triggers = [t for _, t in frames]
    assert triggers[0] == 1 and triggers[-1] is None
    assert all(t is not None for t in triggers[:-1])


def test_decoder_that_does_not_build_raises(monkeypatch):
    """A failed build of the decoder raises with the compiler's output:
    nothing falls back to another decoder."""
    from auformer_torch.data import native
    monkeypatch.setattr(native, "_cxx", lambda: "/nonexistent/c++")
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR / "absent")
    h264._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="H.264 decoder"):
            list(h264.decode_range(str(D / "ip_cavlc_120x90.mp4")))
    finally:
        h264._library.cache_clear()


def test_frames_on_cuda_tensors_need_the_card():
    """The planes of a CUDA device go through the kernel: without a GPU the
    device is refused, not replaced by the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Video(str(D / "bt709_176x144.mp4"), write=False).read_RGB(0)


# ---- refusals on headers written here --------------------------------------

def _scaling_lists(w, n: int, lists: dict) -> None:
    """n scaling_list_present_flags, each present list delta-coded: lists
    maps an index to its values in zig-zag order, or to None for
    useDefaultScalingMatrixFlag."""
    for i in range(n):
        w.u(1, int(i in lists))
        if i in lists:
            last = 8
            for v in lists[i] or [0]:
                w.se((v - last + 128) % 256 - 128)
                last = v


def _sps(profile=100, chroma=1, depth=0, bypass=0, scaling=None, poc_type=0,
         frame_mbs_only=1, mbaff=0, separate=0) -> bytes:
    """An SPS of a 32x32 picture, or of a 32x64 one coded for fields
    (frame_mbs_only 0; log2_max_frame_num 8, POC lsb 8 bits); scaling: the
    lists of ``_scaling_lists`` (8, or 12 for 4:4:4), None for none;
    separate: separate_colour_plane_flag of a 4:4:4 one."""
    w = fixtures._Bits()
    w.u(8, profile)
    w.u(16, 40)                       # constraint flags, level_idc
    w.ue(0)
    if profile in (100, 110, 122, 244):
        w.ue(chroma)
        if chroma == 3:
            w.u(1, separate)
        w.ue(depth)
        w.ue(depth)
        w.u(1, bypass)
        w.u(1, int(scaling is not None))
        if scaling is not None:
            _scaling_lists(w, 12 if chroma == 3 else 8, scaling)
    w.ue(4)                           # log2_max_frame_num_minus4
    w.ue(poc_type)
    if poc_type == 0:
        w.ue(4)
    elif poc_type == 1:
        w.u(1, 0)
        w.se(0)
        w.se(0)
        w.ue(0)
    w.ue(1)                           # max_num_ref_frames
    w.u(1, 0)
    w.ue(1)
    w.ue(1)                           # 2x2 macroblocks
    w.u(1, frame_mbs_only)
    if not frame_mbs_only:
        w.u(1, mbaff)                 # mb_adaptive_frame_field_flag
    w.u(1, 1)                         # direct_8x8_inference
    w.u(2, 0)                         # no cropping, no VUI
    return fixtures._nal(3, 7, w.trailing())


def _pps(cabac=0, slice_groups=1, redundant=0, scaling=None, t8=0,
         constrained=0) -> bytes:
    """A PPS; scaling as ``_sps``'s (6 + 2 * t8 lists)."""
    w = fixtures._Bits()
    w.ue(0)
    w.ue(0)
    w.u(1, cabac)
    w.u(1, 0)
    w.ue(slice_groups - 1)
    if slice_groups > 1:
        w.ue(0)                       # slice_group_map_type: interleaved
        for _ in range(slice_groups):
            w.ue(1)
    w.ue(0)
    w.ue(0)
    w.u(3, 0)                         # weighted prediction
    w.se(0)
    w.se(0)
    w.se(0)
    w.u(1, 1)                         # deblocking_filter_control_present
    w.u(1, constrained)               # constrained_intra_pred_flag
    w.u(1, redundant)
    if scaling is not None:
        w.u(1, t8)                    # transform_8x8_mode_flag
        w.u(1, 1)                     # pic_scaling_matrix_present_flag
        _scaling_lists(w, 6 + 2 * t8, scaling)
        w.se(0)
    return fixtures._nal(3, 8, w.trailing())


def _idr(slice_type=7, redundant_pic_cnt=None, field_pic=None, pcm=384
         ) -> bytes:
    """An IDR slice of the 2x2-macroblock picture: I_PCM grey, ``pcm``
    samples a macroblock (384 for 4:2:0, 256 monochrome, 512 4:2:2, 768
    4:4:4); field_pic writes field_pic_flag (a stream coded for fields),
    and for a field bottom_field_flag 0."""
    w = fixtures._Bits()
    w.ue(0)
    w.ue(slice_type)
    w.ue(0)
    w.u(8, 0)                         # frame_num
    if field_pic is not None:
        w.u(1, field_pic)
        if field_pic:
            w.u(1, 0)
    w.ue(0)                           # idr_pic_id
    w.u(8, 0)                         # pic_order_cnt_lsb
    if redundant_pic_cnt is not None:
        w.ue(redundant_pic_cnt)
    w.u(2, 0)                         # dec_ref_pic_marking
    w.se(0)
    w.ue(1)                           # no deblocking
    for _ in range(4):
        w.ue(25)                      # I_PCM
        w.align()
        w.raw(bytes([128]) * pcm)
    return fixtures._nal(3, 5, w.trailing())


def _decode(*nals: bytes) -> int:
    return len(_frames(*nals))


def _frames(*nals: bytes) -> list[list[bytes]]:
    """The Y, U and V planes of each frame the decoder gives the units."""
    dec = h264.Decoder()
    try:
        n = dec.send(b"".join(b"\x00\x00\x00\x01" + x for x in nals), 0)
        n += dec.flush()
        out = []
        for _ in range(n):
            h, w, _ = dec.size()
            planes = [torch.empty(s, dtype=torch.uint8)
                      for s in ((h, w), ((h + 1) // 2, (w + 1) // 2),
                                ((h + 1) // 2, (w + 1) // 2))]
            dec.receive(*planes)
            out.append([p.numpy().tobytes() for p in planes])
        return out
    finally:
        dec.close()


LIST4 = [6 + 2 * k for k in range(16)]          # neither flat nor a default
# tools the decoder refused once, whose header-written streams now decode
DECODED_HEADERS = ("chroma_format_idc 0", "chroma_format_idc 2",
                   "qpprime_y_zero_transform_bypass")
LIST8 = [8 + k // 4 for k in range(64)]


@pytest.mark.parametrize("what,nals", [
    ("scaling matrices",
     lambda: (_sps(scaling={0: LIST4, 3: None, 6: LIST8}), _pps(), _idr())),
    ("scaling matrices",
     lambda: (_sps(), _pps(scaling={1: LIST4, 3: None, 7: LIST8}, t8=1),
              _idr())),
    ("field pictures", lambda: (_sps(frame_mbs_only=0), _pps(), _idr())),
    ("field_pic_flag 1",
     lambda: (_sps(frame_mbs_only=0), _pps(), _idr(field_pic=1))),
    ("constrained intra prediction in MBAFF",
     lambda: (_sps(frame_mbs_only=0, mbaff=1), _pps(constrained=1),
              _idr(field_pic=0))),
    ("slice groups", lambda: (_sps(), _pps(slice_groups=2), _idr())),
    ("SP and SI", lambda: (_sps(), _pps(), _idr(slice_type=8))),
    ("SP and SI", lambda: (_sps(), _pps(), _idr(slice_type=9))),
    ("chroma_format_idc 0", lambda: (_sps(chroma=0), _pps(), _idr(pcm=256))),
    ("chroma_format_idc 2", lambda: (_sps(chroma=2), _pps(), _idr(pcm=512))),
    ("bit depth of 11", lambda: (_sps(depth=3), _pps(), _idr())),
    ("qpprime_y_zero_transform_bypass",
     lambda: (_sps(bypass=1), _pps(), _idr())),
    ("separate_colour_plane_flag 1",
     lambda: (_sps(profile=244, chroma=3, separate=1), _pps(), _idr(pcm=768))),
    ("chroma_format_idc 2 in a stream coded for fields",
     lambda: (_sps(chroma=2, frame_mbs_only=0), _pps(),
              _idr(field_pic=0, pcm=512))),
    ("redundant pictures",
     lambda: (_sps(), _pps(redundant=1), _idr(redundant_pic_cnt=1))),
    ("order count type 1", lambda: (_sps(poc_type=1), _pps(), _idr())),
    ("data partitioning", lambda: (_sps(), _pps(), b"\x02\x80")),
], ids=lambda x: x if isinstance(x, str) else "")
def test_refused_headers_raise_naming_a9(what, nals, tmp_path):
    """Each tool the decoder does not decode raises NotImplementedError
    naming A9 and the tool, on a stream whose headers ask for it; the same
    stream without it decodes. Scaling lists in the SPS or the PPS, which
    the decoder now decodes, give the list-free stream's frame (I_PCM
    samples are not scaled); so do monochrome, 4:2:2 and the bypass flag,
    now decoded too: their grey frame is cv2's (an AVI of the one IDR)."""
    if what == "scaling matrices":
        assert _frames(*nals()) == _frames(_sps(), _pps(), _idr())
    elif what in DECODED_HEADERS:
        path = str(tmp_path / "one.avi")
        unit = b"".join(b"\x00\x00\x00\x01" + x for x in nals())
        with open(path, "wb") as f:
            f.write(fixtures._avi([unit], [True], b"H264", 1, 30, 32, 32))
        ours = list(Video(path, write=False).frames(device="cpu"))
        theirs = list(JaxVideo(path, write=False).frames())
        assert len(ours) == len(theirs) == 1
        assert np.array_equal(ours[0], theirs[0])
    else:
        with pytest.raises(NotImplementedError, match=f"(?s){what}.*A9"):
            _decode(*nals())
    assert _decode(_sps(), _pps(), _idr()) == 1
    assert _decode(_sps(), _pps(redundant=1), _idr(redundant_pic_cnt=0)) == 1


def test_frame_num_gap_raises_naming_a9():
    """A reference picture missing from the stream (a gap in frame_num)
    raises rather than being concealed."""
    path = str(D / "ip_cavlc_120x90.mp4")
    units = [u for _, u in container.access_units(path)]
    dec = h264.Decoder()
    try:
        dec.send(units[0], 0)
        with pytest.raises(NotImplementedError, match="gap in frame_num.*A9"):
            dec.send(units[2], 2)
    finally:
        dec.close()


def test_decode_not_from_an_idr_raises_naming_a9():
    """A decode that begins at a picture other than an IDR one (an open
    GOP's sync sample) raises rather than guessing its references."""
    path = str(D / "ip_cavlc_120x90.mp4")
    units = [u for _, u in container.access_units(path)]
    head = units[0][:units[0].index(b"\x00\x00\x01\x65") - 1]  # SPS, PPS
    dec = h264.Decoder()
    try:
        with pytest.raises(NotImplementedError, match="IDR picture.*A9"):
            dec.send(head + units[1], 1)
    finally:
        dec.close()


def test_malformed_stream_raises():
    """A slice cut short raises ValueError: no macroblock is guessed."""
    path = str(D / "ip_cavlc_120x90.mp4")
    unit = next(container.access_units(path))[1]
    dec = h264.Decoder()
    try:
        with pytest.raises(ValueError, match="H.264 decode"):
            dec.send(unit[:len(unit) // 2], 0)
    finally:
        dec.close()


# ---- MPEG-4 part 2's colour description (ROADMAP.md C13) -------------------

@pytest.mark.parametrize("signal", [(1, 0), (7, 0), (1, 1), (2, 1)],
                         ids=["bt709", "smpte240m", "bt709_full", "full"])
@pytest.mark.parametrize("ext", ["mp4", "avi"])
def test_mpeg4_colour_description_matches_cv2(signal, ext, tmp_path):
    """ffmpeg's mpeg4 decoder gives the frames the visual object header's
    matrix_coefficients and video_range, and cv2 converts by them: the
    port's frames equal cv2's on streams that carry them."""
    path = str(tmp_path / f"c.{ext}")
    write_mpeg4(path, 112, 96, 6, b_frames=1 if ext == "mp4" else 0,
                seed=3, colour=signal)
    ours = list(Video(path, write=False).frames(device="cpu"))
    theirs = list(JaxVideo(path, write=False).frames())
    assert len(ours) == len(theirs) == 6
    assert all(np.array_equal(a, b) for a, b in zip(ours, theirs))


def test_yuv_rgb_rejects_nothing_on_cpu_for_every_matrix():
    """yuv_rgb on CPU planes is the plain version, for every matrix and
    range."""
    rs = np.random.RandomState(0)
    y = torch.from_numpy(rs.randint(0, 256, (6, 10), dtype=np.uint8))
    u = torch.from_numpy(rs.randint(0, 256, (3, 5), dtype=np.uint8))
    v = torch.from_numpy(rs.randint(0, 256, (3, 5), dtype=np.uint8))
    for m in (1, 2, 4, 7, 9):
        for limited in (True, False):
            assert torch.equal(yuv_rgb(y, u, v, limited, m),
                               yuv_rgb_plain(y, u, v, limited, m))
