"""auformer_torch's H.264 decoding at bit depths above 8 (High 10, High
4:2:2 and High 4:4:4 at 9-14 bits: data/native/h264_decode.cpp's uint16_t
decoder, data/h264.py's int16 planes) and swscale's high-depth route to
cv2's frames (ops/colour.py: deep_rgb) on the CPU.

The x264 streams of tests/data/videos_h264/ whose names say 10 bits are
held to libavcodec's planes and to cv2's frames, seeks and timestamps with
every stream in test_torch_video_h264.py; here their planes' type and
depth and the third entry point, ``frame_tensors``. I_PCM streams of the
port's own writer (``fixtures.write_h264(..., depth=...)``), which cv2
reads, pin down swscale's route: a grid of (U, V) with both ends and the
low two bits under a dozen luma values, in 4:2:0, 4:2:2 and 4:4:4, at each
range and matrix; 9, 12 and 14 bits; 11 and 13 bits and luma and chroma
depths apart, which libavcodec refuses, raise naming A9. The route is held
to libswscale 9.5's arithmetic, not to the 8-bit converter on rounded
samples, which misses.
"""
import numpy as np
import pytest
import torch

from auformer.data.video import Video as JaxVideo
from auformer_torch.data import fixtures, h264
from auformer_torch.data.video import Video
from auformer_torch.ops import colour
from test_torch_video_h264 import D, EXPECTED, _pps, _sha, _sps
from test_torch_video_h264_cabac import _CabacWriter

# the x264 streams deeper than 8 bits that the decoder decodes (all but the
# full-width one, which test_torch_video_h264.py decodes)
DEEP = sorted(n for n in EXPECTED if "planes_sha256" in EXPECTED[n]
              and any(t in n for t in ("high10", "high422_10", "high444_10"))
              and "1280x720" not in n)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread: several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the x264 streams -------------------------------------------------------

def test_deep_fixtures_cover_the_tools():
    """The 10-bit fixtures: each chroma format, CAVLC and CABAC, weighted
    prediction, scaling lists, a negative QPY, lossless, MBAFF and the
    full-width stream; the refused stream is 4:2:2 coded for fields."""
    assert {"high10_176x144.mp4", "high10_cabac_176x144.mp4",
            "high10_cqm_cabac_176x144.mp4", "high10_qp_low_176x144.mp4",
            "high10_lossless_176x144.mp4", "high422_10_cabac_176x144.mp4",
            "high444_10_cabac_176x144.mp4",
            "mbaff_high10_cabac_176x144.mp4"} == set(DEEP)
    assert "planes_sha256" in EXPECTED["ipb_high10_1280x720.mp4"]
    assert EXPECTED["mbaff_high10_cabac_176x144.mp4"]["frames_from"] == "plain"
    assert all(EXPECTED[n]["frames_from"] == "cv2" for n in DEEP
               if "mbaff" not in n)
    assert "planes_sha256" not in EXPECTED["mbaff_yuv422_176x144.mp4"]


@pytest.mark.parametrize("name", DEEP)
def test_deep_planes_and_frame_tensors(name):
    """decode_range gives int16 planes of the stream's 10-bit samples,
    libavcodec's, with the depth beside the colour; frame_tensors gives
    expected.json's frames (cv2's; the MBAFF stream's yuv_rgb_plain of
    libavcodec's planes, C14)."""
    path = str(D / name)
    want = EXPECTED[name]
    planes = []
    for _, yuv, got in h264.decode_range(path):
        assert got == (2, 0) and got.bit_depth == 10
        assert all(p.dtype == torch.int16 for p in yuv)
        assert int(max(p.max() for p in yuv)) < 1024
        planes.append([_sha(p.numpy()) for p in yuv])
    assert planes == [[p["y"], p["u"], p["v"]] for p in want["planes_sha256"]]
    got = [_sha(f.numpy()) for f in Video(path, write=False).frame_tensors(
        device="cpu")]
    assert got == want["frames_sha256"]


# ---- swscale's high-depth route, pinned by I_PCM sweeps against cv2 ---------

# chroma values: both ends, every low two bits, a step across the range
GRID = np.unique(np.concatenate([np.arange(0, 1024, 13), np.arange(4),
                                 1023 - np.arange(4)])).astype(np.uint16)
SWEEP_LUMA = (0, 63, 64, 65, 256, 512, 800, 940, 941, 1000, 1023, None)
SHAPES = {1: (2, 2), 2: (1, 2), 3: (1, 1)}   # luma rows, cols per chroma


def _sweep_planes(chroma: int, luma) -> tuple:
    """10-bit planes whose chroma runs over GRID, U by chroma column and V
    by chroma row, under the luma ``luma`` (a value, or None for random
    samples)."""
    n = len(GRID)
    sy, sx = SHAPES[chroma]
    rs = np.random.RandomState(7)
    y = (rs.randint(0, 1024, (sy * n, sx * n)) if luma is None
         else np.full((sy * n, sx * n), luma)).astype(np.uint16)
    u = np.tile(GRID, (n, 1))
    return y, u, np.ascontiguousarray(u.T)


def _write_sweep(path, chroma, signal, depth=10) -> None:
    frames = [_sweep_planes(chroma, y) for y in SWEEP_LUMA]
    h, w = frames[0][0].shape
    fixtures.write_h264(path, w, h, len(frames), gop=1,
                        source=lambda t: frames[t], chroma=chroma,
                        colour=signal, depth=depth)


@pytest.mark.parametrize("chroma", [1, 2, 3], ids=["420", "422", "444"])
@pytest.mark.parametrize("signal", [(2, 0), (1, 0), (2, 1), (1, 1)],
                         ids=["bt601", "bt709", "bt601_full", "bt709_full"])
def test_pcm_sweep_10bit_converts_as_cv2(chroma, signal, tmp_path):
    """(U, V) on GRID under a dozen luma values (and random luma), coded
    as 10-bit I_PCM in each chroma format at each range and matrix: the
    decoder gives the written planes, and yuv_rgb_plain of them, like the
    port's frames, is cv2's bit for bit (its chroma filtered across, and
    for 4:2:0 down, by swscale's bicubic taps)."""
    path = str(tmp_path / "sweep.mp4")
    _write_sweep(path, chroma, signal)
    theirs = list(JaxVideo(path, write=False).frames())
    ours = list(Video(path, write=False).frames(device="cpu"))
    assert len(theirs) == len(ours) == len(SWEEP_LUMA)
    matrix, full = signal
    for k, (_, yuv, got) in enumerate(h264.decode_range(path)):
        assert got == signal and got.bit_depth == 10
        for plane, want in zip(yuv, _sweep_planes(chroma, SWEEP_LUMA[k])):
            np.testing.assert_array_equal(plane.numpy(), want)
        rgb = colour.yuv_rgb_plain(*yuv, limited=not full, matrix=matrix,
                                   bit_depth=10)
        assert np.array_equal(rgb.numpy(), theirs[k]), SWEEP_LUMA[k]
        assert np.array_equal(ours[k], theirs[k])


def test_high_depth_route_is_not_the_8bit_one(tmp_path):
    """cv2's 10-bit frames are not the 8-bit route's on the same samples,
    rounded or cut to 8 bits (nearest chroma, the unscaled converter's
    arithmetic), nor the 4:2:0 route without its vertical filter (the
    4:2:2 route over each chroma row twice): the sweep tells them apart,
    and the high-depth route gives cv2's."""
    path = str(tmp_path / "sweep.mp4")
    _write_sweep(path, 1, (2, 0))
    theirs = next(iter(JaxVideo(path, write=False).frames()))
    _, (y, u, v), _ = next(h264.decode_range(path))
    for to8 in (lambda p: ((p.int() + 2) >> 2).clamp(max=255),
                lambda p: p.int() >> 2):
        rgb8 = colour.yuv_rgb_plain(*(to8(p).to(torch.uint8)
                                      for p in (y, u, v)), limited=True)
        assert not np.array_equal(rgb8.numpy(), theirs)
    rows = colour.yuv_rgb_plain(y, u.repeat_interleave(2, 0),
                                v.repeat_interleave(2, 0), limited=True,
                                bit_depth=10)
    assert not np.array_equal(rows.numpy(), theirs)
    assert np.array_equal(colour.yuv_rgb_plain(y, u, v, limited=True,
                                               bit_depth=10).numpy(), theirs)


@pytest.mark.parametrize("loc", [None, 0, 1, 2, 3, 4, 5],
                         ids=["none", *(f"type{t}" for t in range(6))])
@pytest.mark.parametrize("chroma", [1, 2], ids=["420", "422"])
def test_chroma_siting_converts_as_cv2(chroma, loc, tmp_path):
    """The VUI's chroma_sample_loc_type (none: libavcodec's left siting)
    reaches the decoder's chroma_loc and the colour route's filters: the
    frames are cv2's, which hands swscale the siting (across for 4:2:0 and
    4:2:2, down for 4:2:0 alone); a stream without a VUI (unspecified,
    swscale's default centre) is test_pcm_10bit_macroblocks_match_cv2's."""
    rs = np.random.RandomState(chroma + 10 * (loc or 0))
    sy, sx = SHAPES[chroma]
    planes = tuple(rs.randint(0, 1024, s).astype(np.uint16)
                   for s in ((48, 64), (48 // sy, 32), (48 // sy, 32)))
    path = str(tmp_path / "siting.mp4")
    fixtures.write_h264(path, 64, 48, 1, gop=1, source=lambda t: planes,
                        chroma=chroma, depth=10, chroma_loc=loc)
    (_, _, got), = h264.decode_range(path)
    assert got.chroma_loc == (1 if loc is None else loc + 1)
    ours = list(Video(path, write=False).frames(device="cpu"))
    theirs = list(JaxVideo(path, write=False).frames())
    assert len(ours) == len(theirs) == 1
    assert np.array_equal(ours[0], theirs[0])


@pytest.mark.parametrize("depth", [9, 12, 14])
@pytest.mark.parametrize("chroma", [1, 3], ids=["420", "444"])
def test_pcm_depths_decode_to_cv2s(depth, chroma, tmp_path):
    """I_PCM streams at 9, 12 and 14 bits (random samples, IDR and P
    pictures): the decoder gives the written samples, and the frames are
    cv2's."""
    rs = np.random.RandomState(depth)
    sy, sx = SHAPES[chroma]
    frames = [tuple(rs.randint(0, 1 << depth, s).astype(np.uint16)
                    for s in ((48, 64), (48 // sy, 64 // sx),
                              (48 // sy, 64 // sx))) for _ in range(4)]
    path = str(tmp_path / "pcm.mp4")
    fixtures.write_h264(path, 64, 48, 4, gop=2, band=2,
                        source=lambda t: frames[t], chroma=chroma,
                        depth=depth)
    out = list(h264.decode_range(path))
    assert [c.bit_depth for _, _, c in out] == [depth] * 4
    np.testing.assert_array_equal(out[0][1][0].numpy(), frames[0][0])
    ours = list(Video(path, write=False).frames(device="cpu"))
    theirs = list(JaxVideo(path, write=False).frames())
    assert len(ours) == len(theirs) == 4
    assert all(np.array_equal(a, b) for a, b in zip(ours, theirs))


@pytest.mark.parametrize("depth,what", [
    (11, "bit depth of 11"), (13, "bit depth of 13"),
    ((10, 8), r"luma bit depth \(10\) other than the chroma's \(8\)"),
    ((8, 10), r"luma bit depth \(8\) other than the chroma's \(10\)")],
    ids=["11", "13", "luma10_chroma8", "luma8_chroma10"])
def test_unsupported_depths_raise_naming_a9(depth, what, tmp_path):
    """What libavcodec refuses (cv2 reads no frame of these streams): 11
    and 13 bits, and luma and chroma depths apart, raise
    NotImplementedError naming A9 and the depth, from decode_range and
    from the frames."""
    path = str(tmp_path / "bad.mp4")
    fixtures.write_h264(path, 32, 32, 2, gop=2, depth=depth)
    assert list(JaxVideo(path, write=False).frames()) == []
    with pytest.raises(NotImplementedError, match=f"(?s){what}.*A9"):
        list(h264.decode_range(path))
    with pytest.raises(NotImplementedError, match="A9"):
        next(Video(path, write=False).frames(device="cpu"))


def test_monochrome_10bit_is_grey_512(tmp_path):
    """A 10-bit monochrome stream: 4:2:0 planes whose chroma is 512 (1 <<
    (BitDepth - 1)), as libavcodec puts them out, converted to cv2's
    frames."""
    path = str(tmp_path / "gray.mp4")
    luma = (np.arange(1024, dtype=np.uint16).reshape(32, 32))
    frames = [np.roll(luma, 3 * t, 1) for t in range(4)]
    fixtures.write_h264(path, 32, 32, 4, gop=1,
                        source=lambda t: (frames[t], None, None), chroma=0,
                        depth=10)
    for k, (_, (y, u, v), c) in enumerate(h264.decode_range(path)):
        assert c.bit_depth == 10
        np.testing.assert_array_equal(y.numpy(), frames[k])
        assert bool((u == 512).all() and (v == 512).all())
    ours = list(Video(path, write=False).frames(device="cpu"))
    theirs = list(JaxVideo(path, write=False).frames())
    assert len(ours) == len(theirs) == 4
    assert all(np.array_equal(a, b) for a, b in zip(ours, theirs))


@pytest.mark.parametrize("qp", [-12, 0, 50], ids=["qp-12", "qp0", "qp50"])
def test_pcm_beside_skipped_deblocks_as_libavcodec(qp, tmp_path):
    """10-bit P pictures of skipped macroblocks beside moving I_PCM
    columns, the deblocking filter on at slice QP ``qp`` (QPY -12 to 51):
    the edges are filtered with the thresholds scaled to 10 bits and
    libavcodec's QP of an I_PCM macroblock (QP'Y 0, QPY -12), so the
    frames are cv2's."""
    path = str(tmp_path / "deblock.mp4")
    fixtures.write_h264(path, 64, 48, 8, gop=4, b_frames=1, band=2, seed=3,
                        qp=qp, depth=10)
    ours = list(Video(path, write=False).frames(device="cpu"))
    theirs = list(JaxVideo(path, write=False).frames())
    assert len(ours) == len(theirs) == 8
    assert all(np.array_equal(a, b) for a, b in zip(ours, theirs))


def _pcm_idr10(samples: np.ndarray, cabac: bool) -> bytes:
    """An IDR slice of the 2x2-macroblock picture: four 10-bit I_PCM
    macroblocks of samples[k] (256 Y, 64 Cb, 64 Cr each), CAVLC- or
    CABAC-coded (test_torch_video_h264_cabac.py's 8-bit one, with samples
    of 10 bits)."""
    w = fixtures._Bits()
    for v in (0, 7, 0):
        w.ue(v)                       # first_mb, slice_type, pps_id
    w.u(8, 0)                         # frame_num
    w.ue(0)                           # idr_pic_id
    w.u(8, 0)                         # pic_order_cnt_lsb
    w.u(2, 0)                         # dec_ref_pic_marking
    w.se(0)                           # slice_qp_delta: QP 26
    w.ue(1)                           # no deblocking
    enc = None
    if cabac:
        while w.n % 8:
            w.u(1, 1)                 # cabac_alignment_one_bit
        enc = _CabacWriter(w, 26)
    for k in range(4):
        if cabac:
            enc.decision(3 + (k in (1, 3)) + (k in (2, 3)), 1)
            enc.terminate(1)          # I_PCM
        else:
            w.ue(25)
        w.align()
        w.raw(fixtures._pcm_bytes(samples[k], 10))
        if cabac:
            enc.start()
            enc.terminate(int(k == 3))    # end_of_slice_flag
    if not cabac:
        return fixtures._nal(3, 5, w.trailing())
    w.align()                         # the flush wrote rbsp_stop_one_bit
    w.raw(b"")
    return fixtures._nal(3, 5, b"".join(w.chunks))


@pytest.mark.parametrize("cabac", [False, True], ids=["cavlc", "cabac"])
def test_pcm_10bit_macroblocks_match_cv2(cabac, tmp_path):
    """10-bit I_PCM macroblocks (CABAC's: the samples from the engine's
    byte position, 10 bits each, the engine started again after them) give
    the samples written, and the frame is cv2's."""
    samples = np.random.RandomState(19).randint(0, 1024, (4, 384)).astype(
        np.uint16)
    y = np.zeros((32, 32), np.uint16)
    u, v = np.zeros((16, 16), np.uint16), np.zeros((16, 16), np.uint16)
    for k in range(4):
        r, c = 16 * (k // 2), 16 * (k % 2)
        y[r:r + 16, c:c + 16] = samples[k][:256].reshape(16, 16)
        u[r // 2:r // 2 + 8, c // 2:c // 2 + 8] = samples[k][256:320].reshape(
            8, 8)
        v[r // 2:r // 2 + 8, c // 2:c // 2 + 8] = samples[k][320:].reshape(
            8, 8)
    nals = (_sps(depth=2), _pps(cabac=int(cabac)), _pcm_idr10(samples,
                                                              cabac))
    unit = b"".join(b"\x00\x00\x00\x01" + x for x in nals)
    dec = h264.Decoder()
    try:
        assert dec.send(unit, 0) + dec.flush() == 1
        assert dec.depth() == 10
        planes = [torch.empty(p.shape, dtype=torch.int16) for p in (y, u, v)]
        dec.receive(*planes)
        assert dec.counts()["pcm_macroblocks"] == 4
        assert dec.counts()["cabac_slices"] == int(cabac)
    finally:
        dec.close()
    for got, want in zip(planes, (y, u, v)):
        np.testing.assert_array_equal(got.numpy(), want)
    path = tmp_path / "pcm.h264"
    path.write_bytes(unit)
    theirs = JaxVideo(str(path), write=False).read_RGB(0)
    # no VUI: chroma siting unspecified, swscale's centre (no move across)
    assert np.array_equal(colour.yuv_rgb_plain(
        *planes, limited=True, bit_depth=10, chroma_loc=0).numpy(), theirs)
    assert not np.array_equal(colour.yuv_rgb_plain(
        *planes, limited=True, bit_depth=10).numpy(), theirs)


# ---- the colour route's limits and filters ---------------------------------

def test_sws_filters_are_normalised_and_shift_the_chroma():
    """The bicubic taps sum to 1 << 14 across and 1 << 12 down; across,
    the interior taps move the chroma a quarter sample (they are not the
    identity), down, 4:2:0's even and odd rows mirror each other; 4:2:2
    keeps one tap."""
    (th, ph), (tv, pv) = colour.deep_filters(144, 176, 1)
    assert all(sum(t) == 1 << 14 for t in th)
    assert all(sum(t) == 1 << 12 for t in tv)
    assert th[40] == (-1382, 14284, 3943, -461) and ph[40] == 39
    assert tv[40] == tuple(reversed(tv[41])) and pv[41] == pv[40] + 1
    (_, _), (tv2, pv2) = colour.deep_filters(144, 176, 0)
    assert all(t == (4096,) for t in tv2) and pv2 == tuple(range(144))


@pytest.mark.parametrize("shape", [(16, 15), (7, 16), (8, 16)],
                         ids=["odd_width", "rows7", "rows8"])
def test_routes_not_followed_raise_naming_a9(shape):
    """An odd width (swscale interpolates its chroma in full) and 4:2:0
    frames of 7 or 8 rows (its 2-tap vertical route) raise
    NotImplementedError naming A9 at 10 bits."""
    h, w = shape
    y = torch.zeros((h, w), dtype=torch.int16)
    c = torch.zeros(((h + 1) // 2, (w + 1) // 2), dtype=torch.int16)
    with pytest.raises(NotImplementedError, match="A9"):
        colour.yuv_rgb(y, c, c, limited=True, bit_depth=10)


def test_planes_must_fit_their_depth():
    """uint8 planes at 10 bits, int16 ones at 8 and depths outside 8-14
    raise."""
    y8 = torch.zeros((16, 16), dtype=torch.uint8)
    c8 = torch.zeros((8, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="int16"):
        colour.yuv_rgb(y8, c8, c8, bit_depth=10)
    with pytest.raises(ValueError, match="uint8"):
        colour.yuv_rgb(y8.short(), c8.short(), c8.short())
    with pytest.raises(ValueError, match="bit depth"):
        colour.yuv_rgb(y8.short(), c8.short(), c8.short(), bit_depth=16)
