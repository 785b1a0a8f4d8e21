"""auformer_torch's H.264 chroma formats other than 4:2:0 and its lossless
coding (data/native/h264_decode.cpp, ops/colour.py) on the CPU: 4:4:4,
4:2:2 and monochrome (chroma_format_idc 3, 2, 0) and transform bypass
(qpprime_y_zero_transform_bypass_flag with QP 0).

The decoder's tables of those formats are held to libavcodec 59.37.100's
bytes (CABAC's ctxIdx 460-1023, skipped with another build) and to the
standard's code words (Table 9-4's column for ChromaArrayType 0 and 3,
Table 9-5's nC == -2 column, Table 9-9 (b)); I_PCM streams of the port's
own writer in each format, which cv2 reads, pin down swscale's two routes
(the 4:4:4 one converts through its full-chroma path, 30-bit fixed point:
``colour.full_chroma``) by sweeping (Y, U, V); a bypass stream of I_PCM
macroblocks beside skipped ones shows libavcodec's loop filter reaching
into lossless macroblocks. The x264 streams of these formats
(tests/data/videos_h264/) are held to cv2 and to libavcodec's planes with
every other stream in test_torch_video_h264.py.
"""
import numpy as np
import pytest
import torch

from auformer.data.video import Video as JaxVideo
from auformer_torch.data import fixtures, h264
from auformer_torch.data.video import Video
from auformer_torch.ops import colour
from test_torch_video_h264 import _frames, _idr, _pps, _sps
from test_torch_video_h264_cabac import AT, _libavcodec, _raster


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread: several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the tables -------------------------------------------------------------

@pytest.mark.parametrize("table", [0, 1, 2, 3],
                         ids=["idc0", "idc1", "idc2", "islice"])
def test_cabac_contexts_460_to_1023_are_libavcodecs(table):
    """The (m, n) of ctxIdx 460-1023 (the Cb and Cr contexts of 4:4:4,
    which the decoder builds from the luma ranges the standard repeats)
    equal libavcodec's cabac_context_init_PB / _I beyond ctxIdx 459."""
    lib = _libavcodec()
    key, off = ("init_i", 0) if table == 3 else ("init_pb", 2048 * table)
    theirs = np.frombuffer(lib, np.int8, 2048, AT[key] + off).reshape(1024, 2)
    ours = h264.cabac_tables()["init_444"][table]
    np.testing.assert_array_equal(ours, theirs[460:])


def test_cbp_of_monochrome_and_444_is_table_9_4():
    """coded_block_pattern's me(v) mapping for ChromaArrayType 0 and 3
    (Table 9-4's right-hand column): codeNum 0-15 to Intra_4x4 / Intra_8x8
    and to Inter, no chroma bits."""
    intra = [15, 0, 7, 11, 13, 14, 3, 5, 10, 12, 1, 2, 4, 8, 6, 9]
    inter = [0, 1, 2, 4, 8, 3, 5, 10, 12, 15, 7, 11, 13, 14, 6, 9]
    np.testing.assert_array_equal(h264.cavlc_tables()["cbp_gray"],
                                  [intra, inter])


# Table 9-5, nC == -2 (4:2:2's chroma DC): the code of (TrailingOnes,
# TotalCoeff) as the standard prints it
COEFF_TOKEN_422 = {
    (0, 0): "1", (0, 1): "0001111", (1, 1): "01", (0, 2): "0001110",
    (1, 2): "0001101", (2, 2): "001", (0, 3): "000000111",
    (1, 3): "0001100", (2, 3): "0001011", (3, 3): "00001",
    (0, 4): "000000110", (1, 4): "000000101", (2, 4): "0001010",
    (3, 4): "000001", (0, 5): "0000000111", (1, 5): "0000000110",
    (2, 5): "000000100", (3, 5): "0001001", (0, 6): "00000000111",
    (1, 6): "00000000110", (2, 6): "0000000101", (3, 6): "0001000",
    (0, 7): "000000000111", (1, 7): "000000000110", (2, 7): "00000000101",
    (3, 7): "0000000100", (0, 8): "0000000000111", (1, 8): "000000000101",
    (2, 8): "000000000100", (3, 8): "00000000100"}
# Table 9-9 (b): total_zeros of the 2x4 chroma DC by TotalCoeff 1-7
TOTAL_ZEROS_422 = [
    ["1", "010", "011", "0010", "0011", "0001", "00001", "00000"],
    ["000", "01", "001", "100", "101", "110", "111"],
    ["000", "001", "01", "10", "110", "111"],
    ["110", "00", "01", "10", "111"],
    ["00", "01", "10", "11"],
    ["00", "01", "1"],
    ["0", "1"]]


def _prefix_free(codes: list[str], complete: bool) -> bool:
    """No code begins another; with ``complete`` the codes fill the code
    space (Kraft's sum 1; coeff_token leaves one word unused)."""
    kraft = sum(2.0 ** -len(c) for c in codes)
    return (kraft == 1.0 if complete else kraft < 1.0) and not any(
        a != b and b.startswith(a) for a in codes for b in codes)


def test_coeff_token_of_422_chroma_dc_is_table_9_5():
    """The decoder's nC == -2 coeff_token lengths and codes are Table 9-5's
    column, a prefix-free code."""
    lens, bits = h264.cavlc_tables()["dc422_token"]
    for total in range(9):
        for ones in range(4):
            code = COEFF_TOKEN_422.get((ones, total))
            if code is None:
                assert lens[total, ones] == 0, (ones, total)
                continue
            assert lens[total, ones] == len(code), (ones, total)
            assert bits[total, ones] == int(code, 2), (ones, total)
    assert _prefix_free(list(COEFF_TOKEN_422.values()), complete=False)


@pytest.mark.parametrize("total", range(1, 8))
def test_total_zeros_of_422_chroma_dc_is_table_9_9b(total):
    """The decoder's total_zeros of the 2x4 chroma DC for TotalCoeff
    ``total``: Table 9-9 (b)'s column, complete and prefix-free."""
    lens, bits = h264.cavlc_tables()["dc422_zeros"]
    codes = TOTAL_ZEROS_422[total - 1]
    assert len(codes) == 9 - total
    for zeros, code in enumerate(codes):
        assert lens[total - 1, zeros] == len(code)
        assert bits[total - 1, zeros] == int(code, 2)
    assert _prefix_free(codes, complete=True)


def test_444_scaling_lists_fall_back_per_component():
    """A 4:4:4 SPS reads twelve lists: the Cb and Cr 8x8 lists it does not
    give fall back to the component before (rule A), so Intra Y's list
    reaches Intra Cb and Cr, and Inter Cb takes Inter Y's default."""
    list8 = [8 + k // 4 for k in range(64)]
    inter8 = [9, 13, 13, 15, 13, 15, 17, 17, 17, 17, 19, 19, 19, 19, 19, 21,
              21, 21, 21, 21, 21, 22, 22, 22, 22, 22, 22, 22, 24, 24, 24, 24,
              24, 24, 24, 24, 25, 25, 25, 25, 25, 25, 25, 27, 27, 27, 27, 27,
              27, 28, 28, 28, 28, 28, 30, 30, 30, 30, 32, 32, 32, 33, 33, 35]
    dec = h264.Decoder()
    try:
        dec.send(b"".join(b"\x00\x00\x00\x01" + x for x in (
            _sps(profile=244, chroma=3, scaling={6: list8, 11: None}),
            _pps(), _idr(pcm=768))), 0)
        _, w8 = dec.scaling_lists()
    finally:
        dec.close()
    y8, i8 = _raster(list8, 8), _raster(inter8, 8)
    np.testing.assert_array_equal(w8, [y8, i8, y8, i8, y8, i8])


# ---- swscale's routes, pinned by I_PCM sweeps against cv2 ------------------

def _sweep_planes(chroma: int, luma) -> tuple:
    """Planes in which every (U, V) pair occurs: U by chroma column, V by
    chroma row (256 x 256 chroma samples), under the luma ``luma`` (a
    value, or None for random samples)."""
    cols = 256 * (2 if chroma == 2 else 1)
    rs = np.random.RandomState(7)
    y = (rs.randint(0, 256, (256, cols)) if luma is None
         else np.full((256, cols), luma)).astype(np.uint8)
    u = np.tile(np.arange(256, dtype=np.uint8), (256, 1))
    return y, u, np.ascontiguousarray(u.T)


SWEEP_LUMA = (0, 15, 16, 17, 64, 128, 200, 235, 236, 250, 255, None)


def _write_sweep(path, chroma, signal) -> None:
    frames = [_sweep_planes(chroma, y) for y in SWEEP_LUMA]
    h, w = frames[0][0].shape
    fixtures.write_h264(path, w, h, len(frames), gop=1,
                        source=lambda t: frames[t], chroma=chroma,
                        colour=signal)


@pytest.mark.parametrize("chroma", [3, 2], ids=["444", "422"])
@pytest.mark.parametrize("signal", [(2, 0), (1, 0), (2, 1), (1, 1)],
                         ids=["bt601", "bt709", "bt601_full", "bt709_full"])
def test_pcm_sweep_converts_as_cv2(chroma, signal, tmp_path):
    """Every (U, V) pair under a dozen luma values (and random luma), coded
    as I_PCM 4:4:4 or 4:2:2 at each range and matrix: the decoder gives the
    written planes, and yuv_rgb_plain of them, like the port's frames, is
    cv2's bit for bit. 4:4:4 takes swscale's full-chroma route, whose
    wrapped sums clip the brightest blues to 0; 4:2:2 its unscaled one."""
    path = str(tmp_path / "sweep.mp4")
    _write_sweep(path, chroma, signal)
    theirs = list(JaxVideo(path, write=False).frames())
    ours = list(Video(path, write=False).frames(device="cpu"))
    assert len(theirs) == len(ours) == len(SWEEP_LUMA)
    matrix, full = signal
    for k, (_, yuv, got) in enumerate(h264.decode_range(path)):
        assert got == signal
        for plane, want in zip(yuv, _sweep_planes(chroma, SWEEP_LUMA[k])):
            np.testing.assert_array_equal(plane.numpy(), want)
        rgb = colour.yuv_rgb_plain(*yuv, limited=not full, matrix=matrix)
        assert np.array_equal(rgb.numpy(), theirs[k]), SWEEP_LUMA[k]
        assert np.array_equal(ours[k], theirs[k])


def test_444_route_is_not_the_subsampled_one(tmp_path):
    """The 4:4:4 frames are not what swscale's nearest-chroma arithmetic
    would give on the same samples (the 4:2:2 route over each chroma
    sample's own column): the sweep above tells the routes apart."""
    path = str(tmp_path / "sweep.mp4")
    _write_sweep(path, 3, (2, 0))
    theirs = next(iter(JaxVideo(path, write=False).frames()))
    _, (y, u, v), _ = next(h264.decode_range(path))
    wide = [p.repeat_interleave(2, 1) for p in (y, u, v)]
    subsampled = colour.yuv_rgb_plain(wide[0], u, v, limited=True)
    assert not np.array_equal(subsampled[:, ::2].numpy(), theirs)
    assert np.array_equal(colour.yuv_rgb_plain(y, u, v, limited=True)
                          .numpy(), theirs)


@pytest.mark.parametrize("signal", [None, (1, 1)], ids=["limited", "full"])
def test_monochrome_pcm_is_cv2s(signal, tmp_path):
    """A monochrome stream (chroma_format_idc 0) of all 256 luma values:
    the decoder's frames are 4:2:0 planes whose chroma is 128, as
    libavcodec outputs them, and convert to cv2's frames."""
    path = str(tmp_path / "gray.mp4")
    luma = np.arange(256, dtype=np.uint8).reshape(16, 16)
    frames = [np.roll(luma, t, 1) for t in range(4)]
    fixtures.write_h264(path, 16, 16, 4, gop=2, b_frames=1,
                        source=lambda t: (frames[t], None, None), chroma=0,
                        colour=signal)
    theirs = list(JaxVideo(path, write=False).frames())
    ours = list(Video(path, write=False).frames(device="cpu"))
    assert len(ours) == len(theirs) == 4
    assert all(np.array_equal(a, b) for a, b in zip(ours, theirs))
    for k, (_, (y, u, v), _) in enumerate(h264.decode_range(path)):
        np.testing.assert_array_equal(y.numpy(), frames[k])
        assert u.shape == v.shape == (8, 8)
        assert bool((u == 128).all() and (v == 128).all())


def test_planes_take_each_formats_chroma_size(tmp_path):
    """decode_range gives 4:4:4 chroma at the luma's size and 4:2:2 chroma
    at half its width: an odd-height 4:2:2 frame (its crop in whole rows)
    keeps every row."""
    for chroma, (h, w), want in ((3, (24, 40), (24, 40)),
                                 (2, (22, 40), (22, 20))):
        path = str(tmp_path / f"c{chroma}.mp4")
        fixtures.write_h264(path, w, h, 2, gop=2, chroma=chroma, seed=1)
        for _, (y, u, v), _ in h264.decode_range(path):
            assert y.shape == (h, w) and u.shape == v.shape == want
        theirs = list(JaxVideo(path, write=False).frames())
        ours = list(Video(path, write=False).frames(device="cpu"))
        assert all(np.array_equal(a, b) for a, b in zip(ours, theirs))


# ---- transform bypass ------------------------------------------------------

def test_bypass_pcm_neighbours_are_filtered_as_libavcodec(tmp_path):
    """A lossless stream (qpprime_y_zero_transform_bypass_flag) of I_PCM
    macroblocks (QP 0, so bypass) beside skipped ones at slice QP 40, the
    deblocking filter on: libavcodec filters the edges between them on
    both sides, the lossless macroblock's samples too, where the standard
    would keep them; the port does as libavcodec does, so its frames are
    cv2's, and equal to those of the same stream without the flag."""
    frames = {}
    for bypass in (True, False):
        path = str(tmp_path / f"b{int(bypass)}.mp4")
        fixtures.write_h264(path, 64, 48, 8, gop=4, b_frames=1, band=2,
                            seed=5, bypass=bypass, qp=40)
        ours = list(Video(path, write=False).frames(device="cpu"))
        theirs = list(JaxVideo(path, write=False).frames())
        assert len(ours) == len(theirs) == 8
        assert all(np.array_equal(a, b) for a, b in zip(ours, theirs))
        frames[bypass] = ours
    assert all(np.array_equal(a, b)
               for a, b in zip(frames[True], frames[False]))
    path = str(tmp_path / "open.mp4")
    fixtures.write_h264(path, 64, 48, 8, gop=4, b_frames=1, band=2, seed=5,
                        bypass=True)
    unfiltered = list(JaxVideo(path, write=False).frames())
    assert any(not np.array_equal(a, b)
               for a, b in zip(frames[True], unfiltered))


def test_bypass_header_decodes_pcm_unchanged():
    """I_PCM samples of a 4:2:0 stream with the bypass flag and QP 0 come
    out as written: the flag changes no sample that is not a residual."""
    assert _frames(_sps(profile=244, bypass=1), _pps(), _idr()) == _frames(
        _sps(), _pps(), _idr())
