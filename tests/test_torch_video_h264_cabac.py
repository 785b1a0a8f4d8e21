"""auformer_torch's H.264 CABAC and scaling lists
(data/native/h264_decode.cpp) on the CPU: the decoder's CABAC tables
against the bytes of the installed libavcodec 59, the CAVLC streams' planes
through the reader that both entropy modes share, the scaling lists'
fall-back rule B, the decoder's count of CABAC slices and I_PCM
macroblocks, and CABAC's I_PCM path on a stream written here (x264 writes
no I_PCM) against cv2.

The frames, seeks, counts and timestamps of the CABAC and scaling-list
streams of tests/data/videos_h264/ are held to cv2 in
test_torch_video_h264.py, with the CAVLC ones.
"""
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from auformer.data.video import Video as JaxVideo
from auformer_torch.data import container, fixtures, h264
from test_torch_video_h264 import LIST4, LIST8, _frames, _idr, _pps, _sps

D = Path(__file__).parent / "data" / "videos_h264"
EXPECTED = json.loads((D / "expected.json").read_text())
CAVLC = sorted(n for n, w in EXPECTED.items()
               if "planes_sha256" in w and "cabac=0" in w["x264"])

# libavcodec 59.37.100 as Debian and Ubuntu build it, and where its
# read-only data holds ffmpeg's tables: cabac_context_init_PB[3][1024][2]
# then cabac_context_init_I[1024][2], the 8x8 significance offsets,
# ff_h264_cabac_tables (norm_shift, then lps_range [4][64][2], then
# mlps_state, then the 8x8 last offsets) and the default scaling lists
LIBAVCODEC = ("libavcodec.so.59.37.100", 14938720)
AT = {"init_pb": 11846784, "init_i": 11852928, "sig8x8": 11846176,
      "lps": 11472160, "mlps": 11472672, "last8x8": 11472928,
      "default4": 11864832, "default8": 11864704}


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread: several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _libavcodec() -> bytes:
    for d in ("/lib/x86_64-linux-gnu", "/usr/lib/x86_64-linux-gnu"):
        p = Path(d) / LIBAVCODEC[0]
        if p.is_file() and p.stat().st_size == LIBAVCODEC[1]:
            return p.read_bytes()
    pytest.skip("no libavcodec 59.37.100 of the build whose table offsets "
                "this test knows")


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def test_cabac_tables_are_libavcodecs():
    """kCabacInit (ctxIdx 0-459 for cabac_init_idc 0-2 and I slices),
    rangeTabLPS, transIdxLPS/MPS, the 8x8 block's frame context increments
    and the default scaling lists equal libavcodec's bytes."""
    lib = _libavcodec()

    def at(key, n, off=0, dtype=np.uint8):
        return np.frombuffer(lib, dtype, n, AT[key] + off)

    ours = h264.cabac_tables()
    for k in range(3):
        np.testing.assert_array_equal(
            ours["init"][k], at("init_pb", 920, 2048 * k, np.int8)
            .reshape(460, 2), err_msg=f"cabac_init_idc {k}")
    np.testing.assert_array_equal(
        ours["init"][3], at("init_i", 920, dtype=np.int8).reshape(460, 2))
    # ffmpeg keeps each rangeTabLPS entry twice, for valMPS 0 and 1
    lps = at("lps", 512).reshape(4, 64, 2)
    np.testing.assert_array_equal(lps[..., 0], lps[..., 1])
    np.testing.assert_array_equal(ours["range_lps"], lps[..., 0].T)
    # mlps_state[128 + 2 s + mps] = 2 transIdxMPS(s) + mps and
    # mlps_state[127 - 2 s] = 2 transIdxLPS(s) for s > 0
    mlps = at("mlps", 256).astype(int)
    np.testing.assert_array_equal(ours["trans"][1], mlps[128::2] >> 1)
    np.testing.assert_array_equal(ours["trans"][0][1:],
                                  mlps[127 - 2 * np.arange(1, 64)] >> 1)
    assert ours["trans"][0][0] == 0
    np.testing.assert_array_equal(ours["ctx8x8"][0], at("sig8x8", 63))
    np.testing.assert_array_equal(ours["ctx8x8"][1], at("last8x8", 63))
    for got, (key, off, n) in zip(ours["defaults"], [
            ("default4", 0, 16), ("default4", 16, 16), ("default8", 0, 64),
            ("default8", 64, 64)]):
        np.testing.assert_array_equal(got, at(key, n, off))


@pytest.mark.parametrize("name", CAVLC)
def test_cavlc_planes_unchanged_by_the_shared_reader(name):
    """Each CAVLC stream's Y, U and V planes are still libavcodec's, now
    that CAVLC and CABAC share the macroblock layer."""
    planes = [[_sha(p.numpy()) for p in yuv]
              for _, yuv, _ in h264.decode_range(str(D / name))]
    assert planes == [[p["y"], p["u"], p["v"]]
                      for p in EXPECTED[name]["planes_sha256"]]


def _counts(name: str) -> dict:
    dec = h264.Decoder()
    try:
        for k, unit in container.access_units(str(D / name), kept_only=False):
            dec.send(unit, k)
        dec.flush()
        return dec.counts()
    finally:
        dec.close()


@pytest.mark.parametrize("name,slices,cabac,pcm,scaled", [
    ("qp_low_cabac_176x144.mp4", 12, 12, 0, 0),
    ("slices_cabac_176x144.mp4", 90, 90, 0, 0),
    ("cqm_176x144.mp4", 3, 0, 0, 3),
    ("cqm_custom_176x144.mp4", 12, 12, 0, 12),
])
def test_decoder_counts(name, slices, cabac, pcm, scaled):
    """The decoder's count of slices, CABAC slices, I_PCM macroblocks and
    slices with scaling lists: x264 at QP 1 writes no I_PCM macroblock, so
    the CABAC I_PCM path is held below on a stream written here."""
    assert _counts(name) == {"slices": slices, "cabac_slices": cabac,
                   "pcm_macroblocks": pcm, "scaled_slices": scaled,
                   "field_pairs": 0, "frame_pairs": 0}


def _raster(zigzag, n):
    """A list in zig-zag order (8.5.6, 8.5.7) laid out in raster order."""
    scan = sorted(range(n * n), key=lambda k: (
        k // n + k % n, k // n if (k // n + k % n) % 2 else k % n))
    out = np.zeros(n * n, np.uint8)
    out[scan] = zigzag
    return out


def test_scaling_lists_fall_back_by_rule_b():
    """An SPS with lists and a PPS with pic_scaling_matrix_present_flag and
    none: each first list of a kind takes the SPS's (rule B), the others
    the PPS's previous list; 8x8 lists likewise under the 8x8 transform.
    Without the PPS flag the SPS's own lists hold, where rule A filled its
    gaps from the default lists and the previous list."""
    flat = np.full(16, 16, np.uint8)
    inter = [10, 14, 14, 20, 20, 20, 24, 24, 24, 24, 27, 27, 27, 30, 30, 34]
    sps = _sps(scaling={0: LIST4, 1: [16] * 16, 4: LIST4, 6: LIST8})
    got = {}
    for key, pps in (("b", _pps(scaling={}, t8=1)), ("sps", _pps())):
        dec = h264.Decoder()
        try:
            dec.send(b"".join(b"\x00\x00\x00\x01" + x for x in (
                sps, pps, _idr())), 0)
            got[key] = dec.scaling_lists()
        finally:
            dec.close()
    l4, i4 = _raster(LIST4, 4), _raster(inter, 4)
    # the SPS: Intra Y, Cb given, Cr from Cb; Inter Y default, Cb given, Cr
    # from Cb; Intra 8x8 given, Inter 8x8 default
    np.testing.assert_array_equal(got["sps"][0],
                                  [l4, flat, flat, i4, l4, l4])
    np.testing.assert_array_equal(got["sps"][1][0], _raster(LIST8, 8))
    # the PPS by rule B: Y lists from the SPS's, chroma from the PPS's Y
    np.testing.assert_array_equal(got["b"][0], [l4, l4, l4, i4, i4, i4])
    np.testing.assert_array_equal(got["b"][1], got["sps"][1])


class _CabacWriter:
    """9.3.4's arithmetic encoder (EncodeDecision, EncodeTerminate with its
    flush), enough for I_PCM macroblocks of an I slice."""

    def __init__(self, w: fixtures._Bits, qp: int):
        t = h264.cabac_tables()
        self.w, self.lps, self.trans = w, t["range_lps"], t["trans"]
        self.ctx = {}
        for i in (3, 4, 5):
            m, n = (int(v) for v in t["init"][3][i])
            pre = min(126, max(1, ((m * qp) >> 4) + n))
            self.ctx[i] = (63 - pre, 0) if pre <= 63 else (pre - 64, 1)
        self.start()

    def start(self):
        self.low, self.range, self.first, self.outstanding = 0, 510, True, 0

    def _put(self, b):
        if self.first:
            self.first = False
        else:
            self.w.u(1, b)
        for _ in range(self.outstanding):
            self.w.u(1, 1 - b)
        self.outstanding = 0

    def _renorm(self):
        while self.range < 256:
            if self.low < 256:
                self._put(0)
            elif self.low >= 512:
                self.low -= 512
                self._put(1)
            else:
                self.low -= 256
                self.outstanding += 1
            self.range <<= 1
            self.low <<= 1

    def decision(self, i, b):
        state, mps = self.ctx[i]
        lps = int(self.lps[state][(self.range >> 6) & 3])
        self.range -= lps
        if b != mps:
            self.low += self.range
            self.range = lps
            self.ctx[i] = (int(self.trans[0][state]),
                           1 - mps if state == 0 else mps)
        else:
            self.ctx[i] = (int(self.trans[1][state]), mps)
        self._renorm()

    def terminate(self, b):
        self.range -= 2
        if not b:
            self._renorm()
            return
        self.low += self.range
        self.range = 2
        self._renorm()
        self._put((self.low >> 9) & 1)
        self.w.u(2, ((self.low >> 7) & 3) | 1)


def _pcm_idr(samples: np.ndarray, cabac: bool) -> bytes:
    """An IDR slice of the 2x2-macroblock picture: four I_PCM macroblocks
    of samples[k] (256 Y, 64 Cb, 64 Cr each), CAVLC- or CABAC-coded."""
    w = fixtures._Bits()
    w.ue(0)
    w.ue(7)
    w.ue(0)
    w.u(8, 0)                         # frame_num
    w.ue(0)                           # idr_pic_id
    w.u(8, 0)                         # pic_order_cnt_lsb
    w.u(2, 0)                         # dec_ref_pic_marking
    w.se(0)                           # slice_qp_delta: QP 26
    w.ue(1)                           # no deblocking
    if not cabac:
        for k in range(4):
            w.ue(25)
            w.align()
            w.raw(samples[k].tobytes())
        return fixtures._nal(3, 5, w.trailing())
    while w.n % 8:
        w.u(1, 1)                     # cabac_alignment_one_bit
    enc = _CabacWriter(w, 26)
    for k in range(4):
        # mb_type bin 0: ctxIdxInc counts the neighbours that are not
        # I_NxN (left of 1 and 3, above 2 and 3)
        enc.decision(3 + (k in (1, 3)) + (k in (2, 3)), 1)
        enc.terminate(1)              # I_PCM
        w.align()                     # pcm_alignment_zero_bit
        w.raw(samples[k].tobytes())
        enc.start()
        enc.terminate(int(k == 3))    # end_of_slice_flag
    w.align()                         # the flush wrote rbsp_stop_one_bit
    w.raw(b"")
    return fixtures._nal(3, 5, b"".join(w.chunks))


def test_cabac_pcm_macroblocks_match_cv2(tmp_path):
    """CABAC's I_PCM (mb_type's terminating bin, the samples from the
    engine's byte position, the engine started again) gives the samples
    written, as CAVLC's does, and cv2 gives the CABAC stream the CAVLC
    stream's frame."""
    rs = np.random.RandomState(19)
    samples = rs.randint(16, 236, (4, 384)).astype(np.uint8)
    y = np.zeros((32, 32), np.uint8)
    u, v = np.zeros((16, 16), np.uint8), np.zeros((16, 16), np.uint8)
    for k in range(4):
        r, c = k // 2, k % 2
        y[16 * r:16 * r + 16, 16 * c:16 * c + 16] = samples[k][:256].reshape(
            16, 16)
        u[8 * r:8 * r + 8, 8 * c:8 * c + 8] = samples[k][256:320].reshape(8, 8)
        v[8 * r:8 * r + 8, 8 * c:8 * c + 8] = samples[k][320:].reshape(8, 8)
    frames = []
    for cabac in (True, False):
        nals = (_sps(), _pps(cabac=int(cabac)), _pcm_idr(samples, cabac))
        assert _frames(*nals) == [[y.tobytes(), u.tobytes(), v.tobytes()]]
        dec = h264.Decoder()
        try:
            dec.send(b"".join(b"\x00\x00\x00\x01" + x for x in nals), 0)
            assert dec.counts()["pcm_macroblocks"] == 4
            assert dec.counts()["cabac_slices"] == int(cabac)
        finally:
            dec.close()
        path = tmp_path / f"pcm{int(cabac)}.h264"
        path.write_bytes(b"".join(b"\x00\x00\x00\x01" + x for x in nals))
        frames.append(JaxVideo(str(path), write=False).read_RGB(0))
    assert frames[0] is not None and np.array_equal(*frames)
