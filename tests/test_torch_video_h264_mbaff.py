"""auformer_torch's interlaced H.264 (data/native/h264_decode.cpp): what only
streams coded for fields (frame_mbs_only_flag 0) and MBAFF frames have, on
the CPU.

x264's ``--interlaced`` streams of tests/data/videos_h264/ (MBAFF, CAVLC
and CABAC, top and bottom field first, B-pyramids, temporal direct with
implicit weights and several slices, one at 1920x1080) code both field and
frame macroblock pairs. Their planes, frames (swscale's: cv2 flags these
frames interlaced and its swscale refuses them, ROADMAP.md C14), seeks,
counts and timestamps are held with every other stream's in
test_torch_video_h264.py.

Also here: CABAC's field tables against libavcodec's bytes, the frame
height and cropping of a stream coded for fields and the DPB size it
implies on headers written here, field pictures refused naming A9, and
C14 itself.
"""
import hashlib
import json
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from auformer.data.video import Video as JaxVideo
from auformer_torch.data import bitstream, container, fixtures, h264
from auformer_torch.data.video import Video

from test_torch_video_h264 import INTERLACED
from test_torch_video_h264_cabac import AT, _libavcodec

D = Path(__file__).parent / "data" / "videos_h264"
EXPECTED = json.loads((D / "expected.json").read_text())


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread: several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sha(img) -> str | None:
    return None if img is None else hashlib.sha256(
        np.ascontiguousarray(img).tobytes()).hexdigest()


def test_interlaced_fixtures_are_mbaff():
    """Every stream cv2 does not convert is an x264 --interlaced one, and
    the fixtures cover CAVLC and CABAC, both field orders, temporal direct,
    several slices and the full-width stream."""
    assert INTERLACED == sorted([
        "interlaced_176x144.mp4", "mbaff_cabac_176x144.mp4",
        "mbaff_bff_cabac_176x144.mp4", "mbaff_temporal_cabac_176x144.mp4",
        "ipb_mbaff_1920x1080.mp4"])
    opts = " ".join(EXPECTED[n]["x264"] for n in INTERLACED)
    for tool in ("cabac=0", "bff=1", "direct=temporal", "weightb=1",
                 "slices=3", "b-pyramid=normal"):
        assert tool in opts
    assert EXPECTED["fakeint_cabac_176x144.mp4"]["frames_from"] == "cv2"


def _counts(path: str, mixed: bool) -> dict:
    """The decoder's counts after the access units of ``path``: each unit
    in turn until the stream has shown both a field and a frame pair where
    ``mixed``, else every unit."""
    dec = h264.Decoder()

    def take(n):
        for _ in range(n):
            h, w, _ = dec.size()
            dec.receive(*[torch.empty(s, dtype=torch.uint8) for s in (
                (h, w), ((h + 1) // 2, (w + 1) // 2),
                ((h + 1) // 2, (w + 1) // 2))])
    try:
        for k, unit in container.access_units(path, kept_only=False):
            take(dec.send(unit, k))
            counts = dec.counts()
            if mixed and counts["field_pairs"] and counts["frame_pairs"]:
                return counts
        take(dec.flush())
        return dec.counts()
    finally:
        dec.close()


@pytest.mark.parametrize("name", INTERLACED
                         + ["fakeint_cabac_176x144.mp4"])
def test_pairs_are_mixed(name):
    """An MBAFF stream codes both field and frame macroblock pairs (the
    1920x1080 one within its first pictures), the fake-interlaced one
    none; the slices are CABAC's or CAVLC's as x264 was told."""
    fake = name.startswith("fakeint")
    counts = _counts(str(D / name), mixed=not fake)
    if fake:
        assert counts["field_pairs"] == counts["frame_pairs"] == 0
    else:
        assert counts["field_pairs"] > 0 and counts["frame_pairs"] > 0
    assert counts["cabac_slices"] == (0 if "cabac=0" in
                                      EXPECTED[name]["x264"]
                                      else counts["slices"])


# ---- CABAC's field tables ----------------------------------------------------

def test_cabac_field_tables_are_libavcodecs():
    """The 8x8 block's field ctxIdxInc of significant_coeff_flag (Table
    9-43) lies next to the frame column at AT["sig8x8"]; a field
    macroblock's last_significant_coeff_flag takes the frame column at
    AT["last8x8"]; the contexts of field coding (70-72, 277-398, 436-459)
    stand in kCabacInit with the rest."""
    lib = _libavcodec()
    ours = h264.cabac_tables()
    np.testing.assert_array_equal(
        ours["ctx8x8_field"], np.frombuffer(lib, np.uint8, 63,
                                            AT["sig8x8"] + 63))
    np.testing.assert_array_equal(
        ours["ctx8x8"][1], np.frombuffer(lib, np.uint8, 63, AT["last8x8"]))
    assert not np.array_equal(ours["ctx8x8_field"], ours["ctx8x8"][0])
    for k in range(3):
        table = np.frombuffer(lib, np.int8, 920, AT["init_pb"] + 2048 * k)
        for lo, hi in ((70, 73), (277, 399), (436, 460)):
            np.testing.assert_array_equal(
                ours["init"][k][lo:hi], table.reshape(460, 2)[lo:hi])


# ---- headers written here ----------------------------------------------------

def _sps(w_mbs: int, map_h: int, frame_mbs_only: int, level: int = 40,
         crop_bottom: int = 0, mbaff: int = 0) -> bytes:
    """A Baseline-style SPS (POC type 2, one reference, no VUI) of w_mbs x
    map_h map units, cropped by crop_bottom CropUnitY rows."""
    w = fixtures._Bits()
    w.u(8, 77)
    w.u(16, level)                    # constraint flags, level_idc
    w.ue(0)
    w.ue(4)                           # log2_max_frame_num_minus4
    w.ue(2)                           # pic_order_cnt_type
    w.ue(1)                           # max_num_ref_frames
    w.u(1, 0)
    w.ue(w_mbs - 1)
    w.ue(map_h - 1)
    w.u(1, frame_mbs_only)
    if not frame_mbs_only:
        w.u(1, mbaff)
    w.u(1, 1)                         # direct_8x8_inference
    w.u(1, int(crop_bottom > 0))
    if crop_bottom:
        for v in (0, 0, 0, crop_bottom):
            w.ue(v)
    w.u(1, 0)                         # no VUI
    return fixtures._nal(3, 7, w.trailing())


def _pps() -> bytes:
    w = fixtures._Bits()
    w.ue(0)
    w.ue(0)
    w.u(2, 0)                         # CAVLC, no bottom field POC
    w.ue(0)
    w.ue(0)
    w.ue(0)
    w.u(3, 0)
    w.se(0)
    w.se(0)
    w.se(0)
    w.u(3, 0b100)                     # deblocking control present
    return fixtures._nal(3, 8, w.trailing())


def _slice(frame_num: int, mbs: int, field_pic: int | None,
           bottom: int = 0) -> bytes:
    """An IDR slice of I_PCM mid-grey macroblocks (frame_num 0), or a P
    slice that skips every macroblock; field_pic writes field_pic_flag."""
    w = fixtures._Bits()
    w.ue(0)
    w.ue(7 if frame_num == 0 else 5)
    w.ue(0)
    w.u(8, frame_num)
    if field_pic is not None:
        w.u(1, field_pic)
        if field_pic:
            w.u(1, bottom)
    if frame_num == 0:
        w.ue(0)                       # idr_pic_id
        w.u(2, 0)                     # no_output_of_prior_pics, long_term
    else:
        w.u(1, 0)                     # num_ref_idx_active_override_flag
        w.u(1, 0)                     # ref_pic_list_modification_flag_l0
        w.u(1, 0)                     # adaptive_ref_pic_marking_mode_flag
    w.se(0)
    w.ue(1)                           # no deblocking
    if frame_num == 0:
        for _ in range(mbs):
            w.ue(25)                  # I_PCM
            w.align()
            w.raw(bytes([128]) * 384)
    else:
        w.ue(mbs)                     # mb_skip_run
    return fixtures._nal(3, 5 if frame_num == 0 else 1, w.trailing())


def _ready_counts(units: list[bytes]) -> tuple[list[int], list[tuple]]:
    """The frames the decoder makes ready after each unit, and the size of
    each frame out."""
    dec = h264.Decoder()
    ready, sizes = [], []

    def take(n):
        ready.append(n)
        for _ in range(n):
            h, w, _ = dec.size()
            sizes.append((h, w))
            dec.receive(*[torch.empty(s, dtype=torch.uint8) for s in (
                (h, w), ((h + 1) // 2, (w + 1) // 2),
                ((h + 1) // 2, (w + 1) // 2))])
    try:
        for k, u in enumerate(units):
            take(dec.send(u, k))
        take(dec.flush())
        return ready, sizes
    finally:
        dec.close()


@pytest.mark.parametrize("frame_mbs_only", [1, 0])
def test_frame_height_cropping_and_dpb_of_a_stream_coded_for_fields(
        frame_mbs_only):
    """frame_mbs_only_flag 0 doubles the map units into FrameHeightInMbs
    (7.4.2.1.1) and makes CropUnitY 4: 11 x 9 map units at level 1.0
    (MaxDpbMbs 396) are 176x288 frames of 198 macroblocks, a DPB of 2
    frames, where a progressive 176x144 stream of 99 has 4. Without a
    bitstream restriction the decoder and bitstream.h264_output_frames
    hold that many frames before the first leaves, and the SPS's bottom
    crop of 2 units takes 8 rows, not 4."""
    mbs = 11 * 9 * (2 - frame_mbs_only)
    sps = _sps(11, 9, frame_mbs_only, level=10, crop_bottom=2)
    field = None if frame_mbs_only else 0
    units = [b"".join(b"\x00\x00\x00\x01" + n for n in (sps, _pps(),
                                                        _slice(0, mbs, field)))]
    units += [b"\x00\x00\x00\x01" + _slice(k, mbs, field) for k in range(1, 7)]
    depth = 4 if frame_mbs_only else 2
    assert bitstream.parse_sps(sps)["num_reorder_frames"] == depth
    ready, sizes = _ready_counts(units)
    assert ready == [0] * depth + [1] * (7 - depth) + [depth]
    height = 16 * 9 * (2 - frame_mbs_only) - 2 * (2 * (2 - frame_mbs_only))
    assert sizes == [(height, 176)] * 7
    out = bitstream.h264_output_frames(units)
    assert [k for k, _ in out] == list(range(7))
    assert [r for _, r in out] == list(range(depth, 7)) + [None] * depth


def test_full_width_sps_gets_the_level_dpb_from_frame_height():
    """AVCHD's 1920x1080 coded as MBAFF: 120 x 34 map units, 68 macroblock
    rows; at level 4.0 (MaxDpbMbs 32768) that is a DPB of 4 frames, not
    the 8 that 34 rows would give."""
    assert bitstream.parse_sps(_sps(120, 34, 0, level=40, mbaff=1))[
        "num_reorder_frames"] == 4
    assert bitstream.parse_sps(_sps(120, 34, 1, level=40))[
        "num_reorder_frames"] == 8


def _mux(path: Path, units: list[bytes], w: int, h: int) -> None:
    """An MP4 of Annex B units (SPS and PPS first) with their avcC."""
    nals = [bitstream.annexb_nals(u) for u in units]
    sps = next(n for ns in nals for n in ns if n[0] & 0x1F == 7)
    pps = next(n for ns in nals for n in ns if n[0] & 0x1F == 8)
    avcc = (bytes([1, sps[1], sps[2], sps[3], 0xFF, 0xE1])
            + struct.pack(">H", len(sps)) + sps + b"\x01"
            + struct.pack(">H", len(pps)) + pps)
    samples = [b"".join(struct.pack(">I", len(n)) + n for n in ns
                        if n[0] & 0x1F not in (7, 8)) for ns in nals]
    delta, scale = fixtures._frame_rate(30.0)
    path.write_bytes(fixtures._mp4(samples, [True] + [False] * (len(units)
                                                                 - 1),
                                   [0] * len(units), delta, scale, w, h,
                                   avcc, 0))


@pytest.mark.parametrize("call", ["read_RGB", "frames", "frame_tensors"])
def test_field_pictures_raise_naming_a9(call, tmp_path):
    """A stream of field pictures (field_pic_flag 1, PAFF) raises
    NotImplementedError naming A9 and the tool from each entry point; the
    same stream as frame pictures decodes."""
    sps = _sps(2, 1, 0)
    units = [b"".join(b"\x00\x00\x00\x01" + n
                      for n in (sps, _pps(), _slice(0, 2, 1)))]
    path = tmp_path / "fields.mp4"
    _mux(path, units, 32, 32)
    v = Video(str(path), write=False)
    assert v.count_frames() == 1
    with pytest.raises(NotImplementedError, match="field_pic_flag 1.*A9"):
        out = getattr(v, call)(device="cpu")
        if call != "read_RGB":
            next(iter(out))
    frames = tmp_path / "frames.mp4"
    _mux(frames, [b"".join(b"\x00\x00\x00\x01" + n
                           for n in (sps, _pps(), _slice(0, 4, 0)))], 32, 32)
    img = Video(str(frames), write=False).read_RGB(0, device="cpu")
    assert img.shape == (32, 32, 3)


# ---- C14: the JAX package's frames of an MBAFF stream ------------------------

def test_c14_jax_frames_of_mbaff_stream_are_not_decoded(capfd):
    """ROADMAP.md C14: cv2 (libavcodec 62's swscale) refuses to convert the
    frames libavcodec flags interlaced and hands back a buffer it never
    wrote, one buffer for every frame. The count is still right. Where a
    cv2 converts them, its frames are swscale's and the fault is gone."""
    name = "interlaced_176x144.mp4"
    want = EXPECTED[name]
    theirs = [_sha(f) for f in JaxVideo(str(D / name), write=False).frames()]
    assert len(theirs) == want["count_frames"]
    if theirs != want["frames_sha256"]:
        err = capfd.readouterr().err
        assert (len(set(theirs)) == 1
                or "Cannot convert interlaced" in err), err[-400:]
        assert not set(theirs) & set(want["frames_sha256"])
