"""The headers of H.264 video streams, read without a decoder: enough to
know the order in which a decoder returns the frames of a stream whose
pictures are stored out of presentation order (B-frames).

``h264_output_order(units)`` takes the access units of an H.264 stream in
decode order (Annex B: start codes, the SPS and PPS in band, as
``data/container.py`` writes them) and gives their indices in the order a
decoder outputs their pictures: by picture order count (ITU-T H.264 8.2.1,
types 0 and 2) within each run of pictures that starts at an IDR picture,
which a decoder flushes before it (no_output_of_prior_pics_flag 0). Field
pictures and POC type 1 raise naming ROADMAP.md queue A9; a memory
management operation 5 (a POC reset without an IDR) is not looked for.
``h264_output_frames(units)`` gives the same order with the unit whose
decoding returns each frame, as ffmpeg's decoder returns them: one frame a
picture once more pictures wait than the VUI's max_num_reorder_frames
(the level's DPB size where the SPS has no bitstream restriction), the rest
at the end of the stream. MPEG-4 part 2's order comes from the port's decoder itself
(``mpeg4.output_frames``).
"""
from __future__ import annotations

import re

_A9 = "ROADMAP.md queue A9 (offline ingest from videos)"
_START = re.compile(b"\x00\x00\x01")


def _unread(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not read by the stream header "
                               f"parser; {_A9} lists it")


class BitReader:
    """MSB-first reader of an RBSP (emulation prevention removed)."""

    def __init__(self, data: bytes):
        self.value = int.from_bytes(data, "big")
        self.size = 8 * len(data)
        self.pos = 0

    def u(self, n: int) -> int:
        if self.pos + n > self.size:
            raise ValueError("a header runs past the end of its NAL unit")
        self.pos += n
        return (self.value >> (self.size - self.pos)) & ((1 << n) - 1)

    def ue(self) -> int:
        zeros = 0
        while not self.u(1):
            zeros += 1
            if zeros > 31:
                raise ValueError("an Exp-Golomb code of more than 32 bits")
        return (1 << zeros) - 1 + self.u(zeros)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k & 1 else -(k // 2)


def rbsp(nal_payload: bytes) -> bytes:
    """A NAL unit's payload without its emulation prevention bytes."""
    return nal_payload.replace(b"\x00\x00\x03", b"\x00\x00")


def annexb_nals(unit: bytes) -> list[bytes]:
    """The NAL units (header byte first) of an Annex B byte stream."""
    starts = [m.end() for m in _START.finditer(unit)]
    out = []
    for k, s in enumerate(starts):
        end = starts[k + 1] - 3 if k + 1 < len(starts) else len(unit)
        # a 4-byte start code's leading zero and trailing_zero_8bits are
        # not part of the NAL unit, which never ends in a zero byte
        nal = unit[s:end].rstrip(b"\x00")
        if nal:
            out.append(nal)
    return out


_HIGH_PROFILES = {100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134,
                  135}


def _skip_scaling_list(r: BitReader, size: int) -> None:
    last = nxt = 8
    for _ in range(size):
        if nxt:
            nxt = (last + r.se() + 256) % 256
        last = nxt or last


def parse_sps(nal: bytes) -> dict:
    """The fields of a sequence parameter set that the picture order count
    needs (ITU-T H.264 7.3.2.1.1), the cropped ``width`` and ``height`` and
    the VUI's ``timing`` (num_units_in_tick, time_scale; None without)."""
    r = BitReader(rbsp(nal[1:]))
    profile = r.u(8)
    level = r.u(16) & 0xFF                     # constraints, level_idc
    sps_id = r.ue()
    separate_planes, chroma = 0, 1
    if profile in _HIGH_PROFILES:
        chroma = r.ue()
        if chroma == 3:
            separate_planes = r.u(1)
        r.ue()
        r.ue()                                 # bit depths
        r.u(1)                                 # qpprime_y_zero_transform
        if r.u(1):                             # seq_scaling_matrix_present
            for i in range(8 if chroma != 3 else 12):
                if r.u(1):
                    _skip_scaling_list(r, 16 if i < 6 else 64)
    sps = {"id": sps_id, "profile": profile,
           "separate_planes": separate_planes,
           "log2_max_frame_num": r.ue() + 4, "poc_type": r.ue()}
    if sps["poc_type"] == 0:
        sps["log2_max_poc_lsb"] = r.ue() + 4
    elif sps["poc_type"] == 1:
        raise _unread("H.264 picture order count type 1")
    r.ue()                                     # max_num_ref_frames
    r.u(1)                                     # gaps_in_frame_num_allowed
    width, units = r.ue() + 1, r.ue() + 1      # in macroblocks, map units
    sps["frame_mbs_only"] = r.u(1)
    # FrameHeightInMbs: twice the map units of a stream coded for fields
    height = units * (2 - sps["frame_mbs_only"])
    sps["num_reorder_frames"] = _max_dpb_frames(level, width * height)
    if not sps["frame_mbs_only"]:
        r.u(1)                                 # mb_adaptive_frame_field
    r.u(1)                                     # direct_8x8_inference
    crop = (0, 0, 0, 0)
    if r.u(1):                                 # frame_cropping_flag
        crop = tuple(r.ue() for _ in range(4))
    # the cropped size (7.4.2.1.1: CropUnitX, CropUnitY)
    unit_x = 1 if chroma in (0, 3) or separate_planes else 2
    unit_y = (1 if chroma != 1 or separate_planes else 2) * (
        2 - sps["frame_mbs_only"])
    sps["width"] = 16 * width - unit_x * (crop[0] + crop[1])
    sps["height"] = 16 * height - unit_y * (crop[2] + crop[3])
    sps["timing"] = None
    if r.u(1):                                 # vui_parameters_present
        _vui(r, sps)
    return sps


# MaxDpbMbs by level_idc (ITU-T H.264 Table A-1)
_MAX_DPB_MBS = {9: 396, 10: 396, 11: 900, 12: 2376, 13: 2376, 20: 2376,
                21: 4752, 22: 8100, 30: 8100, 31: 18000, 32: 20480,
                40: 32768, 41: 32768, 42: 34816, 50: 110400, 51: 184320,
                52: 184320}


def _max_dpb_frames(level: int, mbs: int) -> int:
    """The DPB size in frames, what a stream without a bitstream
    restriction may reorder (as data/native/h264_decode.cpp takes it)."""
    return max(1, min(_MAX_DPB_MBS.get(level, 184320) // max(mbs, 1), 16))


def _vui(r: BitReader, sps: dict) -> None:
    """The VUI (ITU-T H.264 E.1.1) as far as max_num_reorder_frames."""
    if r.u(1) and r.u(8) == 255:               # aspect_ratio_idc
        r.u(32)
    if r.u(1):                                 # overscan_info_present
        r.u(1)
    if r.u(1):                                 # video_signal_type_present
        r.u(4)
        if r.u(1):
            r.u(24)                            # colour description
    if r.u(1):                                 # chroma_loc_info_present
        r.ue()
        r.ue()
    if r.u(1):                                 # timing_info_present
        sps["timing"] = (r.u(32), r.u(32))     # num_units_in_tick, scale
        r.u(1)
    hrd = [r.u(1)]

    def skip_hrd():
        count = r.ue() + 1
        r.u(8)
        for _ in range(count):
            r.ue()
            r.ue()
            r.u(1)
        r.u(20)

    if hrd[0]:
        skip_hrd()
    hrd.append(r.u(1))
    if hrd[1]:
        skip_hrd()
    if any(hrd):
        r.u(1)                                 # low_delay_hrd_flag
    r.u(1)                                     # pic_struct_present_flag
    if r.u(1):                                 # bitstream_restriction
        r.u(1)
        for _ in range(4):
            r.ue()
        sps["num_reorder_frames"] = r.ue()
        r.ue()                                 # max_dec_frame_buffering


def parse_pps(nal: bytes) -> dict:
    r = BitReader(rbsp(nal[1:]))
    pps = {"id": r.ue(), "sps": r.ue()}
    r.u(1)                                     # entropy_coding_mode_flag
    pps["bottom_field_poc_present"] = r.u(1)
    return pps


def _slice_poc_fields(nal: bytes, sps_by_id: dict, pps_by_id: dict) -> dict:
    """The slice header up to its picture order count fields (7.3.3)."""
    r = BitReader(rbsp(nal[1:64]) if len(nal) > 64 else rbsp(nal[1:]))
    kind = nal[0] & 0x1F
    r.ue()                                     # first_mb_in_slice
    r.ue()                                     # slice_type
    pps = pps_by_id.get(r.ue())
    if pps is None or pps["sps"] not in sps_by_id:
        raise ValueError("a slice whose parameter sets were not seen")
    sps = sps_by_id[pps["sps"]]
    if sps["separate_planes"]:
        r.u(2)
    r.u(sps["log2_max_frame_num"])             # frame_num
    if not sps["frame_mbs_only"] and r.u(1):
        raise _unread("an H.264 stream of field pictures")
    if kind == 5:
        r.ue()                                 # idr_pic_id
    out = {"idr": kind == 5,
           "reference": bool(nal[0] >> 5 & 3), "sps": sps, "lsb": 0,
           "delta_bottom": 0}
    if sps["poc_type"] == 0:
        out["lsb"] = r.u(sps["log2_max_poc_lsb"])
        if pps["bottom_field_poc_present"]:
            out["delta_bottom"] = r.se()
    return out


def h264_output_order(units) -> list[int]:
    """Indices of ``units`` (Annex B access units in decode order) in the
    order a decoder outputs their pictures (module docstring). A unit that
    holds no slice outputs no picture and is left out."""
    return [k for k, _ in h264_output_frames(units)]


def h264_output_frames(units) -> list[tuple[int, int | None]]:
    """(index of the unit, index of the unit whose decoding returns it or
    None at the end of the stream) of each picture of ``units`` in the
    order a decoder outputs them (module docstring)."""
    pictures = _pictures(units)
    out: list[tuple[int, int | None]] = []
    delayed: list[tuple[int, int, bool]] = []

    def select() -> tuple[int, int, bool]:
        # the smallest POC before the next IDR picture
        best = 0
        for i in range(1, len(delayed)):
            if delayed[i][2]:
                break
            if delayed[i][1] < delayed[best][1]:
                best = i
        return delayed.pop(best)

    for k, poc, idr, depth in pictures:
        delayed.append((k, poc, idr))
        if len(delayed) > depth:
            out.append((select()[0], k))
    while delayed:
        out.append((select()[0], None))
    return out


def _pictures(units) -> list[tuple[int, int, bool, int]]:
    """(unit index, POC, IDR, reorder depth) of each picture in decode
    order, the POC counted from 0 at each IDR picture."""
    sps_by_id: dict = {}
    pps_by_id: dict = {}
    pictures = []
    prev_msb = prev_lsb = 0
    frame_index = 0
    for k, unit in enumerate(units):
        poc = None
        for nal in annexb_nals(unit):
            kind = nal[0] & 0x1F
            if kind == 7:
                sps = parse_sps(nal)
                sps_by_id[sps["id"]] = sps
            elif kind == 8:
                pps = parse_pps(nal)
                pps_by_id[pps["id"]] = pps
            elif kind in (1, 5) and poc is None:
                s = _slice_poc_fields(nal, sps_by_id, pps_by_id)
                if s["idr"]:
                    prev_msb = prev_lsb = 0
                if s["sps"]["poc_type"] == 2:
                    poc = frame_index       # output order = decode order
                else:
                    max_lsb = 1 << s["sps"]["log2_max_poc_lsb"]
                    lsb = s["lsb"]
                    if lsb < prev_lsb and prev_lsb - lsb >= max_lsb // 2:
                        msb = prev_msb + max_lsb
                    elif lsb > prev_lsb and lsb - prev_lsb > max_lsb // 2:
                        msb = prev_msb - max_lsb
                    else:
                        msb = prev_msb
                    top = msb + lsb
                    poc = min(top, top + s["delta_bottom"])
                    if s["reference"]:
                        prev_msb, prev_lsb = msb, lsb
                pictures.append((k, poc, s["idr"],
                                 s["sps"]["num_reorder_frames"]))
                frame_index += 1
    return pictures

