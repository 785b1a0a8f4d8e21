"""auformer_torch's video frame decoding against the JAX package's cv2: the
demuxer's access units (data/container.py) against cv2's raw packets, the
decoder output order of B-frame streams (data/bitstream.py), the colour
conversion (ops/colour.py) against cv2 on swept (Y, U, V) inputs, and
``Video`` on the MJPEG fixtures of tests/data/videos_decode/ and
tests/data/videos/ with ``device="cpu"``.

Tolerances. The conversion is bit for bit: the inputs are I_PCM H.264
frames and flat-block JPEGs, whose decoded planes every decoder gives
exactly. A whole MJPEG frame may differ from cv2's by ``MJPG_MAX`` levels
with a mean of at most ``MJPG_MEAN``: its inverse DCT is libjpeg's here
(nvJPEG's on the card), cv2's is ffmpeg's, and the two round apart.
"""
import hashlib
import io
import json
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from auformer.data import ingest as jax_ingest
from auformer.data.video import Video as JaxVideo
from auformer_torch.data import bitstream, container, fixtures, ingest, mpeg4
from auformer_torch.data.fixtures import (h264_access_units, h264_gop_order,
                                          write_h264, write_mjpeg_avi)
from auformer_torch.data.video import Video, decode_mjpeg_frame
from auformer_torch.ops.colour import yuv_rgb, yuv_rgb_plain

DECODE = Path(__file__).parent / "data" / "videos_decode"
VIDEOS = Path(__file__).parent / "data" / "videos"
EXPECTED = json.loads((DECODE / "expected.json").read_text())
MJPG_MAX, MJPG_MEAN = 3, 0.1
CPU = torch.device("cpu")


def _sha(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def _cv2_packets(path) -> tuple[bytes, list[bytes]]:
    """(extradata, packets) of cv2's raw mode (CAP_PROP_FORMAT -1)."""
    cap = cv2.VideoCapture(str(path))
    assert cap.set(cv2.CAP_PROP_FORMAT, -1)
    ok, extra = cap.retrieve(
        flag=int(cap.get(cv2.CAP_PROP_CODEC_EXTRADATA_INDEX)))
    packets = []
    while True:
        ok, p = cap.read()
        if not ok:
            break
        packets.append(p.tobytes())
    cap.release()
    return extra.tobytes() if extra is not None else b"", packets


@pytest.mark.parametrize("path", [
    DECODE / "ip_112.mp4", DECODE / "ipb_112.mp4", DECODE / "ip_112.avi",
    DECODE / "mjpg_112.avi", VIDEOS / "mp4v_30.mp4", VIDEOS / "xvid_25.avi",
    VIDEOS / "rec.avi", VIDEOS / "elst_window.mp4"], ids=lambda p: p.name)
def test_access_units_equal_cv2_raw_packets(path):
    """Each access unit is cv2's raw packet byte for byte: H.264 in MP4 as
    ffmpeg's h264_mp4toannexb writes it, the rest as stored; MPEG-4 part 2
    in MP4 with the esds VOL (cv2's extradata) ahead of the first. Raw
    packets include the samples an edit list leaves out (elst_window.mp4),
    which the decoder then drops, and which count_frames does not count."""
    index = container.packet_index(str(path))
    units = [u for _, u in container.access_units(str(path), index,
                                                  kept_only=False)]
    extra, packets = _cv2_packets(path)
    assert len(units) == len(packets)
    assert sum(p.kept for p in index["packets"]) == \
        Video(str(path), write=False).count_frames()
    if index["codec"] == "mpeg4" and index["setup"]:
        assert index["setup"]["vol"] == extra
        packets[0] = extra + packets[0]
    assert units == packets


def test_packet_index_of_a_b_frame_mp4():
    """Sync flags, decode and presentation times and offsets of the B-frame
    fixture: IDR samples are the sync ones, each sample's presentation time
    is its display index (512 ticks a frame, one frame of delay)."""
    index = container.packet_index(str(DECODE / "ipb_112.mp4"))
    order = h264_gop_order(26, 12, 2)
    assert index["codec"] == "h264" and index["setup"]["nal_length_size"] == 4
    assert [p.sync for p in index["packets"]] == [k == "I" for _, k in order]
    assert [p.dts for p in index["packets"]] == [512 * k for k in range(26)]
    assert [p.pts for p in index["packets"]] == [512 * (t + 1)
                                                 for t, _ in order]
    assert all(p.kept for p in index["packets"])
    data = (DECODE / "ipb_112.mp4").read_bytes()
    for p in index["packets"]:     # each sample is length-prefixed NALs
        assert int.from_bytes(data[p.offset:p.offset + 4], "big") == \
            p.size - 4


@pytest.mark.parametrize("b_frames,gop,n", [(0, 12, 26), (1, 12, 26),
                                            (2, 12, 26), (3, 300, 300)])
def test_h264_output_order_is_display_order(b_frames, gop, n):
    """The decoder's output order from the slice headers' picture order
    counts is the display order, across IDR periods and, in a 300-frame
    GOP, across the wrap of an 8-bit pic_order_cnt_lsb."""
    units, shown = [], []
    for t, _, nals in h264_access_units(16, 16, n, gop, b_frames):
        units.append(b"".join(b"\x00\x00\x00\x01" + x for x in nals))
        shown.append(t)
    order = bitstream.h264_output_order(units)
    assert [shown[k] for k in order] == list(range(n))


def test_mpeg4_output_order():
    """A B-VOP is output when decoded, an I- or P-VOP when the next one
    arrives; without B-VOPs the decode order stands (the port's MPEG-4
    decoder reading the VOP headers alone). A packed bitstream's frames
    (DivX's packed flag: a unit's second VOP decoded in the next unit's
    place, a one-byte unit skipped) come out of the full decode by the
    same rule."""
    head = fixtures._m4_headers(32, 32, 30, False, False, False)

    def vop(kind, t):                  # a VOP header up to vop_coded 1
        w = fixtures._BitList()
        for value, bits in ((0x1B6, 32), (kind, 2), (0, 1), (1, 1), (t, 5),
                            (1, 1), (1, 1)):
            w.put(value, bits)
        w.stuff()
        return w.tobytes()
    ipbb = [head + vop(0, 0), vop(1, 3), vop(2, 1), vop(2, 2), vop(1, 5),
            vop(2, 4)]
    frames, _ = mpeg4.output_frames(ipbb)
    assert [k for k, _, _ in frames] == [0, 2, 3, 1, 5, 4]
    ipp = [head + vop(0, 0), vop(1, 1), vop(1, 2)]
    assert [k for k, _, _ in mpeg4.output_frames(ipp)[0]] == [0, 1, 2]
    headers, units = fixtures.mpeg4_access_units(32, 32, 5, gop=5,
                                                 b_frames=1, seed=1,
                                                 qscale=4)
    vops = [v for _, _, v in units]          # I0 P2 B1 P4 B3
    packed = [headers + b"\x00\x00\x01\xb2DivX503b1393p" + vops[0],
              vops[1] + vops[2], vops[3] + vops[4], b"\x7f"]
    dec, full = mpeg4.Decoder("FMP4"), []
    for k, unit in enumerate(packed):
        if dec.send(unit, k):
            full.append(dec.receive_tag())
    if dec.flush():
        full.append(dec.receive_tag())
    dec.close()
    headers_only = [(k, props) for k, props, _ in
                    mpeg4.output_frames(packed)[0]]
    assert full == headers_only == [(0, 0), (2, 2), (1, 1)]


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_count_and_timestamps_equal_jax(tmp_path, name):
    """count_frames and extract_timestamps equal what the JAX package read
    when the fixtures were made; on ipb_112.mp4 the timestamps follow the
    decoder's output order (presentation order), not the samples'."""
    path = str(DECODE / name)
    assert Video(path, write=False).count_frames() == \
        EXPECTED[name]["count_frames"]
    ts = ingest.extract_timestamps(path, str(tmp_path / "ts.txt"))
    assert Path(ts).read_text() == EXPECTED[name]["timestamps"]


def test_b_frame_timestamps_without_an_edit_list(tmp_path):
    """A ctts track without an edit list: its timestamps start at its
    first presentation time, as cv2's do."""
    path = str(tmp_path / "ipb.mp4")
    write_h264(path, 32, 32, 10, gop=5, b_frames=1)
    data = bytearray(Path(path).read_bytes())
    at = data.index(b"edts") - 4
    data[at + 4:at + 8] = b"free"     # the edit list, skipped
    Path(path).write_bytes(bytes(data))
    ours = ingest.extract_timestamps(path, str(tmp_path / "a.txt"))
    theirs = jax_ingest.extract_timestamps(path, str(tmp_path / "b.txt"))
    assert Path(ours).read_text() == Path(theirs).read_text()


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_expected_still_what_jax_reads(name):
    """expected.json (and mjpg_112.npz) still hold what the JAX package's
    cv2 reads, frames, seeks and count."""
    want = EXPECTED[name]
    v = JaxVideo(str(DECODE / name), write=False)
    frames = list(v.frames())
    assert [_sha(f) for f in frames] == want["frames_sha256"]
    for k, digest in want["read_RGB_sha256"].items():
        assert _sha(v.read_RGB(int(k))) == digest
        assert digest == want["frames_sha256"][int(k)]
    v.release()
    if name == "mjpg_112.avi":
        np.testing.assert_array_equal(
            np.load(DECODE / "mjpg_112.npz")["frames"], np.stack(frames))


def _limited_range_rgb(y, u, v) -> np.ndarray:
    """swscale's limited-range BT.601 yuv2rgb of 4:2:0 planes (13-bit
    coefficients, offset 16, floors), the arithmetic an H.264 decoder's
    colour conversion will need: ``yuv_rgb_plain`` is its full-range
    twin."""
    y, u, v = (p.astype(np.int64) for p in (y, u, v))
    cu = np.repeat(np.repeat(u, 2, 0), 2, 1) * 8 - 1024
    cv = np.repeat(np.repeat(v, 2, 0), 2, 1) * 8 - 1024
    yt = ((y * 8 - 128) * 9539) >> 16
    rgb = np.stack([yt + ((cv * 13075) >> 16),
                    yt + ((cu * -3209) >> 16) + ((cv * -6660) >> 16),
                    yt + ((cu * 16525) >> 16)], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def test_limited_range_conversion_equals_cv2(tmp_path):
    """swscale's limited-range arithmetic (``_limited_range_rgb``) equals
    cv2's frames of an I_PCM H.264 stream bit for bit: every (U, V) pair,
    each with 64 Y values."""
    h = w = 1024
    blocks = (h // 2) * (w // 2)

    def source(t):
        k = t * blocks + np.arange(blocks)
        uv = k // 64
        y0 = (k % 64) * 4
        y = np.empty((h, w), np.uint8)
        for j, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            y[dy::2, dx::2] = (y0 + j).reshape(h // 2, w // 2)
        return (y, (uv // 256).astype(np.uint8).reshape(h // 2, w // 2),
                (uv % 256).astype(np.uint8).reshape(h // 2, w // 2))

    path = str(tmp_path / "sweep.mp4")
    write_h264(path, w, h, 4, gop=1, source=source)
    cap = cv2.VideoCapture(path)
    for t in range(4):
        ok, bgr = cap.read()
        assert ok
        np.testing.assert_array_equal(_limited_range_rgb(*source(t)),
                                      cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    cap.release()


def _flat_jpegs(subsampling: int, n: int, size: int = 256):
    """JPEGs whose 8x8 blocks are each one value in every plane (so every
    decoder gives their planes exactly), 4:2:0 (``subsampling`` 2) or
    4:2:2 (1), each with the planes it holds: random (U, V) pairs, random
    Y."""
    rs = np.random.RandomState(subsampling)
    vs = 2 if subsampling == 2 else 1
    out = []
    for _ in range(n):
        uv = rs.randint(0, 65536, (size // vs // 8, size // 16))
        u, v = (np.kron(c, np.ones((8, 8), int)) for c in divmod(uv, 256))
        y = np.kron(rs.randint(0, 256, (size // 8, size // 8)),
                    np.ones((8, 8), int))
        img = np.stack([y] + [np.repeat(np.repeat(c, vs, 0), 2, 1)
                              for c in (u, v)], -1).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img, "YCbCr").save(buf, "JPEG", quality=100,
                                           subsampling=subsampling)
        out.append((buf.getvalue(), y, u, v))
    return out


@pytest.mark.parametrize("subsampling", [2, 1], ids=["420", "422"])
def test_full_range_conversion_equals_cv2(tmp_path, subsampling):
    """At full range (cv2's MJPEG frames) the plain conversion, and the
    MJPEG route through libjpeg's planes, equal cv2 bit for bit on JPEGs
    of flat blocks: 4096 random (U, V) pairs at 4:2:0, 8192 at 4:2:2."""
    jpegs = _flat_jpegs(subsampling, 16)
    path = str(tmp_path / "flat.avi")
    write_mjpeg_avi(path, [j for j, *_ in jpegs], 256, 256)
    cap = cv2.VideoCapture(path)
    for data, y, u, v in jpegs:
        ok, bgr = cap.read()
        want = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        got = yuv_rgb_plain(*[torch.from_numpy(p.astype(np.uint8))
                              for p in (y, u, v)])
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            decode_mjpeg_frame(data, CPU).numpy(), want)
    cap.release()


def test_yuv_rgb_takes_pitched_planes_and_refuses_others():
    """Planes with pitched rows convert as contiguous ones; chroma that is
    not planar (NV12's interleaved pairs as strided views) or not 4:2:0,
    4:2:2 or 4:4:4 of the luma raises."""
    rs = np.random.RandomState(0)
    y = torch.from_numpy(rs.randint(0, 256, (30, 64)).astype(np.uint8))
    uv = torch.from_numpy(rs.randint(0, 256, (15, 48)).astype(np.uint8))
    planes = (y[:, :42], uv[:, :21], uv[:, 24:45])
    assert torch.equal(yuv_rgb(*planes),
                       yuv_rgb(*[p.contiguous() for p in planes]))
    with pytest.raises(ValueError, match="columns must be contiguous"):
        yuv_rgb(y[:, :42], uv[:, 0:42:2], uv[:, 1:42:2])
    with pytest.raises(ValueError, match="not 4:2:0, 4:2:2 or 4:4:4"):
        yuv_rgb(y[:, :42], uv[:, :5], uv[:, 24:29])


def _mjpeg_cases():
    npz = np.load(DECODE / "mjpg_112.npz")["frames"]
    yield DECODE / "mjpg_112.avi", list(npz)
    for name in ("mjpg_30.avi", "rec.avi", "avix.avi", "drop.avi"):
        yield VIDEOS / name, None


@pytest.mark.parametrize("path,want", list(_mjpeg_cases()),
                         ids=lambda x: getattr(x, "name", ""))
def test_mjpeg_video_matches_jax(path, want):
    """Video.frames / read_RGB / count_frames on the CPU against the JAX
    package's cv2: the same frames within MJPG_MAX (mean MJPG_MEAN), the
    seeks and the sequential reads where cv2 puts them."""
    v = Video(str(path), write=False)
    jv = JaxVideo(str(path), write=False)
    want = want if want is not None else list(jv.frames())
    got = list(v.frames(device="cpu"))
    assert len(got) == len(want) == v.count_frames() == jv.count_frames()
    diff = np.abs(np.stack(got).astype(int) - np.stack(want).astype(int))
    assert diff.max() <= MJPG_MAX and diff.mean() <= MJPG_MEAN
    n = len(got)
    for k, at in ((n - 1, n - 1), (0, 0), (None, 1), (None, 2),
                  (n // 2, n // 2), (None, n // 2 + 1)):
        ours, theirs = v.read_RGB(k, device="cpu"), jv.read_RGB(k)
        np.testing.assert_array_equal(ours, got[at])
        assert np.abs(ours.astype(int) - theirs.astype(int)).max() <= \
            MJPG_MAX
    assert v.read_RGB(n, device="cpu") is None and jv.read_RGB(n) is None
    jv.release()


@pytest.mark.parametrize("name", ["ip_112.mp4", "ipb_112.mp4", "ip_112.avi"])
@pytest.mark.parametrize("call", ["read_RGB", "frames", "frame_tensors"])
def test_h264_frames_match_cv2(name, call):
    """The I_PCM, P_Skip and B_Skip streams of write_h264 decode through the
    port's H.264 decoder to cv2's frames bit for bit: each entry point's
    frames against expected.json's SHA-256s of the JAX package's."""
    v = Video(str(DECODE / name), write=False)
    want = json.loads((DECODE / "expected.json").read_text())[name]
    if call == "read_RGB":
        for k, digest in want["read_RGB_sha256"].items():
            img = v.read_RGB(int(k), device="cpu")
            assert hashlib.sha256(img.tobytes()).hexdigest() == digest, k
        return
    frames = [np.asarray(f) for f in getattr(v, call)(device="cpu")]
    assert [hashlib.sha256(f.tobytes()).hexdigest() for f in frames] == \
        want["frames_sha256"]


def test_jpeg_of_other_layouts_raise_naming_a9():
    """A 4:4:4 frame is not converted as cv2 converts it: it raises."""
    buf = io.BytesIO()
    Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(
        buf, "JPEG", subsampling=0)
    with pytest.raises(NotImplementedError, match="A9"):
        decode_mjpeg_frame(buf.getvalue(), CPU)


def test_frames_default_to_the_gpu():
    """Without a device the frames are decoded on the GPU; a box without
    one raises rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU")
    v = Video(str(DECODE / "mjpg_112.avi"), write=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        v.read_RGB(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        v.frames()


def test_cpu_frames_need_libjpeg(monkeypatch):
    """On the CPU the planes come from libjpeg whatever else the host has:
    without its header the frames raise naming it, and nothing falls back
    to nvJPEG."""
    from auformer_torch.data import native
    v = Video(str(DECODE / "mjpg_112.avi"), write=False)
    assert v.read_RGB(0, device="cpu").shape == (112, 112, 3)
    monkeypatch.setattr(native, "_has_libjpeg", lambda: False)
    with pytest.raises(RuntimeError, match="needs libjpeg"):
        v.read_RGB(0, device="cpu")


_CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl"}


def _parse_boxes(b: bytes) -> list:
    out, off = [], 0
    while off < len(b):
        size, kind = int.from_bytes(b[off:off + 4], "big"), b[off + 4:off + 8]
        body = b[off + 8:off + size]
        out.append([kind, _parse_boxes(body) if kind in _CONTAINERS
                    else body])
        off += size
    return out


def _build_boxes(tree: list) -> bytes:
    out = b""
    for kind, body in tree:
        payload = _build_boxes(body) if isinstance(body, list) else body
        out += (8 + len(payload)).to_bytes(4, "big") + kind + payload
    return out


def _stbl_variant(src: Path, dst: Path, variant: str) -> None:
    """``src`` (one sample per chunk, moov after mdat) with its chunk
    offsets as ``co64``, or with two samples in each chunk."""
    tree = _parse_boxes(src.read_bytes())
    stbl = tree
    for kind in (b"moov", b"trak", b"mdia", b"minf", b"stbl"):
        stbl = next(body for k, body in stbl if k == kind)
    i = next(k for k, (kind, _) in enumerate(stbl) if kind == b"stco")
    body = stbl[i][1]
    n = int.from_bytes(body[4:8], "big")
    offsets = [int.from_bytes(body[8 + 4 * k:12 + 4 * k], "big")
               for k in range(n)]
    if variant == "co64":
        stbl[i] = [b"co64", body[:8] + b"".join(
            o.to_bytes(8, "big") for o in offsets)]
    else:
        j = next(k for k, (kind, _) in enumerate(stbl) if kind == b"stsc")
        runs = [(1, 2, 1)] + ([(n // 2 + 1, 1, 1)] if n % 2 else [])
        stbl[j] = [b"stsc", bytes(4) + len(runs).to_bytes(4, "big") + b"".join(
            b"".join(x.to_bytes(4, "big") for x in r) for r in runs)]
        kept = offsets[::2]
        stbl[i] = [b"stco", bytes(4) + len(kept).to_bytes(4, "big") + b"".join(
            o.to_bytes(4, "big") for o in kept)]
    dst.write_bytes(_build_boxes(tree))


@pytest.mark.parametrize("variant", ["co64", "two_per_chunk"])
def test_sample_tables_of_other_layouts(tmp_path, variant):
    """64-bit chunk offsets and chunks of several samples place each
    sample where stco's one-per-chunk table does: the same units, equal
    to cv2's raw packets."""
    dst = tmp_path / f"{variant}.mp4"
    _stbl_variant(DECODE / "ipb_112.mp4", dst, variant)
    want = [u for _, u in container.access_units(str(DECODE /
                                                      "ipb_112.mp4"))]
    assert [u for _, u in container.access_units(str(dst))] == want
    assert _cv2_packets(dst)[1] == want


def test_parameter_sets_in_band(tmp_path):
    """An IDR sample that carries its own SPS and PPS gets none from
    avcC: 4-byte start codes on its parameter sets, a 3-byte one on its
    slice, as cv2's packets show."""
    from auformer_torch.data import fixtures
    samples, sync, units = [], [], list(h264_access_units(32, 32, 6, 3))
    for _, kind, nals in units:
        samples.append(b"".join(len(x).to_bytes(4, "big") + x for x in nals))
        sync.append(kind == "I")
    sps, pps = units[0][2][:2]
    avcc = (bytes([1, sps[1], sps[2], sps[3], 0xFF, 0xE1])
            + len(sps).to_bytes(2, "big") + sps + b"\x01"
            + len(pps).to_bytes(2, "big") + pps)
    path = tmp_path / "inband.mp4"
    path.write_bytes(fixtures._mp4(samples, sync, [0] * 6, 512, 15360, 32,
                                   32, avcc, 0))
    got = [u for _, u in container.access_units(str(path))]
    assert got == _cv2_packets(path)[1]
    assert got[0].count(b"\x00\x00\x00\x01") == 2
    assert got[0].count(b"\x00\x00\x01\x65") == 1


def test_avi_key_frames_from_its_indexes(tmp_path):
    """Key frames from idx1 (the H.264 AVI's IDR chunks), and from an
    OpenDML ix00 index where the file has one."""
    index = container.packet_index(str(DECODE / "ip_112.avi"))
    assert [p.sync for p in index["packets"]] == [
        k == "I" for _, k in h264_gop_order(26, 12, 0)]
    data = bytearray((DECODE / "mjpg_112.avi").read_bytes())
    index = container.packet_index(str(DECODE / "mjpg_112.avi"))
    assert all(p.sync for p in index["packets"])
    # an ix00 standard index (base 0) in the movi list, frame 3 a delta
    entries = b"".join(
        p.offset.to_bytes(4, "little")
        + (p.size | (0x80000000 if k == 3 else 0)).to_bytes(4, "little")
        for k, p in enumerate(index["packets"]))
    ix = (b"ix00" + (24 + len(entries)).to_bytes(4, "little")
          + (2).to_bytes(2, "little") + bytes([0, 1])
          + len(index["packets"]).to_bytes(4, "little") + b"00dc"
          + bytes(8) + bytes(4) + entries)
    movi = data.index(b"movi") - 8
    size = int.from_bytes(data[movi + 4:movi + 8], "little")
    end = movi + 8 + size
    ix_at = end                     # appended at the end of the movi list
    data[movi + 4:movi + 8] = (size + len(ix)).to_bytes(4, "little")
    data[ix_at:ix_at] = ix
    data[4:8] = (len(data) - 8).to_bytes(4, "little")
    # idx1's offsets are relative to movi: unchanged; ours come from ix00
    path = tmp_path / "odml.avi"
    path.write_bytes(bytes(data))
    index = container.packet_index(str(path))
    assert [p.sync for p in index["packets"]] == [k != 3 for k in range(12)]
