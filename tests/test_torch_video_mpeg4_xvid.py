"""auformer_torch's MPEG-4 part 2 frames of the streams XviD writes
(data/mpeg4.py, the port's decoder data/native/mpeg4_decode.cpp, the
limited-range conversion of ops/colour.py) against the JAX package's cv2 and
libavcodec's own decoder, on the CPU.

The libxvid streams of tests/data/videos_mpeg4/ (the entries of
expected.json with ``planes_sha256``; regenerate them with
``JAX_PLATFORMS=cpu python scripts/make_mpeg4_fixtures.py --xvid``, which
needs gcc, cv2, the JAX package and the system's libavcodec with libxvid)
carry XviD's signature, so ffmpeg decodes them with XviD's inverse DCT;
with B-frames they are packed bitstreams, and two of them are quarter-pel.
Their frames, seeks, sequential reads, counts and timestamps are held to
cv2's bit for bit and their planes to libavcodec 59's. The 1280x720
stream is decoded once (planes, frames, count and timestamps; its seeks are
held on the card by chip_smoke.py). The inverse DCT is held to libavcodec's
own through its AVDCT interface where the system has libavcodec 59. The
streams ffmpeg decodes with an encoder's bug workarounds (XviD builds of
32 and below, a stream tagged XVID without a signature, quarter-pel DivX
without XviD) raise naming ROADMAP.md queue A9, on libxvid's streams with
their signatures edited; XviD build 33 and a DivX 5 stream without
quarter-pel decode to cv2's frames.
"""
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from auformer_torch.data import container, fixtures, ingest, mpeg4
from auformer_torch.data.video import Video, _rgb
from test_torch_video_mpeg4 import _against_jax

D = Path(__file__).parent / "data" / "videos_mpeg4"
EXPECTED = {name: entry for name, entry in
            json.loads((D / "expected.json").read_text()).items()
            if "planes_sha256" in entry}
FULL_WIDTH = "xvid_1280x720.avi"
SMALL = sorted(name for name in EXPECTED if name != FULL_WIDTH)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread for this file: its conversions are small torch
    ops, and several test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sha(img) -> str | None:
    return None if img is None else hashlib.sha256(
        np.ascontiguousarray(img).tobytes()).hexdigest()


def _planes(want: dict) -> list[list[str]]:
    return [[p["y"], p["u"], p["v"]] for p in want["planes_sha256"]]


def test_fixtures_are_libxvids():
    """The six streams: libxvid's signature in every one, packed (DivX's
    packed flag, two VOPs in a chunk) where it has B-frames, a version 2
    VOL (quarter_sample) where named so, the VfW layout's two one-byte
    chunks, and the 1280x720 stream at the size of users' files."""
    assert sorted(EXPECTED) == sorted(
        ["xvid_ip_176x144.avi", "xvid_packed_176x144.avi",
         "xvid_packed_nvop_176x144.avi", "xvid_qpel_176x144.avi",
         "xvid_qpel_4mv_176x144.avi", FULL_WIDTH])
    for name, want in EXPECTED.items():
        units = [u for _, u in container.access_units(str(D / name))]
        assert b"XviD0069" in units[0], name
        assert (b"DivX503b1393p" in units[0]) == (want["xvid"]["b"] > 0)
        vops = [u.count(b"\x00\x00\x01\xb6") for u in units]
        assert (max(vops) == 2) == (want["xvid"]["b"] > 0), name
        vol = units[0][units[0].index(b"\x00\x00\x01\x20"):]
        # is_object_layer_identifier (a version 2 VOL: quarter_sample)
        assert bool(vol[5] & 0x40) == ("qpel" in want["xvid"].get(
            "flags", "")), name
    assert 9000 < EXPECTED[FULL_WIDTH]["bytes_per_frame"] < 13000
    vfw = [u for _, u in container.access_units(
        str(D / "xvid_packed_nvop_176x144.avi"))]
    assert vfw.count(b"\x7f") == 2


@pytest.mark.parametrize("name", SMALL)
def test_port_matches_expected(tmp_path, name):
    """Frames, every seek of expected.json, the count and the timestamps
    equal what the JAX package read when the fixtures were made, and the
    decoder's planes equal libavcodec 59's."""
    want = EXPECTED[name]
    path = str(D / name)
    planes = [[_sha(p.numpy()) for p in yuv]
              for _, yuv, _ in mpeg4.decode_range(path)]
    assert planes == _planes(want)
    v = Video(path, write=False)
    assert [_sha(f) for f in v.frames(device="cpu")] == want["frames_sha256"]
    for k, digest in want["read_RGB_sha256"].items():
        assert _sha(v.read_RGB(int(k), device="cpu")) == digest, k
    assert v.count_frames() == want["count_frames"]
    ts = ingest.extract_timestamps(path, str(tmp_path / "ts.txt"))
    assert Path(ts).read_text() == want["timestamps"]


@pytest.mark.parametrize("name", SMALL)
def test_frames_and_seeks_equal_jax(name):
    """Against the JAX package on the same file: every frame, every seek
    from 0 to past the end (the packed streams' seeks drop the B-VOPs
    packed with their sync VOP, and cv2 numbers the first frame by the
    chunk that returns it), sequential reads after a seek, the count."""
    _against_jax(str(D / name))


def test_full_width_stream_decoded_once(tmp_path):
    """xvid_1280x720.avi, decoded once: the planes equal libavcodec's, the
    frames Video.frames converts from them equal cv2's, and the count and
    the timestamps (from the VOP headers) equal the JAX package's."""
    want = EXPECTED[FULL_WIDTH]
    path = str(D / FULL_WIDTH)
    planes, frames = [], []
    for frame in mpeg4.decode_range(path):
        planes.append([_sha(p.numpy()) for p in frame[1]])
        frames.append(_sha(_rgb(frame).numpy()))
    assert planes == _planes(want)
    assert frames == want["frames_sha256"]
    assert Video(path, write=False).count_frames() == want["count_frames"]
    ts = ingest.extract_timestamps(path, str(tmp_path / "ts.txt"))
    assert Path(ts).read_text() == want["timestamps"]


def _edited(tmp_path, name: str, old: bytes, new: bytes,
            fourcc: bytes = b"XVID") -> str:
    """``name`` with the bytes ``old`` replaced by ``new`` in every chunk,
    muxed again with ``fourcc``."""
    index = container.packet_index(str(D / name))
    units = [u.replace(old, new)
             for _, u in container.access_units(str(D / name), index)]
    delta, scale = fixtures._frame_rate(25.0)
    path = tmp_path / f"edited_{name}"
    path.write_bytes(fixtures._avi(
        units, [p.sync for p in index["packets"]], fourcc, delta, scale,
        index["width"], index["height"]))
    return str(path)


@pytest.mark.parametrize("build", [1, 3, 12, 32])
@pytest.mark.parametrize("call", ["frames", "read_RGB"])
def test_old_xvid_builds_raise_naming_a9(tmp_path, build, call):
    """XviD builds of 32 and below, for which ffmpeg switches on FF_BUG_
    DC_CLIP (and FF_BUG_EDGE to 12, the padding bug to 3, FF_BUG_QPEL_
    CHROMA to 1): the packed quarter-pel stream with its signature edited
    raises NotImplementedError naming A9 before any frame."""
    path = _edited(tmp_path, "xvid_qpel_176x144.avi", b"XviD0069",
                   b"XviD%04d" % build)
    v = Video(path, write=False)
    with pytest.raises(NotImplementedError, match="A9"):
        if call == "frames":
            list(v.frames(device="cpu"))
        else:
            v.read_RGB(5, device="cpu")


@pytest.mark.parametrize("call", ["frames", "read_RGB"])
def test_bare_xvid_fourcc_raises_naming_a9(tmp_path, call):
    """A stream tagged XVID without any signature, which ffmpeg takes for
    XviD build 0 (all of that build's workarounds): libxvid's stream
    without its user data raises naming A9."""
    path = _edited(tmp_path, "xvid_ip_176x144.avi",
                   b"\x00\x00\x01\xb2XviD0069", b"")
    assert b"XviD" not in Path(path).read_bytes()
    v = Video(path, write=False)
    with pytest.raises(NotImplementedError, match="A9"):
        if call == "frames":
            list(v.frames(device="cpu"))
        else:
            v.read_RGB(3, device="cpu")


@pytest.mark.parametrize("call", ["frames", "read_RGB"])
def test_quarter_pel_divx_raises_naming_a9(tmp_path, call):
    """A DivX-written quarter-pel stream (DivX's signature without XviD's:
    ffmpeg's FF_BUG_QPEL_CHROMA, QPEL_CHROMA2 and DIRECT_BLOCKSIZE act on
    it) raises naming A9."""
    path = _edited(tmp_path, "xvid_qpel_176x144.avi",
                   b"\x00\x00\x01\xb2XviD0069", b"")
    v = Video(path, write=False)
    with pytest.raises(NotImplementedError, match="A9"):
        if call == "frames":
            list(v.frames(device="cpu"))
        else:
            v.read_RGB(3, device="cpu")


@pytest.mark.parametrize("case", ["xvid-build-33", "divx-5-half-pel"])
def test_signed_controls_decode_to_cv2s_frames(tmp_path, case):
    """The controls of the refusals: XviD build 33 (no workaround, XviD's
    inverse DCT) and the packed half-pel stream with DivX's signature
    alone (its workarounds act on none of its tools; the simple inverse
    DCT) decode to cv2's frames and seeks; the two inverse DCTs give
    different frames."""
    if case == "xvid-build-33":
        path = _edited(tmp_path, "xvid_packed_176x144.avi", b"XviD0069",
                       b"XviD0033")
    else:
        path = _edited(tmp_path, "xvid_packed_176x144.avi",
                       b"\x00\x00\x01\xb2XviD0069", b"")
    _against_jax(path)
    ours = [_sha(f) for f in Video(path, write=False).frames(device="cpu")]
    same = ours == EXPECTED["xvid_packed_176x144.avi"]["frames_sha256"]
    assert same == (case == "xvid-build-33")


def test_packed_stream_decoded_from_its_second_sync_chunk():
    """decode_range from a sync chunk that holds an I-VOP and the B-VOP
    before it: the B-VOP, and the one after it, lack a reference and give
    no frame (no pending VOP of the earlier decode reaches this one); the
    frames from the I-VOP on equal the whole decode's."""
    path = str(D / "xvid_packed_176x144.avi")
    index = container.packet_index(path)
    whole = [(k, [p.clone() for p in yuv])
             for k, yuv, _ in mpeg4.decode_range(path, index)]
    key = next(k for k, p in enumerate(index["packets"])
               if p.sync and k > 0)
    part = list(mpeg4.decode_range(path, index, key))
    assert part[0][0] == key
    at = [k for k, _ in whole].index(key)
    assert at > [k for k, _ in whole].index(key - 1)   # B-VOPs went before
    assert len(part) == len(whole) - at
    for (k, planes), (k2, planes2, _) in zip(whole[at:], part):
        assert k == k2 and all(torch.equal(a, b)
                               for a, b in zip(planes, planes2))


# libavcodec 59's XviD inverse DCT through its public AVDCT interface (the
# one its mpeg4 decoder takes for XviD's streams: the SSE2 version on x86,
# or with argv[3] "c" the C one), on the blocks of argv[1] (int16, (n, 64),
# raster order), written to argv[2]. It runs in a process of its own: the
# x86 version leaves the MMX state set (ffmpeg's callers clear it with
# emms), after which x87 arithmetic in the same process gives NaN.
_AVDCT = r"""
import ctypes, sys
import numpy as np
try:
    lib = ctypes.CDLL("libavcodec.so.59")
    util = ctypes.CDLL("libavutil.so.57")
except OSError:
    sys.exit(3)

class AVDCT(ctypes.Structure):
    _fields_ = [("av_class", ctypes.c_void_p),
                ("idct", ctypes.CFUNCTYPE(None, ctypes.c_void_p)),
                ("idct_permutation", ctypes.c_uint8 * 64),
                ("fdct", ctypes.c_void_p), ("dct_algo", ctypes.c_int),
                ("idct_algo", ctypes.c_int)]

lib.avcodec_dct_alloc.restype = ctypes.POINTER(AVDCT)
if sys.argv[3] == "c":
    util.av_force_cpu_flags(0)
dct = lib.avcodec_dct_alloc()
dct.contents.idct_algo = 14                       # FF_IDCT_XVID
if lib.avcodec_dct_init(dct):
    sys.exit(4)
perm = np.array(dct.contents.idct_permutation)
blocks = np.load(sys.argv[1])
buf = np.zeros(64 + 8, np.int16)                  # 16-byte aligned for SSE2
block = buf[(-buf.ctypes.data % 16) // 2:][:64]
out = np.empty_like(blocks)
for k, coefs in enumerate(blocks):
    block[perm] = coefs
    dct.contents.idct(block.ctypes.data)
    out[k] = block
np.save(sys.argv[2], out)
"""


def _libavcodec_idct(blocks: np.ndarray, tmp_path, force_c: bool
                     ) -> np.ndarray:
    """``_AVDCT``'s outputs for ``blocks``; skips where the system has no
    libavcodec 59."""
    import subprocess
    import sys
    src, dst = tmp_path / "blocks.npy", tmp_path / "out.npy"
    np.save(src, blocks)
    run = subprocess.run([sys.executable, "-c", _AVDCT, str(src), str(dst),
                          "c" if force_c else "auto"], capture_output=True)
    if run.returncode == 3:
        pytest.skip("no libavcodec 59 on this system")
    assert run.returncode == 0, run.stderr.decode()
    return np.load(dst)


def _blocks(n: int, seed: int = 0) -> np.ndarray:
    """Random coefficient blocks, (n, 64) int16: a few low ones, dense small
    ones, dense ones over the whole range of a dequantised coefficient, and
    a DC alone, in turns."""
    rs = np.random.RandomState(seed)
    out = np.zeros((n, 64), np.int16)
    for k, block in enumerate(out):
        kind = k % 4
        if kind == 0:
            at = rs.randint(0, 16, 3)
            block[at] = rs.randint(-300, 300, 3)
        elif kind == 1:
            block[:] = rs.randint(-150, 150, 64)
        elif kind == 2:
            at = rs.randint(0, 64, 20)
            block[at] = rs.randint(-2048, 2048, 20)
        else:
            block[0] = rs.randint(-2048, 2048)
    return out


def test_xvid_inverse_dct_is_libavcodecs(tmp_path):
    """The decoder's XviD inverse DCT equals libavcodec's on the machine's
    CPU (x86: ff_xvid_idct_sse2, with 16-bit saturation) on 4000 blocks,
    the extreme ones too, and differs from the simple one; libavcodec's C
    version, which does not saturate, equals it where no sum passes 16
    bits and differs on the extreme blocks."""
    blocks = _blocks(4000)
    ours = np.stack([mpeg4.inverse_dct(b.reshape(8, 8), xvid=True)
                     .reshape(64) for b in blocks])
    np.testing.assert_array_equal(ours, _libavcodec_idct(blocks, tmp_path,
                                                         force_c=False))
    simple = np.stack([mpeg4.inverse_dct(b.reshape(8, 8), xvid=False)
                       .reshape(64) for b in blocks])
    assert (ours != simple).any(axis=1).sum() > 1000
    c_version = _libavcodec_idct(blocks[:400], tmp_path, force_c=True)
    same = (ours[:400] == c_version).all(axis=1)
    extreme = np.arange(400) % 4 == 2
    assert same[~extreme].all() and not same[extreme].all()
