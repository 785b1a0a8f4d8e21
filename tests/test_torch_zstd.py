"""The port's own zstd decoder (auformer_torch/data/native/zstd_decode.cpp)
against the zstandard package's encoder, and its checksums.

Frames at levels -5, 1, 3 and 19 of random, text-like and repetitive data
at 0, 1, 128 KiB - 1, 128 KiB + 1 and 4 MiB + 3 bytes; with and without
the content checksum and the content size; concatenated with skippable
frames between; hypothesis cases. Malformed inputs raise ValueError, a
dictionary frame is refused by name, and a decoder that does not build
raises with the compiler's output.
"""
import functools
import os
import random
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from auformer_torch.data import native

zstandard = pytest.importorskip("zstandard")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVELS = (-5, 1, 3, 19)
KINDS = ("random", "text", "repetitive", "constant", "records")
BLOCK = 128 * 1024
SIZES = (0, 1, BLOCK - 1, BLOCK + 1, (4 << 20) + 3)


@functools.lru_cache(maxsize=None)
def data(kind: str, size: int) -> bytes:
    rng = random.Random(zlib.crc32(f"{kind}-{size}".encode()))
    if kind == "random":
        return rng.randbytes(size)
    if kind == "repetitive":
        unit = b"0123456789abcdef" * 3 + b"xyz"
        return (unit * (size // len(unit) + 1))[:size]
    if kind == "constant":                  # RLE blocks
        return b"\x07" * size
    if kind == "records":    # 3 fresh bytes + 16 repeated: RLE sequences
        out = bytearray()
        while len(out) < size:
            out += rng.randbytes(3) + b"ABCDEFGHIJKLMNOP"
        return bytes(out[:size])
    letters = b"abcdefghijklmnopqrstuvwxyz"
    words = [bytes(rng.choice(letters) for _ in range(rng.randint(2, 9)))
             for _ in range(500)]
    out = bytearray()
    while len(out) < size:
        out += rng.choice(words) + (b"\n" if rng.random() < 0.1 else b" ")
    return bytes(out[:size])


def compress(payload: bytes, level: int, **kw) -> bytes:
    return zstandard.ZstdCompressor(level=level, **kw).compress(payload)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("level", LEVELS)
def test_frames_decode_as_zstandard_wrote_them(level, kind, size):
    payload = data(kind, size)
    frame = compress(payload, level, write_checksum=True)
    assert native.zstd_decompress(frame) == payload
    out = np.empty(size, np.uint8)
    assert native.zstd_decompress_into(frame, out) == size
    assert out.tobytes() == payload


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("level", LEVELS)
def test_without_checksum_and_without_content_size(level, kind):
    """A frame without the checksum, and one without Frame_Content_Size
    (a streamed frame of several blocks)."""
    payload = data(kind, 3 * BLOCK + 5)
    plain = compress(payload, level, write_checksum=False,
                     write_content_size=False)
    assert plain[4] & 0xC4 == 0        # no FCS flag, no checksum flag
    assert native.zstd_decompress(plain) == payload
    cctx = zstandard.ZstdCompressor(level=level, write_checksum=True)
    chunker = cctx.chunker(chunk_size=BLOCK)
    streamed = b"".join(list(chunker.compress(payload)) +
                        list(chunker.finish()))
    assert native.zstd_decompress(streamed) == payload


def skippable(body: bytes, nibble: int = 0) -> bytes:
    return struct.pack("<II", 0x184D2A50 | nibble, len(body)) + body


def test_concatenated_and_skippable_frames():
    parts = [data("text", 5000), b"", data("random", 300),
             data("repetitive", 2 * BLOCK)]
    frames = [compress(p, lvl, write_checksum=i % 2 == 0)
              for i, (p, lvl) in enumerate(zip(parts, (1, 3, -5, 19)))]
    stream = (skippable(b"meta", 0xF) + frames[0] + frames[1]
              + skippable(b"") + frames[2] + skippable(os.urandom(40), 3)
              + frames[3])
    assert native.zstd_decompress(stream) == b"".join(parts)


@settings(max_examples=50, deadline=None, database=None)
@given(payload=st.binary(max_size=3000), level=st.sampled_from(LEVELS),
       repeat=st.integers(1, 60), checksum=st.booleans())
def test_hypothesis_frames(payload, level, repeat, checksum):
    """Random bytes, repeated to give matches, at a random level."""
    body = payload * repeat
    frame = compress(body, level, write_checksum=checksum)
    assert native.zstd_decompress(frame) == body


@pytest.mark.parametrize("size", range(60, 300, 20))
def test_short_text_single_huffman_stream(size):
    """Literal sections under 256 bytes: one Huffman stream."""
    for level in LEVELS:
        payload = data("text", size)
        assert native.zstd_decompress(compress(payload, level)) == payload


@pytest.mark.parametrize("cut", [0, 1, 4, 5, 7, 12, -5, -1])
def test_truncated_input_raises(cut):
    frame = compress(data("text", 20000), 3, write_checksum=True)
    with pytest.raises(ValueError, match="zstd"):
        native.zstd_decompress(frame[:cut] if cut >= 0 else frame[:cut])


def test_bad_magic_and_trailing_bytes_raise():
    frame = compress(data("text", 2000), 1)
    with pytest.raises(ValueError, match="bad magic"):
        native.zstd_decompress(b"\x00" + frame[1:])
    with pytest.raises(ValueError, match="bad magic"):
        native.zstd_decompress(frame + b"junkjunk")


def test_bad_checksum_raises():
    frame = bytearray(compress(data("text", 2000), 3, write_checksum=True))
    frame[-1] ^= 0x55
    with pytest.raises(ValueError, match="checksum"):
        native.zstd_decompress(bytes(frame))


def test_corrupted_frames_raise_or_decode_but_never_crash():
    """Every single-byte corruption of a compressed frame raises ValueError
    or decodes (a literal changed); none reads past the buffer."""
    frame = compress(data("text", 3000), 19, write_checksum=False)
    for i in range(len(frame)):
        for flip in (0x01, 0x80, 0xFF):
            bad = bytearray(frame)
            bad[i] ^= flip
            try:
                native.zstd_decompress(bytes(bad))
            except ValueError:
                pass


def test_output_buffer_too_small_raises():
    frame = compress(data("text", 5000), 3)
    with pytest.raises(ValueError, match="exceeds"):
        native.zstd_decompress_into(frame, np.empty(4999, np.uint8))


def test_dictionary_frames_are_refused_by_name():
    samples = [data("text", 2000)[i:i + 200] for i in range(0, 2000, 40)]
    d = zstandard.train_dictionary(1024, samples * 4)
    frame = zstandard.ZstdCompressor(dict_data=d).compress(samples[0])
    with pytest.raises(ValueError, match="dictionar"):
        native.zstd_decompress(frame)


def test_crc32c():
    crc32c = pytest.importorskip("google_crc32c")
    for size in (0, 1, 7, 8, 9, 1000, 65537):
        payload = data("random", size)
        assert native.crc32c(payload) == crc32c.value(payload)
    payload = data("text", 4096)
    assert native.crc32c(payload[1000:], native.crc32c(payload[:1000])) == \
        crc32c.value(payload)


def test_a_decoder_that_does_not_build_raises(tmp_path):
    """In a fresh process (a built library is kept per process): the
    compiler's error, no fallback."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "zstd_decode.cpp").write_text("#error broken decoder\n")
    code = (
        "import sys, pathlib\n"
        "from auformer_torch.data import native\n"
        f"native.SRC_DIR = pathlib.Path({str(src)!r})\n"
        f"native.BUILD_DIR = pathlib.Path({str(tmp_path / 'build')!r})\n"
        "try:\n"
        "    native.zstd_decompress(b'(\\xb5/\\xfd')\n"
        "except RuntimeError as e:\n"
        "    assert 'broken decoder' in str(e), e\n"
        "    sys.exit(7)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 7, proc.stderr + proc.stdout
