"""auformer_torch log-mel frontend against the JAX package.

The port's ``mel_frontend_reference`` (the plain version of the CUDA
kernel) is held against ``mel_frontend_pallas`` in interpret mode and
against ``audio_frontend(mel_bf16=True)``, at 2e-3 in normalized units as
tests/test_audio_pallas.py holds the Pallas kernel. The fp32 plain chain is
held against the JAX fp32 frontend at a short length, and the left-aligned
chain with ``reflect_end_patch`` (the dense sweep's per-window route)
against the JAX package's at 2e-4. The CUDA kernel is held against the
plain version on the card in tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auformer.ops import audio_host as jax_audio_host
from auformer.ops.audio import audio_frontend as jax_frontend
from auformer.ops.audio import reflect_end_patch as jax_reflect_end_patch
from auformer.ops.audio_pallas import mel_frontend_pallas
from auformer_torch.ops import audio as taudio
from auformer_torch.ops import audio_kernel

ATOL = 2e-3        # normalized units (0.04 dB); paths differ in sum order
F32_ATOL = 1e-4    # both sides f32 throughout
LEFT_ATOL = 2e-4   # left-aligned windows, normalized units


def _left_padded(seed, n_valid, scale=0.05):
    rs = np.random.RandomState(seed)
    audio = (rs.randn(len(n_valid), 441000) * scale).astype(np.float32)
    k = np.arange(441000)
    keep = k[None, :] >= 441000 - np.asarray(n_valid)[:, None]
    return np.where(keep, audio, 0.0).astype(np.float32)


CASES = {
    "full_window": (
        lambda: (np.random.RandomState(0).randn(2, 441000) * 0.1
                 ).astype(np.float32), None),
    "feature_len": (
        lambda: _left_padded(1, [441000, 200_000, 441]),
        np.array([1001, 1 + 200_000 // 441, 2], np.int32)),
    "all_zero": (lambda: np.zeros((1, 441000), np.float32), None),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    make, flen = CASES[request.param]
    audio = make()
    jflen = None if flen is None else jnp.asarray(flen)
    port = audio_kernel.mel_frontend_reference(
        torch.from_numpy(audio), None if flen is None
        else torch.from_numpy(flen))
    return request.param, audio, jflen, port.numpy()


def test_plain_version_matches_pallas_interpret(case):
    _, audio, flen, port = case
    want = np.asarray(mel_frontend_pallas(jnp.asarray(audio), flen,
                                          interpret=True))
    assert port.shape == want.shape == (len(audio), 1, 64, 1001)
    np.testing.assert_allclose(port, want, atol=ATOL, rtol=0)


def test_plain_version_matches_bf16_audio_frontend(case):
    _, audio, flen, port = case
    want = np.asarray(jax_frontend(jnp.asarray(audio), flen, mel_bf16=True))
    np.testing.assert_allclose(port, want, atol=ATOL, rtol=0)


def test_edge_frames_match_reflect_pad():
    """Frames 0 and 1000 cross the reflect padding."""
    audio = (np.random.RandomState(2).randn(1, 441000) * 0.3
             ).astype(np.float32)
    port = audio_kernel.mel_frontend_reference(torch.from_numpy(audio))
    want = np.asarray(jax_frontend(jnp.asarray(audio), mel_bf16=True))
    for col in (0, 1, 999, 1000):
        np.testing.assert_allclose(port.numpy()[..., col], want[..., col],
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("with_len", [False, True])
def test_fp32_frontend_short_length(with_len):
    """Other lengths run the plain chain; in fp32 it matches the JAX fp32
    frontend (right-aligned into 1001 columns, dead columns zeroed)."""
    rs = np.random.RandomState(3)
    audio = (rs.randn(2, 44100) * 0.1).astype(np.float32)
    flen = np.array([101, 40], np.int32) if with_len else None
    want = np.asarray(jax_frontend(
        jnp.asarray(audio), None if flen is None else jnp.asarray(flen)))
    got = taudio.audio_frontend(
        torch.from_numpy(audio),
        None if flen is None else torch.from_numpy(flen))
    assert got.shape == (2, 1, 64, 1001)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)


def test_frontend_dispatches_full_buffer_to_mel_frontend():
    audio = torch.from_numpy(
        (np.random.RandomState(4).randn(1, 441000) * 0.1).astype(np.float32))
    before = audio_kernel.mel_frontend.launches
    got = taudio.audio_frontend(audio, mel_bf16=False)
    torch.testing.assert_close(
        got, audio_kernel.mel_frontend_reference(audio), rtol=0, atol=0)
    assert audio_kernel.mel_frontend.launches == before


def test_left_aligned_is_not_ported():
    """The mel kernel has no left-aligned mode (the Pallas kernel has none
    either): a left-aligned (B, 441000) buffer runs the plain chain, in f32
    unless ``mel_bf16``, never ``mel_frontend``."""
    audio = torch.from_numpy(
        (np.random.RandomState(6).randn(2, 441000) * 0.1).astype(np.float32))
    flen = torch.tensor([1001, 300])
    before = audio_kernel.mel_frontend.launches
    got = taudio.audio_frontend(audio, flen, left_aligned=True)
    assert audio_kernel.mel_frontend.launches == before
    torch.testing.assert_close(
        got, taudio.plain_frontend(audio, flen, left_aligned=True),
        rtol=0, atol=0)
    assert not torch.equal(
        got, audio_kernel.mel_frontend_reference(audio, flen))


LEFT_N_VALID = np.array([441, 513, 1000, 300_000, 441_000], np.int32)


@pytest.fixture(scope="module")
def left_aligned_windows():
    """Left-aligned windows (valid samples first, zeros after) of each
    length in LEFT_N_VALID, and the JAX package's reflect_end_patch and
    left-aligned audio_frontend of them."""
    rs = np.random.RandomState(8)
    audio = (rs.randn(len(LEFT_N_VALID), 441000) * 0.1).astype(np.float32)
    audio[np.arange(441000)[None, :] >= LEFT_N_VALID[:, None]] = 0.0
    patched = np.array(jax_reflect_end_patch(jnp.asarray(audio),
                                               jnp.asarray(LEFT_N_VALID)))
    flen = (1 + LEFT_N_VALID // 441).astype(np.int32)
    feats = {bf16: np.asarray(jax_frontend(
        jnp.asarray(patched), jnp.asarray(flen), mel_bf16=bf16,
        left_aligned=True)) for bf16 in (False, True)}
    return audio, patched, flen, feats


def test_reflect_end_patch_matches_jax(left_aligned_windows):
    audio, patched, _, _ = left_aligned_windows
    got = taudio.reflect_end_patch(torch.from_numpy(audio),
                                   torch.from_numpy(LEFT_N_VALID))
    np.testing.assert_array_equal(got.numpy(), patched)
    # the end reflect: position nv + j holds sample nv - 2 - j
    nv = int(LEFT_N_VALID[2])
    np.testing.assert_array_equal(got[2, nv:nv + 512].numpy(),
                                  audio[2, nv - 513:nv - 1][::-1])
    assert not got[0, 441:].any()            # below 513 samples: no patch
    np.testing.assert_array_equal(got[-1].numpy(), audio[-1])  # full window


@pytest.mark.parametrize("mel_bf16", [False, True])
def test_left_aligned_frontend_matches_jax(left_aligned_windows, mel_bf16):
    """n_valid in {441, 513, 1000, 300000, 441000}: the port's left-aligned
    frontend of the patched windows equals the JAX package's (f32 DFT: sum
    order only; bf16 DFT operands: the same rounding on both sides)."""
    _, patched, flen, feats = left_aligned_windows
    got = taudio.audio_frontend(torch.from_numpy(patched),
                                torch.from_numpy(flen), mel_bf16=mel_bf16,
                                left_aligned=True)
    assert got.shape == (len(flen), 1, 64, 1001)
    np.testing.assert_allclose(got.numpy(), feats[mel_bf16], rtol=0,
                               atol=LEFT_ATOL)


def test_left_aligned_frontend_matches_reference_host(left_aligned_windows):
    """For every window of at least 513 samples the patched left-aligned
    frontend equals the reference's mel over the short window
    (aff2compdataset.py:227-247, the JAX package's audio_host)."""
    audio, patched, flen, _ = left_aligned_windows
    got = taudio.audio_frontend(torch.from_numpy(patched),
                                torch.from_numpy(flen), left_aligned=True)
    for i, nv in enumerate(LEFT_N_VALID):
        if nv < 513:
            continue
        ref = jax_audio_host.reference_audio_features(
            audio[i:i + 1, :nv], 10, 10e-3, 441000, 64)[0]
        np.testing.assert_allclose(got[i].numpy(), ref, rtol=1e-4,
                                   atol=1e-4)


def test_mel_frontend_rejects_other_lengths():
    with pytest.raises(ValueError):
        audio_kernel.mel_frontend(torch.zeros(1, 44100))


def _kernel_layout_mel(audio: np.ndarray, frames) -> np.ndarray:
    """The CUDA kernel's arithmetic for some frames of one sample, from its
    own tables, in numpy: hop rows of 441 samples (reflect padding by index,
    rows past hop 1000 zero) padded to the kernel's stride, frame f as the
    padded values of rows f-1 and f, bf16 frames and basis with f32 sums,
    power from interleaved (re, im) columns, and each mel band summed over
    its own bin range."""
    pairs, melfb, ranges = audio_kernel.kernel_tables()
    stride = pairs.shape[1] // 2
    bf16 = lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    out = []
    for k in frames:
        row = np.zeros(2 * stride, np.float32)
        for half, h in enumerate((k - 1, k)):
            if h > 1000:
                continue
            i = h * 441 + np.arange(441)
            i = np.where(i < 0, -i, i)
            i = np.where(i >= 441000, 2 * 440999 - i, i)
            row[half * stride:half * stride + 441] = audio[i]
        spec = bf16(pairs) @ bf16(row)                     # (1024,)
        power = spec[0::2] ** 2 + spec[1::2] ** 2           # (512,)
        out.append([power[lo:hi] @ melfb[m, lo:hi]
                    for m, (lo, hi) in enumerate(ranges)])
    return np.asarray(out, np.float32).T                   # (64, frames)


def test_kernel_tables_reproduce_the_plain_mel_power():
    """The kernel's padded hop-row frames, interleaved basis, dropped bin
    512 and per-band bin ranges give the plain chain's mel power, edge
    frames included (the CUDA kernel itself runs on the card only)."""
    audio = (np.random.RandomState(5).randn(441000) * 0.3).astype(np.float32)
    frames = [0, 1, 2, 500, 999, 1000]
    want = taudio.mel_spectrogram(torch.from_numpy(audio[None]),
                                  conv_dtype=torch.bfloat16)[0].numpy()
    got = _kernel_layout_mel(audio, frames)
    np.testing.assert_allclose(got, want[:, frames], rtol=2e-5, atol=1e-7)


def test_kernel_tables_drop_only_weightless_bins():
    pairs, melfb, ranges = audio_kernel.kernel_tables()
    fb = taudio.mel_filterbank()
    assert pairs.shape == (1024, 912) and melfb.shape == (64, 512)
    assert np.abs(fb[512]).max() < 1e-12 * fb.max()
    for m, (lo, hi) in enumerate(ranges):
        assert np.all(melfb[m, :lo] == 0) and np.all(melfb[m, hi:] == 0)
        assert melfb[m, lo] != 0 and melfb[m, hi - 1] != 0
    # the pads of both hop rows are zero basis rows
    assert not pairs[:, 441:456].any() and not pairs[:, 897:].any()
