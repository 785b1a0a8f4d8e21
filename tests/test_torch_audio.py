"""auformer_torch log-mel frontend against the JAX package.

The port's ``mel_frontend_reference`` (the plain version of the CUDA
kernel) is held against ``mel_frontend_pallas`` in interpret mode and
against ``audio_frontend(mel_bf16=True)``, at 2e-3 in normalized units as
tests/test_audio_pallas.py holds the Pallas kernel. The fp32 plain chain is
held against the JAX fp32 frontend at a short length. The CUDA kernel is
held against the plain version on the card in tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auformer.ops.audio import audio_frontend as jax_frontend
from auformer.ops.audio_pallas import mel_frontend_pallas
from auformer_torch.ops import audio as taudio
from auformer_torch.ops import audio_kernel

ATOL = 2e-3        # normalized units (0.04 dB); paths differ in sum order
F32_ATOL = 1e-4    # both sides f32 throughout


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
    with pytest.raises(NotImplementedError):
        taudio.audio_frontend(torch.zeros(1, 441000), left_aligned=True)
    with pytest.raises(NotImplementedError):
        taudio.reflect_end_patch(torch.zeros(1, 441000),
                                 torch.tensor([1000]))


def test_mel_frontend_rejects_other_lengths():
    with pytest.raises(ValueError):
        audio_kernel.mel_frontend(torch.zeros(1, 44100))
