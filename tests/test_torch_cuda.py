"""auformer_torch CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
neither JAX nor the JAX package, so it runs where only PyTorch is installed;
``tests/conftest.py`` imports JAX, so skip it there:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import ctypes
import functools

import numpy as np
import pytest
import torch

from auformer_torch.core.config import Config
from auformer_torch.infer import make_infer_fn
from auformer_torch.nn import build_model
from auformer_torch.ops import attention as tatt
from auformer_torch.ops import audio_kernel
from auformer_torch.sweep import AvformerSweep

pytestmark = pytest.mark.cuda

TOKENS = [1, 12, 17, 33, 49, 64, 129]
DIMS = [32, 64]
TOL = {torch.float32: (1e-4, 1e-5),
       # one bf16 ulp (2**-7 relative) where the f32 sums round differently
       torch.bfloat16: (1e-2, 1e-3)}
MEL_ATOL = 2e-3    # normalized units (0.04 dB): order of summation only


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(n, d, seed, device, dtype, b=4, h=8, layout="contiguous"):
    """q, k, v as (B, H, N, D) tensors: contiguous, or the head split of a
    fused (B, N, 3 * H * D) projection (strided views of one tensor, as
    ``Attention.forward`` hands them over)."""
    rs = np.random.RandomState(seed)
    if layout == "contiguous":
        return [torch.from_numpy(rs.randn(b, h, n, d).astype(np.float32)).to(
            device, dtype) for _ in range(3)]
    qkv = torch.from_numpy(rs.randn(b, n, 3 * h * d).astype(np.float32)).to(
        device, dtype)
    return list(qkv.reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0))


def _check_attention(q, k, v, scale):
    before = tatt.fused_attention.launches
    got = tatt.fused_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert tatt.fused_attention.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    assert got.transpose(1, 2).is_contiguous()        # (B, N, H, D) storage
    want = tatt.attention_reference(q, k, v, scale)
    rtol, atol = TOL[q.dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("layout", ["contiguous", "to_qkv"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("n", TOKENS)
def test_attention_kernel_matches_plain_version(cuda_device, n, d, dtype,
                                                layout):
    q, k, v = _qkv(n, d, n * d, cuda_device, dtype, layout=layout)
    _check_attention(q, k, v, d ** -0.5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_ragged_last_cta(cuda_device, dtype):
    """1001 rows of 49 tokens: 2 rows per CTA, the last CTA holds one."""
    lib = tatt._library()
    per_cta, warps, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    assert lib.attention_launch_shape(
        1001, 49, 32, tatt._DTYPE_CODE[dtype], ctypes.byref(per_cta),
        ctypes.byref(warps), ctypes.byref(smem)) == 0
    assert per_cta.value > 1 and 1001 % per_cta.value != 0
    q, k, v = _qkv(49, 32, 5, cuda_device, dtype, b=143, h=7,
                   layout="to_qkv")
    _check_attention(q, k, v, 32 ** -0.5)


@pytest.mark.parametrize("n,d", [(49, 32), (17, 64), (12, 32)])
def test_attention_kernel_keeps_p_in_f32(cuda_device, n, d):
    """bf16 P V takes P in f32 (the kernel's hi + lo bf16 parts), not P
    rounded to bf16 once. Every query token of a row attends alike (equal q
    rows), and each V column is 30 * (s - p.s) with s = +-1: the terms are
    ~30 / N, the output cancels to below 0.07, and one rounding of P
    (2^-9 relative) moves it by >20x the tolerance."""
    b, h, big = 2, 4, 30.0
    rs = np.random.RandomState(n)
    bf16 = functools.partial(torch.tensor, dtype=torch.bfloat16)
    q = bf16(np.repeat(rs.randn(b, h, 1, d), n, axis=2))
    k = bf16(rs.randn(b, h, n, d))
    scale = d ** -0.5
    p = torch.softmax(q[:, :, :1].double() @ k.double().transpose(-1, -2)
                      * scale, dim=-1)
    sign = torch.from_numpy(rs.choice([-1.0, 1.0], (b, h, n, d)))
    v = (big * (sign - p @ sign)).bfloat16()
    q, k, v = (t.to(cuda_device) for t in (q, k, v))
    _check_attention(q, k, v, scale)
    want = tatt.attention_reference(q, k, v, scale).float()
    p_once = torch.softmax(q.float() @ k.float().transpose(-1, -2) * scale,
                           dim=-1).bfloat16().float()
    once = (p_once @ v.float()).bfloat16().float()
    rtol, atol = TOL[torch.bfloat16]
    assert want.abs().max() < 0.07
    assert not torch.allclose(once, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("n,d", [(49, 40), (17, 8), (129, 48)])
def test_attention_kernel_other_head_dims(cuda_device, n, d):
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _qkv(n, d, 6, cuda_device, dtype, b=2, h=3)
        _check_attention(q, k, v, d ** -0.5)


def test_attention_kernel_rejects_what_it_does_not_take(cuda_device):
    q, k, v = _qkv(12, 32, 1, cuda_device, torch.float32)
    with pytest.raises(NotImplementedError):
        tatt.fused_attention(q, k, v, 0.2, torch.ones(
            4, 12, dtype=torch.bool, device=cuda_device))
    with pytest.raises(ValueError):       # stride(-1) != 1
        tatt.fused_attention(q.transpose(2, 3), k, v, 0.2)
    with pytest.raises(TypeError):
        tatt.fused_attention(q.half(), k.half(), v.half(), 0.2)
    with pytest.raises(TypeError):        # mixed dtypes
        tatt.fused_attention(q, k.bfloat16(), v, 0.2)
    flat = torch.zeros(4 * 8 * 12 * 32 + 1, device=cuda_device)
    shifted = flat[1:].view(4, 8, 12, 32)  # rows off 16 bytes
    with pytest.raises(ValueError):
        tatt.fused_attention(shifted, k, v, 0.2)
    for n, d in ((145, 32), (12, 72), (12, 12)):
        big = torch.zeros(1, 1, n, d, device=cuda_device)
        with pytest.raises(ValueError):
            tatt.fused_attention(big, big, big, 0.1)


def _mel_audio(b, seed, n_valid=None):
    rs = np.random.RandomState(seed)
    audio = (rs.randn(b, 441000) * 0.1).astype(np.float32)
    if n_valid is not None:
        audio[np.arange(441000)[None, :]
              < (441000 - np.asarray(n_valid))[:, None]] = 0.0
    return audio


def _check_mel(audio, flen=None):
    dev = torch.device("cuda")
    audio = torch.from_numpy(np.ascontiguousarray(audio)).to(dev)
    if flen is not None:
        flen = torch.as_tensor(np.asarray(flen, np.int32)).to(dev)
    before = audio_kernel.mel_frontend.launches
    got = audio_kernel.mel_frontend(audio, flen)
    torch.cuda.synchronize()
    assert audio_kernel.mel_frontend.launches == before + 1
    want = audio_kernel.mel_frontend_reference(audio, flen)
    assert got.shape == (audio.shape[0], 1, 64, 1001)
    torch.testing.assert_close(got, want, rtol=0, atol=MEL_ATOL)
    return got


@pytest.mark.parametrize("with_len", [False, True])
def test_mel_kernel_matches_plain_version(cuda_device, with_len):
    n_valid = np.array([441000, 300_000, 441, 441000])
    _check_mel(_mel_audio(4, 2, n_valid),
               1 + n_valid // 441 if with_len else None)


@pytest.mark.parametrize("b", [1, 3, 8])
def test_mel_kernel_batch_sizes(cuda_device, b):
    _check_mel(_mel_audio(b, 10 + b))


@pytest.mark.parametrize("flen", [1, 2, 1000, 1001, 5000])
def test_mel_kernel_feature_len(cuda_device, flen):
    n_valid = min(441000, max(0, (flen - 1) * 441))
    _check_mel(_mel_audio(2, flen, [n_valid, n_valid]), [flen, flen])


@pytest.mark.parametrize("at", [0, 440999])
def test_mel_kernel_impulse(cuda_device, at):
    audio = np.zeros((1, 441000), np.float32)
    audio[0, at] = 1.0
    _check_mel(audio)


def test_mel_kernel_all_zero(cuda_device):
    got = _check_mel(np.zeros((2, 441000), np.float32))
    assert torch.unique(got).numel() == 1


def test_mel_kernel_repeats_and_samples_stand_alone(cuda_device):
    """Two calls in a row give the same bits (the per-sample scratch is
    reset), and a sample's output does not depend on its batch."""
    audio = _mel_audio(3, 7, [441000, 100_000, 441000])
    flen = [1001, 1 + 100_000 // 441, 1001]
    first = _check_mel(audio, flen)
    second = _check_mel(audio, flen)
    assert torch.equal(first, second)
    alone = _check_mel(audio[1:2], flen[1:2])
    assert torch.equal(alone[0], first[1])


def test_mel_kernel_rejects_what_it_does_not_take(cuda_device):
    audio = torch.zeros(2, 441000, device=cuda_device)
    with pytest.raises(TypeError):
        audio_kernel.mel_frontend(audio.double())
    with pytest.raises(ValueError):
        audio_kernel.mel_frontend(
            torch.zeros(441000, 2, device=cuda_device).t())


def test_slice_on_the_card_matches_the_cpu(cuda_device):
    """Small avformer (32x32 clips, B=2) through make_infer_fn's default
    device: fp32 logits on the card equal the CPU port's."""
    cfg = Config(compute_dtype="float32", image_size=32)
    torch.manual_seed(0)
    cpu_model = build_model(cfg).eval()
    card_model = build_model(cfg)
    card_model.load_state_dict(cpu_model.state_dict())
    rs = np.random.RandomState(3)
    batch = {"clip": rs.randint(0, 256, (2, 16, 32, 32, 3)).astype(np.uint8),
             "audio": (rs.randn(2, 441000) * 0.1).astype(np.float32)}
    attn, mel = tatt.fused_attention.launches, audio_kernel.mel_frontend.launches
    got = make_infer_fn(cfg, card_model)(batch)
    assert got.device.type == "cuda"
    assert tatt.fused_attention.launches - attn == 11
    assert audio_kernel.mel_frontend.launches - mel == 1
    want = make_infer_fn(cfg, cpu_model, device="cpu")(batch)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-3, atol=2e-4)


# attention sites of one full-width sweep bucket of 1280 label frames
# (T=16, dilation 3): the trunk batch is 1280 + 48 history frames + the
# black frame; (batch, tokens, head dim), 8 heads
SWEEP_SITES = {"spatial": (1329, 49, 32), "temporal": (1280, 17, 64),
               "au_tokens": (1280, 12, 32)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("site", sorted(SWEEP_SITES))
def test_attention_kernel_at_sweep_sites(cuda_device, site, dtype):
    b, n, d = SWEEP_SITES[site]
    q, k, v = _qkv(n, d, b + n, cuda_device, dtype, b=b, layout="to_qkv")
    _check_attention(q, k, v, d ** -0.5)


SWEEP_CFG = dict(compute_dtype="float32", image_size=32, n_frames=4,
                 dilation=2)


def _sweep_video(n=20, seed=5):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, 256, (n, 32, 32, 3)).astype(np.uint8),
            (rs.randn(11 * 44100) * 0.1).astype(np.float32),
            (np.arange(n) * 16 + 1) * 1000.0 / 30.0)


def test_sweep_on_the_card_matches_the_cpu(cuda_device):
    """Small-width sweep (32x32, T=4, dilation 2, bucket 8) on the phase
    route: fp32 logits on the card equal the CPU port's; 11 attention
    launches per bucket, no mel kernel."""
    cfg = Config(**SWEEP_CFG)
    torch.manual_seed(0)
    cpu_model = build_model(cfg)
    card_model = build_model(cfg)
    card_model.load_state_dict(cpu_model.state_dict())
    frames, wav, ts = _sweep_video()
    card = AvformerSweep(cfg, card_model)
    attn = tatt.fused_attention.launches
    mel = audio_kernel.mel_frontend.launches
    got = card.sweep_video_device_audio(frames, wav, ts, batch=8)
    assert tatt.fused_attention.launches - attn == 11 * 3
    assert audio_kernel.mel_frontend.launches == mel
    want = AvformerSweep(cfg, cpu_model, device="cpu"
                         ).sweep_video_device_audio(frames, wav, ts, batch=8)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


def test_phase_route_matches_per_window_route_on_the_card(cuda_device):
    """Features at 1e-4 in normalized units (f32 DFTs) and logits at rtol
    2e-3 / atol 2e-4: the phase-mel tables against left-aligned windows."""
    cfg = Config(**SWEEP_CFG)
    torch.manual_seed(1)
    sweep = AvformerSweep(cfg, build_model(cfg))
    frames, wav, ts = _sweep_video(seed=6)
    phase = sweep.sweep_video_device_audio(frames, wav, ts, batch=8)
    sweep.max_phases = 0
    per_window = sweep.sweep_video_device_audio(frames, wav, ts, batch=8)
    np.testing.assert_allclose(per_window, phase, rtol=2e-3, atol=2e-4)

    from auformer_torch.ops.phase_mel import (phase_mel_table, phase_plan,
                                              phase_window_features)
    starts, n_valid = sweep.audio_window_plan(ts, len(wav))
    phases, base, sel = phase_plan(starts.astype(np.int64) - 441000, n_valid)
    ext = torch.zeros(len(wav) + 2 * 441000 + 512, device=cuda_device)
    ext[441000:441000 + len(wav)] = torch.from_numpy(wav).to(cuda_device)
    on_card = [torch.from_numpy(a).to(cuda_device)
               for a in (starts, n_valid, base, sel)]
    feats = phase_window_features(
        ext, phase_mel_table(ext, np.unique(phases)), *on_card)
    windows = sweep.window_features(ext, on_card[0], on_card[1])
    torch.testing.assert_close(feats, windows, rtol=0, atol=1e-4)
