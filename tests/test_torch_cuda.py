"""auformer_torch CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
neither JAX nor the JAX package, so it runs where only PyTorch is installed;
``tests/conftest.py`` imports JAX, so skip it there:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from auformer_torch.core.config import Config
from auformer_torch.infer import make_infer_fn
from auformer_torch.nn import build_model
from auformer_torch.ops import attention as tatt
from auformer_torch.ops import audio_kernel

pytestmark = pytest.mark.cuda

SHAPES = [(49, 32), (17, 64), (12, 32)]
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


def _qkv(n, d, seed, device, dtype, b=4, h=8):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.randn(b, h, n, d).astype(np.float32)).to(
        device, dtype) for _ in range(3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", SHAPES)
def test_attention_kernel_matches_plain_version(cuda_device, n, d, dtype):
    q, k, v = _qkv(n, d, 0, cuda_device, dtype)
    before = tatt.fused_attention.launches
    got = tatt.fused_attention(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert tatt.fused_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = tatt.attention_reference(q, k, v, d ** -0.5)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def test_attention_kernel_rejects_what_it_does_not_take(cuda_device):
    q, k, v = _qkv(12, 32, 1, cuda_device, torch.float32)
    with pytest.raises(NotImplementedError):
        tatt.fused_attention(q, k, v, 0.2, torch.ones(
            4, 12, dtype=torch.bool, device=cuda_device))
    with pytest.raises(ValueError):
        tatt.fused_attention(q.transpose(2, 3), k, v, 0.2)
    with pytest.raises(TypeError):
        tatt.fused_attention(q.half(), k.half(), v.half(), 0.2)
    big = torch.zeros(1, 1, 128, 64, device=cuda_device)
    with pytest.raises(ValueError):
        tatt.fused_attention(big, big, big, 0.1)


@pytest.mark.parametrize("with_len", [False, True])
def test_mel_kernel_matches_plain_version(cuda_device, with_len):
    rs = np.random.RandomState(2)
    n_valid = np.array([441000, 300_000, 441, 441000])
    audio = (rs.randn(4, 441000) * 0.1).astype(np.float32)
    audio[np.arange(441000)[None, :] < (441000 - n_valid)[:, None]] = 0.0
    audio = torch.from_numpy(audio).to(cuda_device)
    flen = (torch.from_numpy(1 + n_valid // 441).to(cuda_device)
            if with_len else None)
    before = audio_kernel.mel_frontend.launches
    got = audio_kernel.mel_frontend(audio, flen)
    torch.cuda.synchronize()
    assert audio_kernel.mel_frontend.launches == before + 1
    want = audio_kernel.mel_frontend_reference(audio, flen)
    torch.testing.assert_close(got, want, rtol=0, atol=MEL_ATOL)


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
