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
import torch.nn.functional as F

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


def test_native_reader_builds_and_decodes_on_this_host(cuda_device,
                                                       tmp_path):
    """The reader this host's JPEG library gives (libjpeg, else nvJPEG on
    the card) builds, and decodes the frames its own encoder wrote (q90)
    near their sources, colour and grayscale; a missing key, an empty key
    and a corrupt value stay black with ok False."""
    from auformer_torch.data import FrameStoreWriter, native
    from auformer_torch.data.fixtures import fixture_frame

    path = str(tmp_path / "store")
    sources = [fixture_frame(0, 0, t, 32) for t in range(6)]
    with FrameStoreWriter(path) as w:
        for t, img in enumerate(sources):
            w.put(f"v/{t}.jpg", native.encode_jpeg(img, 90))
            w.put(f"g/{t}.jpg", native.encode_jpeg(img[:, :, 1], 90))
        w.put("v/corrupt.jpg", b"\xff\xd8\xff\xe0 not a jpeg")
    store = native.NativeFrameStore(path, n_threads=4)
    assert store.decoder == native.decoder()
    keys = [f"v/{t}.jpg" for t in range(6)] + ["v/missing.jpg", "",
                                               "v/corrupt.jpg"]
    frames, ok = store.decode_batch(keys, 32, 32, 3)
    assert ok.tolist() == [True] * 6 + [False] * 3
    assert not frames[6:].any()
    err = np.abs(frames[:6].astype(np.int16) - np.stack(sources))
    assert err.mean() < 6 and err.max() <= 48
    gray, gok = store.decode_batch([f"g/{t}.jpg" for t in range(6)], 32, 32,
                                   1)
    assert gok.all()
    gerr = np.abs(gray[..., 0].astype(np.int16) - np.stack(sources)[..., 1])
    assert gerr.mean() < 6 and gerr.max() <= 48


def test_dataset_fed_sweep_on_the_card_matches_the_cpu(cuda_device,
                                                       tmp_path):
    """run_inference_sweep over an Aff2TestDataset of the port's fixtures
    (two 20-frame videos, 32x32): the decode thread, the native reader,
    sweep_stream; fp32 logits on the card equal the CPU port's, with 11
    attention launches per bucket and no mel kernel."""
    from auformer_torch.data import Aff2TestDataset
    from auformer_torch.data.fixtures import generate_synthetic_dataset
    from auformer_torch.infer import run_inference_sweep

    root, labels = str(tmp_path / "root"), str(tmp_path / "labels")
    generate_synthetic_dataset(root, labels, n_videos=2,
                               frames_per_video=[20, 13], image_size=32,
                               splits=["test"])
    cfg = Config(root=root, lmdb_label_dir=labels,
                 cache_dir=str(tmp_path / "cache"), **SWEEP_CFG)
    torch.manual_seed(2)
    cpu_model = build_model(cfg)
    card_model = build_model(cfg)
    card_model.load_state_dict(cpu_model.state_dict())
    attn = tatt.fused_attention.launches
    mel = audio_kernel.mel_frontend.launches
    got = run_inference_sweep(cfg, card_model, result_path=str(tmp_path / "a"),
                              bucket=8, dataset=Aff2TestDataset(cfg))
    assert tatt.fused_attention.launches - attn == 11 * (3 + 2)
    assert audio_kernel.mel_frontend.launches == mel
    want = run_inference_sweep(cfg, cpu_model, result_path=str(tmp_path / "b"),
                               bucket=8, dataset=Aff2TestDataset(cfg),
                               device="cpu")
    assert got.shape == want.shape == (33, 21)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


# -- packed serving -------------------------------------------------------------

def test_frame_arena_ring_is_page_locked(cuda_device):
    """The ring is registered with cudaHostRegister: torch sees it pinned,
    a non_blocking copy of a ring view reads it; close() unregisters."""
    from auformer_torch.packed import FrameArena

    arena = FrameArena(64, 16, 16, device=cuda_device)
    try:
        assert arena.registered and arena.backing == "memfd"
        ring = torch.from_numpy(arena.buf)
        assert ring.is_pinned()
        arena.buf[:] = np.arange(64, dtype=np.uint8)[:, None, None, None]
        got = ring[8:40].to(cuda_device, non_blocking=True)
        torch.cuda.synchronize()
        assert got[:, 0, 0, 0].tolist() == list(range(8, 40))
    finally:
        arena.close()
    assert not arena.registered


def test_arena_release_waits_for_its_copy(cuda_device):
    """A copy held back on its stream (a device sleep before it) keeps its
    rows: polling releases nothing, the blocking path waits on that copy's
    event and then releases."""
    from auformer_torch.packed import ArenaReleases, FrameArena

    arena = FrameArena(64, 16, 16, device=cuda_device)
    try:
        arena.alloc(0, 32)
        stream = torch.cuda.Stream(cuda_device)
        with torch.cuda.stream(stream):
            torch.cuda._sleep(200_000_000)
            got = torch.from_numpy(arena.buf[:32]).to(cuda_device,
                                                     non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(stream)
        releases = ArenaReleases(arena)
        releases.push(copied, 24)
        assert not releases.reap() and arena._free_g == 0
        assert releases.reap(block=True) and copied.query()
        assert arena._free_g == 24 and releases.blocked == 1
        assert got.shape == (32, 16, 16, 3)
    finally:
        torch.cuda.synchronize()
        arena.close()


def test_packed_stream_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """packed_sweep_stream over three small videos (32x32, bucket 16) on the
    card through the registered ring: fp32 logits
    equal the per-video stream's on the CPU; 11 attention launches per
    packed bucket, no mel kernel; every release after its copy."""
    from auformer_torch.data import Aff2TestDataset
    from auformer_torch.data.fixtures import generate_synthetic_dataset
    from auformer_torch.packed import packed_sweep_stream
    from auformer_torch.serve import sweep_stream

    root, labels = str(tmp_path / "root"), str(tmp_path / "labels")
    generate_synthetic_dataset(root, labels, n_videos=3,
                               frames_per_video=[40, 13, 27], image_size=32,
                               splits=["test"])
    cfg = Config(root=root, lmdb_label_dir=labels,
                 cache_dir=str(tmp_path / "cache"), **SWEEP_CFG)
    torch.manual_seed(3)
    cpu_model = build_model(cfg)
    card_model = build_model(cfg)
    card_model.load_state_dict(cpu_model.state_dict())
    attn = tatt.fused_attention.launches
    mel = audio_kernel.mel_frontend.launches
    stats = {}
    got = list(packed_sweep_stream(cfg, card_model,
                                   dataset=Aff2TestDataset(cfg), bucket=16,
                                   decode_worker=False, stats=stats))
    assert tatt.fused_attention.launches - attn == 11 * stats["buckets"]
    assert stats["buckets"] == 5 and stats["rows_padded"] == 0
    assert audio_kernel.mel_frontend.launches == mel
    assert stats["arena"]["registered"]
    assert stats["releases"]["made"] == stats["buckets"]
    want = list(sweep_stream(cfg, cpu_model, dataset=Aff2TestDataset(cfg),
                             bucket=16, decode_worker=False, device="cpu"))
    assert [v for _, v, _ in got] == [v for _, v, _ in want]
    for (gi, _, gl), (wi, _, wl) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gl, wl, rtol=2e-3, atol=2e-4)


# -- training ------------------------------------------------------------------

# attention sites of a B=64 train step (T=16): (batch, tokens, head dim),
# 8 heads; the fusion head's is the one whose gradient trains
TRAIN_SITES = {"fusion_head": (64, 12, 32), "spatial": (1024, 49, 32),
               "temporal": (64, 17, 64)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("site", sorted(TRAIN_SITES))
def test_attention_gradient_at_training_sites(cuda_device, site, dtype):
    """The autograd Function (kernel forward, recomputing backward) on the
    to_qkv head split against autograd through the plain version: forward
    and q, k, v gradients; one kernel launch and one backward call."""
    b, n, d = TRAIN_SITES[site]
    rs = np.random.RandomState(b + n)
    base = torch.from_numpy(rs.randn(b, n, 3 * 8 * d).astype(np.float32))
    grad = torch.from_numpy(rs.randn(b, 8, n, d).astype(np.float32)).to(
        cuda_device, dtype)
    results = []
    for fn in (tatt.fused_attention, tatt.attention_reference):
        qkv = base.to(cuda_device, dtype).requires_grad_()
        q, k, v = qkv.reshape(b, n, 3, 8, d).permute(2, 0, 3, 1, 4).unbind(0)
        launches = tatt.fused_attention.launches
        backward = tatt.fused_attention.backward_calls
        out = fn(q, k, v, d ** -0.5)
        out.backward(grad)
        torch.cuda.synchronize()
        if fn is tatt.fused_attention:
            assert type(out.grad_fn).__name__ == "_FusedAttentionBackward"
            assert tatt.fused_attention.launches == launches + 1
            assert tatt.fused_attention.backward_calls == backward + 1
        results.append((out.detach().float(), qkv.grad.float()))
    rtol, atol = TOL[dtype]
    for got, want in zip(*results):
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def _symmetric_batch(seed, b=4, image=32):
    rs = np.random.RandomState(seed)
    half = rs.randint(0, 256, (b, 16, image, image // 2, 3)).astype(np.uint8)
    au = rs.randint(0, 2, (b, 12)).astype(np.int8)
    au[0, 0] = -1
    return {"clip": np.concatenate([half, half[:, :, :, ::-1]], axis=3),
            "audio_features": rs.randn(b, 1, 64, 1001).astype(np.float32),
            "AU": au, "EX": rs.randint(-1, 7, (b, 1)).astype(np.int8),
            "VA": rs.uniform(-1, 1, (b, 2)).astype(np.float32)}


def test_train_step_on_the_card_matches_the_cpu(cuda_device):
    """One fp32 avformer train step (32x32, B=4, dropout 0, symmetric clips
    so the flip is the identity, no augmentation) on the card and on the
    CPU: the loss, every trainable gradient (the fusion head's to_qkv ones
    non-zero), the updated parameters (Adam's first step moves each by
    +-lr, so an element whose gradient is ~0 may step either way: 99.9 %
    within the tolerance, all within 2 lr) and every BatchNorm statistic."""
    from auformer_torch.nn import loss_suite
    from auformer_torch.parallel import step as tstep

    cfg = Config(compute_dtype="float32", image_size=32, dropout_rate=0.0,
                 batch_size=4, learning_rate=1e-3)
    torch.manual_seed(4)
    cpu_model = build_model(cfg, dtype=torch.float32)
    card_model = build_model(cfg, dtype=torch.float32)
    card_model.load_state_dict(cpu_model.state_dict())
    card_model.to(cuda_device)
    batch = _symmetric_batch(5)
    grads, out = [], []
    for model, dev in ((card_model, cuda_device), (cpu_model, "cpu")):
        state = tstep.create_train_state(cfg, model)
        step = tstep.make_train_step(cfg, model, loss_suite(model))
        tensors = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                   for k, v in batch.items()}
        hook = {}
        orig = state.apply_gradients

        def capture(orig=orig, state=state, hook=hook):
            hook.update({n: p.grad.detach().cpu().clone()
                         for n, p in state.model.named_parameters()
                         if p.requires_grad})
            orig()
        state.apply_gradients = capture
        attn = tatt.fused_attention.backward_calls
        metrics = step(state, tensors, torch.Generator(dev).manual_seed(0))
        if dev != "cpu":
            assert tatt.fused_attention.backward_calls - attn == 3
        grads.append(hook)
        out.append((float(metrics["loss"]),
                    {k: v.cpu() for k, v in model.state_dict().items()}))
    (loss_card, sd_card), (loss_cpu, sd_cpu) = out
    assert loss_card == pytest.approx(loss_cpu, rel=2e-3, abs=2e-4)
    qkv = "au_head.corr_transformer.layers.0.0.fn.fn.to_qkv.weight"
    assert grads[0][qkv].abs().sum() > 0
    for name, g in grads[1].items():
        torch.testing.assert_close(grads[0][name], g, rtol=2e-3, atol=2e-4)
    close = []
    for key, want in sd_cpu.items():
        got = sd_card[key]
        if key.startswith("au_head"):
            diff = (got - want).abs()
            assert diff.max() <= 2 * cfg.learning_rate, key
            close.append((diff <= 2e-4 + 2e-3 * want.abs()).reshape(-1))
        else:
            torch.testing.assert_close(got.float(), want.float(), rtol=1e-3,
                                       atol=1e-4)
    assert torch.cat(close).float().mean() >= 0.999


def test_augmentation_stages_on_the_card_match_the_cpu(cuda_device):
    """Every op of the vocabulary at both signs through the four stages
    and a whole slot, on the card against the CPU: LUT ops and the nearest
    warps exact, blends and bicubic warps +-1 level."""
    from auformer_torch.ops import augment_device as aug
    rs = np.random.RandomState(6)
    ops = np.tile(np.arange(15), 4)
    signs = np.where(np.arange(len(ops)) >= 30, -1.0, 1.0)
    mags = np.array([0, 0.2, 0.3, 0.3, 0.45, 26.67, 0, 5, 142.2, 0.6, 0.3,
                     0, 0, 0.7, 0.5])[ops]
    signed = np.isin(ops, [1, 2, 3, 4, 5, 9, 10, 13, 14])
    m = (mags * np.where(signed, signs, 1.0)).astype(np.float32)
    x = rs.randint(0, 256, (len(ops), 112, 112, 3)).astype(np.uint8)
    x[::7] //= 3                                # narrow histograms too
    args = [torch.from_numpy(a) for a in (x, ops, m)]
    card_args = [a.to(cuda_device) for a in args]
    loose = torch.from_numpy(np.isin(ops, [1, 2, 13, 14]))
    for name in ("_geo_stage", "_lut_stage", "_slot_apply"):
        got = getattr(aug, name)(*card_args).cpu()
        want = getattr(aug, name)(*args)
        diff = (got.int() - want.int()).abs().amax(dim=(1, 2, 3))
        assert (diff[~loose] == 0).all(), (name, diff)
        assert (diff[loose] <= 1).all(), (name, diff)
    factor = torch.from_numpy((1.0 + m).astype(np.float32))
    for name in ("_color_stage", "_sharp_stage"):
        got = getattr(aug, name)(card_args[0], factor.to(cuda_device)).cpu()
        want = getattr(aug, name)(args[0], factor)
        assert (got.int() - want.int()).abs().max() <= 1


# -- the model zoo --------------------------------------------------------------

# (model, modality, task, frames per clip, attention and mel launches per
# clip forward)
ZOO = {"vformer": ("vformer", "V", "AU", 4, 4, 0),
       "sformer_au": ("sformer", "V", "AU", 1, 3, 0),
       "sformer_va": ("sformer", "V", "VA", 1, 3, 0),
       "tformer": ("tformer", "V", "AU", 4, 9, 0),
       "dsformer": ("dsformer", "V;M", "AU", 1, 2, 0),
       "vggformer": ("vggformer", "V", "AU", 4, 4, 0),
       "audio": ("audio", "A", "AU", 4, 2, 1),
       "resnet": ("resnet", "V", "AU", 1, 0, 0),
       "van": ("van", "V", "AU", 1, 2, 0),
       "emonet": ("emonet", "V", "AU", 1, 2, 0),
       "i3d": ("i3d", "V", "AU", 4, 0, 0),
       "mc3d": ("mc3d", "V", "AU", 4, 0, 0),
       "tsav": ("tsav", "A;V", "AU", 4, 0, 1)}
CONV_ZOO = ("emonet", "i3d", "mc3d", "tsav", "van")


def _zoo_pair(case, **kw):
    """The config and a CPU and a card copy of one zoo model (64x64, B=2)
    on the same seeded weights."""
    name, modality, task, t, _, _ = ZOO[case]
    cfg = Config(**{**dict(model_name=name, modality=modality, task=task,
                           n_frames=t, dilation=1, image_size=64,
                           compute_dtype="float32"), **kw})
    torch.manual_seed(0)
    cpu_model = build_model(cfg).eval()
    card_model = build_model(cfg)
    card_model.load_state_dict(cpu_model.state_dict())
    return cfg, cpu_model, card_model


def _zoo_batch(case, b=2):
    """uint8 clips of the model's frames and channels and/or raw
    right-aligned audio (the mel kernel's input)."""
    name, modality, _, t, _, _ = ZOO[case]
    rs = np.random.RandomState(4)
    batch = {}
    if name in ("audio", "tsav"):
        batch["audio"] = (rs.randn(b, 441000) * 0.1).astype(np.float32)
    if name != "audio":
        channels = 4 if modality == "V;M" else 3
        batch["clip"] = rs.randint(0, 256, (b, t, 64, 64, channels)
                                   ).astype(np.uint8)
    return batch


@pytest.mark.parametrize("case", sorted(ZOO))
def test_zoo_model_on_the_card_matches_the_cpu(cuda_device, case):
    """A B=2 clip forward of each zoo model through make_infer_fn's default
    device: fp32 logits equal the CPU port's; the launches per forward of
    chip_smoke's table."""
    cfg, cpu_model, card_model = _zoo_pair(case)
    name, modality, _, t, n_attn, n_mel = ZOO[case]
    batch = _zoo_batch(case)
    attn, mel = tatt.fused_attention.launches, audio_kernel.mel_frontend.launches
    got = make_infer_fn(cfg, card_model)(batch)
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.shape == (2, 21)
    assert tatt.fused_attention.launches - attn == n_attn
    assert audio_kernel.mel_frontend.launches - mel == n_mel
    want = make_infer_fn(cfg, cpu_model, device="cpu")(batch)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-3, atol=2e-4)


# the zoo's new attention sites at full width, B=8 clips of T=16:
# (batch, tokens, head dim), 8 heads
ZOO_SITES = {"va_head": (8, 2, 32), "vgg_spatial": (128, 16, 32),
             "tformer_au_tokens": (128, 12, 32),
             "tformer_temporal_1536": (8, 17, 64)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("site", sorted(ZOO_SITES))
def test_attention_kernel_at_zoo_sites(cuda_device, site, dtype):
    b, n, d = ZOO_SITES[site]
    q, k, v = _qkv(n, d, b + n, cuda_device, dtype, b=b, layout="to_qkv")
    _check_attention(q, k, v, d ** -0.5)


def test_zoo_sweeps_on_the_card_match_the_cpu(cuda_device):
    """VformerSweep (T=4, dilation 1, bucket 8: 4 attention launches per
    bucket) and sformer's SingleFrameSweep (3 per bucket) on the card
    against the CPU port's, fp32."""
    from auformer_torch.sweep import make_sweep
    frames = _sweep_video(n=20)[0]
    frames = np.repeat(np.repeat(frames, 2, axis=1), 2, axis=2)  # 64x64
    for case, per_bucket, buckets in (("vformer", 4, 3),
                                      ("sformer_au", 3, 3)):
        cfg, cpu_model, card_model = _zoo_pair(case)
        attn = tatt.fused_attention.launches
        got = make_sweep(cfg, card_model).sweep_video(frames, batch=8)
        assert tatt.fused_attention.launches - attn == per_bucket * buckets
        want = make_sweep(cfg, cpu_model, device="cpu").sweep_video(
            frames, batch=8)
        assert got.shape == want.shape == (20, 21)
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("case", CONV_ZOO)
def test_prepare_inference_rounds_conv3d_once(cuda_device, case):
    """Under bf16, prepare_inference rounds every Conv2d, Conv3d and Linear
    weight once; the logits equal, bit for bit, those of f32 weights that
    autocast casts at every call."""
    from auformer_torch.nn.registry import compute_autocast, output_table
    from auformer_torch.ops.audio import audio_frontend
    from auformer_torch.ops.preprocess import normalize_clip
    cfg, _, card_model = _zoo_pair(case, compute_dtype="bfloat16")
    per_call = build_model(cfg)
    per_call.load_state_dict(card_model.state_dict())
    per_call.to(cuda_device).eval()
    batch = _zoo_batch(case)
    got = make_infer_fn(cfg, card_model)(batch)
    convs = (torch.nn.Conv2d, torch.nn.Conv3d, torch.nn.Linear)
    assert all(m.weight.dtype == torch.bfloat16
               for m in card_model.modules() if isinstance(m, convs))
    assert any(isinstance(m, torch.nn.Conv3d) for m in card_model.modules()) \
        == (case in ("i3d", "mc3d", "tsav"))
    x = {}
    if "clip" in batch:
        x["clip"] = normalize_clip(torch.from_numpy(batch["clip"]).to(
            cuda_device))
    if "audio" in batch:
        x["audio_features"] = audio_frontend(
            torch.from_numpy(batch["audio"]).to(cuda_device),
            mel_bf16=cfg.mel_bf16).bfloat16()
    with torch.inference_mode(), compute_autocast(cfg, cuda_device):
        want = output_table(per_call(x).float())
    assert torch.equal(got, want)


def _step_grads(cfg, model, batch, dev):
    """Loss, gradients (before Adam) and state dict of one fp32 train
    step."""
    from auformer_torch.nn import loss_suite
    from auformer_torch.parallel import step as tstep
    state = tstep.create_train_state(cfg, model)
    step = tstep.make_train_step(cfg, model, loss_suite(model))
    grads = {}
    apply = state.apply_gradients

    def capture():
        grads.update({n: p.grad.detach().cpu().clone()
                      for n, p in model.named_parameters()})
        apply()
    state.apply_gradients = capture
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
               for k, v in batch.items()}
    loss = float(step(state, tensors, torch.Generator(dev).manual_seed(0))[
        "loss"])
    return loss, grads, {k: v.cpu() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("case", CONV_ZOO + ("vformer",))
def test_zoo_train_step_on_the_card_matches_the_cpu(cuda_device, case):
    """One fp32 train step (64x64, B=4, dropout 0, left-right symmetric
    clips, host audio features) on the card and on the CPU: the loss and
    the BatchNorm statistics within 2e-3 / 1e-3; each gradient within
    2e-3 of its norm plus 3x the CPU gradient's largest move when the
    weights move by 1e-6 of themselves (3 seeded draws: a ReLU that flips
    within f32 noise of 0 moves a 3-d model's gradients by ~1 %:
    tests/test_torch_zoo_train.py)."""
    name, modality, _, t, _, _ = ZOO[case]
    cfg, cpu_model, card_model = _zoo_pair(case, dropout_rate=0.0,
                                           batch_size=4, learning_rate=1e-3)
    rs = np.random.RandomState(8)
    half = rs.randint(0, 256, (4, t, 64, 32, 3)).astype(np.uint8)
    au = rs.randint(0, 2, (4, 12)).astype(np.int8)
    au[0, 0] = -1
    batch = {"clip": np.concatenate([half, half[:, :, :, ::-1]], axis=3),
             "AU": au, "EX": rs.randint(-1, 7, (4, 1)).astype(np.int8),
             "VA": rs.uniform(-1, 1, (4, 2)).astype(np.float32)}
    if name == "tsav":
        batch["audio_features"] = rs.randn(4, 1, 64, 1001).astype(np.float32)
    weights = {k: v.clone() for k, v in cpu_model.state_dict().items()}
    gen = torch.Generator().manual_seed(9)
    moves = []
    for _ in range(3):
        moved = build_model(cfg)
        moved.load_state_dict({k: v * (1 + 1e-6 * torch.randn(
            v.shape, generator=gen)) if v.is_floating_point() else v
            for k, v in weights.items()})
        moves.append(_step_grads(cfg, moved, batch, "cpu")[1])
    loss_card, g_card, sd_card = _step_grads(cfg, card_model.to(cuda_device),
                                             batch, cuda_device)
    loss_cpu, g_cpu, sd_cpu = _step_grads(cfg, cpu_model, batch, "cpu")
    assert loss_card == pytest.approx(loss_cpu, rel=2e-3, abs=2e-4)
    for key, want in g_cpu.items():
        bound = (2e-3 * want.norm() + 2e-4 * want.numel() ** 0.5
                 + 3 * max((want - g[key]).norm() for g in moves))
        assert (g_card[key] - want).norm() <= bound, key
    for key, want in sd_cpu.items():
        if "running_" in key:
            torch.testing.assert_close(sd_card[key], want, rtol=1e-3,
                                       atol=1e-4)


def test_arena_gather_on_the_card_matches_the_cpu(cuda_device):
    """The wav arena's gather at the train step's shape (B=64 windows of
    441000 samples, some cut short, one on the zero region) on the card
    equals the CPU's, bitwise."""
    from auformer_torch.parallel import step as tstep
    rs = np.random.RandomState(12)
    sample_len = 441000
    arena = (rs.randn(3_000_000) * 0.1).astype(np.float32)
    arena[-sample_len:] = 0.0
    zero_ofs = arena.shape[0] - sample_len
    ofs = rs.randint(0, zero_ofs + 1, 64).astype(np.int32)
    ofs[-1] = zero_ofs
    n_valid = np.where(rs.rand(64) < 0.5, sample_len,
                       rs.randint(882, sample_len, 64)).astype(np.int32)
    args = [torch.from_numpy(a) for a in (arena, ofs, n_valid)]
    want = tstep.gather_arena_windows(*args, sample_len)
    got = tstep.gather_arena_windows(*(a.to(cuda_device) for a in args),
                                     sample_len)
    assert got.device.type == "cuda" and got.shape == (64, sample_len)
    assert torch.equal(got.cpu(), want)


def test_clip_expander_on_the_card_matches_the_cpu(cuda_device):
    """frames[clip_idx] at the train step's shape (a 1,024-slot pool of
    112x112 frames, B=64, T=16) on the card equals the CPU's, bitwise."""
    from auformer_torch.parallel import step as tstep
    rs = np.random.RandomState(13)
    frames = torch.from_numpy(
        rs.randint(0, 256, (1024, 112, 112, 3)).astype(np.uint8))
    clip_idx = torch.from_numpy(rs.randint(0, 1024, (64, 16)).astype(np.int32))
    want = tstep.expand_dedup_batch({"frames": frames, "clip_idx": clip_idx})
    got = tstep.expand_dedup_batch({"frames": frames.to(cuda_device),
                                    "clip_idx": clip_idx.to(cuda_device)})
    assert got["clip"].device.type == "cuda"
    assert got["clip"].shape == (64, 16, 112, 112, 3)
    assert torch.equal(got["clip"].cpu(), want["clip"])


# -- K steps per dispatch: a CUDA graph of the train step ------------------------

def _train_tensors(state) -> dict:
    """Every parameter and BatchNorm statistic, and Adam's moments and step
    counts."""
    out = {f"model.{k}": v.detach().clone()
           for k, v in state.model.state_dict().items()}
    for i, s in state.optimizer.state_dict()["state"].items():
        for name in ("exp_avg", "exp_avg_sq", "step"):
            out[f"adam.{i}.{name}"] = s[name].detach().clone()
    return out


def _k_step_run(cfg, weights, batches, seeds, dev, k=None):
    """The steps of ``batches`` with ``seeds`` from ``weights``, with the
    capturable optimizer: dispatches of ``make_multi_train_step(k)``, or
    (k None) eager single steps. -> (losses, _train_tensors, step_k,
    state)."""
    from auformer_torch.nn import loss_suite
    from auformer_torch.parallel import step as tstep
    model = build_model(cfg)
    model.load_state_dict(weights)
    model.to(dev)
    state = tstep.create_train_state(cfg, model, capturable=True)
    if k is None:
        step = tstep.make_train_step(cfg, model, loss_suite(model))
        gen = torch.Generator(dev)
        losses = torch.stack([step(state, b, gen.manual_seed(s))["loss"]
                              for b, s in zip(batches, seeds)])
        return losses, _train_tensors(state), None, state
    step_k = tstep.make_multi_train_step(cfg, model, loss_suite(model), k)
    losses = []
    for d in range(0, len(batches), k):
        stacked = {key: torch.stack([b[key] for b in batches[d:d + k]])
                   for key in batches[0]}
        losses.append(step_k(state, stacked, seeds[d:d + k])["loss"])
    return torch.cat(losses), _train_tensors(state), step_k, state


def _graph_case(name, dev, seed=20):
    """A 32x32 fp32 config of ``name`` with augmentation and dropout on, its
    seeded weights and 4 batches of B=4 on ``dev``."""
    modality, t = {"avformer": ("A;V", 16), "vformer": ("V", 4)}[name]
    cfg = Config(model_name=name, modality=modality, task="AU", n_frames=t,
                 image_size=32, compute_dtype="float32", batch_size=4,
                 learning_rate=1e-3, device_augment=True)
    torch.manual_seed(seed)
    weights = build_model(cfg).state_dict()
    batches = []
    for i in range(4):
        b = _symmetric_batch(seed + i)
        b["clip"] = np.ascontiguousarray(b["clip"][:, :t])
        batches.append({k: torch.from_numpy(v).to(dev) for k, v in b.items()})
    return cfg, weights, batches, [1000 + i for i in range(4)]


@pytest.fixture
def deterministic():
    """cuDNN's deterministic algorithms and PyTorch's deterministic
    implementations (a warning for an op without one): without them a
    model that trains its convolutions differs run to run, and a few Adam
    steps amplify that past any fixed bound."""
    saved = (torch.backends.cudnn.deterministic,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.backends.cudnn.deterministic = saved[0]
    torch.use_deterministic_algorithms(saved[1], warn_only=saved[2])


def test_max_pool_same_trains_deterministically(cuda_device, deterministic):
    """Under deterministic algorithms ``max_pool_same`` trains through the
    separable route (max_pool3d's CUDA backward scatters with atomics):
    two backward passes of i3d's overlapping pools in bf16 agree bit for
    bit, and on a tie-rich integer input with an integer upstream
    gradient both the values and the input gradient equal
    ``F.max_pool3d``'s."""
    from auformer_torch.nn import blocks
    rs = np.random.RandomState(70)
    for kernel, stride in (((1, 3, 3), (1, 2, 2)), ((3, 3, 3), (1, 1, 1))):
        x = torch.from_numpy(rs.randn(8, 64, 8, 28, 28).astype(
            np.float32)).to(cuda_device, torch.bfloat16)
        grads, g = [], None
        for _ in range(2):
            xt = x.clone().requires_grad_()
            y = blocks.max_pool_same(xt, kernel, stride)
            if g is None:
                g = torch.from_numpy(rs.randn(*y.shape).astype(
                    np.float32)).to(cuda_device, torch.bfloat16)
            y.backward(g)
            grads.append(xt.grad)
        assert torch.equal(grads[0], grads[1])
        x = torch.from_numpy(rs.randint(-3, 3, (2, 8, 6, 15, 15)).astype(
            np.float32)).to(cuda_device)
        g = None
        outs = []
        for route in ("separable", "max_pool3d"):
            xt = x.clone().requires_grad_()
            if route == "separable":
                y = blocks.max_pool_same(xt, kernel, stride)
            else:
                pads = blocks.same_pads(x.shape[2:], kernel, stride)
                xp = F.pad(xt, blocks._torch_pad(pads), value=float("-inf"))
                y = F.max_pool3d(xp, kernel, stride)
            if g is None:
                g = torch.from_numpy(rs.randint(-4, 5, y.shape).astype(
                    np.float32)).to(cuda_device)
            y.backward(g)
            outs.append((y.detach(), xt.grad))
        assert torch.equal(outs[0][0], outs[1][0])
        assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("name", ["avformer", "vformer"])
def test_multi_step_graph_matches_eager_steps(cuda_device, deterministic,
                                              name):
    """2 dispatches of K = 2 (the warm-up, then a capture and its replays)
    against 4 eager steps from the same weights and seeds, with the same
    capturable Adam: losses, parameters, BatchNorm statistics, Adam's
    moments equal wherever two eager runs are equal, else within twice
    their spread. The replays draw the augmentation and dropout masks the
    eager steps draw."""
    cfg, weights, batches, seeds = _graph_case(name, cuda_device)
    eager = [_k_step_run(cfg, weights, batches, seeds, cuda_device)
             for _ in range(2)]
    losses, tensors, step_k, _ = _k_step_run(cfg, weights, batches, seeds,
                                             cuda_device, k=2)
    assert (step_k.captures, step_k.replays) == (1, 2)
    (want_loss, want, _, _), (other_loss, other, _, _) = eager
    pairs = [("loss", losses, want_loss, other_loss)] + [
        (key, tensors[key], value, other[key]) for key, value in want.items()]
    for key, got, value, alt in pairs:
        spread = (value.double() - alt.double()).abs().max()
        if spread == 0:
            assert torch.equal(got, value), key
        else:
            assert (got.double() - value.double()).abs().max() \
                <= 2 * spread, key


def test_multi_step_counts_launches_per_replay(cuda_device):
    """The attention kernel's launches and backward calls count the
    kernels run: the warm-up's eagerly, then the capture's per replay
    (avformer: 11 and 3 per step)."""
    cfg, weights, batches, seeds = _graph_case("avformer", cuda_device)
    before = (tatt.fused_attention.launches,
              tatt.fused_attention.backward_calls)
    _, _, step_k, _ = _k_step_run(cfg, weights, batches, seeds, cuda_device,
                                  k=2)
    torch.cuda.synchronize()
    assert step_k.captured_counts == (11, 3, 0)
    assert (tatt.fused_attention.launches - before[0],
            tatt.fused_attention.backward_calls - before[1]) == (44, 12)


def test_multi_step_capture_that_fails_raises(cuda_device, monkeypatch):
    """A host sync inside the step breaks the capture: the dispatch raises
    naming it, and no step runs in its place."""
    from auformer_torch.parallel import step as tstep
    cfg, weights, batches, seeds = _graph_case("vformer", cuda_device)
    _, _, step_k, state = _k_step_run(cfg, weights, batches[:2], seeds[:2],
                                      cuda_device, k=2)
    task_loss = tstep.task_loss

    def syncing(*args, **kw):
        loss, parts = task_loss(*args, **kw)
        float(loss)
        return loss, parts
    monkeypatch.setattr(tstep, "task_loss", syncing)
    before = {k: v.clone() for k, v in step_k.model.state_dict().items()}
    stacked = {key: torch.stack([b[key] for b in batches[2:]])
               for key in batches[0]}
    with pytest.raises(RuntimeError, match="capturing the train step"):
        step_k(state, stacked, seeds[2:])
    torch.cuda.synchronize()
    assert step_k.graph is None and step_k.captures == 0
    assert state.step == 2
    for key, value in step_k.model.state_dict().items():
        assert torch.equal(value, before[key]), key


@pytest.mark.parametrize("shape", [(720, 1280), (112, 112), (99, 121)])
@pytest.mark.parametrize("layout", ["420", "422"])
def test_yuv_rgb_kernel_matches_plain(cuda_device, shape, layout):
    """The colour conversion kernel equals its plain version bit for bit on
    planar 4:2:0 and 4:2:2 planes with pitched rows."""
    from auformer_torch.ops import colour
    h, w = shape
    cw = (w + 1) // 2
    rs = np.random.RandomState(h + w)
    rows = (h + 1) // 2 if layout == "420" else h
    luma = torch.from_numpy(rs.randint(0, 256, (h, w + 64)).astype(np.uint8))
    chroma = torch.from_numpy(
        rs.randint(0, 256, (rows, 2 * cw + 64)).astype(np.uint8))

    def planes(luma, chroma):
        """Pitched rows: U and V side by side in one buffer."""
        return luma[:, :w], chroma[:, :cw], chroma[:, cw + 32:2 * cw + 32]

    want = colour.yuv_rgb_plain(*planes(luma, chroma))
    before = colour.yuv_rgb.launches
    got = colour.yuv_rgb(*planes(luma.to(cuda_device),
                                 chroma.to(cuda_device)))
    torch.cuda.synchronize()
    assert colour.yuv_rgb.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("shape", [(720, 1280), (96, 112), (90, 120),
                                   (99, 121)])
def test_yuv_rgb_limited_kernel_matches_plain(cuda_device, shape):
    """The kernel's limited-range conversion (MPEG-4 part 2 frames) equals
    its plain version bit for bit on 4:2:0 planes with pitched rows."""
    from auformer_torch.ops import colour
    h, w = shape
    cw, ch = (w + 1) // 2, (h + 1) // 2
    rs = np.random.RandomState(h * w)
    luma = torch.from_numpy(rs.randint(0, 256, (h, w + 32)).astype(np.uint8))
    chroma = torch.from_numpy(
        rs.randint(0, 256, (ch, 2 * cw + 64)).astype(np.uint8))

    def planes(luma, chroma):
        return luma[:, :w], chroma[:, :cw], chroma[:, cw + 32:2 * cw + 32]

    want = colour.yuv_rgb_plain(*planes(luma, chroma), limited=True)
    before = colour.yuv_rgb.launches
    got = colour.yuv_rgb(*planes(luma.to(cuda_device),
                                 chroma.to(cuda_device)), limited=True)
    torch.cuda.synchronize()
    assert colour.yuv_rgb.launches == before + 1
    assert torch.equal(got.cpu(), want)
    assert not torch.equal(want, colour.yuv_rgb_plain(*planes(luma,
                                                              chroma)))


def test_mpeg4_frames_on_the_card(cuda_device):
    """Video.frame_tensors on the card for every MPEG-4 part 2 fixture:
    the port's decoder on the host, the planes copied to the card, the
    kernel's limited-range conversion; each frame's SHA-256 is that of
    cv2's frame (expected.json), one launch a frame, and a seek equals."""
    import hashlib
    import json
    from pathlib import Path

    from auformer_torch.data.video import Video
    from auformer_torch.ops import colour
    d = Path(__file__).parent / "data" / "videos_mpeg4"
    expected = json.loads((d / "expected.json").read_text())
    for name, want in expected.items():
        v = Video(str(d / name), write=False)
        before = colour.yuv_rgb.launches
        frames = [t.cpu().numpy() for t in v.frame_tensors(cuda_device)]
        assert colour.yuv_rgb.launches == before + len(frames)
        assert [hashlib.sha256(f.tobytes()).hexdigest()
                for f in frames] == want["frames_sha256"], name
        img = v.read_RGB(13, device=cuda_device)
        assert hashlib.sha256(img.tobytes()).hexdigest() == \
            want["read_RGB_sha256"]["13"], name


def test_xvid_frames_on_the_card(cuda_device):
    """libxvid's streams of tests/data/videos_mpeg4/ (XviD's inverse DCT,
    packed B-VOPs, quarter-pel) on the card: the host decoder's planes
    copied to the card equal libavcodec's (expected.json's planes_sha256),
    every frame of Video.frame_tensors equals cv2's with one yuv_rgb launch
    a frame, and every seek of expected.json equals cv2's."""
    import hashlib
    import json
    from pathlib import Path

    from auformer_torch.data import mpeg4
    from auformer_torch.data.video import Video
    from auformer_torch.ops import colour

    def sha(a) -> str:
        return hashlib.sha256(a.tobytes()).hexdigest()

    d = Path(__file__).parent / "data" / "videos_mpeg4"
    expected = {name: want for name, want in
                json.loads((d / "expected.json").read_text()).items()
                if "planes_sha256" in want}
    assert len(expected) == 6
    for name, want in expected.items():
        path = str(d / name)
        planes = [[sha(p.cpu().numpy()) for p in yuv] for _, yuv, _ in
                  mpeg4.decode_range(path, device=cuda_device)]
        assert planes == [[p["y"], p["u"], p["v"]]
                          for p in want["planes_sha256"]], name
        v = Video(path, write=False)
        before = colour.yuv_rgb.launches
        frames = [t.cpu().numpy() for t in v.frame_tensors(cuda_device)]
        assert colour.yuv_rgb.launches == before + len(frames)
        assert [sha(f) for f in frames] == want["frames_sha256"], name
        for k, digest in want["read_RGB_sha256"].items():
            img = v.read_RGB(int(k), device=cuda_device)
            assert (None if img is None else sha(img)) == digest, (name, k)


@pytest.mark.parametrize("matrix,limited", [(1, True), (4, True),
                                            (7, True), (9, True),
                                            (2, False), (1, False)])
def test_yuv_rgb_matrix_kernel_matches_plain(cuda_device, matrix, limited):
    """The kernel with an H.264 stream's colour matrix and range equals its
    plain version bit for bit on 4:2:0 planes with pitched rows."""
    from auformer_torch.ops import colour
    h, w = 90, 121
    cw, ch = (w + 1) // 2, (h + 1) // 2
    rs = np.random.RandomState(matrix)
    luma = torch.from_numpy(rs.randint(0, 256, (h, w + 32)).astype(np.uint8))
    chroma = torch.from_numpy(
        rs.randint(0, 256, (ch, 2 * cw + 64)).astype(np.uint8))

    def planes(luma, chroma):
        return luma[:, :w], chroma[:, :cw], chroma[:, cw + 32:2 * cw + 32]

    want = colour.yuv_rgb_plain(*planes(luma, chroma), limited, matrix)
    got = colour.yuv_rgb(*planes(luma.to(cuda_device),
                                 chroma.to(cuda_device)), limited, matrix)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("matrix,limited", [(2, True), (1, True),
                                            (2, False), (1, False)])
def test_yuv_rgb_444_kernel_matches_plain(cuda_device, matrix, limited):
    """The kernel's 4:4:4 route (swscale's full-chroma arithmetic, its
    32-bit sums wrapping) equals its plain version bit for bit on pitched
    4:4:4 planes holding every (U, V) pair, under random luma and a row of
    luma 255."""
    from auformer_torch.ops import colour
    h, w = 256, 259
    rs = np.random.RandomState(matrix + 10 * limited)
    luma = rs.randint(0, 256, (h, w + 32)).astype(np.uint8)
    luma[-1] = 255
    cols = np.arange(w) % 256
    chroma = np.zeros((h, 2 * w + 64), np.uint8)
    chroma[:, :w] = cols[None, :]
    chroma[:, w + 32:2 * w + 32] = np.arange(h)[:, None]

    def planes(luma, chroma):
        return luma[:, :w], chroma[:, :w], chroma[:, w + 32:2 * w + 32]

    luma, chroma = torch.from_numpy(luma), torch.from_numpy(chroma)
    want = colour.yuv_rgb_plain(*planes(luma, chroma), limited, matrix)
    before = colour.yuv_rgb.launches
    got = colour.yuv_rgb(*planes(luma.to(cuda_device),
                                 chroma.to(cuda_device)), limited, matrix)
    torch.cuda.synchronize()
    assert colour.yuv_rgb.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("depth", [10, 9, 12, 14])
@pytest.mark.parametrize("layout", [(1, 1), (0, 1), (0, 0)],
                         ids=["420", "422", "444"])
@pytest.mark.parametrize("matrix,limited", [(2, True), (1, True),
                                            (2, False), (9, False)])
def test_yuv_rgb_deep_kernel_matches_plain(cuda_device, depth, layout,
                                           matrix, limited):
    """The kernel's high-depth route (swscale's scaler: the bicubic chroma
    taps across and down, the packed outputs of the rows above the last
    two and of the last two) equals its plain version bit for bit on
    pitched int16 planes of random samples, both ends among them, at
    1280x720 and at a small odd-rowed frame."""
    from auformer_torch.ops import colour
    v_shift, h_shift = layout
    rs = np.random.RandomState(depth + matrix)
    for h, w in ((720, 1280), (37, 40)):
        ch, cw = -(-h >> v_shift), -(-w >> h_shift)
        top = (1 << depth) - 1
        luma = rs.randint(0, top + 1, (h, w + 16)).astype(np.int16)
        luma[0, :8] = top
        chroma = rs.randint(0, top + 1, (ch, 2 * cw + 32)).astype(np.int16)
        chroma[-1, :8] = 0

        def planes(luma, chroma):
            return luma[:, :w], chroma[:, :cw], chroma[:, cw + 16:2 * cw + 16]

        luma, chroma = torch.from_numpy(luma), torch.from_numpy(chroma)
        want = colour.yuv_rgb_plain(*planes(luma, chroma), limited, matrix,
                                    depth)
        before = colour.yuv_rgb.launches
        got = colour.yuv_rgb(*planes(luma.to(cuda_device),
                                     chroma.to(cuda_device)), limited,
                             matrix, depth)
        torch.cuda.synchronize()
        assert colour.yuv_rgb.launches == before + 1
        assert torch.equal(got.cpu(), want), (h, w)


@pytest.mark.parametrize("chroma_loc", range(7))
@pytest.mark.parametrize("layout", [(1, 1), (0, 1)], ids=["420", "422"])
def test_yuv_rgb_deep_kernel_sitings(cuda_device, chroma_loc, layout):
    """The high-depth route's filters for each chroma siting (unspecified,
    then the six of AVChromaLocation): the kernel equals its plain version
    on 10-bit 1280x720 planes."""
    from auformer_torch.ops import colour
    v_shift, _ = layout
    rs = np.random.RandomState(chroma_loc)
    h, w = 720, 1280
    c = (h >> v_shift, w // 2)
    planes = [torch.from_numpy(rs.randint(0, 1024, s).astype(np.int16))
              for s in ((h, w), c, c)]
    want = colour.yuv_rgb_plain(*planes, True, 2, 10, chroma_loc)
    got = colour.yuv_rgb(*[p.to(cuda_device) for p in planes], True, 2, 10,
                         chroma_loc)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def test_h264_frames_on_the_card(cuda_device):
    """Video.frame_tensors on the card for every H.264 fixture the decoder
    takes: the port's decoder on the host, the planes copied to the card,
    the kernel with the stream's colour matrix and range; each frame's
    SHA-256 is that of cv2's frame (expected.json), one launch a frame."""
    import hashlib
    import json
    from pathlib import Path

    from auformer_torch.data.video import Video
    from auformer_torch.ops import colour
    d = Path(__file__).parent / "data" / "videos_h264"
    expected = json.loads((d / "expected.json").read_text())
    for name, want in expected.items():
        if "planes_sha256" not in want:
            continue
        v = Video(str(d / name), write=False)
        before = colour.yuv_rgb.launches
        frames = [t.cpu().numpy() for t in v.frame_tensors(cuda_device)]
        assert colour.yuv_rgb.launches == before + len(frames)
        assert [hashlib.sha256(f.tobytes()).hexdigest()
                for f in frames] == want["frames_sha256"], name


def test_mjpeg_frames_on_the_card(cuda_device):
    """Video.frames on the card: nvJPEG's planes through the kernel equal
    the plain conversion of the same planes, and the frames stay within
    the CPU tests' tolerance of the JAX package's (mjpg_112.npz)."""
    from pathlib import Path

    from auformer_torch.data import container, native
    from auformer_torch.data.video import Video
    from auformer_torch.ops import colour
    d = Path(__file__).parent / "data" / "videos_decode"
    v = Video(str(d / "mjpg_112.avi"), write=False)
    before = colour.yuv_rgb.launches
    frames = [t.cpu() for t in v.frame_tensors(cuda_device)]
    assert colour.yuv_rgb.launches == before + len(frames) == before + 12
    want = np.load(d / "mjpg_112.npz")["frames"]
    diff = np.abs(np.stack([f.numpy() for f in frames]).astype(int)
                  - want.astype(int))
    assert diff.max() <= 3 and diff.mean() <= 0.1
    _, unit = next(container.access_units(str(d / "mjpg_112.avi")))
    h, w, layout = native.jpeg_info(unit, "nvjpeg")
    planes = [torch.empty(s, dtype=torch.uint8, device=cuda_device)
              for s in ((h, w), ((h + 1) // 2, (w + 1) // 2),
                        ((h + 1) // 2, (w + 1) // 2))]
    native.decode_jpeg_yuv(unit, *[p.data_ptr() for p in planes], h, w,
                           layout, torch.cuda.current_stream().cuda_stream,
                           "nvjpeg")
    torch.cuda.synchronize()
    assert torch.equal(frames[0], colour.yuv_rgb_plain(
        *[p.cpu() for p in planes]))
    assert np.array_equal(v.read_RGB(7, device=cuda_device),
                          frames[7].numpy())


def test_nvdec_caps_answer_or_name_the_refusal(cuda_device):
    """NVDEC's caps: a yes for H.264 where the driver exposes the decoder,
    else an error naming cuvidGetDecoderCaps and its CUresult."""
    from auformer_torch.data import nvdec
    try:
        caps = nvdec.caps("h264")
    except RuntimeError as e:
        assert "cuvidGetDecoderCaps returned CUresult" in str(e)
    else:
        assert caps["supported"] == 1 and caps["output_formats"] & 1
