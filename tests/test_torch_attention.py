"""auformer_torch attention against the JAX package.

The port's plain version ``attention_reference`` is held against the JAX
XLA path and against the Pallas kernel body run in interpret mode, at the
avformer shapes (spatial 49/32, temporal 17/64, AU 12/32). The CUDA kernel
is held against the plain version on the card in tests/test_torch_cuda.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from auformer.ops import attention as jatt
from auformer_torch.ops import attention as tatt

SHAPES = [(49, 32), (17, 64), (12, 32)]
RTOL, ATOL = 1e-4, 1e-5
# bf16 outputs: both sides round the same f32 result, so they differ by at
# most one bf16 ulp (2**-7 relative) where the f32 sums straddle a rounding
# boundary
BF16_RTOL, BF16_ATOL = 1e-2, 1e-3


def _qkv(n, d, seed, b=2, h=8):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, h, n, d).astype(np.float32) for _ in range(3)]


def _pallas_interpret(q, k, v, scale, dtype=jnp.float32):
    b, h, n, d = q.shape
    bh, g = b * h, 8
    spec = pl.BlockSpec((g, n, d), lambda i: (i, 0, 0))
    out = pl.pallas_call(
        functools.partial(jatt._attn_kernel, scale=scale),
        out_shape=jax.ShapeDtypeStruct((bh, n, d), dtype),
        grid=(bh // g,), in_specs=[spec, spec, spec], out_specs=spec,
        interpret=True,
    )(*(jnp.asarray(t.reshape(bh, n, d), dtype) for t in (q, k, v)))
    return np.asarray(out.astype(jnp.float32)).reshape(b, h, n, d)


@pytest.mark.parametrize("n,d", SHAPES)
def test_reference_matches_xla_attention(n, d):
    q, k, v = _qkv(n, d, 0)
    scale = d ** -0.5
    want = np.asarray(jatt._xla_attention(q, k, v, scale))
    got = tatt.attention_reference(*map(torch.from_numpy, (q, k, v)), scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,d", SHAPES)
def test_reference_matches_pallas_kernel_interpret(n, d):
    q, k, v = _qkv(n, d, 1)
    scale = d ** -0.5
    want = _pallas_interpret(q, k, v, scale)
    got = tatt.attention_reference(*map(torch.from_numpy, (q, k, v)), scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,d", SHAPES)
def test_bf16_reference_matches_pallas_kernel_interpret(n, d):
    """In bf16 the port follows the Pallas kernel (f32 P.V, one rounding of
    the output), not ``_xla_attention`` (P cast to bf16 before P.V)."""
    q, k, v = _qkv(n, d, 2)
    scale = d ** -0.5
    want = _pallas_interpret(q, k, v, scale, jnp.bfloat16)
    got = tatt.attention_reference(
        *(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)), scale)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_RTOL,
                               atol=BF16_ATOL)


def test_reference_mask_matches_xla_attention():
    rs = np.random.RandomState(3)
    q = rs.randn(2, 4, 8, 16).astype(np.float32)
    mask = np.ones((2, 8), bool)
    mask[0, 5:] = False
    want = np.asarray(jatt._xla_attention(q, q, q, 0.25, mask))
    qt = torch.from_numpy(q)
    got = tatt.attention_reference(qt, qt, qt, 0.25, torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_fused_attention_on_cpu_takes_the_plain_version():
    q, k, v = map(torch.from_numpy, _qkv(12, 32, 4, b=1))
    before = tatt.fused_attention.launches
    out = tatt.fused_attention(q, k, v, 0.2)
    torch.testing.assert_close(out, tatt.attention_reference(q, k, v, 0.2),
                               rtol=0, atol=0)
    assert tatt.fused_attention.launches == before


def _to_qkv_views(b, n, h, d, dtype=torch.float32, seed=5):
    """The head split ``Attention.forward`` hands over: (B, H, N, D) views
    of one fused (B, N, 3 * H * D) projection."""
    rs = np.random.RandomState(seed)
    qkv = torch.from_numpy(rs.randn(b, n, 3 * h * d).astype(np.float32)
                           ).to(dtype)
    return qkv, qkv.reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", SHAPES + [(129, 64), (1, 8)])
def test_kernel_takes_the_to_qkv_views_in_place(n, d, dtype):
    """The kernel reads the head split where it lies: three views of one
    storage, k and v H * D elements apart, tokens 3 * H * D apart."""
    qkv, (q, k, v) = _to_qkv_views(2, n, 8, d, dtype)
    assert not q.is_contiguous()
    assert q.data_ptr() == qkv.data_ptr()
    assert k.data_ptr() - q.data_ptr() == 8 * d * qkv.element_size()
    assert q.stride() == (n * 3 * 8 * d, d, 3 * 8 * d, 1)
    tatt.check_kernel_inputs(q, k, v)
    tatt.check_kernel_inputs(*(t.contiguous() for t in (q, k, v)))


def test_kernel_inputs_rejected_as_the_kernel_would():
    _, (q, k, v) = _to_qkv_views(2, 12, 8, 32)
    bad = {
        "stride(-1) != 1": (q.transpose(2, 3), k, v),
        "shape": (q[:, :, :11], k, v),
        "N > 144": tuple(torch.zeros(1, 1, 145, 32) for _ in range(3)),
        "D not a multiple of 8": tuple(torch.zeros(1, 1, 12, 12)
                                       for _ in range(3)),
        "D > 64": tuple(torch.zeros(1, 1, 12, 72) for _ in range(3)),
        "misaligned pointer": (torch.zeros(2 * 8 * 12 * 32 + 1)[1:].view(
            2, 8, 12, 32), k, v),
        "misaligned token rows": tuple(
            torch.zeros(1, 12, 3 * 8 + 1)[..., :8].unsqueeze(1)
            for _ in range(3)),
    }
    for why, args in bad.items():
        with pytest.raises(ValueError):
            tatt.check_kernel_inputs(*args)
            pytest.fail(why)
    with pytest.raises(TypeError):
        tatt.check_kernel_inputs(q, k.to(torch.bfloat16), v)
    with pytest.raises(TypeError):
        tatt.check_kernel_inputs(q.half(), k.half(), v.half())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_output_is_a_view_of_tokens_first_storage(dtype):
    """``fused_attention`` returns (B, H, N, D) laid out as (B, N, H, D),
    on the CPU as the kernel writes it on the card: merging the heads is a
    view, and the values are the plain version's."""
    _, (q, k, v) = _to_qkv_views(2, 17, 8, 64, dtype)
    out = tatt.fused_attention(q, k, v, 0.125)
    assert out.shape == q.shape and out.dtype == dtype
    assert out.transpose(1, 2).is_contiguous()
    merged = out.transpose(1, 2).reshape(2, 17, -1)
    assert merged.data_ptr() == out.data_ptr()
    torch.testing.assert_close(out, tatt.attention_reference(q, k, v, 0.125),
                               rtol=0, atol=0)
    assert tatt.output_buffer(q).transpose(1, 2).is_contiguous()
