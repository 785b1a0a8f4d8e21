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
