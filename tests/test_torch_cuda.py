"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests import no jax (the GPU host has none) and skip without a card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""

import math

import pytest
import torch

from repro_torch.kernels import ops, ref

# f32: summation order only.  bf16: the outputs round separately from the
# same f32 math, one bf16 ulp is 2^-8 relative (3.9e-3), 1e-2 allows two.
RMS_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(7, 64), (1024, 1536), (4, 1536), (3, 100)])
@pytest.mark.parametrize("dtype,wdtype", [(torch.bfloat16, torch.float32),
                                          (torch.float32, torch.float32),
                                          (torch.bfloat16, torch.bfloat16)])
def test_rmsnorm_kernel_matches_plain_on_card(cuda_device, shape, dtype, wdtype):
    x = torch.randn(shape, device=cuda_device).to(dtype)
    w = torch.randn(shape[-1], device=cuda_device).to(wdtype)
    before = ops.launch_counts()["rmsnorm"]
    got = ops.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rmsnorm"] == before + 1
    tol = RMS_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.rmsnorm_ref(x, w).float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,smax,h,kh,d,q_offset,kv_len,window", [
    (4, 256, 256, 12, 2, 128, 0, 256, None),    # prefill
    (4, 1, 512, 12, 2, 128, 299, 300, None),    # decode
    (4, 256, 256, 12, 2, 128, 0, 256, 64),      # windowed prefill
    (2, 37, 80, 4, 2, 64, 11, 48, None),        # ragged, prefill into a cache
    (1, 3, 16, 4, 4, 32, 0, 3, 2),              # smoke head_dim, MHA
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_kernel_matches_plain_on_card(cuda_device, b, sq, smax, h, kh, d,
                                                q_offset, kv_len, window, dtype):
    q = torch.randn(b, sq, h, d, device=cuda_device).to(dtype)
    k = torch.randn(b, smax, kh, d, device=cuda_device).to(dtype)
    v = torch.randn(b, smax, kh, d, device=cuda_device).to(dtype)
    kw = dict(causal=True, q_offset=q_offset, kv_len=kv_len, window=window)
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, **kw)
    # bf16 outputs round separately (2 ulps of O(1) values); f32 differs in
    # summation order only
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert math.isfinite(float(got.float().abs().max()))
