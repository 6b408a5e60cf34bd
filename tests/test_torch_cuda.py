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


# ------------------------------------------------------------ quantization
# The wire contract: q, scales, deq and the residual bit-equal to the plain
# versions on the same inputs (IEEE division, round half to even, no FMA
# contraction in the kernels; the plain versions divide by a tensor, never
# by a host scalar, which CUDA torch would turn into a reciprocal multiply).

QUANT_CASES = [(n, block) for n in (1, 255, 1024, 5000, (1 << 20) + 3)
               for block in (64, 256, 1024)] + [(5000, 100), (20000, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,block", QUANT_CASES)
@pytest.mark.parametrize("bits", (8, 4))
def test_ef_quantize_kernel_bit_equal_on_card(cuda_device, n, block, bits):
    g = torch.randn(n, device=cuda_device)
    e = 0.01 * torch.randn(n, device=cuda_device)
    before = ops.launch_counts()["ef_quantize_bucketize"]
    got = ops.ef_quantize_bucketize(g, e, block=block, bits=bits)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ef_quantize_bucketize"] == before + 1
    want = ref.ef_quantize_bucketize_ref(g, e, block=block, bits=bits)
    assert got[4] == want[4] == n
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.cuda
def test_ef_quantize_kernel_unaligned_view_on_card(cuda_device):
    """A view that starts 4 bytes into its storage is copied to an aligned
    buffer before the launch."""
    g = torch.randn(4097, device=cuda_device)[1:]
    e = torch.randn(4097, device=cuda_device)[1:] * 0.01
    got = ops.ef_quantize_bucketize(g, e, block=1024)
    want = ref.ef_quantize_bucketize_ref(g, e, block=1024)
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("block", (6, 8192))
def test_quant_kernels_reject_unsupported_block_on_card(cuda_device, block):
    """The kernels keep a block in registers: a multiple of 4 up to 4096."""
    g = torch.randn(20000, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 4 up to 4096"):
        ops.ef_quantize_bucketize(g, g, block=block)
    with pytest.raises(ValueError, match="multiple of 4 up to 4096"):
        ops.quantize_blocks(g, block=block)


@pytest.mark.cuda
@pytest.mark.parametrize("n,block", QUANT_CASES)
@pytest.mark.parametrize("bits", (8, 4))
def test_quantize_blocks_kernel_bit_equal_on_card(cuda_device, n, block, bits):
    x = torch.randn(n, device=cuda_device)
    got = ops.quantize_blocks(x, block=block, bits=bits)
    want = ref.quantize_blocks_ref(x, block=block, bits=bits)
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n,block", QUANT_CASES)
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_dequant_add_kernel_bit_equal_on_card(cuda_device, n, block, dtype):
    q, s, _ = ref.quantize_blocks_ref(torch.randn(n, device=cuda_device), block=block)
    acc = torch.randn(q.shape[0], device=cuda_device).to(dtype)
    got = ops.dequant_add(q, s, acc, block=block)
    assert got.dtype == dtype and torch.equal(got, ref.dequant_add_ref(q, s, acc, block=block))


# ------------------------------------------ gradients through the kernels
# The kernels' autograd Functions: the kernel's forward, the plain version's
# vector-Jacobian product.  Grads equal those of autograd through the plain
# version on the same inputs; forward outputs differ as the kernels' tests
# above allow.

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
def test_rmsnorm_gradient_through_kernel_on_card(cuda_device, dtype):
    x = torch.randn(64, 1536, device=cuda_device).to(dtype).requires_grad_()
    w = (1 + 0.1 * torch.randn(1536, device=cuda_device)).requires_grad_()
    dy = torch.randn(64, 1536, device=cuda_device).to(dtype)
    before = ops.launch_counts()["rmsnorm"]
    y = ops.rmsnorm(x, w)
    assert y.grad_fn is not None and ops.launch_counts()["rmsnorm"] == before + 1
    got = torch.autograd.grad(y, (x, w), dy)
    want = torch.autograd.grad(ref.rmsnorm_ref(x, w), (x, w), dy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
def test_attention_gradient_through_kernel_on_card(cuda_device, dtype):
    q, k, v = (torch.randn(2, 64, h, 128, device=cuda_device).to(dtype).requires_grad_()
               for h in (12, 2, 2))
    do = torch.randn(2, 64, 12, 128, device=cuda_device).to(dtype)
    o = ops.flash_attention(q, k, v, causal=True)
    assert o.grad_fn is not None
    got = torch.autograd.grad(o, (q, k, v), do)
    want = torch.autograd.grad(ref.flash_attention_ref(q, k, v, causal=True), (q, k, v), do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_model_gradients_on_card_match_cpu(cuda_device):
    """Every param gets a gradient through the kernels, equal to the CPU's
    plain path in f32 within 1e-4 of the largest gradient (summation order)."""
    from repro_torch.configs import registry
    from repro_torch.models import api as mapi
    from repro_torch.models import transformer
    from repro_torch.tree import leaves, map_tensors, parts

    cfg = registry.get("qwen2-1.5b", smoke=True)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 33), generator=torch.Generator().manual_seed(1))
    grads = {}
    for dev in ("cpu", cuda_device):
        tree = map_tensors(lambda t: t.detach().to(dev).requires_grad_(), params)
        flat = [t for leaf in leaves(tree) for t in parts(leaf)]
        api = mapi.get_api(cfg, compute_dtype=torch.float32, device=dev, remat="full")
        batch = {"tokens": tokens[:, :-1].to(dev), "labels": tokens[:, 1:].to(dev)}
        loss, _ = api.loss(tree, batch)
        grads[str(dev)] = [g.cpu() for g in torch.autograd.grad(loss, flat)]
    cpu, card = grads["cpu"], grads[str(cuda_device)]
    scale = max(float(g.abs().max()) for g in cpu)
    for a, b in zip(card, cpu):
        assert a is not None and torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4 * scale)
