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


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each |v| (8 significant bits)."""
    v = v.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(v)) - 7)


def _assert_rmsnorm_close(got, want):
    """bf16: within one bf16 ulp of the plain version per element (the same
    f32 math rounds once on each side); f32: within 1e-5 relative."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.bfloat16:
        diff = (got.float() - want.float()).abs()
        assert bool((diff <= _bf16_ulp(want)).all()), float((diff / _bf16_ulp(want)).max())
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


# rows 1, the decode rows 4 and either side of the kernel's 132-row threshold
# (a block per row up to it, warps per row above), a prefill; the models'
# widths, one that is not a multiple of the 16-byte vector, and either side
# of the widest row held in registers (3,072 vectors: 24,576 bf16 values)
@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4, 132, 133, 1024])
@pytest.mark.parametrize("d", [1536, 2560, 5120, 1000 + 3, 24576, 24576 + 8])
@pytest.mark.parametrize("dtype,wdtype", [(torch.bfloat16, torch.float32),
                                          (torch.bfloat16, torch.bfloat16),
                                          (torch.float32, torch.float32),
                                          (torch.float32, torch.bfloat16)])
def test_rmsnorm_kernel_within_one_ulp_on_card(cuda_device, n, d, dtype, wdtype):
    gen = torch.Generator(device=cuda_device).manual_seed(n * 7 + d)
    x = torch.randn(n, d, device=cuda_device, generator=gen).to(dtype)
    w = (1.0 + 0.1 * torch.randn(d, device=cuda_device, generator=gen)).to(wdtype)
    before = ops.launch_counts()["rmsnorm"]
    got = ops.rmsnorm(x, w)
    again = ops.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rmsnorm"] == before + 2
    assert torch.equal(got, again)
    _assert_rmsnorm_close(got, ref.rmsnorm_ref(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [1, 2])
@pytest.mark.parametrize("n,d", [(4, 1536), (1024, 2560), (200, 5120), (3, 128), (70, 256)])
def test_rmsnorm_both_row_layouts_on_card(cuda_device, layout, n, d):
    """A block per row (1) and warps per row (2) at any row count; both sum
    in one order (each lane's running sum over vectors l, l + 32, ..., then
    a butterfly), so they agree to the bit with the kernel's own choice."""
    from repro_torch.kernels import rmsnorm as rms
    x = torch.randn(n, d, device=cuda_device).to(torch.bfloat16)
    w = 1.0 + 0.1 * torch.randn(d, device=cuda_device)
    got = rms._launch(x, w, 1e-6, layout=layout)
    _assert_rmsnorm_close(got, ref.rmsnorm_ref(x, w))
    assert torch.equal(got, rms._launch(x, w, 1e-6))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rmsnorm_unaligned_view_on_card(cuda_device, dtype):
    """A view that starts 2 or 4 bytes into its storage takes the generic
    kernel; w a view as well."""
    x = torch.randn(4 * 1536 + 1, device=cuda_device).to(dtype)[1:].view(4, 1536)
    w = torch.randn(1537, device=cuda_device)[1:]
    _assert_rmsnorm_close(ops.rmsnorm(x, w), ref.rmsnorm_ref(x, w))


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


# ----------------------------------------------------------------- ssd scan
# The kernel against its plain version (ssd_chunked_ref) on the same inputs:
# the same f32 math in another summation order over up to 128-step chunks
# and a carried state.  |err| <= SSD_TOL * (1 + |want|) on y and on the final
# state, as in chip_smoke.py: sound kernels read ~1e-6, outputs stored in
# bf16 read ~2e-3 (the reference's own kernel tolerance).
SSD_TOL = 1e-4

SSD_CASES = [
    (4, 256, 80, 64, 64, 128),    # serving prefill
    (4, 200, 80, 64, 64, 128),    # ragged last chunk
    (2, 37, 8, 32, 16, 16),       # smoke dims, ragged
    (1, 5, 2, 16, 16, 128),       # a prompt shorter than a chunk
    (3, 130, 4, 64, 32, 64),
]


def _ssd_inputs(device, b, s, h, p, n, dtype, strided):
    """x, B, C as the Mamba block hands them over: slices of one conv
    output when ``strided``."""
    gen = torch.Generator(device=device).manual_seed(b * 1000 + s)
    conv = torch.randn(b, s, h * p + 2 * n, device=device, generator=gen).to(dtype)
    if strided:
        x = conv[..., :h * p].reshape(b, s, h, p)
        bm, cm = conv[..., h * p:h * p + n], conv[..., h * p + n:]
    else:
        x = conv[..., :h * p].reshape(b, s, h, p).contiguous()
        bm, cm = conv[..., h * p:h * p + n].contiguous(), conv[..., h * p + n:].contiguous()
    dt = torch.rand(b, s, h, device=device, generator=gen) * 0.19 + 0.01
    a = -(torch.rand(h, device=device, generator=gen) * 1.5 + 0.5)
    return x, dt, a, bm, cm


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("strided", [True, False])
def test_ssd_scan_kernel_matches_plain_on_card(cuda_device, b, s, h, p, n, chunk, dtype,
                                               strided):
    inputs = _ssd_inputs(cuda_device, b, s, h, p, n, dtype, strided)
    before = ops.launch_counts()["ssd_scan"]
    y, state = ops.ssd_scan(*inputs, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_scan"] == before + 1
    want_y, want_state = ref.ssd_chunked_ref(*inputs, chunk=chunk)
    assert y.shape == (b, s, h, p) and state.shape == (b, h, n, p)
    torch.testing.assert_close(y, want_y, rtol=SSD_TOL, atol=SSD_TOL)
    torch.testing.assert_close(state, want_state, rtol=SSD_TOL, atol=SSD_TOL)


@pytest.mark.cuda
def test_ssd_scan_kernel_matches_sequential_oracle_on_card(cuda_device):
    inputs = _ssd_inputs(cuda_device, 2, 70, 3, 32, 16, torch.float32, True)
    for got, want in zip(ops.ssd_scan(*inputs, chunk=32), ref.ssd_ref(*inputs)):
        torch.testing.assert_close(got, want, rtol=SSD_TOL, atol=SSD_TOL)


@pytest.mark.cuda
def test_ssd_scan_rejects_unsupported_shapes_on_card(cuda_device):
    x, dt, a, bm, cm = _ssd_inputs(cuda_device, 1, 8, 2, 48, 16, torch.float32, False)
    with pytest.raises(ValueError, match="head_dim 48"):
        ops.ssd_scan(x, dt, a, bm, cm)
    x, dt, a, bm, cm = _ssd_inputs(cuda_device, 1, 300, 2, 16, 16, torch.float32, False)
    with pytest.raises(ValueError, match="chunk 256"):
        ops.ssd_scan(x, dt, a, bm, cm, chunk=256)


@pytest.mark.cuda
def test_ssd_scan_gradient_through_kernel_on_card(cuda_device):
    inputs = [t.detach().requires_grad_() for t in
              _ssd_inputs(cuda_device, 2, 40, 4, 32, 16, torch.float32, False)]
    y, state = ops.ssd_scan(*inputs, chunk=16)
    assert y.grad_fn is not None
    gy, gs = torch.randn_like(y), torch.randn_like(state)
    got = torch.autograd.grad((y, state), inputs, (gy, gs))
    want = torch.autograd.grad(ref.ssd_chunked_ref(*inputs, chunk=16), inputs, (gy, gs))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# The tensor-core kernel (bf16 inputs): every head and state dim, chunks that
# divide its 64-step tiles and chunks that do not, ragged S, strided views of
# one conv output; against the chunked plain version at the caller's chunk and
# the sequential recurrence, and two calls bit-equal.
@pytest.mark.cuda
@pytest.mark.parametrize("p", [16, 32, 64])
@pytest.mark.parametrize("n", [16, 32, 64])
def test_ssd_scan_bf16_dims_on_card(cuda_device, p, n):
    inputs = _ssd_inputs(cuda_device, 2, 150, 3, p, n, torch.bfloat16, True)
    y, state = ops.ssd_scan(*inputs, chunk=128)
    torch.cuda.synchronize()
    for got, want in zip((y, state), ref.ssd_chunked_ref(*inputs, chunk=128)):
        torch.testing.assert_close(got, want, rtol=SSD_TOL, atol=SSD_TOL)
    for got, want in zip((y, state), ref.ssd_ref(*inputs)):
        torch.testing.assert_close(got, want, rtol=SSD_TOL, atol=SSD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [16, 17, 64, 128])
@pytest.mark.parametrize("s", [256, 200, 63, 1])
def test_ssd_scan_bf16_chunks_on_card(cuda_device, chunk, s):
    inputs = _ssd_inputs(cuda_device, 2, s, 4, 64, 64, torch.bfloat16, True)
    before = ops.launch_counts()["ssd_scan"]
    got = ops.ssd_scan(*inputs, chunk=chunk)
    again = ops.ssd_scan(*inputs, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_scan"] == before + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    for g, w in zip(got, ref.ssd_chunked_ref(*inputs, chunk=chunk)):
        torch.testing.assert_close(g, w, rtol=SSD_TOL, atol=SSD_TOL)
    for g, w in zip(got, ref.ssd_ref(*inputs)):
        torch.testing.assert_close(g, w, rtol=SSD_TOL, atol=SSD_TOL)


@pytest.mark.cuda
def test_ssd_scan_bf16_serving_prefill_on_card(cuda_device):
    """The serving prefill [4, 256, 80, 64] as the Mamba block hands it over."""
    inputs = _ssd_inputs(cuda_device, 4, 256, 80, 64, 64, torch.bfloat16, True)
    got = ops.ssd_scan(*inputs, chunk=128)
    torch.cuda.synchronize()
    for g, w in zip(got, ref.ssd_chunked_ref(*inputs, chunk=128)):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, rtol=SSD_TOL, atol=SSD_TOL)


@pytest.mark.cuda
def test_ssd_scan_bf16_unaligned_views_are_copied_on_card(cuda_device):
    """Rows that do not start on 16 bytes (a conv output one value wider)
    are copied before the launch; the result is the same function."""
    b, s, h, p, n = 2, 70, 3, 32, 16
    conv = torch.randn(b, s, h * p + 2 * n + 1, device=cuda_device).to(torch.bfloat16)
    x = conv[..., 1:1 + h * p].reshape(b, s, h, p)
    bm, cm = conv[..., 1 + h * p:1 + h * p + n], conv[..., 1 + h * p + n:]
    dt = torch.rand(b, s, h, device=cuda_device) * 0.19 + 0.01
    a = -(torch.rand(h, device=cuda_device) * 1.5 + 0.5)
    got = ops.ssd_scan(x, dt, a, bm, cm, chunk=32)
    for g, w in zip(got, ref.ssd_chunked_ref(x, dt, a, bm, cm, chunk=32)):
        torch.testing.assert_close(g, w, rtol=SSD_TOL, atol=SSD_TOL)


# zamba2's shared block: head_dim 80, MHA (H = K = 32); decode reads the ring
# cache with no causal mask and kv_len = the filled slots
@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,smax,q_offset,kv_len,causal", [
    (4, 256, 256, 0, 256, True),     # prefill
    (4, 1, 512, 511, 512, False),    # decode over a full ring
    (4, 1, 512, 0, 300, False),      # decode over 300 filled slots
    (2, 37, 64, 5, 42, True),        # ragged prefill into a cache
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_head_dim_80_matches_plain_on_card(cuda_device, b, sq, smax, q_offset,
                                                     kv_len, causal, dtype):
    q = torch.randn(b, sq, 32, 80, device=cuda_device).to(dtype)
    k = torch.randn(b, smax, 32, 80, device=cuda_device).to(dtype)
    v = torch.randn(b, smax, 32, 80, device=cuda_device).to(dtype)
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), ref.flash_attention_ref(q, k, v, **kw).float(),
                               rtol=tol, atol=tol)


# ---------------------------------------------- attention: the two bf16 paths
# bf16 q and K/V with rows = Sq * H / K <= 16 take the split-KV kernel, more
# rows the tensor-core kernel (csrc/attention.cu).  Limits as above: bf16
# 2e-2, f32 queries 1e-4.

def _attention_case(device, b, sq, smax, h, kh, d, qdtype, kvdtype, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(b, sq, h, d, device=device, generator=gen).to(qdtype)
    k = torch.randn(b, smax, kh, d, device=device, generator=gen).to(kvdtype)
    v = torch.randn(b, smax, kh, d, device=device, generator=gen).to(kvdtype)
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,smax,h,kh,d,q_offset,kv_len,window,causal", [
    (4, 1, 512, 12, 2, 128, 511, 512, 20, True),     # window shorter than a split
    (4, 1, 512, 12, 2, 128, 64, 65, None, True),     # kv_len one past a split edge
    (4, 1, 512, 12, 2, 128, 32, 33, None, True),
    (4, 1, 512, 32, 32, 80, 0, 129, None, False),    # zamba2's ring, 129 filled slots
    (1, 1, 16, 4, 2, 64, 9, 3, 2, True),             # the query sees no key: 0
    (2, 2, 300, 12, 2, 128, 250, 252, None, True),   # qwen2 g = 6, Sq 2: 12 rows, split
    (2, 3, 300, 12, 2, 128, 250, 253, None, True),   # Sq 3: 18 rows, tensor cores
    (2, 16, 128, 32, 32, 80, 40, 56, None, True),    # zamba2 g = 1, Sq 16: split
    (2, 17, 128, 32, 32, 80, 40, 57, None, True),    # Sq 17: tensor cores
    (2, 16, 128, 32, 32, 80, 40, 56, 9, True),       # rows that see different keys
])
def test_attention_bf16_paths_match_plain_on_card(cuda_device, b, sq, smax, h, kh, d, q_offset,
                                                 kv_len, window, causal):
    q, k, v = _attention_case(cuda_device, b, sq, smax, h, kh, d, torch.bfloat16,
                              torch.bfloat16)
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len, window=window)
    before = ops.launch_counts()["gqa_attention"]
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["gqa_attention"] == before + 1
    torch.testing.assert_close(got.float(), ref.flash_attention_ref(q, k, v, **kw).float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 80, 128])
@pytest.mark.parametrize("window", [None, 37])
def test_attention_tensor_core_head_dims_on_card(cuda_device, d, window):
    """Sq 45 and kv_len 145 are no multiples of the 64-row and 64-key tiles."""
    q, k, v = _attention_case(cuda_device, 2, 45, 200, 8, 2, d, torch.bfloat16, torch.bfloat16,
                              seed=d)
    kw = dict(causal=True, q_offset=100, kv_len=145, window=window)
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.flash_attention_ref(q, k, v, **kw).float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_attention_training_shape_on_card(cuda_device):
    """The [train] phase's call: q [4, 512, 12, 128], causal, no cache."""
    q, k, v = _attention_case(cuda_device, 4, 512, 512, 12, 2, 128, torch.bfloat16,
                              torch.bfloat16)
    got = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.flash_attention_ref(q, k, v).float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,q_offset,kv_len", [(1, 299, 300), (40, 10, 50)])
def test_attention_f32_query_bf16_cache_on_card(cuda_device, sq, q_offset, kv_len):
    """The reference engine's case: f32 queries on a bf16 cache (f32 kernel)."""
    q, k, v = _attention_case(cuda_device, 2, sq, 320, 12, 2, 128, torch.float32,
                              torch.bfloat16)
    kw = dict(causal=True, q_offset=q_offset, kv_len=kv_len)
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v, **kw), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_attention_split_kv_merge_is_deterministic_on_card(cuda_device):
    """The merge sums the splits in order, whichever block takes the last
    ticket, and each launch leaves its tickets at 0: the same call gives the
    same bits, also after calls of other shapes in between."""
    q, k, v = _attention_case(cuda_device, 4, 1, 512, 12, 2, 128, torch.bfloat16,
                              torch.bfloat16)
    kw = dict(causal=True, q_offset=511, kv_len=512)
    first = ops.flash_attention(q, k, v, **kw)
    for kv_len in (33, 200, 512):
        ops.flash_attention(q, k, v, causal=True, q_offset=kv_len - 1, kv_len=kv_len)
    zq, zk, zv = _attention_case(cuda_device, 4, 1, 512, 32, 32, 80, torch.bfloat16,
                                 torch.bfloat16)
    ops.flash_attention(zq, zk, zv, causal=False, kv_len=512)
    again = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.cuda
def test_attention_unaligned_views_are_copied_on_card(cuda_device):
    """The kernels load 16 bytes at a time: a contiguous view that starts 8
    bytes into its storage is copied to an aligned buffer before the launch."""
    q, k, v = _attention_case(cuda_device, 2, 1, 64, 12, 2, 128, torch.bfloat16, torch.bfloat16)
    views = []
    for t in (q, k, v):
        buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=cuda_device)
        view = buf[4:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 == 8
        views.append(view)
    kw = dict(causal=True, q_offset=40, kv_len=41)
    got = ops.flash_attention(*views, **kw)
    torch.testing.assert_close(got.float(), ref.flash_attention_ref(q, k, v, **kw).float(),
                               rtol=2e-2, atol=2e-2)
