"""The port's kernels against the reference's.

On the CPU the port's wrappers run their plain PyTorch versions; these are
held against the Pallas kernels (interpret mode, as tests/test_kernels.py
runs them) and against the reference model's jnp twins
(``blocked_attention``, ``decode_attention``).  The CUDA kernels themselves
are held against the plain versions by tests/test_torch_cuda.py, which skips
without a card, and by ``chip_smoke.py`` at full width.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro_torch.kernels import _build, ops, ref

RNG = np.random.default_rng(0)


def _normal(shape):
    return RNG.normal(size=shape).astype(np.float32)


def _pair(a, dtype):
    """The same values as a JAX array and a torch tensor of one dtype."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------------------- rmsnorm

# f32: the same formula in f32, summed in another order (~1e-7 relative).
# bf16: the f32 results round to bf16 separately; one bf16 ulp is 2^-8
# relative (3.9e-3), so 1e-2 allows two.
RMS_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("shape", [(7, 64), (3, 37, 128), (1, 1, 256), (4, 1536)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_matches_pallas(shape, dtype):
    jx, tx = _pair(_normal(shape), dtype)
    jw, tw = _pair(_normal(shape[-1:]), dtype)
    want = jops.rmsnorm(jx, jw, rows_block=4)
    got = ref.rmsnorm_ref(tx, tw)
    assert got.dtype == dtype and got.shape == tx.shape
    tol = RMS_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_rmsnorm_f32_weight_on_bf16_rows():
    """The model's case: bf16 activations, f32 norm scale."""
    jx, tx = _pair(_normal((5, 128)), torch.bfloat16)
    jw, tw = _pair(_normal((128,)), torch.float32)
    got = ref.rmsnorm_ref(tx, tw)
    want = jref.rmsnorm_ref(jx, jw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-2, atol=1e-2)


# ----------------------------------------------------------------- attention

def _gqa_fold_ref(q, k, v, causal):
    """The reference's oracle with the GQA fold of its ops.py."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    qf = q.reshape(b, sq, kh, g, d).transpose(0, 2, 3, 1, 4).reshape(b * h, sq, d)
    kf = jnp.broadcast_to(k.transpose(0, 2, 1, 3)[:, :, None],
                          (b, kh, g, skv, d)).reshape(b * h, skv, d)
    vf = jnp.broadcast_to(v.transpose(0, 2, 1, 3)[:, :, None],
                          (b, kh, g, skv, d)).reshape(b * h, skv, d)
    out = jref.flash_attention_ref(qf, kf, vf, causal=causal)
    return out.reshape(b, kh, g, sq, d).transpose(0, 3, 1, 2, 4).reshape(b, sq, h, d)


# f32 throughout on both sides: differences are summation order and the
# online-vs-exact softmax, ~1e-6 on O(1) outputs.
ATT_TOL = 2e-5


@pytest.mark.parametrize("b,sq,skv,h,k,d", [
    (1, 64, 64, 2, 2, 32),
    (2, 96, 96, 4, 2, 32),     # GQA, sequence not a multiple of the block
    (1, 128, 128, 4, 1, 64),   # MQA
    (2, 33, 65, 2, 2, 16),     # ragged
    (1, 40, 40, 12, 2, 32),    # qwen2's group of 6
])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_matches_pallas(b, sq, skv, h, k, d, causal):
    q, kk, v = _normal((b, sq, h, d)), _normal((b, skv, k, d)), _normal((b, skv, k, d))
    jq, jk, jv = map(jnp.asarray, (q, kk, v))
    pallas = jops.flash_attention(jq, jk, jv, causal=causal, q_block=32, kv_block=32)
    got = ref.flash_attention_ref(*map(torch.from_numpy, (q, kk, v)), causal=causal)
    np.testing.assert_allclose(_np(got), _np(pallas), rtol=ATT_TOL, atol=ATT_TOL)
    np.testing.assert_allclose(_np(got), _np(_gqa_fold_ref(jq, jk, jv, causal)),
                               rtol=ATT_TOL, atol=ATT_TOL)


@pytest.mark.parametrize("q_offset,window", [(0, None), (5, None), (5, 7), (0, 16), (37, 3)])
@pytest.mark.parametrize("extra_cache", [0, 11])
def test_attention_matches_blocked_attention(q_offset, window, extra_cache):
    """Prefill against a cache: queries at q_offset.., keys up to
    q_offset + Sq; ``extra_cache`` rows past kv_len must be ignored."""
    b, sq, h, kh, d = 2, 21, 6, 2, 32
    kv_len = q_offset + sq
    q = _normal((b, sq, h, d))
    k, v = _normal((b, kv_len + extra_cache, kh, d)), _normal((b, kv_len + extra_cache, kh, d))
    want = jlayers.blocked_attention(jnp.asarray(q), jnp.asarray(k[:, :kv_len]),
                                     jnp.asarray(v[:, :kv_len]), causal=True,
                                     q_offset=q_offset, window=window,
                                     q_block=8, kv_block=16)
    got = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)), causal=True,
                                  q_offset=q_offset, window=window, kv_len=kv_len)
    np.testing.assert_allclose(_np(got), _np(want), rtol=ATT_TOL, atol=ATT_TOL)


@pytest.mark.parametrize("length,window", [(1, None), (9, None), (30, None), (30, 4)])
def test_decode_matches_decode_attention(length, window):
    """One query at position length - 1 against a 32-row f32 cache."""
    b, h, kh, d, smax = 3, 12, 2, 32, 32
    q = _normal((b, 1, h, d))
    kc, vc = _normal((b, smax, kh, d)), _normal((b, smax, kh, d))
    want = jlayers.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                    length, window=window)
    got = ref.flash_attention_ref(*map(torch.from_numpy, (q, kc, vc)), causal=True,
                                  q_offset=length - 1, window=window, kv_len=length)
    np.testing.assert_allclose(_np(got), _np(want), rtol=ATT_TOL, atol=ATT_TOL)


def test_decode_against_bf16_cache():
    """f32 queries on a bf16 cache, the reference engine's case.  Its
    ``decode_attention`` rounds the softmax weights to the cache dtype before
    the PV product; the port keeps them in f32 (online softmax), so the two
    differ by bf16 rounding of p: 2^-9 relative per weight, 1e-2 allowed on
    O(1) outputs."""
    b, h, kh, d, smax, length = 2, 12, 2, 32, 24, 17
    q = _normal((b, 1, h, d))
    kc = _normal((b, smax, kh, d))
    vc = _normal((b, smax, kh, d))
    jkc, tkc = _pair(kc, torch.bfloat16)
    jvc, tvc = _pair(vc, torch.bfloat16)
    want = jlayers.decode_attention(jnp.asarray(q), jkc, jvc, length)
    got = ref.flash_attention_ref(torch.from_numpy(q), tkc, tvc, q_offset=length - 1,
                                  kv_len=length)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-2, atol=1e-2)


def test_attention_bf16_matches_pallas():
    q, k, v = (_normal((1, 64, 4, 32)) for _ in range(3))
    k, v = k[:, :, :2], v[:, :, :2]
    jq, tq = _pair(q, torch.bfloat16)
    jk, tk = _pair(np.ascontiguousarray(k), torch.bfloat16)
    jv, tv = _pair(np.ascontiguousarray(v), torch.bfloat16)
    want = jops.flash_attention(jq, jk, jv, q_block=32, kv_block=32)
    got = ref.flash_attention_ref(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    # same f32 math; the outputs round to bf16 separately (reference's 3e-2)
    np.testing.assert_allclose(_np(got), _np(want), rtol=3e-2, atol=3e-2)


def test_attention_row_with_no_visible_key_is_zero():
    """A window of 1 with kv_len short of the query: the query sees nothing
    and gets 0, as the reference's blocked_attention gives."""
    q, k, v = (torch.randn(1, 2, 2, 8) for _ in range(3))
    out = ref.flash_attention_ref(q, k, v, causal=True, q_offset=5, window=1, kv_len=2)
    assert torch.equal(out, torch.zeros_like(out))


# ------------------------------------ the CUDA kernel's two bf16 algorithms
# A test-local model of the arithmetic of csrc/attention.cu's bf16 paths,
# held to the plain version where there is no card.  Split-KV (decode): the
# visible keys [kv_lo, kv_hi) are cut into splits; each split gives per row
# its max m, sum l and unnormalised P V in f32; the splits merge by
# log-sum-exp, a split that shows a row no key (m = -inf) with weight 0, a
# row with no key anywhere to 0.  The tensor-core path (prefill) is the same
# merge done online over 64-key tiles, with P rounded to bf16 before the PV
# product and l summed from the f32 P.

def _split_kv_model(q, k, v, *, causal, q_offset, kv_len, window, split_len, p_bf16):
    b, sq, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    kv_hi = min(kv_len, q_offset + sq) if causal else kv_len
    kv_lo = max(0, q_offset - window + 1) if window else 0
    qf = q.float().reshape(b, sq, kh, g, d)
    qpos = q_offset + torch.arange(sq)[:, None]
    ms, ls, accs = [], [], []
    for n0 in range(kv_lo, max(kv_hi, kv_lo + 1), split_len):
        n = torch.arange(n0, max(n0, min(n0 + split_len, kv_hi)))
        s = torch.einsum("bqkgd,bnkd->bqkgn", qf, k[:, n].float()) / np.sqrt(d)
        vis = n[None, :] < kv_len
        if causal:
            vis = vis & (n[None, :] <= qpos)
        if window:
            vis = vis & (qpos - n[None, :] < window)
        s = s.masked_fill(~vis[None, :, None, None, :], -np.inf)
        m = s.amax(-1) if len(n) else torch.full(s.shape[:-1], -np.inf)
        p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)[..., None])
        pv = p.bfloat16().float() if p_bf16 else p
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bqkgn,bnkd->bqkgd", pv, v[:, n].float()))
    m_all = torch.stack(ms).amax(0)
    w = [torch.exp(m - torch.where(torch.isfinite(m_all), m_all, 0.0)) for m in ms]
    l_all = sum(wi * li for wi, li in zip(w, ls))
    acc = sum(wi[..., None] * ai for wi, ai in zip(w, accs))
    out = torch.where((l_all > 0)[..., None], acc / l_all.clamp_min(1e-30)[..., None], 0.0)
    return out.reshape(b, sq, h, d)


SPLIT_CASES = [
    # b, sq, smax, h, kh, d, q_offset, kv_len, window, causal
    (2, 1, 40, 12, 2, 16, 39, 40, None, True),     # decode
    (2, 1, 40, 12, 2, 16, 32, 33, None, True),     # kv_len one past a split edge
    (2, 1, 40, 12, 2, 16, 39, 40, 3, True),        # window shorter than a split
    (2, 1, 40, 4, 4, 16, 0, 27, None, False),      # the ring: no causal mask
    (1, 16, 40, 4, 4, 16, 20, 30, 2, True),        # splits that show rows no key
    (1, 3, 40, 12, 2, 16, 5, 8, 1, True),          # rows that see no key at all
    (2, 37, 80, 4, 2, 32, 11, 48, None, True),     # prefill into a cache
    (2, 20, 20, 6, 2, 16, 0, 20, 5, True),         # windowed prefill
]


@pytest.mark.parametrize("split_len", [4, 7, 64])
@pytest.mark.parametrize("case", SPLIT_CASES)
@pytest.mark.parametrize("p_bf16", [False, True])
def test_kernel_algorithm_model_matches_plain(case, split_len, p_bf16):
    """f32 P: the merge is exact up to summation order, held at the card's
    f32 limit 1e-4 (reading 4.8e-7 over these cases).  bf16 P on bf16-valued
    inputs: held at the card's bf16 limit 2e-2 (reading 3.1e-3)."""
    b, sq, smax, h, kh, d, q_offset, kv_len, window, causal = case
    rng = np.random.default_rng(sum(case[:6]) + split_len)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).bfloat16().float()
               for s in ((b, sq, h, d), (b, smax, kh, d), (b, smax, kh, d)))
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len, window=window)
    want = ref.flash_attention_ref(q, k, v, **kw)
    got = _split_kv_model(q, k, v, split_len=split_len, p_bf16=p_bf16, **kw)
    tol = 2e-2 if p_bf16 else 1e-4
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    blind = ~ref.flash_attention_ref(q, k, v, **kw).ne(0).any(-1)   # rows with no key
    assert torch.equal(got[blind], torch.zeros_like(got[blind]))


def test_kernel_algorithm_model_has_fully_masked_splits():
    """The cases above reach the merge's edges.  Query i (position 20 + i,
    window 2, kv_len 30) sees keys 19 + i and 20 + i below 30; the visible
    range [19, 30) falls into splits [19, 23), [23, 27), [27, 30), so the
    last two show query 0 no key, and queries 11..15 see no key at all."""
    q, k, v = (torch.ones(1, 16, 4, 16), torch.ones(1, 40, 4, 16), torch.ones(1, 40, 4, 16))
    kw = dict(causal=True, q_offset=20, kv_len=30, window=2)
    out = _split_kv_model(q, k, v, split_len=4, p_bf16=False, **kw)
    assert torch.equal(out, ref.flash_attention_ref(q, k, v, **kw))
    assert torch.equal(out[0, 11:], torch.zeros_like(out[0, 11:]))
    assert torch.equal(out[0, :11], torch.ones_like(out[0, :11]))


# ------------------------------------------------ ssd scan: the kernel's arithmetic
# A model of the tensor-core SSD kernel (csrc/ssd.cu, bf16 inputs): the
# sequence in 64-step tiles whatever the caller's chunk, the state carried in
# f32 between tiles, and every product as bf16 tensor-core passes with f32
# accumulation.  x, B and C are bf16 at rest, so C B^T takes one pass with
# exact products; the f32 factor of each other product (G, the carried state
# h, B o w) is split into hi = bf16(v) and lo = bf16(v - hi), one pass each.
# Held, like the kernel on the card, within SSD_TOL of the plain version:
# |err| <= SSD_TOL * (1 + |want|) on y and on the final state.

SSD_TOL = 1e-4        # chip_smoke.py and tests/test_torch_cuda.py hold the kernel to it
SSD_TILE = 64


def _split_bf16(v, pieces):
    """v as ``pieces`` bf16-valued parts whose sum approximates it."""
    parts = []
    for _ in range(pieces):
        part = v.bfloat16().float()
        parts.append(part)
        v = v - part
    return parts


def _ssd_tile_model(x, dt, a, bm, cm, *, pieces):
    b, s, h, p = x.shape
    n = bm.shape[-1]
    causal = torch.tril(torch.ones(SSD_TILE, SSD_TILE, dtype=torch.bool))
    state = torch.zeros(b, h, n, p)
    ys = []
    for t0 in range(0, s, SSD_TILE):
        qv = min(SSD_TILE, s - t0)
        # rows past S are zeros, as the kernel's zero-filled copies give
        xs, dts, bs, cs = (torch.nn.functional.pad(
            t[:, t0:t0 + qv], (0, 0) * (t.dim() - 2) + (0, SSD_TILE - qv))
            for t in (x, dt, bm, cm))
        cum = torch.cumsum(dts * a, dim=1)                               # [B,T,H]
        seg = cum[:, -1]                                                 # [B,H]
        cb = torch.einsum("bin,bjn->bij", cs, bs)                        # exact products
        li = (cum[:, :, None] - cum[:, None]).masked_fill(~causal[None, :, :, None], -np.inf)
        g = cb[..., None] * torch.exp(li) * dts[:, None]                 # [B,i,j,H]
        y = sum(torch.einsum("bin,bhnp->bihp", cs, hp) for hp in _split_bf16(state, pieces))
        y = y * torch.exp(cum)[..., None]
        y = y + sum(torch.einsum("bijh,bjhp->bihp", gp, xs) for gp in _split_bf16(g, pieces))
        bw = bs[..., None] * (torch.exp(seg[:, None] - cum) * dts)[:, :, None]   # [B,j,N,H]
        state = state * torch.exp(seg)[..., None, None] + sum(
            torch.einsum("bjnh,bjhp->bhnp", ap, xs) for ap in _split_bf16(bw, pieces))
        ys.append(y[:, :qv])
    return torch.cat(ys, dim=1), state


def _ssd_bf16_inputs(b, s, h, p, n, seed):
    """x, B, C bf16-valued (one conv output, as the Mamba block hands them
    over), dt and a f32, in the ranges chip_smoke.py uses."""
    rng = np.random.default_rng(seed)
    conv = torch.from_numpy(rng.normal(size=(b, s, h * p + 2 * n)).astype(np.float32))
    conv = conv.bfloat16().float()
    x = conv[..., :h * p].reshape(b, s, h, p)
    bm, cm = conv[..., h * p:h * p + n], conv[..., h * p + n:]
    dt = torch.from_numpy(rng.random((b, s, h)).astype(np.float32)) * 0.19 + 0.01
    a = -(torch.from_numpy(rng.random(h).astype(np.float32)) * 1.5 + 0.5)
    return x, dt, a, bm, cm


def _ssd_scaled_err(got, want):
    return max(float(((g - w).abs() / (1 + w.abs())).max()) for g, w in zip(got, want))


SSD_MODEL_CASES = [
    # b, s, h, p, n, chunk
    (2, 256, 6, 64, 64, 128),     # the serving prefill's widths, four tiles
    (2, 200, 4, 64, 64, 128),     # a ragged last tile
    (2, 37, 3, 32, 16, 16),       # shorter than a tile; the smoke widths
    (1, 150, 3, 16, 32, 17),      # a chunk that is not a tile's divisor
    (2, 130, 3, 64, 32, 64),
    (1, 64, 2, 16, 64, 128),      # exactly one tile
]


@pytest.mark.parametrize("case", SSD_MODEL_CASES)
def test_ssd_kernel_arithmetic_model_matches_plain(case):
    """Two bf16 parts per f32 factor: within SSD_TOL of the chunked plain
    version at the caller's chunk and of the sequential recurrence (readings
    1.3e-5..3.3e-5 over these cases; 4.8e-5 at the full serving prefill
    [4, 256, 80, 64])."""
    b, s, h, p, n, chunk = case
    inputs = _ssd_bf16_inputs(b, s, h, p, n, seed=sum(case))
    got = _ssd_tile_model(*inputs, pieces=2)
    assert got[0].shape == (b, s, h, p) and got[1].shape == (b, h, n, p)
    assert _ssd_scaled_err(got, ref.ssd_chunked_ref(*inputs, chunk=chunk)) <= SSD_TOL
    assert _ssd_scaled_err(got, ref.ssd_ref(*inputs)) <= SSD_TOL


@pytest.mark.parametrize("case", SSD_MODEL_CASES[:2])
def test_ssd_kernel_arithmetic_control_fails(case):
    """One bf16 pass over each f32 factor (no lo part) reads 1.5e-2..2.1e-2
    here, over SSD_TOL: the limit tells a single pass from the split."""
    b, s, h, p, n, chunk = case
    inputs = _ssd_bf16_inputs(b, s, h, p, n, seed=sum(case))
    got = _ssd_tile_model(*inputs, pieces=1)
    assert _ssd_scaled_err(got, ref.ssd_chunked_ref(*inputs, chunk=chunk)) > 10 * SSD_TOL


# ------------------------------------------------------------------ wrappers

def test_wrappers_take_plain_version_on_cpu_without_counting():
    ops.reset_launch_counts()
    x, w = torch.randn(3, 64), torch.randn(64)
    assert torch.equal(ops.rmsnorm(x, w, eps=1e-5), ref.rmsnorm_ref(x, w, eps=1e-5))
    q, k, v = torch.randn(2, 5, 4, 16), torch.randn(2, 9, 2, 16), torch.randn(2, 9, 2, 16)
    got = ops.flash_attention(q, k, v, q_offset=3, kv_len=8, window=4)
    assert torch.equal(got, ref.flash_attention_ref(q, k, v, q_offset=3, kv_len=8, window=4))
    x, dt, a, bm = torch.randn(2, 7, 3, 16), torch.rand(2, 7, 3), -torch.rand(3), torch.randn(2, 7, 16)
    for g, w in zip(ops.ssd_scan(x, dt, a, bm, bm, chunk=4),
                    ref.ssd_chunked_ref(x, dt, a, bm, bm, chunk=4)):
        assert torch.equal(g, w)
    assert ops.launch_counts() == {"rmsnorm": 0, "gqa_attention": 0,
                                   "ef_quantize_bucketize": 0, "quantize_blocks": 0,
                                   "dequant_add": 0, "ssd_scan": 0}


@pytest.mark.parametrize("kwargs,shapes,match", [
    ({"kv_len": 10}, ((1, 2, 4, 8), (1, 9, 2, 8)), "kv_len"),
    ({"kv_len": 0}, ((1, 2, 4, 8), (1, 9, 2, 8)), "kv_len"),
    ({}, ((1, 2, 4, 8), (1, 9, 3, 8)), "divide"),
    ({}, ((1, 2, 4, 8), (2, 9, 2, 8)), "batch"),
    ({"window": 0}, ((1, 2, 4, 8), (1, 9, 2, 8)), "window"),
])
def test_attention_wrapper_rejects_bad_arguments(kwargs, shapes, match):
    q, k = torch.zeros(shapes[0]), torch.zeros(shapes[1])
    with pytest.raises(ValueError, match=match):
        ops.flash_attention(q, k, k.clone(), **kwargs)


def test_build_targets_hopper_and_is_keyed_by_source():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and path.name.startswith(name + "-")


def test_build_raises_without_nvcc(monkeypatch):
    """No compiler means an error, never a quiet fallback."""
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
