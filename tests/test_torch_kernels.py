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


# ------------------------------------------------------------------ wrappers

def test_wrappers_take_plain_version_on_cpu_without_counting():
    ops.reset_launch_counts()
    x, w = torch.randn(3, 64), torch.randn(64)
    assert torch.equal(ops.rmsnorm(x, w, eps=1e-5), ref.rmsnorm_ref(x, w, eps=1e-5))
    q, k, v = torch.randn(2, 5, 4, 16), torch.randn(2, 9, 2, 16), torch.randn(2, 9, 2, 16)
    got = ops.flash_attention(q, k, v, q_offset=3, kv_len=8, window=4)
    assert torch.equal(got, ref.flash_attention_ref(q, k, v, q_offset=3, kv_len=8, window=4))
    assert ops.launch_counts() == {"rmsnorm": 0, "gqa_attention": 0,
                                   "ef_quantize_bucketize": 0, "quantize_blocks": 0,
                                   "dequant_add": 0}


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
