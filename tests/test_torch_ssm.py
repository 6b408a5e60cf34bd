"""The port's Mamba2 / zamba2 path against the reference, on the same inputs.

Inputs are made with numpy; the reference's params come from its own
``init`` (with the Mamba blocks' f32 vectors perturbed, so that each of
them matters) and reach the port through ``params_from_jax``.  JAX runs on
the CPU, its Pallas SSD kernel in interpret mode; the port runs its plain
kernel versions.  Tolerances: the SSD plain versions repeat the reference's
f32 arithmetic in another summation order (1e-5); the kernel path is held
to the reference's own kernel tolerance (2e-3, tests/test_kernels.py);
whole-model logits and cache leaves to 1e-4 of the largest value in f32 and
2e-2 in bf16, as for the dense decoder (tests/test_torch_models.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import api as japi
from repro.models import ssm as jssm
from repro.serve import Engine as JEngine
from repro_torch.configs import registry as treg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models import convert
from repro_torch.models import ssm as tssm
from repro_torch.serve import Engine
from repro_torch.serve.engine import cast_for_compute

CFG_J = jreg.get("zamba2-2.7b", smoke=True)
CFG_T = treg.get("zamba2-2.7b", smoke=True)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SSD_SHAPES = [(1, 32, 2, 8, 4, 8), (2, 50, 3, 16, 8, 16), (1, 128, 1, 32, 16, 64)]
RNG = np.random.default_rng(0)


def _perturbed(jp, seed=1):
    """The reference's init with its Mamba vectors moved off their 0 / 1
    starts (A_log, D, dt_bias, conv_b, gate_norm, ln), as training would."""
    rng = np.random.default_rng(seed)
    m = dict(jp["mamba"])
    for name, scale in (("A_log", 0.5), ("D", 0.5), ("dt_bias", 0.5), ("conv_b", 0.1),
                        ("gate_norm", 0.2)):
        m[name] = m[name] + jnp.asarray(rng.normal(size=m[name].shape) * scale, m[name].dtype)
    m["ln"] = {"scale": m["ln"]["scale"]
               + jnp.asarray(rng.normal(size=m["ln"]["scale"].shape) * 0.2, jnp.float32)}
    return {**jp, "mamba": m}


def _params(cfg_j, cfg_t):
    jp = _perturbed(japi.get_api(cfg_j, remat="none").init(jax.random.key(0)))
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg_t, device="cpu")


@pytest.fixture(scope="module")
def params():
    return _params(CFG_J, CFG_T)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _rel_err(got, want) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _vocab(logits):
    return logits[..., :CFG_T.vocab_size]


def _ssd_inputs(b, s, h, p, n):
    x = RNG.normal(size=(b, s, h, p)).astype(np.float32)
    dt = RNG.uniform(0.01, 0.2, (b, s, h)).astype(np.float32)
    a = -RNG.uniform(0.5, 2.0, (h,)).astype(np.float32)
    bm = RNG.normal(size=(b, s, n)).astype(np.float32)
    cm = RNG.normal(size=(b, s, n)).astype(np.float32)
    return x, dt, a, bm, cm


def _fold(x, dt, a, bm, cm):
    """The reference kernel's folded layout (ops.py:ssd_scan)."""
    b, s, h, p = x.shape
    n = bm.shape[-1]
    return (x.transpose(0, 2, 1, 3).reshape(b * h, s, p), dt.transpose(0, 2, 1).reshape(b * h, s),
            np.broadcast_to(a[None], (b, h)).reshape(-1),
            np.broadcast_to(bm[:, None], (b, h, s, n)).reshape(b * h, s, n),
            np.broadcast_to(cm[:, None], (b, h, s, n)).reshape(b * h, s, n))


# -------------------------------------------------------------------- config

def test_zamba2_full_width_config():
    cfg = treg.get("zamba2-2.7b")
    _, d_inner, nheads, conv_dim = tssm._dims(cfg)
    assert (cfg.n_layers, cfg.attn_every, cfg.d_model, cfg.n_heads, cfg.resolved_head_dim,
            cfg.d_ff, cfg.padded_vocab) == (54, 6, 2560, 32, 80, 10240, 32000)
    assert (d_inner, nheads, cfg.ssm.head_dim, cfg.ssm.state_dim, cfg.ssm.chunk,
            conv_dim) == (5120, 80, 64, 64, 128, 5248)


# ------------------------------------------------------------------ ssd scan

@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
def test_ssd_plain_versions_match_reference(b, s, h, p, n, chunk):
    """ssd_ref against the reference's sequential oracle (y) and its model
    scan (final state); ssd_chunked_ref against the model scan (both)."""
    inputs = _ssd_inputs(b, s, h, p, n)
    want_y_seq = np.asarray(jref.ssd_ref(*map(jnp.asarray, _fold(*inputs))))
    want_y_seq = want_y_seq.reshape(b, h, s, p).transpose(0, 2, 1, 3)
    want_y, want_h = jssm.ssd_chunked(*map(jnp.asarray, inputs), chunk=chunk)
    t_in = [torch.from_numpy(np.ascontiguousarray(a)) for a in inputs]
    y_seq, h_seq = tref.ssd_ref(*t_in)
    y_chk, h_chk = tref.ssd_chunked_ref(*t_in, chunk=chunk)
    for got, want in ((y_seq, want_y_seq), (h_seq, want_h), (y_chk, want_y), (h_chk, want_h)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
def test_ssd_scan_wrapper_matches_reference_kernel(b, s, h, p, n, chunk):
    """The port's ops.ssd_scan on CPU tensors against the reference's
    ops.ssd_scan (the Pallas kernel in interpret mode)."""
    inputs = _ssd_inputs(b, s, h, p, n)
    want = jops.ssd_scan(*map(jnp.asarray, inputs), chunk=chunk)
    before = tops.launch_counts()["ssd_scan"]
    got, state = tops.ssd_scan(*map(torch.from_numpy, inputs), chunk=chunk)
    assert tops.launch_counts()["ssd_scan"] == before   # no kernel on the CPU
    assert got.dtype == state.dtype == torch.float32 and state.shape == (b, h, n, p)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-3, atol=2e-3)


def test_ssd_scan_takes_strided_bf16_views():
    """The Mamba block hands the scan bf16 slices of its conv output: the
    wrapper reads them as they are, as the f32 copies would read."""
    b, s, h, p, n = 2, 21, 3, 16, 8
    conv = torch.from_numpy(RNG.normal(size=(b, s, h * p + 2 * n)).astype(np.float32))
    conv = conv.to(torch.bfloat16)
    x = conv[..., :h * p].reshape(b, s, h, p)
    bm, cm = conv[..., h * p:h * p + n], conv[..., h * p + n:]
    dt = torch.from_numpy(RNG.uniform(0.01, 0.2, (b, s, h)).astype(np.float32))
    a = -torch.from_numpy(RNG.uniform(0.5, 2.0, (h,)).astype(np.float32))
    assert not x.is_contiguous()
    got = tops.ssd_scan(x, dt, a, bm, cm, chunk=8)
    want = tref.ssd_chunked_ref(x.float().contiguous(), dt, a, bm.float().contiguous(),
                                cm.float().contiguous(), chunk=8)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_ssd_scan_gradient_is_plain_versions():
    """Gradients through the wrapper are those of the sequential oracle."""
    inputs = [torch.from_numpy(t).requires_grad_() for t in _ssd_inputs(1, 20, 2, 8, 4)]
    y, h = tops.ssd_scan(*inputs, chunk=8)
    gy, gh = torch.randn_like(y), torch.randn_like(h)
    got = torch.autograd.grad((y, h), inputs, (gy, gh))
    y2, h2 = tref.ssd_ref(*inputs)
    want = torch.autograd.grad((y2, h2), inputs, (gy, gh))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


# -------------------------------------------------------------- mamba block

@pytest.mark.parametrize("dt", DTYPES)
def test_mamba_block_prefill_and_decode_match(dt, params):
    """One Mamba block: prefill of 13 tokens with a state, then 3 decode
    steps; outputs, SSM state and conv state against the reference's."""
    jdt, tdt = DTYPES[dt]
    jp, tp = params
    jblock = jax.tree.map(lambda a: a[0, 1], jp["mamba"])
    tblock = tp["mamba"][1]
    s_cfg, d_inner, nheads, conv_dim = tssm._dims(CFG_T)
    b = 2
    jstate = {"ssm": jnp.zeros((b, nheads, s_cfg.state_dim, s_cfg.head_dim), jnp.bfloat16),
              "conv": jnp.zeros((b, s_cfg.conv_width - 1, conv_dim), jnp.bfloat16)}
    tstate = {k: torch.zeros(v.shape, dtype=torch.bfloat16) for k, v in jstate.items()}
    x = RNG.normal(size=(b, 16, CFG_T.d_model)).astype(np.float32)
    spans = [(0, 13), (13, 14), (14, 15), (15, 16)]
    for lo, hi in spans:
        want, jstate = jssm.mamba_block_apply(jblock, jnp.asarray(x[:, lo:hi], jdt), CFG_J,
                                              state=jstate)
        got, new = tssm.mamba_block_apply(tblock, torch.from_numpy(x[:, lo:hi]).to(tdt), CFG_T,
                                          state=tstate)
        tstate = {"ssm": new["ssm"].to(tstate["ssm"].dtype), "conv": new["conv"]}
        assert got.dtype == tdt and tstate["conv"].dtype == getattr(torch, str(jstate["conv"].dtype))
        assert _rel_err(got, want) <= REL_TOL[dt], (lo, hi)
        for k in ("ssm", "conv"):
            assert _rel_err(tstate[k], jstate[k]) <= REL_TOL[dt], (k, lo, hi)


def test_mamba_block_without_state_matches(params):
    jp, tp = params
    x = RNG.normal(size=(2, 37, CFG_T.d_model)).astype(np.float32)   # ragged: 37 = 2*16 + 5
    want, _ = jssm.mamba_block_apply(jax.tree.map(lambda a: a[1, 0], jp["mamba"]),
                                     jnp.asarray(x), CFG_J)
    got, state = tssm.mamba_block_apply(tp["mamba"][2], torch.from_numpy(x), CFG_T)
    assert state is None
    assert _rel_err(got, want) <= 1e-4


# --------------------------------------------------------------- whole model

def _apis(dt, cfg_j=CFG_J, cfg_t=CFG_T):
    jdt, tdt = DTYPES[dt]
    return (japi.get_api(cfg_j, compute_dtype=jdt, remat="none"),
            tapi.get_api(cfg_t, compute_dtype=tdt, device="cpu"))


def _cache_leaves(cache):
    return {"mamba.ssm": cache["mamba"]["ssm"], "mamba.conv": cache["mamba"]["conv"],
            "attn.k": cache["attn"]["k"], "attn.v": cache["attn"]["v"]}


@pytest.mark.parametrize("dt", DTYPES)
def test_hybrid_prefill_logits_match(dt, params):
    jp, tp = params
    ja, ta = _apis(dt)
    jdt, tdt = DTYPES[dt]
    toks = RNG.integers(1, CFG_T.vocab_size, (2, 21)).astype(np.int32)
    want, _ = jax.jit(ja.prefill)(jp, {"tokens": jnp.asarray(toks)}, ja.init_cache(2, 32, jdt))
    got, _ = ta.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, ta.init_cache(2, 32, tdt))
    assert got.shape == (2, CFG_T.padded_vocab)
    assert _rel_err(_vocab(got), _vocab(want)) <= REL_TOL[dt]


def _prefill_decode(params, dt, cfg_j, cfg_t, b, plen, max_seq, cache_dtype="bfloat16"):
    """Prefill then decode to the cache end on both sides, comparing logits
    at every step and every cache leaf at the end."""
    jp, tp = params
    ja, ta = _apis(dt, cfg_j, cfg_t)
    jc_dt, tc_dt = DTYPES[cache_dtype]
    toks = RNG.integers(1, cfg_t.vocab_size, (b, plen)).astype(np.int32)
    jl, jc = jax.jit(ja.prefill)(jp, {"tokens": jnp.asarray(toks)},
                                 ja.init_cache(b, max_seq, jc_dt))
    tl, tc = ta.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                        ta.init_cache(b, max_seq, tc_dt))
    errs = [_rel_err(_vocab(tl), _vocab(jl))]
    decode = jax.jit(ja.decode)
    for pos in range(plen, max_seq):
        tok = RNG.integers(1, cfg_t.vocab_size, b).astype(np.int32)
        jl, jc = decode(jp, jnp.asarray(tok), jnp.asarray(pos, jnp.int32), jc)
        tl, tc = ta.decode(tp, torch.from_numpy(tok).long(), pos, tc)
        errs.append(_rel_err(_vocab(tl), _vocab(jl)))
    leaves = {k: (_cache_leaves(tc)[k], v) for k, v in _cache_leaves(jc).items()}
    for k, (got, want) in leaves.items():
        assert got.dtype == getattr(torch, str(want.dtype)), k
    return errs, {k: _rel_err(got, want) for k, (got, want) in leaves.items()}


# A cache leaf stored in bf16 under an f32 model holds the f32 value rounded
# to bf16: the two sides' f32 values differ by ~1e-6, which can put them on
# neighbouring bf16 values, one ulp (2^-8 of the value) apart.
BF16_ULP = 2.0 ** -8


@pytest.mark.parametrize("dt,cache_dt,leaf_tol", [("float32", "float32", 1e-4),
                                                  ("float32", "bfloat16", BF16_ULP),
                                                  ("bfloat16", "bfloat16", 2e-2)])
def test_hybrid_prefill_then_decode_match(dt, cache_dt, leaf_tol, params):
    errs, leaf_errs = _prefill_decode(params, dt, CFG_J, CFG_T, b=3, plen=9, max_seq=16,
                                      cache_dtype=cache_dt)
    assert len(errs) == 8 and max(errs) <= REL_TOL[dt], errs
    assert max(leaf_errs.values()) <= leaf_tol, leaf_errs


@pytest.mark.parametrize("plen", [5, 10])
def test_ring_cache_matches_reference(plen):
    """sliding_window 8 under max_seq 16: the shared block's cache is a ring
    of 8 slots.  Decode runs past the wrap; a prompt of 10 >= 8 seeds the
    ring from its last 8 keys at slot 0, misaligned as in the reference."""
    cfg_j = dataclasses.replace(CFG_J, sliding_window=8)
    cfg_t = dataclasses.replace(CFG_T, sliding_window=8)
    ring_params = _params(cfg_j, cfg_t)
    assert ring_params[1]["shared_attn"]["attn"]["wq"].shape[0] == CFG_T.d_model
    errs, leaf_errs = _prefill_decode(ring_params, "float32", cfg_j, cfg_t, b=2, plen=plen,
                                      max_seq=16, cache_dtype="float32")
    assert tapi.get_api(cfg_t, device="cpu").init_cache(2, 16)["attn"]["k"].shape[2] == 8
    assert max(errs) <= REL_TOL["float32"], errs
    assert max(leaf_errs.values()) <= REL_TOL["float32"], leaf_errs


def test_hybrid_decode_equals_full_forward(params):
    """The port's own cache path (f32 cache): prefill + decode gives the
    logits of one full forward over the same tokens (f32, 1e-4)."""
    _, tp = params
    _, ta = _apis("float32")
    toks = torch.from_numpy(RNG.integers(1, CFG_T.vocab_size, (2, 14))).long()
    hidden, _ = tssm.forward(tp, toks, CFG_T, compute_dtype=torch.float32)
    full = tssm.logits_fn(tp, hidden, CFG_T)
    logits, cache = ta.prefill(tp, {"tokens": toks[:, :8]}, ta.init_cache(2, 16, torch.float32))
    assert _rel_err(_vocab(logits), _vocab(full[:, 7])) <= 1e-4
    for pos in range(8, 14):
        logits, cache = ta.decode(tp, toks[:, pos], pos, cache)
        assert _rel_err(_vocab(logits), _vocab(full[:, pos])) <= 1e-4, pos


@pytest.mark.parametrize("remat", ["none", "full"])
def test_hybrid_loss_matches(remat, params):
    jp, tp = params
    ja = japi.get_api(CFG_J, compute_dtype=jnp.float32, remat=remat)
    ta = tapi.get_api(CFG_T, compute_dtype=torch.float32, device="cpu", remat=remat)
    toks = RNG.integers(1, CFG_T.vocab_size, (2, 19)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -100
    want, _ = ja.loss(jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    # a gradient reaches the first Mamba block and the embedding
    tree = {**tp, "mamba": [dict(lp) for lp in tp["mamba"]], "embed": dict(tp["embed"])}
    flat = [tp["mamba"][0]["in_proj"].clone().requires_grad_(),
            tp["embed"]["tok"].clone().requires_grad_()]
    tree["mamba"][0]["in_proj"], tree["embed"]["tok"] = flat
    got, _ = ta.loss(tree, {"tokens": torch.from_numpy(toks).long(),
                            "labels": torch.from_numpy(labels).long()})
    assert abs(float(got.detach()) - float(want)) <= 1e-4 * abs(float(want))
    grads = torch.autograd.grad(got, flat)
    assert all(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0 for g in grads)


# -------------------------------------------------------------------- params

def test_params_from_jax_unstacks_hybrid(params):
    jp, tp = params
    assert set(tp) == {"embed", "mamba", "shared_attn", "final_norm"}
    assert len(tp["mamba"]) == CFG_T.n_layers
    e = CFG_T.attn_every
    for i, lp in enumerate(tp["mamba"]):
        assert set(lp) == set(jp["mamba"])
        for name in ("in_proj", "A_log", "conv_w", "gate_norm"):
            np.testing.assert_array_equal(lp[name].numpy(),
                                          np.asarray(jp["mamba"][name][i // e, i % e]))
    np.testing.assert_array_equal(tp["shared_attn"]["attn"]["wq"].numpy(),
                                  np.asarray(jp["shared_attn"]["attn"]["wq"]))
    with pytest.raises(ValueError, match="layers"):
        convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                dataclasses.replace(CFG_T, n_layers=6), device="cpu")


def test_port_init_shapes_match_reference_specs():
    specs = japi.param_specs(CFG_J)
    tp = tapi.get_api(CFG_T, device="cpu").init(0)
    g, e = CFG_T.n_layers // CFG_T.attn_every, CFG_T.attn_every
    for path, spec in jax.tree_util.tree_leaves_with_path(specs["mamba"]):
        keys = [k.key for k in path]
        leaf = tp["mamba"][0]
        for k in keys:
            leaf = leaf[k]
        assert (g, e, *leaf.shape) == spec.shape, keys
    for path, spec in jax.tree_util.tree_leaves_with_path(
            {k: v for k, v in specs.items() if k != "mamba"}):
        leaf = tp
        for k in path:
            leaf = leaf[k.key]
        assert tuple(leaf.shape) == spec.shape, path


def test_api_refuses_other_families_and_hybrid_gaps():
    with pytest.raises(NotImplementedError, match="family 'xlstm'"):
        tapi.get_api(dataclasses.replace(CFG_T, family="xlstm"), device="cpu")
    with pytest.raises(NotImplementedError, match="qkv_bias"):
        tapi.get_api(dataclasses.replace(CFG_T, qkv_bias=True), device="cpu")


def test_hybrid_refuses_a_window_other_than_its_ring(params):
    """The shared block's window sizes its ring cache: prefill and decode
    take cfg.sliding_window (what get_api passes) or None, nothing else."""
    _, tp = params
    toks = torch.ones(1, 4, dtype=torch.long)
    cache = lambda: tssm.init_cache(CFG_T, 1, 8, device="cpu", dtype=torch.float32)  # noqa: E731
    with pytest.raises(ValueError, match="window 3"):
        tssm.prefill(tp, toks, CFG_T, cache(), compute_dtype=torch.float32, window=3)
    with pytest.raises(ValueError, match="window 3"):
        tssm.decode_step(tp, toks[:, 0], 4, CFG_T, cache(), compute_dtype=torch.float32,
                         window=3)
    want, _ = tssm.prefill(tp, toks, CFG_T, cache(), compute_dtype=torch.float32)
    got, _ = tssm.prefill(tp, toks, CFG_T, cache(), compute_dtype=torch.float32,
                          window=CFG_T.sliding_window)
    assert torch.equal(got, want)


# ------------------------------------------------------------------- serving

def test_cast_for_compute_keeps_f32_leaves(params):
    _, tp = params
    cast = cast_for_compute(tp, torch.bfloat16, "cpu")
    block = cast["mamba"][0]
    for name in ("A_log", "D", "dt_bias", "gate_norm"):
        assert block[name].dtype == torch.float32, name
        torch.testing.assert_close(block[name], tp["mamba"][0][name], rtol=0, atol=0)
    assert block["ln"]["scale"].dtype == torch.float32
    for name in ("in_proj", "out_proj", "conv_w", "conv_b"):
        assert block[name].dtype == torch.bfloat16, name
    assert cast["shared_attn"]["ln1"]["scale"].dtype == torch.float32
    assert cast["shared_attn"]["attn"]["wq"].dtype == torch.bfloat16


def test_hybrid_engine_matches_reference_engine(params):
    """Greedy tokens, finish reasons and rounds of the zamba2 smoke engine
    equal the reference engine's in f32: left-padded rounds of unequal
    prompts, prompts longer than a chunk, and a one-request last round."""
    jp, tp = params
    rng = np.random.default_rng(5)
    prompts = [([int(t) for t in rng.integers(1, CFG_T.vocab_size, n)], m)
               for n, m in [(5, 6), (19, 4), (3, 7), (8, 7), (2, 3)]]
    out = {}
    for name, eng in (("ref", JEngine(CFG_J, jp, batch_slots=2, max_seq=40,
                                      compute_dtype=jnp.float32)),
                      ("port", Engine(CFG_T, tp, batch_slots=2, max_seq=40,
                                      compute_dtype=torch.float32, device="cpu"))):
        reqs = [eng.submit(p, max_new_tokens=m) for p, m in prompts]
        eng.run()
        out[name] = ([(r.output, r.finish_reason) for r in reqs],
                     [(r.admitted, r.prefill_len, r.decode_steps) for r in eng.round_log])
    assert out["port"] == out["ref"]


def test_serve_cli_serves_zamba2_on_cpu(capsys):
    done = tserve.main(["--arch", "zamba2-2.7b", "--smoke", "--device", "cpu",
                        "--requests", "3", "--max-new", "4", "--max-seq", "64"])
    assert len(done) == 3 and all(len(r.output) == 4 for r in done)
    assert "3 requests, 12 tokens" in capsys.readouterr().out
