"""The port's dense decoder against the reference, on the same parameters.

The reference's params come from its own ``init`` and reach the port through
``params_from_jax``; inputs are made with numpy.  On the CPU the port runs
its plain kernel versions.  Tolerances: f32 runs the same math in another
summation order (~1e-6 relative on logits of magnitude ~1e2), so 1e-4 of
the largest logit; bf16 rounds activations at places the two frameworks
choose differently (2^-8 relative each), so 2e-2 of the largest logit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import qwen2_1_5b as jqwen
from repro.configs import registry as jreg
from repro.configs import zamba2_2_7b as jzamba
from repro.models import api as japi
from repro.models import layers as jlayers
from repro_torch.configs import qwen2_1_5b as tqwen
from repro_torch.configs import registry as treg
from repro_torch.configs import zamba2_2_7b as tzamba
from repro_torch.models import api as tapi
from repro_torch.models import convert
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf

CFG_J = jreg.get("qwen2-1.5b", smoke=True)
CFG_T = treg.get("qwen2-1.5b", smoke=True)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
RNG = np.random.default_rng(0)


@pytest.fixture(scope="module")
def params():
    jp = japi.get_api(CFG_J, remat="none").init(jax.random.key(0))
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), CFG_T, device="cpu")


def _rel_err(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _vocab(logits):
    """Real-vocab columns; the padded ones are -1e9 on both sides."""
    return logits[..., :CFG_T.vocab_size]


# -------------------------------------------------------------------- config

@pytest.mark.parametrize("pair", [(jqwen.CONFIG, tqwen.CONFIG), (jqwen.SMOKE, tqwen.SMOKE),
                                  (jzamba.CONFIG, tzamba.CONFIG), (jzamba.SMOKE, tzamba.SMOKE)])
def test_config_copy_matches_reference(pair):
    jcfg, tcfg = pair
    for f in dataclasses.fields(tcfg):
        got, want = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if dataclasses.is_dataclass(want):   # a nested config (ssm): each copy has its class
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, f.name
    assert tcfg.padded_vocab == jcfg.padded_vocab
    assert tcfg.resolved_head_dim == jcfg.resolved_head_dim


def test_full_width_config():
    cfg = treg.get("qwen2-1.5b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            cfg.d_ff, cfg.padded_vocab) == (28, 1536, 12, 2, 128, 8960, 152064)


@pytest.mark.parametrize("arch", ["gemma-7b", "deepseek-v2-236b", "xlstm-350m"])
def test_registry_refuses_unported_arch(arch):
    with pytest.raises(KeyError, match="not ported"):
        treg.get(arch)


def test_model_refuses_unported_features():
    with pytest.raises(NotImplementedError, match="act 'geglu'"):
        tapi.get_api(dataclasses.replace(CFG_T, act="geglu"), device="cpu")


# -------------------------------------------------------------------- params

def test_params_from_jax_unstacks_layers(params):
    jp, tp = params
    assert set(tp) == {"embed", "layers", "final_norm"}
    assert len(tp["layers"]) == CFG_T.n_layers
    for i, lp in enumerate(tp["layers"]):
        assert set(lp) == {"ln1", "ln2", "attn", "mlp"}
        assert set(lp["attn"]) == {"wq", "wk", "wv", "wo", "bq", "bk", "bv"}
        for name, leaf in lp["attn"].items():
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(jp["layers"]["attn"][name][i]))
    np.testing.assert_array_equal(tp["embed"]["tok"].numpy(), np.asarray(jp["embed"]["tok"]))
    assert tp["embed"]["tok"].shape == (CFG_T.padded_vocab, CFG_T.d_model)


def test_params_from_jax_refuses_wrong_depth(params):
    jp, _ = params
    with pytest.raises(ValueError, match="layers"):
        convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                dataclasses.replace(CFG_T, n_layers=3), device="cpu")


def test_port_init_shapes_match_reference(params):
    jp, _ = params
    tp = tapi.get_api(CFG_T, device="cpu").init(0)
    assert tp["embed"]["tok"].shape == jp["embed"]["tok"].shape
    for name, leaf in tp["layers"][0]["mlp"].items():
        assert leaf.shape == jp["layers"]["mlp"][name].shape[1:]
    assert tp["layers"][0]["ln1"]["scale"].dtype == torch.float32


# -------------------------------------------------------------------- layers

@pytest.mark.parametrize("dt", DTYPES)
def test_apply_rope_matches(dt):
    jdt, tdt = DTYPES[dt]
    x = RNG.normal(size=(2, 9, 4, 32)).astype(np.float32)
    pos = np.stack([np.arange(9), np.arange(100, 109)]).astype(np.int32)
    want = jlayers.apply_rope(jnp.asarray(x, jdt), jnp.asarray(pos), 1e6)
    got = tlayers.apply_rope(torch.from_numpy(x).to(tdt), torch.from_numpy(pos), 1e6)
    assert got.dtype == tdt
    assert _rel_err(got, want) <= {"float32": 1e-5, "bfloat16": 1e-2}[dt]


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm_apply_matches(dt, norm):
    jdt, tdt = DTYPES[dt]
    x = RNG.normal(size=(2, 5, CFG_T.d_model)).astype(np.float32)
    scale = RNG.normal(size=CFG_T.d_model).astype(np.float32)
    bias = RNG.normal(size=CFG_T.d_model).astype(np.float32)
    jp, tp = {"scale": jnp.asarray(scale)}, {"scale": torch.from_numpy(scale)}
    if norm == "layernorm":
        jp["bias"], tp["bias"] = jnp.asarray(bias), torch.from_numpy(bias)
    want = jlayers.norm_apply(jp, jnp.asarray(x, jdt), dataclasses.replace(CFG_J, norm=norm))
    got = tlayers.norm_apply(tp, torch.from_numpy(x).to(tdt), dataclasses.replace(CFG_T, norm=norm))
    assert _rel_err(got, want) <= {"float32": 1e-5, "bfloat16": 1e-2}[dt]


@pytest.mark.parametrize("dt", DTYPES)
def test_mlp_apply_matches(dt, params):
    jdt, tdt = DTYPES[dt]
    jp, tp = params
    x = RNG.normal(size=(2, 7, CFG_T.d_model)).astype(np.float32)
    want = jlayers.mlp_apply(jax.tree.map(lambda a: a[0], jp["layers"]["mlp"]),
                             jnp.asarray(x, jdt), CFG_J)
    got = tlayers.mlp_apply(tp["layers"][0]["mlp"], torch.from_numpy(x).to(tdt), CFG_T)
    assert got.dtype == tdt
    assert _rel_err(got, want) <= REL_TOL[dt]


@pytest.mark.parametrize("window", [None, 4])
def test_attention_apply_matches(params, window):
    jp, tp = params
    ja = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    x = RNG.normal(size=(2, 10, CFG_T.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(10, dtype=np.int32), (2, 10))
    want, _ = jlayers.attention_apply(ja, jnp.asarray(x), CFG_J, jnp.asarray(pos), window=window)
    got, _ = tlayers.attention_apply(tp["layers"][0]["attn"], torch.from_numpy(x), CFG_T,
                                     torch.from_numpy(pos.copy()), window=window)
    assert _rel_err(got, want) <= 1e-4


# --------------------------------------------------------------- whole model

def _apis(dt):
    jdt, tdt = DTYPES[dt]
    return (japi.get_api(CFG_J, compute_dtype=jdt, remat="none"),
            tapi.get_api(CFG_T, compute_dtype=tdt, device="cpu"))


@pytest.mark.parametrize("dt", DTYPES)
def test_prefill_logits_match(dt, params):
    jp, tp = params
    ja, ta = _apis(dt)
    jdt, tdt = DTYPES[dt]
    toks = RNG.integers(1, CFG_T.vocab_size, (2, 13)).astype(np.int32)
    want, _ = jax.jit(ja.prefill)(jp, {"tokens": jnp.asarray(toks)}, ja.init_cache(2, 32, jdt))
    got, _ = ta.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, ta.init_cache(2, 32, tdt))
    assert got.shape == (2, CFG_T.padded_vocab)
    assert bool((got[:, CFG_T.vocab_size:] < -1e8).all())
    assert _rel_err(_vocab(got), _vocab(want)) <= REL_TOL[dt]


@pytest.mark.parametrize("dt", DTYPES)
def test_prefill_then_decode_logits_match(dt, params):
    jp, tp = params
    ja, ta = _apis(dt)
    jdt, tdt = DTYPES[dt]
    toks = RNG.integers(1, CFG_T.vocab_size, (3, 9)).astype(np.int32)
    jl, jc = jax.jit(ja.prefill)(jp, {"tokens": jnp.asarray(toks)}, ja.init_cache(3, 16, jdt))
    tl, tc = ta.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, ta.init_cache(3, 16, tdt))
    decode = jax.jit(ja.decode)
    for pos in range(9, 16):
        tok = RNG.integers(1, CFG_T.vocab_size, 3).astype(np.int32)
        jl, jc = decode(jp, jnp.asarray(tok), jnp.asarray(pos, jnp.int32), jc)
        tl, tc = ta.decode(tp, torch.from_numpy(tok).long(), pos, tc)
        assert _rel_err(_vocab(tl), _vocab(jl)) <= REL_TOL[dt], pos
    assert _rel_err(tc["k"], np.asarray(jc["scan"]["k"], np.float32)) <= REL_TOL[dt]


def test_decode_equals_full_forward(params):
    """The port's own cache path: prefill + decode gives the logits a full
    forward over the same tokens gives (f32, 1e-4)."""
    _, tp = params
    _, ta = _apis("float32")
    toks = torch.from_numpy(RNG.integers(1, CFG_T.vocab_size, (2, 12))).long()
    hidden, _ = ttf.forward(tp, toks, CFG_T, compute_dtype=torch.float32)
    full = ttf.logits_fn(tp, hidden, CFG_T)
    logits, cache = ta.prefill(tp, {"tokens": toks[:, :8]}, ta.init_cache(2, 16, torch.float32))
    assert _rel_err(logits, full[:, 7]) <= 1e-4
    for pos in range(8, 12):
        logits, cache = ta.decode(tp, toks[:, pos], pos, cache)
        assert _rel_err(_vocab(logits), _vocab(full[:, pos])) <= 1e-4


def test_loss_matches(params):
    jp, tp = params
    ja, ta = _apis("float32")
    toks = RNG.integers(1, CFG_T.vocab_size, (2, 11)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -100
    want, _ = ja.loss(jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    got, _ = ta.loss(tp, {"tokens": torch.from_numpy(toks).long(),
                          "labels": torch.from_numpy(labels).long()})
    assert abs(float(got) - float(want)) <= 1e-4 * abs(float(want))
