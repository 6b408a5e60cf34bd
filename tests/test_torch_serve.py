"""The port's serving engine against the reference's, on the same params.

Both engines run in float32 on the same prompts; the reference keeps its
KV cache in bf16 (its ``init_cache`` default), and so does the port.  The
greedy tokens, finish reasons and round log must be identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.core import traffic
from repro.models import api as japi
from repro.serve import Engine as JEngine
from repro_torch.configs import registry as treg
from repro_torch.launch import serve as tserve
from repro_torch.models import convert
from repro_torch.serve import Engine, RoundStats

CFG_J = jreg.get("qwen2-1.5b", smoke=True)
CFG_T = treg.get("qwen2-1.5b", smoke=True)


@pytest.fixture(scope="module")
def params():
    jp = japi.get_api(CFG_J, remat="none").init(jax.random.key(0))
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), CFG_T, device="cpu")


def _engines(params, **kw):
    jp, tp = params
    return (JEngine(CFG_J, jp, compute_dtype=jnp.float32, **kw),
            Engine(CFG_T, tp, compute_dtype=torch.float32, device="cpu", **kw))


def _serve(eng, prompts):
    reqs = [eng.submit(p, max_new_tokens=n, eos_id=e) for p, n, e in prompts]
    eng.run()
    return [(r.rid, r.output, r.finish_reason) for r in reqs]


def _log(eng):
    return [(r.admitted, r.batch, r.prefill_len, r.decode_steps) for r in eng.round_log]


def test_engine_matches_reference_engine(params):
    """Three rounds (batch_slots=2): left-padded batches of unequal prompts,
    unequal budgets, and a half-empty last round."""
    rng = np.random.default_rng(3)
    prompts = [([int(t) for t in rng.integers(1, CFG_T.vocab_size, n)], m, None)
               for n, m in [(5, 6), (11, 4), (3, 7), (8, 7), (2, 3)]]
    je, te = _engines(params, batch_slots=2, max_seq=48)
    assert _serve(te, prompts) == _serve(je, prompts)
    assert _log(te) == _log(je) == [(2, 2, 11, 5), (2, 2, 8, 6), (1, 1, 2, 2)]


def test_finish_reasons_match_reference(params):
    _, probe = _engines(params, max_seq=24)
    first = probe.submit([1, 2, 3], max_new_tokens=1)
    probe.run()
    prompts = [([1, 2, 3], 8, first.output[0]),           # eos at the first token
               (list(range(1, 21)), 16, None),            # seq_limit: 4 positions left
               ([7, 8], 3, None)]                         # budget
    je, te = _engines(params, batch_slots=2, max_seq=24)
    got, want = _serve(te, prompts), _serve(je, prompts)
    assert got == want
    assert [r[2] for r in got] == ["eos", "seq_limit", "budget"]
    assert _log(te) == _log(je)


def test_batched_equals_singleton(params):
    """As in the reference: a request's output does not depend on its
    batch-mates when their prompts have its length (no padding)."""
    _, te = _engines(params, batch_slots=2, max_seq=32)
    ra, _ = te.submit([9, 10, 11], max_new_tokens=5), te.submit([3, 4, 5], max_new_tokens=5)
    te.run()
    _, solo = _engines(params, batch_slots=2, max_seq=32)
    rs = solo.submit([9, 10, 11], max_new_tokens=5)
    solo.run()
    assert ra.output == rs.output


@pytest.mark.parametrize("prompt,kw,match", [
    (list(range(1, 65)), {}, "max_seq=64"),
    (list(range(1, 80)), {}, "max_seq=64"),
    ([], {}, "empty prompt"),
    ([1, 2], {"max_new_tokens": 0}, "max_new_tokens"),
])
def test_submit_rejects_like_reference(params, prompt, kw, match):
    je, te = _engines(params, max_seq=64)
    with pytest.raises(ValueError, match=match) as got:
        te.submit(prompt, **kw)
    with pytest.raises(ValueError) as want:
        je.submit(prompt, **kw)
    assert str(got.value) == str(want.value)


def test_submit_accepts_prompt_leaving_one_position(params):
    _, te = _engines(params, max_seq=64)
    r = te.submit(list(range(1, 64)), max_new_tokens=4)
    te.run()
    # one token from prefill, one from the decode that fills the last position
    assert r.finish_reason == "seq_limit" and len(r.output) == 2


def test_engine_casts_matrices_once_and_keeps_norms_f32(params):
    _, tp = params
    eng = Engine(CFG_T, tp, device="cpu")          # default compute dtype bf16
    lp = eng.params["layers"][0]
    assert lp["attn"]["wq"].dtype == torch.bfloat16 and lp["attn"]["bq"].dtype == torch.bfloat16
    assert lp["ln1"]["scale"].dtype == torch.float32
    assert eng.params["final_norm"]["scale"].dtype == torch.float32
    assert tp["layers"][0]["attn"]["wq"].dtype == torch.float32    # caller's copy untouched
    assert torch.equal(lp["attn"]["wq"], tp["layers"][0]["attn"]["wq"].to(torch.bfloat16))


def test_round_log_feeds_reference_traffic_source(params):
    """The reference's traffic simulator reads the port's round_log unchanged."""
    _, te = _engines(params, batch_slots=2, max_seq=32)
    for i in range(3):
        te.submit([i + 1, i + 2, i + 3], max_new_tokens=3)
    te.run()
    assert all(isinstance(r, RoundStats) for r in te.round_log)
    src = traffic.ServingTrafficSource.from_engine(te, round_period_s=1e-3)
    jobs = src.jobs(1.0)
    r0 = te.round_log[0]
    assert jobs[0].d_bits == r0.admitted * r0.prefill_len * traffic.kv_bits_per_token(
        CFG_T, src.compute_bits)


def test_cli_serves_on_cpu(capsys):
    done = tserve.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
                        "--requests", "3", "--max-new", "4", "--max-seq", "32"])
    assert len(done) == 3 and all(len(r.output) == 4 for r in done)
    assert "3 requests, 12 tokens" in capsys.readouterr().out


def test_cli_has_reference_flags_but_ckpt_dir():
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "qwen2-1.5b", "--ckpt-dir", "x"])
