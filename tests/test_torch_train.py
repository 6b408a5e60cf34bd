"""The port's training path against the reference's, on the smoke qwen2.

* Autograd through the kernel wrappers (repair 0): on the CPU the kernels'
  autograd Functions give the plain versions' gradients exactly.
* Loss and gradients of one rank against ``jax.value_and_grad`` of the
  reference's model (f32, remat none and full, 1 and 2 microbatches).
* The train step on 8 gloo ranks (one spawn per scenario, file rendezvous,
  60 s join timeout; ``_torch_ranks``), from the reference's initial params
  (``params_from_jax``) on one global ``SyntheticLM`` batch per step:
  ``planned_sharded`` against the reference's ``make_train_step`` in
  ``"auto"`` mode on the whole batch, and ``planned_sharded_compressed``
  against the DP mean within the reference's EF bound.
* The trainer on one rank (size-1 mesh): its loss history against the
  reference's ``Trainer``, restart after an injected failure bit for bit,
  and checkpoints read and written across the two packages.

Tolerances: f32 on both sides with sums in another order, rtol 1e-5 and
atol 1e-6 on losses, grad norms and updated params; gradients within 1e-5 of
the largest gradient.  Every rank holds labels >= 0 in every row, so each
shard has the same label count and the DP mean of the shard losses is the
global mean.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_ranks import MESH_SHAPE, run_ranks, scenarios_body
from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import registry as jreg
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import api as japi
from repro.train import Trainer as JTrainer
from repro.train import TrainerOptions as JTrainerOptions
from repro.train import train_step as JTS
from repro_torch import tree as T
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import registry as treg
from repro_torch.configs.base import TrainConfig
from repro_torch.core import bucketing
from repro_torch.data.pipeline import SyntheticLM, shard_batch
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as trms
from repro_torch.models import api as tapi
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime.fault_tolerance import FailureInjector
from repro_torch.train import Trainer, TrainerOptions
from repro_torch.train import train_step as TS

CFG_J = jreg.get("qwen2-1.5b", smoke=True)
CFG_T = treg.get("qwen2-1.5b", smoke=True)
WORLD = 8
BASE = dict(compute_dtype="float32", lr=1e-3, warmup_steps=1, total_steps=10)


@pytest.fixture(scope="module")
def jax_params():
    state = JTS.make_train_state(CFG_J, JTrainConfig(remat="none"), jax.random.key(0))
    return jax.tree.map(np.asarray, state["params"])


SHARDED_TC = dict(BASE, remat="none", sync_algorithm="planned_sharded", bucket_bytes=1 << 16)
COMPRESSED_SYNC_TC = dict(BASE, remat="none", sync_algorithm="planned_sharded_compressed",
                          compress_bits=(8,), compress_block=128, compress_fused_kernel=True,
                          bucket_bytes=1 << 16)
COMPRESSED_STEP_TC = dict(BASE, remat="full", sync_algorithm="planned_sharded_compressed",
                          compress_bits=(8,), compress_fused_kernel=True, bucket_bytes=1 << 16)


@pytest.fixture(scope="module")
def ranks(jax_params, tmp_path_factory):
    """The three 8-rank scenarios of this module, in one spawn."""
    scenarios = [
        ("sharded", "train_body", (jax_params, _batches(2), SHARDED_TC)),
        ("compressed_sync", "compressed_sync_body",
         (jax_params, _batches(1)[0], COMPRESSED_SYNC_TC)),
        ("compressed_step", "train_body", (jax_params, _batches(2), COMPRESSED_STEP_TC)),
    ]
    return run_ranks(scenarios_body, WORLD, tmp_path_factory.mktemp("train"), scenarios)


def _batches(steps, global_batch=WORLD, seq=16):
    src = SyntheticLM(CFG_T.vocab_size, seq, global_batch)
    return [src.batch(k) for k in range(steps)]


def _jax_by_path(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k) for k in p): np.asarray(a, np.float32) for p, a in flat}


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


# --------------------------------------------------------- repair 0: autograd

@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_rmsnorm_function_gives_the_plain_gradient(dtype):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(3, 5, 64)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(3, 5, 64)).astype(np.float32)).to(dtype)
    got = torch.autograd.grad(trms.RMSNormFn.apply(x.requires_grad_(), w.requires_grad_(),
                                                   1e-6), (x, w), dy)
    want = torch.autograd.grad(ref.rmsnorm_ref(x, w, eps=1e-6), (x, w), dy)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("window", (None, 3))
def test_attention_function_gives_the_plain_gradient(dtype, window):
    rng = np.random.default_rng(1)
    q, k, v, do = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dtype)
                   for s in ((2, 7, 4, 32), (2, 7, 2, 32), (2, 7, 2, 32), (2, 7, 4, 32)))
    ins = [t.requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(tfa.FlashAttentionFn.apply(*ins, True, 0.2, 0, window, 7),
                              ins, do)
    want = torch.autograd.grad(ref.flash_attention_ref(*ins, sm_scale=0.2, window=window),
                               ins, do)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_function_skips_inputs_that_need_no_gradient():
    x = torch.randn(4, 32, requires_grad=True)
    w = torch.randn(32)
    (gx,) = torch.autograd.grad(trms.RMSNormFn.apply(x, w, 1e-6).sum(), (x,))
    assert torch.equal(gx, torch.autograd.grad(ref.rmsnorm_ref(x, w).sum(), (x,))[0])


# ---------------------------------------------------- one rank: loss and grads

@functools.cache
def _jax_loss_and_grads(micro):
    jloss_fn = japi.get_api(CFG_J, compute_dtype=jnp.float32, remat="none").loss
    state = JTS.make_train_state(CFG_J, JTrainConfig(remat="none"), jax.random.key(0))
    batch = {k: jnp.asarray(v) for k, v in _batches(1, global_batch=4)[0].items()}
    loss, _, grads = jax.jit(lambda p, b: JTS._microbatched_grads(jloss_fn, p, b, micro))(
        state["params"], batch)
    return loss, grads


@pytest.mark.parametrize("remat,micro", (("none", 1), ("full", 1), ("full", 2)))
def test_loss_and_grads_match_reference(jax_params, remat, micro):
    batch = _batches(1, global_batch=4)[0]
    jloss, jgrads = _jax_loss_and_grads(micro)
    params = T.map_tensors(lambda p: p.requires_grad_(True),
                           params_from_jax(jax_params, CFG_T, device="cpu"))
    api = tapi.get_api(CFG_T, compute_dtype=torch.float32, device="cpu", remat=remat)
    loss, _, grads = TS._microbatched_grads(api.loss, params, shard_batch(batch), micro)
    _close(loss, jloss)
    want = _jax_by_path(jgrads)
    got = {T.path_str(p): (leaf.stack() if isinstance(leaf, T.Stacked) else leaf).numpy()
           for p, leaf in T.leaves_with_paths(grads)}
    assert got.keys() == want.keys()
    scale = max(np.abs(a).max() for a in want.values())
    for k in want:
        _close(got[k], want[k], rtol=1e-4, atol=1e-5 * scale)


# --------------------------------------------------- 8 gloo ranks: the step

def test_planned_sharded_step_matches_reference_on_8_ranks(ranks):
    jtc = JTrainConfig(**BASE, remat="none")
    batches = _batches(2)
    step = jax.jit(JTS.make_train_step(CFG_J, jtc, None))
    state = JTS.make_train_state(CFG_J, jtc, jax.random.key(0))
    jmetrics = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        jmetrics.append(m)
    ranks = [r["sharded"] for r in ranks]
    want_params = {"['params']/" + k: v for k, v in _jax_by_path(state["params"]).items()}
    for res in ranks:
        for got, want in zip(res["metrics"], jmetrics):
            _close(got["loss"], want["loss"])
            _close(got["grad_norm"], want["grad_norm"])
            assert got["lr"] == float(want["lr"])
        for k, v in res["params"].items():
            _close(v, want_params["['params']/" + k])
        # every rank ends with the same bits
        for k in res["params"]:
            np.testing.assert_array_equal(res["params"][k], ranks[0]["params"][k])
    assert ranks[0]["metrics"][1]["lr"] > 0   # the second step moves the params


def test_compressed_sync_within_the_ef_bound_on_8_ranks(ranks):
    ranks = [r["compressed_sync"] for r in ranks]
    assert set(ranks[0]["bits"]) == {8} and len(ranks[0]["bits"]) > 2
    keys = list(ranks[0]["local"])
    mean = {k: np.mean([r["local"][k] for r in ranks], axis=0) for k in keys}

    # per-worker bound: |deq - grad| <= scale / 2 per element, scale =
    # blockmax / 127 over the blocks of the worker's buckets
    leaf_buckets = ranks[0]["leaf_buckets"]
    tol = 0.0
    for r in ranks:
        for b in range(len(ranks[0]["bucket_sizes"])):
            flat = np.concatenate([r["local"][k].reshape(-1) for k, lb in
                                   zip(keys, leaf_buckets) if lb == b])
            blocks = np.pad(flat, (0, (-flat.size) % 128)).reshape(-1, 128)
            tol = max(tol, float((np.abs(blocks).max(axis=1) / 127.0 / 2).max()))
    for r in ranks:
        for k in keys:
            assert np.abs(r["synced"][k] - mean[k]).max() <= tol * 1.01 + 1e-7, k
            np.testing.assert_array_equal(r["synced"][k], ranks[0]["synced"][k])
            # EF invariant on every rank: deq + new residual == grad (old residual 0)
            g, d, e = r["local"][k], r["deq"][k], r["alone_ef"][k]
            assert (np.abs((d + e) - g) <= np.spacing(np.abs(g))).all(), k
            # the residual does not depend on the collective
            np.testing.assert_array_equal(r["ef"][k], e)


def test_compressed_step_trains_on_8_ranks(ranks):
    ranks = [r["compressed_step"] for r in ranks]
    for res in ranks:
        assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
                   for m in res["metrics"])
        assert res["metrics"] == ranks[0]["metrics"]
        for k, v in res["params"].items():
            np.testing.assert_array_equal(v, ranks[0]["params"][k])


# ------------------------------------------------------- one rank: trainer

def _trainer_tc(**over):
    return TrainConfig(**dict(BASE, remat="full", **{"sync_algorithm": "planned_sharded",
                                                      **over}))


def test_trainer_loss_history_matches_reference(tmp_path):
    jtc = JTrainConfig(**BASE, remat="none")
    jsrc = JSyntheticLM(CFG_J.vocab_size, 16, 4)
    jt = JTrainer(CFG_J, jtc, jsrc, options=JTrainerOptions(ckpt_dir=tmp_path / "jax",
                                                            log_every=1, ckpt_every=100))
    jt.run(4)
    # the port starts from the reference's initial state, written by the
    # reference's checkpointer
    JCheckpointer(tmp_path / "port").save(
        0, JTS.make_train_state(CFG_J, jtc, jax.random.key(jtc.seed)), blocking=True)
    tt = Trainer(CFG_T, _trainer_tc(), SyntheticLM(CFG_T.vocab_size, 16, 4),
                 options=TrainerOptions(ckpt_dir=tmp_path / "port", log_every=1,
                                        ckpt_every=100), device="cpu")
    tt.run(4)
    assert [h["step"] for h in tt.history] == [h["step"] for h in jt.history] == [1, 2, 3, 4]
    for a, b in zip(tt.history, jt.history):
        _close(a["loss"], b["loss"])
        _close(a["grad_norm"], b["grad_norm"])


def test_trainer_restart_after_injected_failure_is_bit_identical(tmp_path):
    tc = _trainer_tc(sync_algorithm="planned_sharded_compressed", compress_bits=(8,),
                     compress_fused_kernel=True, bucket_bytes=1 << 16)
    src = SyntheticLM(CFG_T.vocab_size, 16, 2)
    runs = {}
    for name, injector in (("clean", None), ("failed", FailureInjector(fail_at_steps=(3,)))):
        t = Trainer(CFG_T, tc, src, injector=injector, device="cpu",
                    options=TrainerOptions(ckpt_dir=tmp_path / name, ckpt_every=2,
                                           log_every=1))
        runs[name] = (t, t.run(5))
    (clean, a), (failed, b) = runs["clean"], runs["failed"]
    assert failed.injector.fired == {3}
    assert int(a["step"]) == int(b["step"]) == 5
    for (pa, la), (pb, lb) in zip(T.leaves_with_paths(a), T.leaves_with_paths(b)):
        assert pa == pb
        for x, y in zip(T.parts(la), T.parts(lb)):
            assert torch.equal(x, y), T.path_str(pa)
    assert [h["loss"] for h in clean.history][-2:] == [h["loss"] for h in failed.history][-2:]


def test_checkpoints_cross_between_the_packages(tmp_path):
    jtc = JTrainConfig(sync_algorithm="planned_sharded_compressed", remat="none")
    jstate = JTS.make_train_state(CFG_J, jtc, jax.random.key(3))
    jstate = dict(jstate, step=jnp.asarray(7, jnp.int32),
                  ef=jax.tree.map(lambda p: p * 0.5, jstate["params"]))
    JCheckpointer(tmp_path).save(7, jstate, blocking=True)

    tc = TrainConfig(sync_algorithm="planned_sharded_compressed")
    template = TS.make_train_state(CFG_T, tc, device="cpu")
    ck = Checkpointer(tmp_path)
    assert ck.steps() == [7]
    state = ck.restore(7, template)
    want = _jax_by_path(jstate)
    got = {T.path_str(p): (leaf.stack() if isinstance(leaf, T.Stacked) else leaf).detach()
           .float().numpy() for p, leaf in T.leaves_with_paths(state)}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 7
    assert all(p.requires_grad and p._base is None
               for lp in state["params"]["layers"] for p in T.leaves(lp))

    # and back: the port's checkpoint restores into the reference's state
    ck.save(8, state, blocking=True)
    back = JCheckpointer(tmp_path).restore(8, jstate)
    for k, v in _jax_by_path(back).items():
        np.testing.assert_array_equal(v, want[k])
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore(7, TS.make_train_state(dataclasses.replace(CFG_T, n_layers=1), tc,
                                          device="cpu"))


def test_shard_batch_gives_each_rank_its_block():
    class Mesh:
        axis_names = ("data", "pod")
        shape = MESH_SHAPE

        def __init__(self, rank):
            self.coords = dict(zip(self.axis_names, divmod(rank, 2)))

        def axis_index(self, a):
            return self.coords[a]

    batch = _batches(1, global_batch=16)[0]
    blocks = [shard_batch(batch, Mesh(r)) for r in range(WORLD)]
    for k in batch:
        assert np.array_equal(np.concatenate([b[k].numpy() for b in blocks]), batch[k])
        assert all(b[k].dtype == torch.int64 for b in blocks)


def test_bucket_count_of_the_smoke_step():
    spec = bucketing.plan_buckets(TS.abstract_params(CFG_T), 1 << 16)
    assert len(spec.bucket_sizes) > 2


def test_train_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(CFG_T, _trainer_tc(), SyntheticLM(CFG_T.vocab_size, 16, 2),
                options=TrainerOptions(ckpt_dir=tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.make_train_state(CFG_T, _trainer_tc())
