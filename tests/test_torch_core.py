"""The port's copies of the NumPy optical core, its bucketing and its sync
plans, against the reference's on the same inputs.

Plans must be equal, not close: one plan has to mean the same schedule on
both backends.  ``cost_s`` is compared as an exact float: the copies run
the same NumPy code on the same inputs.  Bucket specs are compared on the
full-width qwen2-1.5b without allocating it (``jax.eval_shape`` on the
reference's side, meta tensors on the port's).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import bucketing as jbuck
from repro.core import planner as jplanner
from repro.core import topology as jtopo
from repro.models import api as japi
from repro.runtime import fault_tolerance as jft
from repro.train import train_step as JTS
from repro_torch import tree as T
from repro_torch.configs import registry as treg
from repro_torch.configs.base import TrainConfig
from repro_torch.core import bucketing, planner, topology
from repro_torch.runtime import fault_tolerance as tft
from repro_torch.train import train_step as TS

MASK = dict(dead_segments=((0, 1),), dead_wavelengths=((2, 0),))
BYTES = [512.0, 7.5e3, 3e4, 1e6, 32 * 2**20, 9.3e8]


def _plan_fields(p):
    return (p.strategy, p.cost_s, p.m, p.alltoall, p.factors, p.detail.get("bits"),
            p.detail.get("collective"))


def _mask(mod, on):
    return mod.FailureMask(**MASK) if on else None


# ------------------------------------------------------------------ planner

@pytest.mark.parametrize("n", (1, 2, 4, 8, 64, 256))
@pytest.mark.parametrize("collective,depth", (("allreduce", 1), ("reduce_scatter", 1),
                                              ("all_gather", 1), ("reduce_scatter", 2)))
@pytest.mark.parametrize("bits_candidates", ((32, 8, 4), (8,)))
@pytest.mark.parametrize("failures", (False, True))
def test_planner_copy_gives_the_reference_plans(n, collective, depth, bits_candidates,
                                                failures):
    kw = dict(collective=collective, bits_candidates=bits_candidates, depth=depth)
    got = planner.plan_buckets(n, BYTES, failures=_mask(topology, failures), **kw)
    want = jplanner.plan_buckets(n, BYTES, failures=_mask(jtopo, failures), **kw)
    assert [_plan_fields(p) for p in got] == [_plan_fields(p) for p in want]


@pytest.mark.parametrize("n", (4, 64))
@pytest.mark.parametrize("bits", (32, 8))
def test_planner_copy_fixed_width_and_cost_params(n, bits):
    for cost in (None, "optical", "tpu_v5e"):
        tc = None if cost is None else getattr(planner.CostParams, cost)()
        jc = None if cost is None else getattr(jplanner.CostParams, cost)()
        got = planner.plan_buckets(n, BYTES, tc, bits=bits)
        want = jplanner.plan_buckets(n, BYTES, jc, bits=bits)
        assert [_plan_fields(p) for p in got] == [_plan_fields(p) for p in want]


def test_single_rank_axis_compresses_only_when_forced():
    """One H100 is one DP rank: at N=1 the sweep declines compression, and
    ``compress_bits=(8,)`` forces 8 bits on every bucket."""
    sizes = [32 * 2**20, 4096]
    swept = planner.plan_buckets(1, sizes, collective="reduce_scatter",
                                 bits_candidates=(32, 8, 4))
    forced = planner.plan_buckets(1, sizes, collective="reduce_scatter",
                                  bits_candidates=(8,))
    assert [p.detail.get("bits", 32) for p in swept] == [32, 32]
    assert [p.detail["bits"] for p in forced] == [8, 8]


def test_train_config_copy_matches_reference():
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(JTrainConfig())
    assert [f.name for f in dataclasses.fields(TrainConfig)] == \
        [f.name for f in dataclasses.fields(JTrainConfig)]


# ---------------------------------------------------------------- the tree

@pytest.mark.parametrize("smoke", (True, False))
def test_leaf_view_and_bucket_spec_match_reference(smoke):
    tcfg, jcfg = treg.get("qwen2-1.5b", smoke=smoke), jreg.get("qwen2-1.5b", smoke=smoke)
    tparams = TS.abstract_params(tcfg)
    jparams = japi.param_specs(jcfg)
    jflat, _ = jax.tree_util.tree_flatten_with_path(jparams)
    got = T.leaves_with_paths(tparams)
    assert [T.path_str(p) for p, _ in got] == \
        ["/".join(str(k) for k in path) for path, _ in jflat]
    assert [tuple(leaf.shape) for _, leaf in got] == [tuple(a.shape) for _, a in jflat]
    for cap in (32 * 2**20, 1 << 16):
        ts = bucketing.plan_buckets(tparams, cap)
        js = jbuck.plan_buckets(jparams, cap)
        assert (ts.leaf_shapes, ts.leaf_buckets, ts.bucket_sizes) == \
            (js.leaf_shapes, js.leaf_buckets, js.bucket_sizes)
    if not smoke:
        assert ts.leaf_shapes[0] == (152064, 1536)   # embed/tok: its own bucket
        assert sum(math.prod(s) for s in ts.leaf_shapes) == 1_543_910_912


def _np_tree(rng, cfg):
    return T.map_tensors(lambda p: torch.from_numpy(
        rng.normal(size=tuple(p.shape)).astype(np.float32)), TS.abstract_params(cfg))


def test_flatten_to_buckets_matches_reference_and_round_trips():
    cfg = treg.get("qwen2-1.5b", smoke=True)
    tree = _np_tree(np.random.default_rng(0), cfg)
    to_j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    jtree = {k: T.map_tensors(to_j, v) for k, v in tree.items() if k != "layers"}
    # the reference stacks the layer list into [L, ...] leaves
    jtree["layers"] = jax.tree.map(lambda *xs: jnp.stack(xs),
                                   *[T.map_tensors(to_j, lp) for lp in tree["layers"]])
    spec = bucketing.plan_buckets(tree, 1 << 16)
    jspec = jbuck.plan_buckets(jtree, 1 << 16)
    got = bucketing.flatten_to_buckets(tree, spec)
    want = jbuck.flatten_to_buckets(jtree, jspec)
    assert len(got) == len(want) > 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = bucketing.unflatten_buckets(got, spec)
    for (pa, a), (pb, b) in zip(T.leaves_with_paths(back), T.leaves_with_paths(tree)):
        assert pa == pb
        for x, y in zip(T.parts(a), T.parts(b)):
            assert torch.equal(x, y)


def test_bucketed_apply_compressed_numerics_in_place():
    """The reference's test_bucketed_apply_compressed_numerics on the port:
    the EF invariant per bucket, the declined bucket an exact pass-through,
    and the results written into the given trees."""
    rng = np.random.RandomState(0)
    tree = {"a": torch.from_numpy(rng.randn(3000).astype(np.float32)),
            "b": torch.from_numpy(rng.randn(10).astype(np.float32))}
    orig = {k: v.clone() for k, v in tree.items()}
    ef = {k: torch.zeros_like(v) for k, v in tree.items()}
    spec = bucketing.plan_buckets(tree, 8192)
    bits = tuple(8 if s > 1000 else 32 for s in spec.bucket_sizes)
    out, new_ef = bucketing.bucketed_apply_compressed(
        tree, ef, lambda f, n, i: f, spec, bits=bits, block=256, fused=True)
    assert out is tree and new_ef is ef
    for k in tree:
        np.testing.assert_allclose((out[k] + new_ef[k]).numpy(), orig[k].numpy(), atol=1e-6)
    assert torch.equal(out["b"], orig["b"]) and float(new_ef["b"].abs().max()) == 0.0
    with pytest.raises(ValueError, match="bits"):
        bucketing.bucketed_apply_compressed(tree, ef, lambda f, n, i: f, spec, bits=(8,))


# ------------------------------------------------------------ sync plans

class _StubMesh:
    axis_names = ("data", "model")
    shape = {"data": 256, "model": 16}


class _StubMesh2:
    axis_names = ("data", "pod")
    shape = {"data": 4, "pod": 2}


def _both_grads(cfg_name="qwen2-1.5b", smoke=True):
    return (TS.abstract_params(treg.get(cfg_name, smoke=smoke)),
            japi.param_specs(jreg.get(cfg_name, smoke=smoke)))


def _plans_fields(plans):
    out = {"bits": plans.bits, "sizes": plans.spec.bucket_sizes}
    for name in ("plans", "rs_plans", "ag_plans"):
        d = getattr(plans, name) or {}
        out[name] = {ax: [_plan_fields(p) for p in ps] for ax, ps in d.items()}
    return out


@pytest.mark.parametrize("mesh", (_StubMesh, _StubMesh2), ids=("256x16", "4x2"))
@pytest.mark.parametrize("compress", (False, True))
@pytest.mark.parametrize("smoke", (True, False))
@pytest.mark.parametrize("bucket_bytes", (32 * 2**20, 1 << 14))
def test_plan_gradient_sync_matches_reference(mesh, compress, smoke, bucket_bytes):
    tgrads, jgrads = _both_grads(smoke=smoke)
    alg = "planned_sharded_compressed" if compress else "planned_sharded"
    kw = dict(sync_algorithm=alg, bucket_bytes=bucket_bytes)
    cost = planner.CostParams.optical()
    got = TS.plan_gradient_sync(tgrads, TrainConfig(**kw), mesh(), cost=cost,
                                sharded=True, compress=compress)
    want = JTS.plan_gradient_sync(jgrads, JTrainConfig(**kw), mesh(),
                                  cost=jplanner.CostParams.optical(), sharded=True,
                                  compress=compress)
    assert _plans_fields(got) == _plans_fields(want)


@pytest.mark.parametrize("sharded", (False, True))
@pytest.mark.parametrize("case", ("plain", "compress", "compress+mask", "overrides"))
def test_plan_gradient_sync_other_branches_match_reference(sharded, case):
    tgrads, jgrads = _both_grads()
    tc = dict(sync_algorithm="planned_compressed", bucket_bytes=1 << 14)
    nb = len(bucketing.plan_buckets(tgrads, tc["bucket_bytes"]).bucket_sizes)

    def kw(topo):
        return {"plain": {}, "compress": dict(compress=True),
                "compress+mask": dict(compress=True, failures=topo.FailureMask(**MASK)),
                "overrides": dict(bits_overrides=tuple((8, 4, 32)[i % 3] for i in range(nb)))
                }[case]

    got = TS.plan_gradient_sync(tgrads, TrainConfig(**tc), _StubMesh2(), sharded=sharded,
                                **kw(topology))
    want = JTS.plan_gradient_sync(jgrads, JTrainConfig(**tc), _StubMesh2(), sharded=sharded,
                                  **kw(jtopo))
    assert _plans_fields(got) == _plans_fields(want)


def test_sync_controller_freezes_bits_and_memoizes():
    tc = TrainConfig(sync_algorithm="planned_sharded_compressed", bucket_bytes=1 << 10)
    jtc = JTrainConfig(sync_algorithm="planned_sharded_compressed", bucket_bytes=1 << 10)
    grads = {k: torch.empty(n, device="meta") for k, n in (("a", 37), ("b", 129), ("c", 513))}
    jgrads = {k: jax.ShapeDtypeStruct((n,), jnp.float32) for k, n in
              (("a", 37), ("b", 129), ("c", 513))}
    ctrl = TS.SyncController(grads, tc, _StubMesh2())
    jctrl = JTS.SyncController(jgrads, jtc, _StubMesh2())
    assert ctrl.compress and ctrl.plans.bits == jctrl.plans.bits
    healthy = ctrl.arrays()
    assert {k: v.tolist() for k, v in healthy.items()} == \
        {k: np.asarray(v).tolist() for k, v in jctrl.arrays().items()}
    degraded = ctrl.replan(topology.FailureMask(**MASK))
    jdegraded = jctrl.replan(jtopo.FailureMask(**MASK))
    assert ctrl.plans.bits == jctrl.plans.bits and not ctrl.last_replan_cached
    assert {k: v.tolist() for k, v in degraded.items()} == \
        {k: np.asarray(v).tolist() for k, v in jdegraded.items()}
    for k in healthy:
        assert degraded[k].shape == healthy[k].shape and degraded[k].dtype == torch.int32
    ctrl.replan(None)
    assert ctrl.last_replan_cached and ctrl.plans.bits == jctrl.plans.bits
    assert ctrl.replan_count == 2


def test_unported_modes_raise_naming_the_mode():
    for alg in ("auto", "planned", "planned_pipelined", "wrht"):
        with pytest.raises(NotImplementedError, match=alg):
            TS.make_train_step(treg.get("qwen2-1.5b", smoke=True),
                               TrainConfig(sync_algorithm=alg), _StubMesh2(), device="cpu")


# ------------------------------------------------------------ fault runtime

def test_fault_tolerance_copy_behaves_as_reference():
    """The verbatim copy: injector and watchdog give the reference's events."""
    for mod, topo in ((tft, topology), (jft, jtopo)):
        inj = mod.FailureInjector(fail_at_steps=(2,), degrade_at={3: topo.FailureMask(**MASK)})
        inj.check(1)
        with pytest.raises(mod.InjectedFailure):
            inj.check(2)
        inj.check(2)   # fires once
        assert inj.degradation(3).fingerprint() == jtopo.FailureMask(**MASK).fingerprint()
        assert inj.degradation(3) is None
        with pytest.raises(TypeError, match="FailureMask"):
            mod.FailureInjector(degrade_at={1: "mask"})


def _docstring_and_code(text: str) -> tuple[str, str]:
    end = text.index('"""', 3) + 3
    return text[:end], text[end:]


@pytest.mark.parametrize("name", ("topology", "wavelength", "wrht", "step_models", "timing",
                                  "simulator", "planner", "compose"))
def test_core_modules_are_verbatim_copies(name):
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    got = _docstring_and_code((src / "repro_torch" / "core" / f"{name}.py").read_text())
    want = _docstring_and_code((src / "repro" / "core" / f"{name}.py").read_text())
    assert got[1] == want[1]
    if name != "timing":   # the copy's docstring leaves out the reference's history
        assert got[0] == want[0]


def test_fault_tolerance_is_a_copy_with_package_relative_imports():
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    got = (src / "repro_torch" / "runtime" / "fault_tolerance.py").read_text()
    want = (src / "repro" / "runtime" / "fault_tolerance.py").read_text()
    assert got == want.replace("from repro.core.", "from ..core.")
