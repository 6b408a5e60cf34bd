"""Train step: loss -> grad -> planned sharded gradient sync -> AdamW.

The port of ``repro/train/train_step.py`` for the planned sharded modes:

  planned_sharded
                each gradient bucket runs a planned reduce-scatter down the
                DP axes, then a planned all-gather back up; both phases are
                planned per (axis, bucket) at set-up by
                ``planner.plan_buckets(collective=...)`` (ring pass vs the
                single-step all-to-all finisher).
  planned_sharded_compressed
                the same with bits per element as a plan axis: at set-up
                each bucket is swept over ``compress_bits`` and the cheapest
                width wins; a compressed bucket is quantized with per-block
                scales and error feedback (the residual rides in
                ``state["ef"]``) and the collective reduces the dequantized
                f32 values.  Widths are frozen for the run.

The reference runs the step inside ``shard_map`` over the DP axes; here
each rank of a ``ProcessMesh`` runs it on its block of the batch, and the
collectives of ``core.collectives`` talk over the axes' process groups.  The
step updates the state in place and returns it.  Every other sync mode
raises ``NotImplementedError``: they come with later slices.
"""

from __future__ import annotations

import math
import time
from collections import OrderedDict
from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import bucketing, compression, planner
from repro_torch.core import collectives as C
from repro_torch.models import api as mapi
from repro_torch.models import transformer
from repro_torch.optim import adamw_init, adamw_update, make_lr_schedule
from repro_torch.tree import leaves, map_tensors, parts

# the sharded modes the port runs: per-(axis, bucket) RS/AG schedules planned
# at set-up, re-planned online by the SyncController
PORTED_ALGOS = ("planned_sharded", "planned_sharded_compressed")

# modes that carry EF residual state and quantize each bucket to the
# planner-chosen wire width before its collective
COMPRESSED_ALGOS = ("planned_compressed", "planned_sharded_compressed")


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def dp_axes_of(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("data", "pod") if a in mesh.axis_names)


def _check_mode(tc: TrainConfig) -> None:
    if tc.sync_algorithm not in PORTED_ALGOS:
        raise NotImplementedError(
            f"sync_algorithm {tc.sync_algorithm!r} is not ported to repro_torch yet; "
            f"ported: {', '.join(PORTED_ALGOS)}")
    if tc.compress_pod_axis:
        raise NotImplementedError("compress_pod_axis is not ported to repro_torch yet")


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------

def abstract_params(cfg: ModelConfig, dtype=torch.float32) -> dict:
    """The params as meta tensors: shapes and dtypes, no memory."""
    return transformer.init_params(cfg, None, device="meta", dtype=dtype)


def make_train_state(cfg: ModelConfig, tc: TrainConfig, device="cuda") -> dict:
    """Params from ``tc.seed`` on ``device``, AdamW moments, step 0, and the
    EF residual for the compressed modes."""
    dev = resolve_device(device)
    api = mapi.get_api(cfg, compute_dtype=_dtype(tc.compute_dtype), device=dev,
                       remat=tc.remat)
    params = api.init(tc.seed, _dtype(tc.param_dtype))
    map_tensors(lambda p: p.requires_grad_(True), params)
    state = {
        "params": params,
        "opt": adamw_init(params, _dtype(tc.opt_state_dtype)),
        "step": torch.zeros((), dtype=torch.int32),
    }
    if tc.compress_pod_axis or tc.sync_algorithm in COMPRESSED_ALGOS:
        state["ef"] = compression.init_ef_state(map_tensors(torch.Tensor.detach, params))
    return state


# ---------------------------------------------------------------------------
# gradient sync plans
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GradSyncPlans:
    """Set-up product of the amortized planner: the gradient bucket partition
    plus one schedule per (DP axis, bucket).  The sharded modes carry a
    reduce-scatter plan and an all-gather plan per (axis, bucket); ``bits``
    (the compressed modes) is the per-bucket wire width picked at set-up, 32
    on buckets that declined, frozen for the run."""

    spec: bucketing.BucketSpec
    plans: dict[str, tuple[planner.Plan, ...]]   # DP axis -> per-bucket plan
    rs_plans: dict[str, tuple[planner.Plan, ...]] | None = None
    ag_plans: dict[str, tuple[planner.Plan, ...]] | None = None
    bits: tuple[int, ...] | None = None          # per-bucket wire width


def _plan_axis_with_bits(size, bucket_bytes, bits, cost, backend, failures,
                         collective: str = "allreduce", depth: int = 1):
    """Plan one DP axis's buckets at fixed per-bucket wire widths, one batched
    planner call per width (the frozen-bits path of a compressed re-plan)."""
    out: list = [None] * len(bucket_bytes)
    groups: dict[int, list[int]] = {}
    for i, w in enumerate(bits):
        groups.setdefault(int(w), []).append(i)
    for w, idx in groups.items():
        sub = planner.plan_buckets(
            size, [bucket_bytes[i] for i in idx], cost, backend=backend,
            collective=collective, failures=failures, depth=depth, bits=w)
        for i, pl in zip(idx, sub):
            out[i] = pl
    return tuple(out)


def plan_gradient_sync(grads, tc: TrainConfig, mesh,
                       cost: planner.CostParams | None = None,
                       backend: str = "analytic",
                       sharded: bool = False,
                       failures=None,
                       depth: int = 1,
                       compress: bool = False,
                       bits_overrides=None) -> GradSyncPlans:
    """Partition the gradient tree into size-capped buckets and plan every
    bucket's schedule for every DP axis in one batched planner call per axis
    (and phase).  ``grads`` may hold meta tensors.  Bucket bytes are counted
    in the wire dtype (``tc.sync_dtype``).

    ``sharded=True``: per (DP axis, bucket) a ``reduce_scatter`` plan for the
    way down and an ``all_gather`` plan for the way back up, the all-gather
    seeing the shard left by every axis inside it.  ``failures`` re-plans
    against a degraded ring; ``depth > 1`` costs each reduce-scatter against
    its composed RS+AG interleaving.  ``compress=True`` sweeps each bucket
    over ``tc.compress_bits`` on the first DP axis and plans every other
    axis and phase at the widths found; ``bits_overrides`` skips the sweep.
    Every branch is the reference's, planner call for planner call.
    """
    spec = bucketing.plan_buckets(grads, tc.bucket_bytes)
    itemsize = torch.empty((), dtype=_dtype(tc.sync_dtype)).element_size()
    bucket_bytes = [s * itemsize for s in spec.bucket_sizes]
    axes = dp_axes_of(mesh)
    bits = tuple(int(w) for w in bits_overrides) if bits_overrides else None
    if not sharded:
        if not compress and bits is None:
            plans = {
                ax: tuple(planner.plan_buckets(mesh.shape[ax], bucket_bytes,
                                               cost, backend=backend,
                                               failures=failures))
                for ax in axes
            }
            return GradSyncPlans(spec, plans)
        plans = {}
        for ax in axes:
            if bits is None:
                swept = planner.plan_buckets(
                    mesh.shape[ax], bucket_bytes, cost, backend=backend,
                    failures=failures,
                    bits_candidates=tuple(tc.compress_bits))
                bits = tuple(int(p.detail.get("bits", 32)) for p in swept)
                plans[ax] = tuple(swept)
            else:
                plans[ax] = _plan_axis_with_bits(
                    mesh.shape[ax], bucket_bytes, bits, cost, backend,
                    failures)
        return GradSyncPlans(spec, plans, bits=bits)
    rs_plans, ag_plans = {}, {}
    shard_bytes = list(bucket_bytes)
    for ax in axes:
        size = mesh.shape[ax]
        if compress and bits is None:
            swept = planner.plan_buckets(
                size, shard_bytes, cost, backend=backend,
                collective="reduce_scatter", failures=failures, depth=depth,
                bits_candidates=tuple(tc.compress_bits))
            bits = tuple(int(p.detail.get("bits", 32)) for p in swept)
            rs_plans[ax] = tuple(swept)
        elif bits is not None:
            rs_plans[ax] = _plan_axis_with_bits(
                size, shard_bytes, bits, cost, backend, failures,
                collective="reduce_scatter", depth=depth)
        else:
            rs_plans[ax] = tuple(planner.plan_buckets(
                size, shard_bytes, cost, backend=backend,
                collective="reduce_scatter", failures=failures, depth=depth))
        if bits is not None:
            ag_plans[ax] = _plan_axis_with_bits(
                size, shard_bytes, bits, cost, backend, failures,
                collective="all_gather")
        else:
            ag_plans[ax] = tuple(planner.plan_buckets(
                size, shard_bytes, cost, backend=backend,
                collective="all_gather", failures=failures))
        shard_bytes = [b / size for b in shard_bytes]
    return GradSyncPlans(spec, {}, rs_plans=rs_plans, ag_plans=ag_plans, bits=bits)


def _dispatch_rs(flat, mesh, axis, size, plan: planner.Plan):
    """One bucket's planned reduce-scatter on one DP axis."""
    if size == 1:
        return flat
    if plan.strategy == "alltoall":
        return C.reduce_scatter_alltoall(flat, mesh, axis, size)
    return C.reduce_scatter_ring(flat, mesh, axis, size)


def _dispatch_ag(shard, mesh, axis, size, plan: planner.Plan):
    """One bucket's planned all-gather on one DP axis."""
    if size == 1:
        return shard
    if plan.strategy == "alltoall":
        return C.all_gather_alltoall(shard, mesh, axis, size)
    return C.all_gather_ring(shard, mesh, axis, size)


# ---------------------------------------------------------------------------
# online re-plan: strategy codes + SyncController
# ---------------------------------------------------------------------------

# the planned_sharded strategy menu per (axis, bucket, phase) is exactly
# {ring pass, single-step all-to-all}; the step dispatches on these codes,
# so a re-plan swaps schedules by handing the step new code arrays
STRAT_RING = 0
STRAT_ALLTOALL = 1


def _plan_code(plan: planner.Plan) -> int:
    return STRAT_ALLTOALL if plan.strategy == "alltoall" else STRAT_RING


def _dispatch_rs_dyn(flat, mesh, axis, size, code):
    """Code-driven twin of :func:`_dispatch_rs`."""
    if size == 1:
        return flat
    if int(code) == STRAT_ALLTOALL:
        return C.reduce_scatter_alltoall(flat, mesh, axis, size)
    return C.reduce_scatter_ring(flat, mesh, axis, size)


def _dispatch_ag_dyn(shard, mesh, axis, size, code):
    """Code-driven twin of :func:`_dispatch_ag`."""
    if size == 1:
        return shard
    if int(code) == STRAT_ALLTOALL:
        return C.all_gather_alltoall(shard, mesh, axis, size)
    return C.all_gather_ring(shard, mesh, axis, size)


def _sharded_rs_axes(flat, mesh, axes, sizes, plans: GradSyncPlans, i, codes=None):
    """The way down: reduce-scatter bucket ``i`` over every DP axis,
    innermost first.  Returns the owned shard and the pre-scatter lengths."""
    lengths = []
    for ax in axes:
        lengths.append(flat.shape[0])
        if codes is not None:
            flat = _dispatch_rs_dyn(flat, mesh, ax, sizes[ax], codes[f"rs:{ax}"][i])
        else:
            flat = _dispatch_rs(flat, mesh, ax, sizes[ax], plans.rs_plans[ax][i])
    return flat, lengths


def _sharded_ag_axes(flat, lengths, mesh, axes, sizes, plans: GradSyncPlans, i,
                     codes=None):
    """The way back up: all-gather bucket ``i``'s shard over the DP axes in
    reverse, slicing each level back to the length it scattered."""
    for ax, length in zip(reversed(axes), reversed(lengths)):
        if codes is not None:
            flat = _dispatch_ag_dyn(flat, mesh, ax, sizes[ax], codes[f"ag:{ax}"][i])
        else:
            flat = _dispatch_ag(flat, mesh, ax, sizes[ax], plans.ag_plans[ax][i])
        flat = flat[:length]
    return flat


def _sharded_sync_axes(flat, mesh, axes, sizes, plans: GradSyncPlans, i, codes=None):
    """RS down the DP axes, AG back up: between the phases every rank holds
    only its owned shard of the bucket."""
    flat, lengths = _sharded_rs_axes(flat, mesh, axes, sizes, plans, i, codes=codes)
    return _sharded_ag_axes(flat, lengths, mesh, axes, sizes, plans, i, codes=codes)


class SyncController:
    """Online re-planner for the sharded gradient sync.

    Owns the current :class:`GradSyncPlans` and publishes it as int32
    strategy-code tensors (one per DP axis and phase, indexed by bucket),
    which the step dispatches on; :meth:`replan` re-runs the planner under a
    ``FailureMask`` and returns new codes.  In the compressed mode the
    widths swept at set-up stay frozen across re-plans.  Plans are memoized
    per mask fingerprint (an LRU of ``MEMO_CAP``), seeded with the healthy
    plan, so a recovery re-plan is a hit (``last_replan_cached``).
    """

    MEMO_CAP = 8

    def __init__(self, abstract_grads, tc: TrainConfig, mesh,
                 cost: planner.CostParams | None = None,
                 backend: str = "analytic") -> None:
        self._grads = abstract_grads
        self._tc = tc
        self._mesh = mesh
        self._cost = cost
        self._backend = backend
        self.depth = tc.pipeline_depth if tc.sync_algorithm == "planned_pipelined" else 1
        self.compress = tc.sync_algorithm in COMPRESSED_ALGOS
        self.failures = None
        self.last_replan_s: float | None = None
        self.last_replan_cached = False
        self.replan_count = 0
        self.plans = plan_gradient_sync(abstract_grads, tc, mesh, cost, backend,
                                        sharded=True, depth=self.depth,
                                        compress=self.compress)
        self._plan_memo = OrderedDict({self._memo_key(None): self.plans})

    @staticmethod
    def _memo_key(failure_mask) -> str:
        return "healthy" if failure_mask is None else failure_mask.fingerprint()

    def arrays(self) -> dict:
        """The current plan as ``{"rs:<axis>"|"ag:<axis>" -> int32[n_buckets]}``
        strategy codes."""
        enc = {}
        for phase, plans in (("rs", self.plans.rs_plans), ("ag", self.plans.ag_plans)):
            for ax in dp_axes_of(self._mesh):
                enc[f"{phase}:{ax}"] = torch.tensor([_plan_code(p) for p in plans[ax]],
                                                    dtype=torch.int32)
        return enc

    def replan(self, failure_mask=None) -> dict:
        """Re-plan every (DP axis, bucket) schedule under ``failure_mask``
        (``None`` or an empty mask restores the healthy plan) and return the
        new strategy codes.  Raises ``DegradedInfeasibleError`` when the mask
        leaves no feasible schedule; the previous plan stays installed."""
        if failure_mask is not None and failure_mask.empty:
            failure_mask = None
        key = self._memo_key(failure_mask)
        t0 = time.perf_counter()
        if key in self._plan_memo:
            plans = self._plan_memo[key]
            self._plan_memo.move_to_end(key)
            self.last_replan_cached = True
        else:
            plans = plan_gradient_sync(self._grads, self._tc, self._mesh, self._cost,
                                       self._backend, sharded=True, failures=failure_mask,
                                       depth=self.depth, compress=self.compress,
                                       bits_overrides=self.plans.bits if self.compress
                                       else None)
            self._plan_memo[key] = plans
            while len(self._plan_memo) > self.MEMO_CAP:
                self._plan_memo.popitem(last=False)
            self.last_replan_cached = False
        self.last_replan_s = time.perf_counter() - t0
        self.plans = plans
        self.failures = failure_mask
        self.replan_count += 1
        return self.arrays()


def sync_gradients(grads, tc: TrainConfig, mesh, ef_state=None,
                   sync_plans: GradSyncPlans | None = None, plan_codes=None):
    """Explicit gradient sync over the mesh's DP axes.  Returns (mean grads,
    new EF state | None); both are the given trees, updated in place.

    ``sync_plans`` carries the set-up bucket partition and per-bucket
    schedules (derived here when absent); ``plan_codes`` (the
    :meth:`SyncController.arrays` codes) switches dispatch to the codes."""
    _check_mode(tc)
    axes = dp_axes_of(mesh)
    sizes = {a: mesh.shape[a] for a in axes}
    total = math.prod(sizes.values())
    compress = tc.sync_algorithm == "planned_sharded_compressed"
    plans = sync_plans or plan_gradient_sync(grads, tc, mesh, sharded=True,
                                             compress=compress)

    def bucket_fn(flat, nbytes, i):
        return _sharded_sync_axes(flat, mesh, axes, sizes, plans, i, codes=plan_codes)

    new_ef = None
    if compress:
        if ef_state is None:
            ef_state = map_tensors(torch.zeros_like, grads)
        grads, new_ef = bucketing.bucketed_apply_compressed(
            grads, ef_state, bucket_fn, plans.spec, bits=plans.bits,
            block=tc.compress_block, fused=tc.compress_fused_kernel,
            sync_dtype=_dtype(tc.sync_dtype))
    else:
        grads = bucketing.bucketed_apply_indexed(grads, bucket_fn, plans.spec,
                                                 sync_dtype=_dtype(tc.sync_dtype))
    with torch.no_grad():
        map_tensors(lambda g: g.div_(total), grads)
    return grads, new_ef


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def _microbatched_grads(loss_fn, params, batch, n_micro: int,
                        accum_dtype=torch.float32):
    """Loss and gradients, accumulated over ``n_micro`` splits of the
    batch's leading dimension (the mean over the splits)."""
    flat = [p for leaf in leaves(params) for p in parts(leaf)]
    if n_micro <= 1:
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, flat)
        return loss.detach(), metrics, _like_params(params, grads)
    b = next(iter(batch.values())).shape[0]
    if b % n_micro:
        raise ValueError(f"batch of {b} rows does not split into {n_micro} microbatches")
    rows = b // n_micro
    loss_sum = torch.zeros((), dtype=torch.float32, device=flat[0].device)
    acc = [torch.zeros(p.shape, dtype=accum_dtype, device=p.device) for p in flat]
    for k in range(n_micro):
        mb = {key: v[k * rows:(k + 1) * rows] for key, v in batch.items()}
        loss, _ = loss_fn(params, mb)
        for a, g in zip(acc, torch.autograd.grad(loss, flat)):
            a.add_(g.to(accum_dtype))
        loss_sum = loss_sum + loss.detach()
    for a in acc:
        a.mul_(1.0 / n_micro)
    return loss_sum * (1.0 / n_micro), {}, _like_params(params, acc)


def _like_params(params, flat_grads):
    """Gradients in ``leaves(params)`` part order, laid out as the params tree."""
    flat = [p for leaf in leaves(params) for p in parts(leaf)]
    by_id = {id(p): g for p, g in zip(flat, flat_grads)}
    return map_tensors(lambda p: by_id[id(p)], params)


def make_train_step(cfg: ModelConfig, tc: TrainConfig, mesh, device="cuda"):
    """Returns ``step(state, batch, plan_codes=None) -> (state, metrics)``.

    ``batch`` is this rank's block (``data.shard_batch``).  The step
    computes the local loss and gradients, syncs the gradients over the DP
    axes with the planned sharded schedules, takes the mean of the loss over
    the DP ranks (the reference's ``pmean``) and applies AdamW.  The
    returned function carries the ``SyncController`` as ``.controller``;
    passing ``controller.replan(mask)``'s codes as ``plan_codes`` swaps
    every (axis, bucket) schedule.
    """
    _check_mode(tc)
    if mesh is None or not dp_axes_of(mesh):
        raise ValueError("the planned sharded modes need a mesh with a 'data' or 'pod' "
                         "axis (a size-1 mesh on one rank)")
    if any(mesh.shape[a] > 1 for a in mesh.axis_names if a not in dp_axes_of(mesh)):
        raise NotImplementedError(f"mesh {dict(mesh.shape)}: only the DP axes 'data' and "
                                  f"'pod' are ported")
    dev = resolve_device(device)
    api = mapi.get_api(cfg, compute_dtype=_dtype(tc.compute_dtype), device=dev,
                       remat=tc.remat)
    lr_fn = make_lr_schedule(tc)
    axes = dp_axes_of(mesh)
    total = math.prod(mesh.shape[a] for a in axes)

    g_dtype = _dtype(tc.grad_accum_dtype if tc.microbatches > 1 else tc.param_dtype)
    abstract_grads = abstract_params(cfg, g_dtype)
    controller = SyncController(abstract_grads, tc, mesh)
    sync_plans = controller.plans

    def step(state, batch, plan_codes=None):
        params = state["params"]
        map_tensors(lambda p: p.requires_grad_(True), params)
        loss, metrics, grads = _microbatched_grads(
            api.loss, params, batch, tc.microbatches, accum_dtype=_dtype(tc.grad_accum_dtype))
        grads, new_ef = sync_gradients(grads, tc, mesh, state.get("ef"),
                                       sync_plans=sync_plans, plan_codes=plan_codes)
        loss = loss.float()
        if total > 1:
            for ax in axes:
                if mesh.shape[ax] > 1:
                    dist.all_reduce(loss, group=mesh.group(ax))
            loss = loss / total
        lr = lr_fn(state["step"])
        _, opt, om = adamw_update(grads, state["opt"], params, lr, tc)
        state["opt"] = opt
        state["step"] = state["step"] + 1
        if "ef" in state and new_ef is not None:
            state["ef"] = new_ef
        return state, {"loss": loss, "lr": lr, **om}

    step.controller = controller
    return step
