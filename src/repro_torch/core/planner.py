"""α–β planner: choose the all-reduce schedule per bucket (Lemma 1 on TPU).

The paper minimizes communication *steps* because each optical step pays a
fixed MRR-reconfiguration delay ``a``.  On TPU the same role is played by the
per-collective launch/hop latency α, against the per-byte term β = 1/BW.
This module is the TPU restatement of Lemma 1/Theorem 1: enumerate candidate
schedules, cost them under the α–β model, return the argmin.

    flat ring (psum)      T = 2(S-1)·α + 2·(S-1)/S·bytes·β
    recursive doubling    T = log2(S)·(α + bytes·β)
    m-ary WRHT tree       T = Σ_levels (α + ⌈(m-1)/links⌉·bytes·β)   [full-d]
                          (+ mirrored broadcast levels; optional final
                           all-to-all replaces the top reduce+broadcast pair)
    hierarchical scatter  T = Σ_i [2(f_i-1)·α + 2·bytes_i·(f_i-1)/f_i·β],
                          bytes_i = bytes / Π_{j<i} f_j   (mesh-factorized)

The crossover the paper exploits appears exactly here: small buckets are
latency-bound (few-step WRHT tree wins), huge buckets are bandwidth-bound
(flat or hierarchical scatter wins).  ``benchmarks/planner_crossover.py``
plots it; the trainer plans all of its gradient buckets in one amortized
:func:`plan_buckets` call at setup (DESIGN.md §10) and dispatches each
bucket from the cached plan.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace

import numpy as np

# TPU v5e-ish defaults (assignment constants; α calibratable, see DESIGN.md §4)
DEFAULT_ALPHA_S = 1e-6          # per collective step: launch + hop latency
DEFAULT_LINK_GBPS = 50.0        # ICI per link (decimal GB/s, vendor convention)
DEFAULT_LINKS = 4               # links per chip usable concurrently (ring: 2x2 dirs)

BYTES_PER_GB = 1e9              # GB/s -> bytes/s, defined once
BITS_PER_BYTE = 8               # bit/s link specs -> bytes/s


@dataclass(frozen=True)
class CostParams:
    alpha_s: float = DEFAULT_ALPHA_S
    link_bw_Bps: float = DEFAULT_LINK_GBPS * BYTES_PER_GB
    links: int = DEFAULT_LINKS
    # per-bucket compression compute (DESIGN.md §15): one quantize before the
    # wire + one dequantize after, each a fixed kernel launch plus a linear
    # pass over the *logical* fp32 bytes.  ~4e11 B/s is a VPU-bound
    # streaming pass; the planner uses these to decline compression on
    # buckets too small for the β-term savings to cover the overhead.
    quant_alpha_s: float = 2e-6
    quant_Bps: float = 4e11

    @staticmethod
    def tpu_v5e() -> "CostParams":
        return CostParams(alpha_s=DEFAULT_ALPHA_S, link_bw_Bps=50e9, links=DEFAULT_LINKS)

    @staticmethod
    def optical(w: int = 64) -> "CostParams":
        """The paper's regime: huge per-step cost, w parallel channels
        (40 Gb/s per wavelength, so bytes/s = bits/s over 8)."""
        return CostParams(alpha_s=25e-6, link_bw_Bps=40e9 / BITS_PER_BYTE,
                          links=2 * w)


@dataclass(frozen=True)
class Plan:
    """A chosen schedule for one bucket."""

    strategy: str   # "flat" | "rd" | "wrht_tree" | "hier_scatter" | "alltoall"
    cost_s: float
    m: int = 2                       # branching for wrht_tree
    alltoall: bool = False           # finish tree with all-to-all
    factors: tuple[int, ...] = ()    # per-level sizes for hier_scatter
    detail: dict = field(default_factory=dict, compare=False, hash=False)


# Cost closed forms.  The ``_arr`` versions over a bytes *axis* are the
# single implementation (every form is affine in bytes, so the batched
# planner evaluates candidate × bucket matrices in one pass); the scalar
# entry points below are one-element wrappers — float and float64 IEEE
# arithmetic coincide, so the two views are bit-identical.

def _t_flat_ring_arr(s: int, b: np.ndarray, p: CostParams) -> np.ndarray:
    if s == 1:
        return np.zeros(b.size)
    return 2 * (s - 1) * p.alpha_s + 2 * b * (s - 1) / s / p.link_bw_Bps


def _t_rd_arr(s: int, b: np.ndarray, p: CostParams) -> np.ndarray:
    if s == 1:
        return np.zeros(b.size)
    return math.ceil(math.log2(s)) * (p.alpha_s + b / p.link_bw_Bps)


def _t_wrht_tree_arr(s: int, b: np.ndarray, p: CostParams, m: int,
                     alltoall: bool) -> np.ndarray:
    if s == 1:
        return np.zeros(b.size)
    serial = math.ceil((m - 1) / p.links)  # sequential link occupations/level
    levels = max(1, math.ceil(math.log(s, m)))
    steps = 2 * levels - (1 if alltoall else 0)
    return steps * (p.alpha_s + serial * b / p.link_bw_Bps)


def _t_hier_scatter_arr(factors: tuple[int, ...], b: np.ndarray,
                        p: CostParams) -> np.ndarray:
    total = np.zeros(b.size)
    b = b.astype(np.float64)  # private copy: divided level by level
    for f in factors:
        if f == 1:
            continue
        total += 2 * (f - 1) * p.alpha_s + 2 * b * (f - 1) / f / p.link_bw_Bps
        b /= f
    return total


# Closed forms of the non-all-reduce collectives (DESIGN.md §11).  The ring
# pass is one half of the flat ring's RS+AG; the single-step all-to-all
# trades ⌈N²/8⌉ wavelengths for a single α; the broadcast tree is half the
# WRHT tree's step count.

def _t_ring_pass_arr(s: int, b: np.ndarray, p: CostParams) -> np.ndarray:
    """Ring reduce-scatter or all-gather: S-1 steps of b/S chunks."""
    if s == 1:
        return np.zeros(b.size)
    return (s - 1) * p.alpha_s + b * (s - 1) / s / p.link_bw_Bps


def _t_alltoall_arr(s: int, b: np.ndarray, p: CostParams) -> np.ndarray:
    """One full-mesh step of personalized b/S shards: each node serializes
    its S-1 messages over ``links`` concurrent channels."""
    if s == 1:
        return np.zeros(b.size)
    serial = math.ceil((s - 1) / p.links)
    return p.alpha_s + serial * (b / s) / p.link_bw_Bps


def _t_bcast_tree_arr(s: int, b: np.ndarray, p: CostParams,
                      m: int) -> np.ndarray:
    """WRHT broadcast tree alone: ⌈log_m S⌉ full-vector levels."""
    if s == 1:
        return np.zeros(b.size)
    serial = math.ceil((m - 1) / p.links)
    levels = max(1, math.ceil(math.log(s, m)))
    return levels * (p.alpha_s + serial * b / p.link_bw_Bps)


def _t_quant_arr(b: np.ndarray, p: CostParams, bits: int) -> np.ndarray:
    """Per-bucket quantize+dequantize compute overhead (DESIGN.md §15).

    Strategy-independent — a compressed bucket pays it whatever schedule
    moves the wire bits — so it adds *after* the per-width strategy argmin
    without disturbing tie-breaking.  Zero at full width."""
    if bits >= 32:
        return np.zeros(b.size)
    return np.full(b.size, 2 * p.quant_alpha_s) + 2 * b / p.quant_Bps


def _wire_bytes(b: np.ndarray, bits: int) -> np.ndarray:
    """Logical fp32 bytes → wire bytes at ``bits`` per element (exact: the
    supported widths are power-of-two fractions of 32)."""
    return b if bits == 32 else b * (bits / 32.0)


def _alltoall_feasible(s: int, p: CostParams, max_hops: int | None) -> bool:
    """Single-step all-to-all feasibility under the analytic model: the
    wavelength budget is ``links // 2`` (the exact inverse of
    ``CostParams.optical``/``OpticalParams.from_cost``), and the longest
    shortest-direction pair spans ``⌊S/2⌋`` ring segments."""
    if math.ceil(s ** 2 / 8) > max(1, p.links // 2):
        return False
    return max_hops is None or s // 2 <= max_hops


def _b1(bytes_: float) -> np.ndarray:
    return np.asarray([bytes_], dtype=np.float64)


def t_flat_ring(s: int, bytes_: float, p: CostParams) -> float:
    return float(_t_flat_ring_arr(s, _b1(bytes_), p)[0])


def t_rd(s: int, bytes_: float, p: CostParams) -> float:
    return float(_t_rd_arr(s, _b1(bytes_), p)[0])


def t_wrht_tree(s: int, bytes_: float, p: CostParams, m: int,
                alltoall: bool = True) -> float:
    """Full-vector m-ary tree, per the paper's Eq. (1) with the TPU twist
    that a head drains its m-1 members over ``links`` parallel channels."""
    return float(_t_wrht_tree_arr(s, _b1(bytes_), p, m, alltoall)[0])


def t_hier_scatter(factors: tuple[int, ...], bytes_: float, p: CostParams) -> float:
    return float(_t_hier_scatter_arr(factors, _b1(bytes_), p)[0])


def _factorizations(n: int, max_levels: int = 3) -> list[tuple[int, ...]]:
    """All ordered factorizations of n into 1..max_levels factors >= 2."""
    out = [(n,)]
    if max_levels == 1:
        return out
    f = 2
    while f * f <= n:
        if n % f == 0:
            for rest in _factorizations(n // f, max_levels - 1):
                out.append((f,) + rest)
                if n // f != f:
                    out.append(rest + (f,))
        f += 1
    # dedupe preserving order
    seen, uniq = set(), []
    for t in out:
        if t not in seen:
            seen.add(t)
            uniq.append(t)
    return uniq


DEFAULT_STRATEGIES: dict[str, tuple[str, ...]] = {
    "allreduce": ("flat", "rd", "wrht_tree", "hier_scatter"),
    "reduce_scatter": ("flat", "alltoall"),
    "all_gather": ("flat", "alltoall"),
    "broadcast": ("wrht_tree",),
    "alltoall": ("alltoall",),
}


def plan_bucket(
    axis_size: int,
    bytes_: float,
    params: CostParams | None = None,
    m_candidates: tuple[int, ...] = (2, 3, 4, 8, 16),
    allow: tuple[str, ...] | None = None,
    max_hops: int | None = None,
    backend: str = "analytic",
    optical: "object | None" = None,
    collective: str = "allreduce",
    failures: "object | None" = None,
    depth: int = 1,
    bits: int = 32,
    bits_candidates: "tuple[int, ...] | None" = None,
) -> Plan:
    """Return the minimum-cost schedule for one bucket on one device axis.

    ``max_hops`` is the optical insertion-loss hop budget (see
    ``topology.PhysicalParams.max_hops``): a WRHT tree fan-out ``m`` whose
    middle representative would have to reach members more than ``max_hops``
    positions away (``m > 2·max_hops + 1``) is physically infeasible and is
    never enumerated.

    ``backend`` selects the cost model: ``"analytic"`` (the closed-form α–β
    expressions above) or ``"simulated"`` — the same candidate schedules
    costed by the flit-level optical simulator through the batched timing
    engine (``repro.core.timing``), making the two models interchangeable.
    Under ``backend="simulated"``, ``optical`` optionally supplies explicit
    ``step_models.OpticalParams`` (otherwise derived from ``params`` via
    ``OpticalParams.from_cost``); the ``"rd"`` strategy is skipped (it has
    no explicit optical-ring schedule) and ``"hier_scatter"`` is costed via
    the H-Ring schedule, i.e. only its two-level factorizations.

    ``collective`` plans any member of the scheduled collective algebra
    (DESIGN.md §11), with per-collective candidate strategies
    (:data:`DEFAULT_STRATEGIES`): the ring passes choose between the
    bandwidth-optimal ``"flat"`` ring pass and the single-step
    ``"alltoall"`` finisher (when it fits the wavelength/hop budgets); a
    broadcast sweeps the tree fan-out.

    ``failures`` plans against a degraded ring
    (:class:`~repro.core.topology.FailureMask`, DESIGN.md §12).  The
    simulated backend is exact: every candidate is the degraded builder's
    actual relay/detour schedule, and candidates the mask makes unroutable
    are skipped.  The analytic backend only models the λ loss — the
    channel count shrinks by the worst per-node dead-wavelength count —
    because its closed forms have no route notion; use the simulated
    backend when dead arcs/transceivers matter.

    ``depth`` costs the depth-k composed pipeline against the serial
    baseline (DESIGN.md §13) — see :func:`plan_buckets`.

    ``bits``/``bits_candidates`` make the wire width a plan axis
    (DESIGN.md §15) — see :func:`plan_buckets`.

    This is the one-bucket view of :func:`plan_buckets` — a single
    candidate-scan implementation serves both (DESIGN.md §10).
    """
    return plan_buckets(axis_size, [bytes_], params, m_candidates, allow,
                        max_hops, backend, optical, collective, failures,
                        depth, bits, bits_candidates)[0]


def plan_buckets(
    axis_size: int,
    byte_sizes,
    params: CostParams | None = None,
    m_candidates: tuple[int, ...] = (2, 3, 4, 8, 16),
    allow: tuple[str, ...] | None = None,
    max_hops: int | None = None,
    backend: str = "analytic",
    optical: "object | None" = None,
    collective: str = "allreduce",
    failures: "object | None" = None,
    depth: int = 1,
    bits: int = 32,
    bits_candidates: "tuple[int, ...] | None" = None,
) -> list[Plan]:
    """Plan a whole list of gradient-bucket sizes in one batched call.

    The amortized counterpart of :func:`plan_bucket` (DESIGN.md §10):
    returns ``[plan_bucket(axis_size, b, ...) for b in byte_sizes]``,
    *identically* (same strategies, same costs, same tie-breaking — the
    per-bucket argmin scans candidates in the same order with a strict
    ``<``), but with the work amortized across buckets:

    * analytic backend — every closed form is affine in ``bytes``, so the
      whole candidate × bucket cost matrix evaluates in one vectorized pass;
    * simulated backend — schedules are built and compiled once per
      candidate through the plan cache and the batched timing engine
      evaluates the entire payload axis per candidate (one
      :func:`repro.core.timing.tune_wrht` sweep serves every bucket), so
      the marginal cost of a bucket is one column of array arithmetic, not
      a schedule walk.

    The training stack calls this once at setup with every bucket size of
    the gradient partition (``repro.train.train_step.plan_gradient_sync``);
    warm calls hit the plan cache and skip both build and compile.

    ``depth>1`` additionally costs the depth-k *composed pipeline*
    (DESIGN.md §13: ``collective`` alternating with its partner phase —
    RS↔AG — interleaved on one ring with fused RWA) against the serial
    baseline (the sum of the constituents' serial best costs).  Buckets
    where the composition wins get the amortized per-phase composed cost
    and ``detail["pipeline"]["composed"]=True``; buckets where it does not
    keep their serial plan, with the comparison recorded honestly.

    ``bits`` plans at a fixed wire width (DESIGN.md §15): every strategy's
    β-term shrinks by exactly ``bits/32`` and a strategy-independent
    per-bucket quantize+dequantize compute term is added, recorded in
    ``detail["quant_s"]``.  ``bits_candidates`` (e.g. ``(32, 8, 4)``)
    instead *sweeps* the width per bucket: each width plans independently
    and the per-bucket winner is returned with ``detail["bits"]`` (the
    chosen width — 32 means the tuner declined compression for that
    bucket) and ``detail["compression"]`` (every width's best cost, so the
    decline is auditable).
    """
    if collective not in DEFAULT_STRATEGIES:
        raise ValueError(f"unknown collective {collective!r} "
                         f"(expected one of {sorted(DEFAULT_STRATEGIES)})")
    if depth < 1:
        raise ValueError("pipeline depth must be >= 1")
    if bits_candidates is not None:
        widths = tuple(dict.fromkeys(int(w) for w in bits_candidates))
        if not widths:
            raise ValueError("bits_candidates must name at least one width")
        per_width = {
            wd: plan_buckets(axis_size, byte_sizes, params, m_candidates,
                             allow, max_hops, backend, optical, collective,
                             failures, depth, wd)
            for wd in widths
        }
        merged: list[Plan] = []
        for i in range(len(per_width[widths[0]])):
            # first-argmin over widths in candidate order (strict <), like
            # the strategy scan's tie-breaking
            best_wd = widths[0]
            best_pl = per_width[best_wd][i]
            for wd in widths[1:]:
                if per_width[wd][i].cost_s < best_pl.cost_s:
                    best_wd, best_pl = wd, per_width[wd][i]
            detail = dict(best_pl.detail)
            detail["bits"] = best_wd
            detail["compression"] = {
                str(wd): float(per_width[wd][i].cost_s) for wd in widths}
            merged.append(replace(best_pl, detail=detail))
        return merged
    if bits < 1 or bits > 32:
        raise ValueError("wire width must satisfy 1 <= bits <= 32")
    p = params or CostParams.tpu_v5e()
    if failures is not None and failures.empty:
        failures = None
    if failures is not None and backend == "analytic":
        if failures.disconnects(axis_size):
            # a severed ring has no feasible schedule regardless of backend:
            # raise the uniform infeasibility signal HERE so the analytic
            # path agrees with the simulated one at the cliff (DESIGN.md §14)
            from .wrht import DegradedInfeasibleError
            raise DegradedInfeasibleError(
                f"failure mask severs the N={axis_size} ring "
                f"({failures!r}): no strategy can reach every node")
        # the closed forms have no route notion — the mask enters only as a
        # conservative channel shrink (worst per-node λ loss halves `links`
        # symmetrically, matching wrht.effective_wavelengths)
        w_eff = max(1, p.links // 2 - failures.max_dead_lambda_per_node())
        p = replace(p, links=2 * w_eff)
    b = np.asarray(list(byte_sizes), dtype=np.float64)
    if allow is None:
        allow = DEFAULT_STRATEGIES[collective]
    if collective != "allreduce":
        plans = _plan_buckets_collective(axis_size, b, p, m_candidates, allow,
                                         max_hops, backend, optical,
                                         collective, failures, bits)
    elif backend == "simulated":
        plans = _plan_buckets_simulated(axis_size, b, p, m_candidates, allow,
                                        max_hops, optical, failures, bits)
    elif backend != "analytic":
        raise ValueError(f"unknown backend {backend!r} "
                         "(expected 'analytic' or 'simulated')")
    else:
        bw = _wire_bytes(b, bits)
        best, consider = _bucket_argmin(b.size)

        # candidate enumeration order matches plan_bucket exactly, so the
        # strict-< update reproduces its first-argmin tie-breaking
        if "flat" in allow:
            consider(_t_flat_ring_arr(axis_size, bw, p),
                     lambda i, c: Plan("flat", c))
        if "rd" in allow and axis_size & (axis_size - 1) == 0:
            consider(_t_rd_arr(axis_size, bw, p), lambda i, c: Plan("rd", c))
        if "wrht_tree" in allow:
            fan_out_cap = None if max_hops is None else 2 * max_hops + 1
            for m in m_candidates:
                if m < 2 or m > axis_size:
                    continue
                if fan_out_cap is not None and m > fan_out_cap:
                    continue
                for a2a in (True, False):
                    consider(
                        _t_wrht_tree_arr(axis_size, bw, p, m, a2a),
                        lambda i, c, m=m, a2a=a2a: Plan("wrht_tree", c, m=m,
                                                        alltoall=a2a))
        if "hier_scatter" in allow:
            for factors in _factorizations(axis_size):
                consider(_t_hier_scatter_arr(factors, bw, p),
                         lambda i, c, f=factors: Plan("hier_scatter", c,
                                                      factors=f))
        assert all(pl is not None for pl in best)
        plans = best
    if bits != 32:
        # strategy-independent per-bucket compression compute: added after
        # the strategy argmin (cannot disturb it), before the pipeline
        # comparison (each serial phase pays it, see _cost_pipelined)
        over = _t_quant_arr(b, p, bits)
        plans = [
            replace(pl, cost_s=pl.cost_s + float(over[i]),
                    detail={**pl.detail, "bits": bits,
                            "quant_s": float(over[i])})
            for i, pl in enumerate(plans)
        ]
    if depth > 1 and axis_size > 1:
        plans = _cost_pipelined(axis_size, b, p, params, plans, depth,
                                m_candidates, max_hops, backend, optical,
                                collective, failures, bits)
    return plans


def _bucket_argmin(n_buckets: int):
    """Strict-< per-bucket argmin scaffolding shared by the two
    ``plan_buckets`` backends: candidates scanned in ``plan_bucket``'s
    enumeration order keep its exact first-argmin tie-breaking.  Returns
    the result list and ``consider(cost[B], make_plan(i, cost_i))``."""
    best: list[Plan | None] = [None] * n_buckets
    best_cost = np.full(n_buckets, np.inf)

    def consider(cost: np.ndarray, make_plan) -> None:
        mask = cost < best_cost
        if mask.any():
            best_cost[mask] = cost[mask]
            for i in np.flatnonzero(mask):
                best[i] = make_plan(int(i), float(cost[i]))

    return best, consider


def _cost_pipelined(
    axis_size: int,
    b: np.ndarray,
    p: CostParams,
    params: CostParams | None,
    plans: list[Plan],
    depth: int,
    m_candidates: tuple[int, ...],
    max_hops: int | None,
    backend: str,
    optical,
    collective: str,
    failures,
    bits: int = 32,
) -> list[Plan]:
    """Cost the depth-k composed pipeline against the serial baseline
    (DESIGN.md §13) and adopt it per bucket where it wins.

    Serial baseline: the sum of each constituent phase's serial best cost
    (the partner phase is planned through the same backend).  Composed
    cost: the fused timeline's total — exact via the flit-level engine on
    the composed profile for the simulated backend; closed-form for the
    analytic backend (``depth`` concurrent ring passes fuse in groups of
    ``w = links // 2`` — each pass occupies one wavelength per fused slot —
    so the pipeline costs ``⌈depth / w⌉`` serial passes; tree collectives
    have no analytic overlap model and keep their serial plans).  The
    adopted ``cost_s`` is the amortized per-phase share
    ``composed_total / depth``; either way ``detail["pipeline"]`` records
    the comparison.
    """
    from dataclasses import replace as _replace

    from . import compose

    colls = compose.pipeline_collectives(collective, depth)
    serial = np.asarray([pl.cost_s for pl in plans], dtype=np.float64)
    by_coll = {colls[0]: serial}
    for c in dict.fromkeys(colls[1:]):
        if c in by_coll:
            continue
        # the ORIGINAL params go back in — plan_buckets re-applies the
        # analytic mask shrink itself, so passing the shrunk `p` would
        # double-count the λ loss
        by_coll[c] = np.asarray(
            [pl.cost_s for pl in plan_buckets(
                axis_size, b, params, m_candidates, None, max_hops, backend,
                optical, c, failures, 1, bits)], dtype=np.float64)
    serial_sum = np.sum([by_coll[c] for c in colls], axis=0)

    composed_total = None
    reason = None
    ring_pass_only = all(c in ("reduce_scatter", "all_gather")
                         for c in colls)
    if backend == "simulated":
        from . import step_models, timing, wrht
        from .wavelength import InsertionLossError, WavelengthConflictError

        opt = optical or step_models.OpticalParams.from_cost(
            p.alpha_s, p.link_bw_Bps, p.links
        )
        if max_hops is None and opt.physical is not None:
            max_hops = opt.physical.max_hops
        try:
            composed_total = timing.collective_times(
                collective, axis_size, b * 8, opt, opt.timing,
                max_hops=max_hops, keep_per_step=False, failures=failures,
                depth=depth, bits=bits).total_s
        except (InsertionLossError, WavelengthConflictError,
                wrht.DegradedInfeasibleError) as e:
            reason = f"composed pipeline infeasible: {e}"
    elif ring_pass_only:
        w = max(1, p.links // 2)
        composed_total = (math.ceil(depth / w)
                          * _t_ring_pass_arr(axis_size, _wire_bytes(b, bits),
                                             p))
    else:
        reason = ("analytic backend has no overlap model for "
                  f"constituents {sorted(set(colls))}")
    if composed_total is not None and bits != 32:
        # fairness vs the serial baseline: every serial phase's cost already
        # carries the per-bucket quantize/dequantize term, so the composed
        # timeline pays it once per constituent phase too
        composed_total = composed_total + depth * _t_quant_arr(b, p, bits)

    out = []
    for i, pl in enumerate(plans):
        info = {
            "depth": depth,
            "constituents": list(colls),
            "serial_s": float(serial_sum[i]),
            "composed_s": (None if composed_total is None
                           else float(composed_total[i])),
        }
        if reason is not None:
            info["reason"] = reason
        detail = dict(pl.detail)
        if composed_total is not None and composed_total[i] < serial_sum[i]:
            info["composed"] = True
            info["gain"] = 1.0 - float(composed_total[i]) / float(serial_sum[i])
            detail["pipeline"] = info
            out.append(_replace(pl, cost_s=float(composed_total[i]) / depth,
                                detail=detail))
        else:
            info["composed"] = False
            detail["pipeline"] = info
            out.append(_replace(pl, detail=detail))
    return out


def _plan_buckets_simulated(
    axis_size: int,
    b: np.ndarray,
    p: CostParams,
    m_candidates: tuple[int, ...],
    allow: tuple[str, ...],
    max_hops: int | None,
    optical,
    failures=None,
    bits: int = 32,
) -> list[Plan]:
    """The simulated backend: candidate schedules costed by the flit-level
    simulator over the whole ``d_bits`` axis at once, so every bucket shares
    the same compiled profiles (and the plan cache keeps them warm across
    calls).  Candidate mapping: ``flat`` → the 2(N-1)-step optical ring,
    ``wrht_tree`` → the WRHT sweep of :func:`repro.core.timing.tune_wrht`,
    ``hier_scatter`` → the H-Ring schedule per two-level factorization; all
    costed under the optical model's timing engine, like ``run_optical``.
    ``bits<32`` evaluates every candidate at the compressed wire width: the
    tuner compiles width-scaled profiles under ``bits``-stamped keys, and
    the fixed flat/H-Ring profiles evaluate at the width-scaled payload
    (bit-identical — the width factor is a power-of-two exponent shift that
    commutes with every division chain).  Imports the simulator stack
    lazily so the analytic planner keeps zero package dependencies."""
    from . import step_models, timing, wrht
    from .wavelength import InsertionLossError

    opt = optical or step_models.OpticalParams.from_cost(
        p.alpha_s, p.link_bw_Bps, p.links
    )
    # effective hop budget: an explicit max_hops wins, else the optical
    # physical model's — must match what tune_wrht derives, or the candidate
    # pre-filter below would let through fan-outs the tuner then rejects
    if max_hops is None and opt.physical is not None:
        max_hops = opt.physical.max_hops
    detail = {"backend": "simulated"}
    if axis_size == 1:
        return [Plan("flat", 0.0, detail=dict(detail)) for _ in range(b.size)]
    d_bits = b * 8
    d_wire = d_bits if bits == 32 else d_bits * (bits / 32.0)
    best, consider = _bucket_argmin(b.size)

    if "flat" in allow and failures is None:
        # the flat ring is a fixed wavelength-0 neighbour pattern with no
        # route-around — under a mask only the WRHT builder can replan
        cost = timing.ring_times(axis_size, d_wire, opt, opt.timing).total_s
        consider(cost, lambda i, c: Plan("flat", c, detail=dict(detail)))
    if "wrht_tree" in allow:
        cap = wrht.feasible_group_size(opt.wavelengths, max_hops,
                                       failures=failures)
        ms = tuple(m for m in m_candidates if 2 <= m <= min(axis_size, cap))
        if ms:
            try:
                tuned = timing.tune_wrht(axis_size, opt.wavelengths, d_bits,
                                         max_hops, p=opt, timing=opt.timing,
                                         m_candidates=ms, failures=failures,
                                         bits=bits)
            except wrht.DegradedInfeasibleError:
                tuned = None
            if tuned is not None:
                consider(tuned.best_total_s,
                         lambda i, c: Plan("wrht_tree", c,
                                           m=int(tuned.best_m[i]),
                                           alltoall=bool(
                                               tuned.best_alltoall[i]),
                                           detail=dict(detail)))
    if "hier_scatter" in allow and failures is None:
        for factors in _factorizations(axis_size, max_levels=2):
            if len(factors) != 2 or factors[0] < 2 or axis_size % factors[0]:
                continue
            try:
                cost = timing.hring_times(axis_size, d_wire, opt, opt.timing,
                                          g=factors[0]).total_s
            except InsertionLossError:
                continue
            consider(cost, lambda i, c, f=factors:
                     Plan("hier_scatter", c, factors=f, detail=dict(detail)))
    # "rd" has no explicit optical-ring schedule: skipped under this backend
    if any(pl is None for pl in best):
        if failures is not None:
            from .wrht import DegradedInfeasibleError

            raise DegradedInfeasibleError(
                "no strategy survives the failure mask for the simulated "
                f"backend (allow={allow!r}, failures={failures!r})"
            )
        raise ValueError(
            "no strategy in `allow` has an optical-ring schedule for the "
            f"simulated backend (allow={allow!r})"
        )
    return best


def _plan_buckets_collective(
    axis_size: int,
    b: np.ndarray,
    p: CostParams,
    m_candidates: tuple[int, ...],
    allow: tuple[str, ...],
    max_hops: int | None,
    backend: str,
    optical,
    collective: str,
    failures=None,
    bits: int = 32,
) -> list[Plan]:
    """Candidate scan for the non-all-reduce collectives (DESIGN.md §11).

    The analytic and simulated backends share one enumeration order (flat
    ring pass, then the single-step all-to-all, then the broadcast-tree
    fan-out sweep), so tie-breaking matches across backends exactly like
    the all-reduce path.  The simulated backend costs the same schedules
    the optical simulator executes (``timing.collective_times``); an
    all-to-all beyond the wavelength or hop budget is skipped, never
    silently mis-costed.
    """
    if backend not in ("analytic", "simulated"):
        raise ValueError(f"unknown backend {backend!r} "
                         "(expected 'analytic' or 'simulated')")
    detail = {"backend": backend, "collective": collective}
    if axis_size == 1:
        return [Plan("flat", 0.0, detail=dict(detail)) for _ in range(b.size)]
    best, consider = _bucket_argmin(b.size)
    simulated = backend == "simulated"
    if simulated:
        from . import step_models, timing, wrht
        from .wavelength import InsertionLossError, WavelengthConflictError

        opt = optical or step_models.OpticalParams.from_cost(
            p.alpha_s, p.link_bw_Bps, p.links
        )
        if max_hops is None and opt.physical is not None:
            max_hops = opt.physical.max_hops
        d_bits = b * 8

        def simulated_cost(coll, **kw):
            try:
                return timing.collective_times(
                    coll, axis_size, d_bits, opt, opt.timing,
                    max_hops=max_hops, keep_per_step=False,
                    failures=failures, bits=bits, **kw).total_s
            except (InsertionLossError, WavelengthConflictError,
                    wrht.DegradedInfeasibleError):
                return None

    bw = _wire_bytes(b, bits)
    ring_pass = collective if collective in ("reduce_scatter",
                                             "all_gather") else None
    if "flat" in allow and ring_pass is not None:
        cost = (simulated_cost(ring_pass) if simulated
                else _t_ring_pass_arr(axis_size, bw, p))
        if cost is not None:
            consider(cost, lambda i, c: Plan("flat", c, detail=dict(detail)))
    if "alltoall" in allow:
        if simulated:
            cost = simulated_cost("alltoall")
        else:
            cost = (_t_alltoall_arr(axis_size, bw, p)
                    if _alltoall_feasible(axis_size, p, max_hops) else None)
        if cost is not None:
            consider(cost, lambda i, c: Plan("alltoall", c,
                                             detail=dict(detail)))
    if "wrht_tree" in allow and collective == "broadcast":
        fan_out_cap = None if max_hops is None else 2 * max_hops + 1
        ms = tuple(m for m in m_candidates
                   if 2 <= m <= axis_size
                   and (fan_out_cap is None or m <= fan_out_cap))
        if simulated:
            # same Lemma-1/hop-budget pre-filter as the all-reduce simulated
            # path: candidates beyond the tuner's feasible fan-out would make
            # it raise its internal "no feasible candidates" error instead of
            # this planner's uniform one below
            cap = wrht.feasible_group_size(opt.wavelengths, max_hops,
                                           failures=failures)
            ms = tuple(m for m in ms if m <= cap)
            if ms:
                try:
                    tuned = timing.tune_wrht(axis_size, opt.wavelengths,
                                             d_bits, max_hops, p=opt,
                                             timing=opt.timing,
                                             m_candidates=ms,
                                             collective="broadcast",
                                             failures=failures, bits=bits)
                except wrht.DegradedInfeasibleError:
                    tuned = None
                if tuned is not None:
                    consider(tuned.best_total_s,
                             lambda i, c: Plan("wrht_tree", c,
                                               m=int(tuned.best_m[i]),
                                               detail=dict(detail)))
        else:
            for m in ms:
                consider(_t_bcast_tree_arr(axis_size, bw, p, m),
                         lambda i, c, m=m: Plan("wrht_tree", c, m=m,
                                                detail=dict(detail)))
    if any(pl is None for pl in best):
        if failures is not None and simulated:
            from .wrht import DegradedInfeasibleError

            raise DegradedInfeasibleError(
                f"no strategy in allow={allow!r} survives the failure mask "
                f"for collective {collective!r} at axis_size={axis_size}"
            )
        raise ValueError(
            f"no feasible strategy in allow={allow!r} for collective "
            f"{collective!r} at axis_size={axis_size}"
        )
    return best


def crossover_table(
    axis_size: int,
    byte_sizes: tuple[float, ...] = tuple(2.0 ** e for e in range(10, 31, 2)),
    params: CostParams | None = None,
    backend: str = "analytic",
    max_hops: int | None = None,
    optical: "object | None" = None,
    collective: str = "allreduce",
    bits: int = 32,
    bits_candidates: "tuple[int, ...] | None" = None,
) -> list[dict]:
    """Bucket-size sweep: which schedule wins where (benchmark + tests).

    ``backend``/``max_hops``/``optical``/``bits``/``bits_candidates`` pass
    straight through to the planner, so the crossover benchmarks can sweep
    the flit-level simulated backend (and a hop budget, and compressed wire
    widths) next to the analytic closed forms; the whole sweep is one
    :func:`plan_buckets` call.
    """
    plans = plan_buckets(axis_size, byte_sizes, params, backend=backend,
                         max_hops=max_hops, optical=optical,
                         collective=collective, bits=bits,
                         bits_candidates=bits_candidates)
    return [
        {
            "bytes": int(b),
            "strategy": plan.strategy,
            "m": plan.m,
            "factors": plan.factors,
            "cost_us": plan.cost_s * 1e6,
            **({"bits": plan.detail["bits"]} if "bits" in plan.detail else {}),
        }
        for b, plan in zip(byte_sizes, plans)
    ]
