"""WRHT — Wavelength-Reused Hierarchical Tree schedule builder + the
scheduled collective algebra (DESIGN.md §11).

The paper derives WRHT only for all-reduce (Sec. III-C), but its two phases
are a wavelength-reused reduce tree followed by a broadcast tree.  This
module exposes those phases — plus the ring reduce-scatter / all-gather pass
and the single-step all-to-all finisher — as first-class plannable
collectives (:class:`Collective`, :func:`build_collective_schedule`), each
with an explicit semantic spec (per-node contribution/ownership masks and
payload-per-step accounting) validated by :func:`validate_schedule`.

For the paper's all-reduce, given ``N`` nodes on a bidirectional WDM ring
with ``w`` wavelengths per fiber, build the explicit per-step transfer
schedule:

Reduce stage
    Level 0 partitions the ring into contiguous groups of ``m`` nodes; the
    *middle* node of each group is the representative and receives every
    member's (partially reduced) vector in ONE step — members to its left
    transmit clockwise, members to its right counter-clockwise, so the two
    fibers are loaded symmetrically and ``⌈m/2⌉`` wavelengths suffice.
    Representatives of level ``ℓ`` are regrouped at level ``ℓ+1``.  Recursion
    stops when the surviving representatives can finish with a single
    all-to-all exchange within the wavelength budget (paper Sec. III-C-2:
    ``⌈m*²/8⌉`` wavelengths, citation [16]), or when one root remains.

Broadcast stage
    Exact reverse of the reduce stage (paths reversed, same wavelength
    budget).  Because a reduction is applied at every reduce step, every
    transfer in BOTH stages carries the constant full vector of ``d`` bits.

Total steps: ``2⌈log_m N⌉`` (single root) or ``2⌈log_m N⌉ − 1`` (final
all-to-all) — asserted against the closed forms in ``step_models`` by the
test-suite.  ``m = 2w + 1`` is the Lemma-1 optimum: each fiber then carries
exactly ``w`` concurrent intra-group lightpaths.

Steps are represented as :class:`~repro.core.topology.TransferBatch`
structure-of-arrays (see DESIGN.md §1); transfer generation, RWA, conflict
validation and the semantic data-flow check are all array programs, so
building *and fully validating* a schedule is cheap even at N=32768.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field

import numpy as np

from .topology import CCW, CW, FailureMask, PhysicalParams, Ring, TransferBatch
from .wavelength import (
    InsertionLossError,
    WavelengthConflictError,
    _covers_dead_segment,
    _uses_dead_transceiver,
    first_fit_assign,
    first_fit_assign_concat,
    first_fit_assign_reference,
    split_overlong_arcs,
    validate_no_conflicts,
)


class DegradedInfeasibleError(RuntimeError):
    """No feasible schedule exists under the given :class:`FailureMask`.

    The uniform infeasibility signal of degraded-mode building
    (DESIGN.md §12): raised when a transfer's route is cut in *both* ring
    directions, when no live O/E/O relay exists within the hop budget, or
    when the surviving wavelengths cannot carry a required step (the
    original :class:`WavelengthConflictError` is chained as ``__cause__``).
    Healthy-mode builds (no mask) never raise this.
    """


@dataclass
class Step:
    kind: str                      # "reduce" | "alltoall" | "broadcast" | ...
    level: int                     # tree level (alltoall: top level)
    transfers: TransferBatch
    # chunked collectives (reduce_scatter / all_gather / alltoall): shard id
    # carried by each transfer row — TransferBatch stays payload-agnostic,
    # the chunk identity lives on the Step so a shared batch object can back
    # many steps each moving different shards (DESIGN.md §11)
    chunks: np.ndarray | None = None

    def __post_init__(self) -> None:
        self.transfers = TransferBatch.coerce(self.transfers)

    @property
    def wavelengths(self) -> int:
        return 1 + self.transfers.max_wavelength if len(self.transfers) else 0


@dataclass
class WRHTSchedule:
    n: int
    w: int
    m: int
    steps: list[Step] = field(default_factory=list)
    levels: list[list[int]] = field(default_factory=list)  # active nodes per level
    max_hops: int | None = None            # insertion-loss hop budget, if any
    level_group_sizes: list[int] = field(default_factory=list)  # m used per level
    collective: str = "allreduce"          # which Collective this schedule runs
    failures: FailureMask | None = None    # mask the schedule routes around

    @property
    def num_steps(self) -> int:
        return len(self.steps)

    @property
    def reduce_steps(self) -> int:
        return sum(1 for s in self.steps if s.kind in ("reduce", "alltoall"))

    @property
    def broadcast_steps(self) -> int:
        return sum(1 for s in self.steps if s.kind == "broadcast")


# ------------------------------------------------------------------
# The scheduled collective algebra (DESIGN.md §11).
# ------------------------------------------------------------------

class Collective(str, enum.Enum):
    """The collectives the schedule builder can emit on the optical ring.

    Every member reuses phases of the all-reduce machinery (DESIGN.md §11):

    ``ALLREDUCE``       reduce tree [+ all-to-all finisher] + broadcast tree
                        (the paper's WRHT, Sec. III-C); full ``d`` per step.
    ``REDUCE_SCATTER``  ring pass: ``N-1`` neighbour steps of ``d/N`` chunks;
                        node ``i`` ends owning the complete reduction of
                        chunk ``i``.
    ``ALL_GATHER``      ring pass, mirrored: node ``i`` starts owning chunk
                        ``i``; ``N-1`` steps later every node holds every
                        chunk.
    ``BROADCAST``       the WRHT broadcast tree alone: the root (the tree's
                        final surviving representative) propagates the full
                        vector down the levels; full ``d`` per step.
    ``ALLTOALL``        the single-step full-mesh exchange (paper
                        Sec. III-C-2 / [16]): every ordered pair trades a
                        personalized ``d/N`` shard in ONE reconfiguration,
                        needing ``⌈N²/8⌉`` wavelengths — the one-step
                        finisher for reduce-scatter *and* all-gather.
    """

    ALLREDUCE = "allreduce"
    REDUCE_SCATTER = "reduce_scatter"
    ALL_GATHER = "all_gather"
    BROADCAST = "broadcast"
    ALLTOALL = "alltoall"


@dataclass(frozen=True)
class CollectiveSpec:
    """Semantic spec of one scheduled collective (DESIGN.md §11).

    ``tree`` marks the fan-out ``m`` (and, for all-reduce, the all-to-all
    finisher flag) as meaningful plan dimensions; ``chunked`` marks the
    payload accounting: every transfer carries ``d / n`` bits (the division
    chain :meth:`payload_divisors`) instead of the constant full vector.
    Ownership semantics are enforced by :func:`validate_schedule` against
    the data-flow oracles below.
    """

    name: str
    tree: bool
    chunked: bool
    description: str

    def payload_divisors(self, n: int) -> tuple[float, ...]:
        """Division chain from the payload ``d`` to one transfer's bits
        (the ``timing.PayloadClass`` contract: applied left to right)."""
        return (float(n),) if self.chunked else ()


COLLECTIVES: dict[str, CollectiveSpec] = {
    "allreduce": CollectiveSpec(
        "allreduce", tree=True, chunked=False,
        description="reduce tree [+ all-to-all] + broadcast tree, full d"),
    "reduce_scatter": CollectiveSpec(
        "reduce_scatter", tree=False, chunked=True,
        description="ring pass, N-1 steps of d/N; node i owns chunk i"),
    "all_gather": CollectiveSpec(
        "all_gather", tree=False, chunked=True,
        description="mirrored ring pass, N-1 steps of d/N chunks"),
    "broadcast": CollectiveSpec(
        "broadcast", tree=True, chunked=False,
        description="WRHT broadcast tree alone, root down, full d"),
    "alltoall": CollectiveSpec(
        "alltoall", tree=False, chunked=True,
        description="one full-mesh step of personalized d/N shards"),
}


def coerce_collective(collective: "Collective | str") -> str:
    name = (collective.value if isinstance(collective, Collective)
            else str(collective))
    if name not in COLLECTIVES:
        raise ValueError(f"unknown collective {collective!r} "
                         f"(expected one of {sorted(COLLECTIVES)})")
    return name


def collective_plan_fields(
    collective: "Collective | str", m: int | None, allow_alltoall: bool,
) -> tuple[int | None, bool]:
    """Normalize the d-independent plan identity ``(m, alltoall)`` per
    collective, so plan-cache keys never fragment on irrelevant axes:
    the ring passes and the standalone all-to-all have no fan-out and no
    finisher choice, and a pure broadcast never takes the all-to-all."""
    spec = COLLECTIVES[coerce_collective(collective)]
    if not spec.tree:
        return None, True
    if coerce_collective(collective) == "broadcast":
        return m, False
    return m, allow_alltoall


def collective_steps(collective: "Collective | str", n: int,
                     m: int | None = None, with_alltoall: bool = True) -> int:
    """Nominal (relay-free) step count per collective (DESIGN.md §11)."""
    name = coerce_collective(collective)
    if n <= 1:
        return 0
    if name in ("reduce_scatter", "all_gather"):
        return n - 1
    if name == "alltoall":
        return 1
    if m is None or m < 2:
        raise ValueError("tree collectives need a fan-out m >= 2")
    l = max(1, math.ceil(math.log(n, m)))
    if name == "broadcast":
        return l
    return 2 * l - 1 if with_alltoall else 2 * l


def optimal_group_size(w: int) -> int:
    """Lemma 1: with two fibers and two Tx/Rx sets per node, the largest
    group a representative can drain in one step is ``m = 2w + 1``."""
    return 2 * w + 1


def _cap_group_size(m: int, max_hops: int | None, spacing: int) -> int:
    """Insertion-loss fan-out cap: with a hop budget ``H`` and active nodes
    ``spacing`` segments apart, the farthest member a middle representative
    can reach is ``H // spacing`` active positions away, so at most
    ``2·(H // spacing) + 1`` nodes fit in one group (floored at 2 so the
    tree always makes progress)."""
    if max_hops is not None:
        m = min(m, max(2, 2 * (max_hops // max(1, spacing)) + 1))
    return m


def effective_wavelengths(w: int, failures: FailureMask | None = None) -> int:
    """Wavelengths usable at *every* node under the mask (floored at 1).

    A λ dead at node ``v`` only forbids add/drop *at v*, so this is a
    conservative uniform shrink — the group-size and all-to-all budgets are
    worst-case-node bounds, which is exactly what Lemma 1 needs.
    """
    if failures is None or failures.empty:
        return w
    return max(1, w - failures.max_dead_lambda_per_node())


def feasible_group_size(w: int, max_hops: int | None = None, spacing: int = 1,
                        failures: FailureMask | None = None) -> int:
    """Lemma-1 optimum capped by the insertion-loss fan-out limit.

    A group of 2 whose pair distance still exceeds ``H`` must be relayed —
    ``build_schedule`` does this automatically.  A failure mask shrinks the
    Lemma-1 budget to the worst node's surviving wavelength count.
    """
    return _cap_group_size(optimal_group_size(effective_wavelengths(w, failures)),
                           max_hops, spacing)


# ------------------------------------------------------------------
# Degraded-mode routing (DESIGN.md §12).
#
# A single lightpath has exactly two simple routes per ordered pair, so a
# transfer blocked by a cut span first tries the *direction flip*.  When
# both directions are blocked as single lightpaths (e.g. a dead CW span on
# one side plus a dead CCW transceiver at the destination), an O/E/O
# detour can still work: two legs through a live relay node, each leg
# choosing its own fiber direction.  The router therefore plans per row:
# direct → flipped → cheapest feasible two-leg detour → infeasible.  Legs
# longer than the hop budget are further relayed through live nodes,
# reusing the store-and-forward sub-step convention of
# `split_overlong_arcs`.  Only the single-step all-to-all is restricted to
# the direction flip — a detour would need a second reconfiguration.
# ------------------------------------------------------------------

def _route_blocked(batch: TransferBatch, n: int,
                   failures: FailureMask) -> np.ndarray:
    """Bool per row: the route (as currently directed) touches a dead span
    or a dead endpoint transceiver."""
    return (_covers_dead_segment(batch, n, failures)
            | _uses_dead_transceiver(batch, n, failures))


def _reroute_batch(batch: TransferBatch, n: int,
                   failures: FailureMask) -> TransferBatch:
    """Flip the ring direction of every blocked transfer; raise
    :exc:`DegradedInfeasibleError` when a transfer is blocked both ways."""
    if len(batch) == 0:
        return batch
    bad = _route_blocked(batch, n, failures)
    if not bad.any():
        return batch
    flipped = TransferBatch.from_arrays(
        batch.src, batch.dst,
        np.where(bad, -batch.direction, batch.direction), batch.bits,
        check=False,
    )
    still = _route_blocked(flipped, n, failures) & bad
    if still.any():
        i = int(np.flatnonzero(still)[0])
        raise DegradedInfeasibleError(
            f"transfer {int(batch.src[i])}->{int(batch.dst[i])} is blocked "
            "in both ring directions under the failure mask"
        )
    return flipped


class _DegradedRouter:
    """Per-row route planner under a failure mask (plain Python loops:
    degraded operation is rare and schedules build once per cache key)."""

    def __init__(self, n: int, max_hops: int | None,
                 failures: FailureMask) -> None:
        self.n = n
        self.max_hops = max_hops
        self.segd = failures.segment_dead(n)
        self.tdead = failures.transceiver_dead(n)

    def _leg_ok(self, s: int, t: int, d: int) -> bool:
        """Can ``s -> t`` run as ONE lightpath in direction ``d``?"""
        n, lane = self.n, (1 - d) >> 1
        if self.tdead[s, lane] or self.tdead[t, lane]:
            return False
        h = (t - s) * d % n
        start = s if d == CW else t
        row = self.segd[lane]
        if row.any() and row[(start + np.arange(h)) % n].any():
            return False
        return True

    def _hops(self, s: int, t: int, d: int) -> int:
        return (t - s) * d % self.n

    def _split_leg(self, s: int, t: int, d: int) -> list[tuple[int, int, int]]:
        """Cut one feasible leg into hop-budget pieces through live relays:
        each relay is the farthest live node at most ``max_hops`` ahead, so
        dead nodes are skipped at the price of shorter pieces."""
        h = self._hops(s, t, d)
        if self.max_hops is None or h <= self.max_hops:
            return [(s, t, d)]
        n, lane = self.n, (1 - d) >> 1
        parts: list[tuple[int, int, int]] = []
        off = 0
        while h - off > self.max_hops:
            nxt = None
            for k in range(off + self.max_hops, off, -1):
                if not self.tdead[(s + k * d) % n, lane]:
                    nxt = k
                    break
            if nxt is None:
                raise DegradedInfeasibleError(
                    f"no live O/E/O relay within {self.max_hops} hops along "
                    f"{s}->{t} (lane {lane})"
                )
            parts.append(((s + off * d) % n, (s + nxt * d) % n, d))
            off = nxt
        parts.append(((s + off * d) % n, t, d))
        return parts

    def plan_row(self, s: int, t: int, d_pref: int) -> list[tuple[int, int, int]]:
        """Route one transfer: direct → flipped → cheapest two-leg detour.
        Returns the store-and-forward chain as ``(src, dst, dir)`` legs."""
        for d in (d_pref, -d_pref):
            if self._leg_ok(s, t, d):
                return self._split_leg(s, t, d)
        best: tuple[int, int, int, int] | None = None  # (cost, x, d1, d2)
        for x in range(self.n):
            if x in (s, t):
                continue
            for d1 in (CW, CCW):
                if not self._leg_ok(s, x, d1):
                    continue
                for d2 in (CW, CCW):
                    if not self._leg_ok(x, t, d2):
                        continue
                    cost = self._hops(s, x, d1) + self._hops(x, t, d2)
                    if best is None or cost < best[0]:
                        best = (cost, x, d1, d2)
        if best is None:
            raise DegradedInfeasibleError(
                f"transfer {s}->{t} is unroutable under the failure mask "
                "(both directions blocked and no live relay detour exists)"
            )
        _, x, d1, d2 = best
        return self._split_leg(s, x, d1) + self._split_leg(x, t, d2)


def _degraded_substeps(
    batch: TransferBatch, n: int, max_hops: int | None,
    failures: FailureMask,
) -> list[tuple[TransferBatch, np.ndarray]]:
    """Route a step around the failure mask, as relay sub-steps.

    Every row becomes a chain of one or more legs (see :class:`_DegradedRouter`);
    leg ``k`` of every chain lands in sub-step ``k`` (the store-and-forward
    convention of :func:`~repro.core.wavelength.split_overlong_arcs`, so
    single-leg rows sit in sub-step 0).  Returns ``(sub_batch,
    original_rows)`` per sub-step — the row map lets chunked callers slice
    their per-row shard ids.  Rows whose original route is clean skip the
    planner entirely (vectorized precheck), so lightly-degraded steps cost
    barely more than healthy ones.
    """
    if len(batch) == 0:
        return [(batch, np.arange(0, dtype=np.int64))]
    router = _DegradedRouter(n, max_hops, failures)
    hops = batch.arcs(n)[2]
    clean = ~_route_blocked(batch, n, failures)
    if max_hops is not None:
        clean &= hops <= max_hops
    chains: list[list[tuple[int, int, int]]] = []
    for i in range(len(batch)):
        s, t = int(batch.src[i]), int(batch.dst[i])
        if clean[i]:
            chains.append([(s, t, int(batch.direction[i]))])
        else:
            chains.append(router.plan_row(s, t, int(batch.direction[i])))
    out: list[tuple[TransferBatch, np.ndarray]] = []
    for k in range(max(len(c) for c in chains)):
        rows = np.array([i for i, c in enumerate(chains) if len(c) > k],
                        dtype=np.int64)
        legs = [chains[i][k] for i in rows]
        out.append((TransferBatch.from_arrays(
            [l[0] for l in legs], [l[1] for l in legs],
            [l[2] for l in legs], batch.bits[rows], check=False,
        ), rows))
    return out


def _degraded_assign(batch: TransferBatch, ring: Ring,
                     failures: FailureMask) -> TransferBatch:
    """Failure-aware RWA with the uniform degraded error contract: a
    wavelength shortfall under the mask is an infeasibility, not a caller
    bug, so it surfaces as :exc:`DegradedInfeasibleError` (cause chained)."""
    try:
        return first_fit_assign(batch, ring.n, ring.w, failures=failures)
    except WavelengthConflictError as e:
        raise DegradedInfeasibleError(
            "surviving wavelengths cannot carry a required step under the "
            f"failure mask: {e}"
        ) from e


def _assigner(rwa: str):
    if rwa == "fast":
        return first_fit_assign
    if rwa == "reference":
        return lambda batch, n, w: TransferBatch.from_transfers(
            first_fit_assign_reference(TransferBatch.coerce(batch).to_transfers(), n, w)
        )
    raise ValueError(f"unknown rwa {rwa!r} (expected 'fast' or 'reference')")


@dataclass(frozen=True)
class _LevelGrouping:
    """Grouping arrays of one tree level: the shared structure from which
    the reduce batch, the broadcast batch and the closed-form First-Fit
    assignment are all derived (DESIGN.md §10)."""

    reps: np.ndarray       # representative node per group        [G]
    members: np.ndarray    # member nodes, group-major order      [T]
    rep_for: np.ndarray    # each member's representative         [T]
    left: np.ndarray       # member sits left of its rep          [T] bool
    pos: np.ndarray        # member's in-group position           [T]
    gsize_for: np.ndarray  # size of the member's group           [T]


def _level_grouping(active: np.ndarray, m: int) -> _LevelGrouping:
    """Partition ``active`` into runs of ``m`` with middle representatives.

    Row order matches the original per-object builder exactly (group-major,
    member position order, representative skipped) so that stable
    longest-first RWA ties break identically.
    """
    count = active.size
    n_groups = -(-count // m)
    idx = np.arange(count)
    gi = idx // m
    pos = idx - gi * m
    gsize = np.full(n_groups, m, dtype=np.int64)
    gsize[-1] = count - (n_groups - 1) * m
    mid = gsize // 2
    reps = active[np.arange(n_groups) * m + mid]
    member = pos != mid[gi]
    gim = gi[member]
    posm = pos[member]
    return _LevelGrouping(
        reps=reps, members=active[member], rep_for=reps[gim],
        left=posm < mid[gim], pos=posm, gsize_for=gsize[gim],
    )


def _grouping_batch(g: _LevelGrouping, d_bits: float, broadcast: bool,
                    wavelength=None) -> TransferBatch:
    """Materialize one level's transfers from its grouping arrays.

    Left-of-rep members transmit clockwise, right-of-rep counter-clockwise
    (two Rx sets per node, Sec. III-B); broadcast reverses the paths.
    """
    if broadcast:
        return TransferBatch.from_arrays(
            g.rep_for, g.members, np.where(g.left, CCW, CW), d_bits,
            wavelength=wavelength, check=False
        )
    return TransferBatch.from_arrays(
        g.members, g.rep_for, np.where(g.left, CW, CCW), d_bits,
        wavelength=wavelength, check=False
    )


def _level_transfers(
    active: np.ndarray, m: int, d_bits: float, broadcast: bool
) -> tuple[TransferBatch, np.ndarray]:
    """Member↔representative transfers for one tree level, as arrays."""
    g = _level_grouping(active, m)
    return _grouping_batch(g, d_bits, broadcast), g.reps


def _level_wavelengths(g: _LevelGrouping) -> np.ndarray:
    """Closed-form First-Fit assignment for one plain tree level.

    Within a group the two sides load disjoint fiber lanes, and the arcs of
    one side are strictly nested toward the representative (lengths strictly
    decrease as the member approaches it); different groups of the level
    never share a directed segment on the same lane.  Longest-first First
    Fit therefore gives the member at in-group position ``p`` wavelength
    ``p`` (left side) or ``gsize − 1 − p`` (right side), on both stages —
    the broadcast step's arcs are the lane-mirrored image of the reduce
    step's, so the per-row assignment is identical.  Bit-identity to
    :func:`~repro.core.wavelength.first_fit_assign` on the materialized
    batch is pinned by the golden tests of the batched builder
    (DESIGN.md §10).
    """
    return np.where(g.left, g.pos, g.gsize_for - 1 - g.pos)


def _full_mesh_batch(nodes: np.ndarray, n: int, bits: float) -> TransferBatch:
    """One transfer per ordered pair of ``nodes``, shortest direction each."""
    r = nodes.size
    src, dst = np.meshgrid(nodes, nodes, indexing="ij")
    off = ~np.eye(r, dtype=bool)
    src, dst = src[off], dst[off]
    cw = (dst - src) % n <= (src - dst) % n  # shortest_direction
    return TransferBatch.from_arrays(
        src, dst, np.where(cw, CW, CCW), bits, check=False
    )


def _alltoall_fits(
    reps: np.ndarray, ring: Ring, d_bits: float, rwa: str = "fast",
    max_hops: int | None = None, failures: FailureMask | None = None,
) -> TransferBatch | None:
    """Try to schedule a one-step all-to-all among ``reps``; None if > w
    or if any pairwise lightpath would exceed the insertion-loss budget."""
    r = reps.size
    if r < 2:
        return None
    degraded = failures is not None and not failures.empty
    # Paper Sec. III-C-2 / [16]: all-to-all among m* ring nodes needs
    # ⌈m*²/8⌉ wavelengths.  Cheap necessary condition before running RWA —
    # also keeps the O(r²) enumeration off the N=4096 level-0 case.
    if math.ceil(r ** 2 / 8) > effective_wavelengths(ring.w, failures):
        return None
    batch = _full_mesh_batch(reps, ring.n, d_bits)
    if degraded:
        try:
            batch = _reroute_batch(batch, ring.n, failures)
        except DegradedInfeasibleError:
            return None  # the finisher is optional — keep climbing the tree
    if max_hops is not None and (batch.arcs(ring.n)[2] > max_hops).any():
        return None  # some pair is out of optical reach — keep climbing the tree
    try:
        if degraded:
            return first_fit_assign(batch, ring.n, ring.w, failures=failures)
        return _assigner(rwa)(batch, ring.n, ring.w)
    except WavelengthConflictError:
        return None


def _level_cap(active: np.ndarray, m: int, max_hops: int | None) -> tuple[int, bool]:
    """Group size usable at this level under the hop budget, and whether the
    level's transfers need O/E/O relays.

    Active nodes are grouped by index order, so a member→representative path
    covers the ring gaps between consecutive actives; with worst gap
    ``g_max`` the farthest of ``m`` members is ``⌈(m-1)/2⌉ · g_max`` segments
    out.  Capping ``m`` at ``2·(H // g_max) + 1`` keeps every lightpath
    within the budget.  When even adjacent actives are out of reach
    (``H < g_max``), fall back to pairing (m=2) with relayed transfers.
    """
    if max_hops is None or active.size < 2:
        return m, False
    g_max = int(np.diff(active).max())
    if max_hops < g_max:
        return 2, True
    return _cap_group_size(m, max_hops, g_max), False


def _append_level(
    sched: WRHTSchedule, kind: str, level: int, batch: TransferBatch,
    relay: bool, ring: Ring, assign, max_hops: int | None,
    failures: FailureMask | None = None,
) -> None:
    """Emit one tree level as a Step, splitting into relay sub-steps when the
    hop budget demands it (each sub-step re-runs RWA).  Under a failure mask
    the batch is first re-routed around dead spans/transceivers (which may
    push flipped rows over the hop budget, triggering the relay path even
    when the healthy level needed none)."""
    if failures is not None and not failures.empty:
        for sub, _ in _degraded_substeps(batch, ring.n, max_hops, failures):
            sched.steps.append(
                Step(kind, level, _degraded_assign(sub, ring, failures)))
        return
    if relay:
        for sub in split_overlong_arcs(batch, ring.n, max_hops):
            sched.steps.append(Step(kind, level, assign(sub, ring.n, ring.w)))
    else:
        sched.steps.append(Step(kind, level, assign(batch, ring.n, ring.w)))


def build_schedule(
    n: int,
    w: int,
    d_bits: float,
    m: int | None = None,
    allow_alltoall: bool = True,
    bandwidth_bps: float = 40e9,
    reconfig_delay_s: float = 25e-6,
    validate: bool = True,
    rwa: str = "fast",
    physical: PhysicalParams | None = None,
    max_hops: int | None = None,
    failures: FailureMask | None = None,
) -> WRHTSchedule:
    """Construct and validate the full WRHT schedule for an N-node ring.

    ``rwa`` selects the wavelength assigner: ``"fast"`` (vectorized bitmask
    First Fit) or ``"reference"`` (original per-object greedy) — the two are
    bit-identical; the knob exists for the equivalence test and the
    schedule-build benchmark.

    ``physical`` (or an explicit ``max_hops``) enables the insertion-loss
    constraint (paper Sec. III): the per-level group size is capped so no
    lightpath exceeds the hop budget, the final all-to-all is only taken
    when every pair is within reach, and levels whose active nodes have
    drifted beyond the budget are relayed through intermediate O/E/O
    regeneration sub-steps.  The resulting schedule never contains a
    transfer longer than the budget (enforced by :func:`validate_schedule`).

    A non-empty ``failures`` mask puts the build in degraded mode
    (DESIGN.md §12): blocked routes flip direction (relayed through live
    O/E/O nodes when the long way exceeds the hop budget), the Lemma-1
    group size shrinks to the worst node's surviving wavelengths, and any
    remaining infeasibility raises :exc:`DegradedInfeasibleError`.
    """
    if n < 1:
        raise ValueError("need >= 1 node")
    if failures is not None and failures.empty:
        failures = None
    if max_hops is None and physical is not None:
        max_hops = physical.max_hops
    if max_hops is not None and max_hops < 1:
        raise ValueError("insertion-loss hop budget must allow >= 1 hop")
    ring = Ring(max(n, 2), w, bandwidth_bps=bandwidth_bps,
                reconfig_delay_s=reconfig_delay_s, physical=physical,
                failures=failures)
    w_eff = effective_wavelengths(w, failures)
    if m is None:
        m = optimal_group_size(w_eff)
    if m < 2:
        raise ValueError("group size m must be >= 2")
    # Lemma 1 feasibility: a group of m nodes drains over two fibers with
    # ⌈(m-1)/2⌉ wavelengths per side; beyond m = 2w+1 the step cannot be
    # conflict-free, so clamp (callers probing larger m get the feasible
    # max; a failure mask shrinks the budget to the worst surviving node).
    m = min(m, optimal_group_size(w_eff))
    # level-0 fan-out cap (unit spacing); deeper levels re-cap per spacing
    # in _level_cap as the active nodes spread out
    m = _cap_group_size(m, max_hops, 1)
    assign = _assigner(rwa)

    sched = WRHTSchedule(n=n, w=w, m=m, max_hops=max_hops, failures=failures)
    active = np.arange(n, dtype=np.int64)
    sched.levels.append(active.tolist())
    if n == 1:
        return sched

    # ---------------- reduce stage ----------------
    reduce_actives: list[np.ndarray] = []  # the grouping input per level
    level_meta: list[tuple[int, bool]] = []  # (group size, relayed) per level
    level = 0
    while active.size > 1:
        if allow_alltoall:
            a2a = _alltoall_fits(active, ring, d_bits, rwa, max_hops=max_hops,
                                 failures=failures)
            if a2a is not None:
                sched.steps.append(Step("alltoall", level, a2a))
                break
        m_lvl, relay = _level_cap(active, m, max_hops)
        batch, reps = _level_transfers(active, m_lvl, d_bits, broadcast=False)
        _append_level(sched, "reduce", level, batch, relay, ring, assign,
                      max_hops, failures)
        reduce_actives.append(active)
        level_meta.append((m_lvl, relay))
        sched.level_group_sizes.append(m_lvl)
        active = reps
        sched.levels.append(active.tolist())
        level += 1

    # ---------------- broadcast stage ----------------
    # Reverse of the reduce tree (the all-to-all step, if any, already left
    # every surviving representative with the full reduction).
    for level in range(len(reduce_actives) - 1, -1, -1):
        m_lvl, relay = level_meta[level]
        batch, _ = _level_transfers(reduce_actives[level], m_lvl, d_bits,
                                    broadcast=True)
        _append_level(sched, "broadcast", level, batch, relay, ring, assign,
                      max_hops, failures)

    if validate:
        validate_schedule(sched, ring)
    return sched


def build_collective_schedule(
    collective: "Collective | str",
    n: int,
    w: int,
    d_bits: float,
    m: int | None = None,
    allow_alltoall: bool = True,
    bandwidth_bps: float = 40e9,
    reconfig_delay_s: float = 25e-6,
    validate: bool = True,
    rwa: str = "fast",
    physical: PhysicalParams | None = None,
    max_hops: int | None = None,
    failures: FailureMask | None = None,
) -> WRHTSchedule:
    """Generalized schedule builder: one entry point for the whole scheduled
    collective algebra (DESIGN.md §11).

    Reuses the all-reduce machinery unchanged — level grouping, First-Fit
    RWA, hop-budget relays and the insertion-loss caps:

    * ``allreduce`` delegates to :func:`build_schedule`;
    * ``broadcast`` walks the same reduce tree for structure but emits only
      the broadcast stage (root = the final surviving representative; the
      all-to-all finisher never applies — it is a reduce-phase device);
    * ``reduce_scatter`` / ``all_gather`` emit the ``N-1``-step neighbour
      ring pass of ``d/N`` chunks (one shared ``TransferBatch``, per-step
      ``Step.chunks`` shard ids);
    * ``alltoall`` emits the single full-mesh step of personalized ``d/N``
      shards, raising :class:`~repro.core.wavelength.WavelengthConflictError`
      when ``⌈N²/8⌉ > w`` and
      :class:`~repro.core.wavelength.InsertionLossError` when any pair is
      beyond the hop budget (unlike the all-reduce *finisher*, which simply
      keeps climbing the tree).

    A non-empty ``failures`` mask puts every collective in degraded mode
    (DESIGN.md §12): blocked routes flip direction (relayed when the long
    way exceeds the hop budget), budgets shrink to the surviving
    wavelengths, and ALL infeasibilities — including the all-to-all cases
    above — surface uniformly as :exc:`DegradedInfeasibleError`.
    """
    collective = coerce_collective(collective)
    if failures is not None and failures.empty:
        failures = None
    if collective == "allreduce":
        return build_schedule(
            n, w, d_bits, m=m, allow_alltoall=allow_alltoall,
            bandwidth_bps=bandwidth_bps, reconfig_delay_s=reconfig_delay_s,
            validate=validate, rwa=rwa, physical=physical, max_hops=max_hops,
            failures=failures,
        )
    if n < 1:
        raise ValueError("need >= 1 node")
    if max_hops is None and physical is not None:
        max_hops = physical.max_hops
    if max_hops is not None and max_hops < 1:
        raise ValueError("insertion-loss hop budget must allow >= 1 hop")
    ring = Ring(max(n, 2), w, bandwidth_bps=bandwidth_bps,
                reconfig_delay_s=reconfig_delay_s, physical=physical,
                failures=failures)
    w_eff = effective_wavelengths(w, failures)
    if m is None:
        m = optimal_group_size(w_eff)
    if m < 2:
        raise ValueError("group size m must be >= 2")
    m = _cap_group_size(min(m, optimal_group_size(w_eff)), max_hops, 1)
    assign = _assigner(rwa)

    sched = WRHTSchedule(n=n, w=w, m=m, max_hops=max_hops,
                         collective=collective, failures=failures)
    active = np.arange(n, dtype=np.int64)
    sched.levels.append(active.tolist())
    if n > 1:
        if collective == "broadcast":
            _emit_broadcast_tree(sched, active, m, ring, assign, max_hops,
                                 d_bits, failures)
        elif collective in ("reduce_scatter", "all_gather"):
            _emit_ring_pass(sched, collective, n, ring, assign, d_bits,
                            max_hops, failures)
        else:  # alltoall
            _emit_alltoall(sched, active, ring, assign, max_hops, d_bits, w,
                           failures)
    if validate:
        validate_schedule(sched, ring)
    return sched


def _emit_broadcast_tree(
    sched: WRHTSchedule, active: np.ndarray, m: int, ring: Ring, assign,
    max_hops: int | None, d_bits: float,
    failures: FailureMask | None = None,
) -> None:
    """The WRHT broadcast stage alone: walk the reduce tree for its
    grouping structure (no reduce steps emitted, no all-to-all — a pure
    broadcast has a single source), then emit the levels top-down."""
    bcast_actives: list[np.ndarray] = []
    level_meta: list[tuple[int, bool]] = []
    while active.size > 1:
        m_lvl, relay = _level_cap(active, m, max_hops)
        g = _level_grouping(active, m_lvl)
        bcast_actives.append(active)
        level_meta.append((m_lvl, relay))
        sched.level_group_sizes.append(m_lvl)
        active = g.reps
        sched.levels.append(active.tolist())
    for level in range(len(bcast_actives) - 1, -1, -1):
        m_lvl, relay = level_meta[level]
        batch, _ = _level_transfers(bcast_actives[level], m_lvl, d_bits,
                                    broadcast=True)
        _append_level(sched, "broadcast", level, batch, relay, ring, assign,
                      max_hops, failures)


def _emit_ring_pass(
    sched: WRHTSchedule, collective: str, n: int, ring: Ring, assign,
    d_bits: float, max_hops: int | None = None,
    failures: FailureMask | None = None,
) -> None:
    """``N-1`` neighbour steps of ``d/N`` chunks — the bandwidth-optimal
    ring pass.  Every step shares ONE assigned batch (neighbour hops occupy
    disjoint segments, so First Fit lands everything on wavelength 0); the
    per-step shard identity lives in ``Step.chunks``:

    reduce-scatter   step ``t``: node ``i`` forwards its partial of chunk
                     ``(i - t) mod N`` — chunk ``c`` walks ``c+1 → … → c``,
                     accumulating every node's contribution, so node ``i``
                     ends owning the full reduction of chunk ``i``;
    all-gather       step ``t``: node ``i`` forwards chunk ``(i - t + 1)
                     mod N`` — node ``i``'s owned chunk circulates to all.

    Degraded mode keeps the logical neighbour data flow but re-routes
    blocked hops the long way around (relayed through live O/E/O nodes when
    over the hop budget); each logical step then expands into its
    store-and-forward sub-steps, every sub-step carrying the chunk ids of
    the rows it forwards.
    """
    src = np.arange(n, dtype=np.int64)
    batch = TransferBatch.from_arrays(
        src, (src + 1) % n, CW, d_bits / n, check=False
    )
    if failures is not None and not failures.empty:
        # geometry repeats every step — assign each sub-batch once, share it
        subs = [(_degraded_assign(sb, ring, failures), rows)
                for sb, rows in
                _degraded_substeps(batch, ring.n, max_hops, failures)]
        for t in range(1, n):
            if collective == "reduce_scatter":
                chunks = (src - t) % n
            else:
                chunks = (src - t + 1) % n
            for sb, rows in subs:
                sched.steps.append(Step(collective, 0, sb,
                                        chunks=chunks[rows]))
        return
    assigned = assign(batch, ring.n, ring.w)
    for t in range(1, n):
        if collective == "reduce_scatter":
            chunks = (src - t) % n
        else:
            chunks = (src - t + 1) % n
        sched.steps.append(Step(collective, 0, assigned, chunks=chunks))


def _emit_alltoall(
    sched: WRHTSchedule, active: np.ndarray, ring: Ring, assign,
    max_hops: int | None, d_bits: float, w: int,
    failures: FailureMask | None = None,
) -> None:
    """The single-step full-mesh exchange among all ``n`` nodes.

    Degraded mode preserves the single-step invariant — a relayed pair
    would need a second reconfiguration — so a blocked-both-ways pair, a
    flipped path over the hop budget, or a wavelength shortfall all raise
    :exc:`DegradedInfeasibleError` (the healthy errors stay as documented).
    """
    n = active.size
    degraded = failures is not None and not failures.empty
    need = math.ceil(n ** 2 / 8)
    w_eff = effective_wavelengths(w, failures)
    if need > w_eff:
        err = WavelengthConflictError(
            f"single-step all-to-all among {n} nodes needs ⌈n²/8⌉={need} "
            f"wavelengths, but the ring has w={w_eff}"
            + (" surviving the failure mask" if degraded else "")
        )
        if degraded:
            raise DegradedInfeasibleError(str(err)) from err
        raise err
    batch = _full_mesh_batch(active, ring.n, d_bits / n)
    if degraded:
        batch = _reroute_batch(batch, ring.n, failures)
    hops = batch.arcs(ring.n)[2]
    if max_hops is not None and int(hops.max(initial=0)) > max_hops:
        err = InsertionLossError(
            f"all-to-all lightpath spans {int(hops.max())} segments, "
            f"exceeding the insertion-loss hop budget of {max_hops}"
        )
        if degraded:  # a relay would break the single-step invariant
            raise DegradedInfeasibleError(str(err)) from err
        raise err
    if degraded:
        assigned = _degraded_assign(batch, ring, failures)
    else:
        assigned = assign(batch, ring.n, ring.w)
    sched.steps.append(Step("alltoall", 0, assigned,
                            chunks=assigned.dst.copy()))


# ------------------------------------------------------------------
# Batched multi-candidate builder (DESIGN.md §10).
# ------------------------------------------------------------------

def _concat_batches(batches: list[TransferBatch]) -> tuple[TransferBatch, np.ndarray]:
    """Concatenate step batches into one arc batch with offset pointers."""
    ptr = np.zeros(len(batches) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in batches], out=ptr[1:])
    cat = TransferBatch(
        np.concatenate([b.src for b in batches]),
        np.concatenate([b.dst for b in batches]),
        np.concatenate([b.direction for b in batches]),
        np.concatenate([b.bits for b in batches]),
        np.concatenate([b.wavelength for b in batches]),
    )
    return cat, ptr


def _split_batch(batch: TransferBatch, ptr: np.ndarray) -> list[TransferBatch]:
    """Slice an assigned concatenated batch back into per-step batches."""
    memo = batch._arcs
    out = []
    for lo, hi in zip(ptr[:-1].tolist(), ptr[1:].tolist()):
        sub = TransferBatch(batch.src[lo:hi], batch.dst[lo:hi],
                            batch.direction[lo:hi], batch.bits[lo:hi],
                            batch.wavelength[lo:hi])
        if memo is not None:  # per-row geometry slices with the columns
            sub._arcs = (memo[0], memo[1][lo:hi], memo[2][lo:hi],
                         memo[3][lo:hi])
        out.append(sub)
    return out


def build_candidate_schedules(
    n: int,
    w: int,
    d_bits: float,
    m_candidates=None,
    allow_alltoall: bool = True,
    bandwidth_bps: float = 40e9,
    reconfig_delay_s: float = 25e-6,
    validate: bool = True,
    rwa: str = "fast",
    physical: PhysicalParams | None = None,
    max_hops: int | None = None,
    collective: "Collective | str" = "allreduce",
    failures: FailureMask | None = None,
) -> dict[tuple[int, bool], WRHTSchedule]:
    """Build every candidate WRHT schedule of a fan-out sweep in one pass.

    The auto-tuner costs one schedule per ``(m, alltoall)`` candidate;
    rebuilding each from scratch repeats the level walk, the RWA and the
    validation ~2× per fan-out.  This builder amortizes the sweep
    (DESIGN.md §10):

    * the all-to-all and no-all-to-all variants of one ``m`` share their
      per-level active-node/grouping arrays and their ``Step`` objects —
      the full tree is walked once and the variant that took the all-to-all
      at level ``L`` is the slice ``reduce[:L] + [alltoall] +
      broadcast[L-1::-1]`` of it;
    * plain tree levels take the closed-form First-Fit assignment
      (:func:`_level_wavelengths`) instead of running the greedy;
    * relay chains under a hop budget run First-Fit over concatenated
      per-sub-step arc batches with offset pointers
      (:func:`~repro.core.wavelength.first_fit_assign_concat`), sharing one
      translated-component dedup table across every candidate and both
      stages (a broadcast step's components are the lane-mirror of its
      reduce step's, so mirrors are cache hits).

    Returns ``{(m, alltoall): schedule}`` in candidate order, each entry
    **bit-identical** to ``build_schedule(n, w, d_bits, m=m,
    allow_alltoall=alltoall, ...)`` (golden-tested).  The ``(m, False)``
    variant is materialized only when the ``(m, True)`` build actually took
    the all-to-all — otherwise the two are the same schedule.  ``m`` keys
    are the *requested* fan-outs (the per-schedule ``m`` field carries the
    Lemma-1/hop-budget clamp, as in ``build_schedule``).

    ``validate=True`` checks wavelength conflicts and the hop budget once
    per unique step batch plus the collective's semantics per candidate; the
    tuner passes ``False`` (construction is conflict-free by design and the
    winning schedule is re-validated when materialized through the plan
    cache).

    ``collective`` selects the fan-out-swept collective: ``"allreduce"``
    (the default, both all-to-all variants per ``m``) or ``"broadcast"``
    (the WRHT broadcast tree alone, keyed ``(m, False)`` — a pure broadcast
    never takes the all-to-all).  The ring passes and the standalone
    all-to-all have no fan-out axis, so sweeping them is a caller error.

    A non-empty ``failures`` mask disables the amortized one-pass walk —
    per-node deadness breaks the translation symmetries it exploits, and a
    single infeasible candidate must not poison the sweep — and falls back
    to one degraded :func:`build_schedule` per candidate, skipping fan-outs
    that raise :exc:`DegradedInfeasibleError`.  If *no* candidate survives,
    the error propagates.
    """
    collective = coerce_collective(collective)
    if not COLLECTIVES[collective].tree:
        raise ValueError(
            f"collective {collective!r} has no fan-out axis to sweep — "
            "build it directly with build_collective_schedule"
        )
    if n < 1:
        raise ValueError("need >= 1 node")
    if failures is not None and failures.empty:
        failures = None
    if max_hops is None and physical is not None:
        max_hops = physical.max_hops
    if max_hops is not None and max_hops < 1:
        raise ValueError("insertion-loss hop budget must allow >= 1 hop")
    ring = Ring(max(n, 2), w, bandwidth_bps=bandwidth_bps,
                reconfig_delay_s=reconfig_delay_s, physical=physical,
                failures=failures)
    if m_candidates is None:
        m_candidates = range(2, feasible_group_size(w, max_hops,
                                                    failures=failures) + 1)
    ms: list[int] = []
    for m in m_candidates:
        m = int(m)
        if m < 2:
            raise ValueError("group size m must be >= 2")
        if m not in ms:
            ms.append(m)
    if failures is not None:
        return _candidate_schedules_degraded(
            collective, n, w, d_bits, ms, allow_alltoall, bandwidth_bps,
            reconfig_delay_s, validate, rwa, physical, max_hops, failures,
        )
    assign = _assigner(rwa)
    closed_form = rwa == "fast"
    rwa_cache: dict = {}  # translated-component dedup, shared by all candidates

    def emit_level(kind: str, level: int, g: _LevelGrouping,
                   relay: bool, broadcast: bool) -> list[Step]:
        batch = _grouping_batch(g, d_bits, broadcast)
        if relay:
            subs = split_overlong_arcs(batch, ring.n, max_hops)
            if closed_form:
                cat, ptr = _concat_batches(subs)
                assigned = first_fit_assign_concat(cat, ptr, ring.n, ring.w,
                                                   cache=rwa_cache)
                subs = _split_batch(assigned, ptr)
            else:
                subs = [assign(sub, ring.n, ring.w) for sub in subs]
            return [Step(kind, level, sub) for sub in subs]
        if closed_form:
            return [Step(kind, level, batch.with_wavelengths(_level_wavelengths(g)))]
        return [Step(kind, level, assign(batch, ring.n, ring.w))]

    out: dict[tuple[int, bool], WRHTSchedule] = {}
    for m_req in ms:
        # same clamps as build_schedule: Lemma 1 then the level-0 fan-out cap
        m = _cap_group_size(min(m_req, optimal_group_size(w)), max_hops, 1)
        variant_key = allow_alltoall if collective == "allreduce" else False
        active = np.arange(n, dtype=np.int64)
        levels = [active]
        if n == 1:
            out[(m_req, variant_key)] = WRHTSchedule(
                n=n, w=w, m=m, levels=[active.tolist()], max_hops=max_hops,
                collective=collective)
            continue

        reduce_steps: list[list[Step]] = []   # Steps per level (relays split)
        groupings: list[_LevelGrouping] = []
        meta: list[tuple[int, bool]] = []     # (m_lvl, relay) per level
        a2a_at: int | None = None
        a2a_step: Step | None = None
        level = 0
        while active.size > 1:
            if collective == "allreduce" and allow_alltoall and a2a_at is None:
                fit = _alltoall_fits(active, ring, d_bits, rwa,
                                     max_hops=max_hops)
                if fit is not None:
                    # the all-to-all variant stops here; keep walking the
                    # tree — the no-all-to-all variant needs the rest
                    a2a_at = level
                    a2a_step = Step("alltoall", level, fit)
            m_lvl, relay = _level_cap(active, m, max_hops)
            g = _level_grouping(active, m_lvl)
            if collective == "allreduce":
                reduce_steps.append(emit_level("reduce", level, g, relay,
                                               False))
            groupings.append(g)
            meta.append((m_lvl, relay))
            active = g.reps
            levels.append(active)
            level += 1

        bcast_steps = [
            emit_level("broadcast", lvl, g, meta[lvl][1], True)
            for lvl, g in enumerate(groupings)
        ]

        if collective == "broadcast":
            out[(m_req, False)] = WRHTSchedule(
                n=n, w=w, m=m,
                steps=[s for lvl in range(len(groupings) - 1, -1, -1)
                       for s in bcast_steps[lvl]],
                levels=[l.tolist() for l in levels], max_hops=max_hops,
                level_group_sizes=[ml for ml, _ in meta],
                collective="broadcast",
            )
            continue

        def assemble(depth: int, tail: list[Step]) -> list[Step]:
            steps = [s for lvl in range(depth) for s in reduce_steps[lvl]]
            steps.extend(tail)
            for lvl in range(depth - 1, -1, -1):
                steps.extend(bcast_steps[lvl])
            return steps

        full_tree = WRHTSchedule(
            n=n, w=w, m=m, steps=assemble(len(groupings), []),
            levels=[l.tolist() for l in levels], max_hops=max_hops,
            level_group_sizes=[ml for ml, _ in meta],
        )
        if a2a_at is None:
            out[(m_req, allow_alltoall)] = full_tree
        else:
            out[(m_req, True)] = WRHTSchedule(
                n=n, w=w, m=m, steps=assemble(a2a_at, [a2a_step]),
                levels=[levels[i].tolist() for i in range(a2a_at + 1)],
                max_hops=max_hops,
                level_group_sizes=[meta[i][0] for i in range(a2a_at)],
            )
            out[(m_req, False)] = full_tree

    if validate:
        hops_budget = max_hops if max_hops is not None else ring.max_hops
        seen: set[int] = set()
        for sched in out.values():
            for step in sched.steps:
                if id(step.transfers) not in seen:
                    seen.add(id(step.transfers))
                    validate_no_conflicts(step.transfers, ring.n, ring.w,
                                          max_hops=hops_budget)
            _validate_semantics(sched)
    return out


def _candidate_schedules_degraded(
    collective: str, n: int, w: int, d_bits: float, ms: list[int],
    allow_alltoall: bool, bandwidth_bps: float, reconfig_delay_s: float,
    validate: bool, rwa: str, physical: PhysicalParams | None,
    max_hops: int | None, failures: FailureMask,
) -> dict[tuple[int, bool], WRHTSchedule]:
    """Per-candidate degraded sweep (see :func:`build_candidate_schedules`):
    each fan-out builds independently so one infeasible ``m`` cannot poison
    the rest; the all-to-all variant split mirrors the healthy builder."""
    kw = dict(bandwidth_bps=bandwidth_bps, reconfig_delay_s=reconfig_delay_s,
              validate=validate, rwa=rwa, physical=physical,
              max_hops=max_hops, failures=failures)
    out: dict[tuple[int, bool], WRHTSchedule] = {}
    last_err: DegradedInfeasibleError | None = None
    for m_req in ms:
        try:
            if collective == "broadcast":
                out[(m_req, False)] = build_collective_schedule(
                    "broadcast", n, w, d_bits, m=m_req,
                    allow_alltoall=False, **kw)
                continue
            sched = build_schedule(n, w, d_bits, m=m_req,
                                   allow_alltoall=allow_alltoall, **kw)
        except DegradedInfeasibleError as e:
            last_err = e
            continue
        took_a2a = any(s.kind == "alltoall" for s in sched.steps)
        if allow_alltoall and took_a2a:
            out[(m_req, True)] = sched
            try:
                out[(m_req, False)] = build_schedule(
                    n, w, d_bits, m=m_req, allow_alltoall=False, **kw)
            except DegradedInfeasibleError as e:
                last_err = e
        else:
            out[(m_req, allow_alltoall)] = sched
    if not out:
        raise DegradedInfeasibleError(
            f"no feasible fan-out among {ms} for {collective} on n={n} "
            f"w={w} under the failure mask"
        ) from last_err
    return out


# ------------------------------------------------------------------
# Validation: structural (wavelengths) and semantic (per collective).
# ------------------------------------------------------------------

# Chunked-collective semantic validation tracks an [n, n_chunks, n/64] bitset
# cube; beyond this many nodes only the (always-on) structural checks run —
# the ring passes are correct by construction and conformance-tested at
# every size below the cap (DESIGN.md §11).
CHUNKED_SEMANTIC_CAP = 512


def validate_schedule(sched: WRHTSchedule, ring: Ring | None = None) -> None:
    """Structural validation (wavelengths + insertion loss) then semantic —
    the semantic check dispatches on ``sched.collective`` (DESIGN.md §11).

    The hop budget comes from the schedule itself or, failing that, from the
    ring's physical model — a schedule built without the constraint validates
    as before.  Likewise the failure mask: a degraded schedule (or a ring
    with failures) additionally rejects any step touching a dead
    span/transceiver/λ (:exc:`~repro.core.wavelength.FailedResourceError`).
    """
    ring = ring or Ring(max(sched.n, 2), sched.w)
    max_hops = sched.max_hops if sched.max_hops is not None else ring.max_hops
    failures = (sched.failures if sched.failures is not None
                else ring.failures)
    for step in sched.steps:
        validate_no_conflicts(step.transfers, ring.n, ring.w,
                              max_hops=max_hops, failures=failures)
    _validate_semantics(sched)


def broadcast_root(sched: WRHTSchedule) -> int:
    """The source node of a broadcast schedule: the final surviving
    representative of the tree walk (node 0 on a one-node ring)."""
    return int(sched.levels[-1][0]) if sched.levels else 0


def _validate_semantics(sched: WRHTSchedule) -> None:
    """Check the schedule's data-flow against its collective's semantic spec."""
    c = sched.collective
    n = sched.n
    if n <= 1:
        return
    if c == "allreduce":
        bad = _incomplete_nodes(_contribution_words(sched), n)
        if bad:
            raise AssertionError(
                f"all-reduce semantics violated: nodes {bad[:8]} missing "
                "contributions"
            )
    elif c == "broadcast":
        words = _contribution_words(sched)
        root = broadcast_root(sched)
        want = np.zeros(words.shape[1], dtype=np.uint64)
        want[root // 64] = np.uint64(1) << np.uint64(root % 64)
        bad = np.flatnonzero((words != want).any(axis=1)).tolist()
        if bad:
            raise AssertionError(
                f"broadcast semantics violated: nodes {bad[:8]} do not hold "
                f"exactly the root node {root}'s value"
            )
    elif c in ("reduce_scatter", "all_gather"):
        if n > CHUNKED_SEMANTIC_CAP:
            return  # structural checks only beyond the cube cap (see above)
        state = _chunk_contribution_words(sched)
        ids = np.arange(n)
        if c == "reduce_scatter":
            own = state[ids, ids]              # node i's partial of chunk i
            full = np.full(own.shape[1], np.uint64(0xFFFFFFFFFFFFFFFF))
            tail = n % 64
            if tail:
                full[-1] = np.uint64((1 << tail) - 1)
            bad = np.flatnonzero((own != full).any(axis=1)).tolist()
            if bad:
                raise AssertionError(
                    f"reduce-scatter semantics violated: nodes {bad[:8]} do "
                    "not own the complete reduction of their chunk"
                )
        else:
            # every node must hold exactly chunk c's originator, for every c
            want = np.zeros((n, state.shape[2]), dtype=np.uint64)
            want[ids, ids // 64] = np.left_shift(
                np.uint64(1), (ids % 64).astype(np.uint64))
            bad = np.flatnonzero(
                (state != want[None]).any(axis=(1, 2))).tolist()
            if bad:
                raise AssertionError(
                    f"all-gather semantics violated: nodes {bad[:8]} are "
                    "missing (or corrupting) some chunk"
                )
    elif c == "alltoall":
        if len(sched.steps) != 1:
            raise AssertionError(
                f"all-to-all must be a single step, got {len(sched.steps)}"
            )
        b = sched.steps[0].transfers
        codes = np.sort(b.src * n + b.dst)
        pair = np.arange(n)[:, None] * n + np.arange(n)[None, :]
        want = np.sort(pair[~np.eye(n, dtype=bool)])
        if codes.size != want.size or (codes != want).any():
            raise AssertionError(
                "all-to-all semantics violated: transfer rows do not cover "
                "every ordered pair exactly once"
            )


def _contribution_words(sched: WRHTSchedule) -> np.ndarray:
    """Data-flow simulation over uint64 bitset rows (one row per node)."""
    n = sched.n
    n_words = (n + 63) // 64
    state = np.zeros((n, n_words), dtype=np.uint64)
    ids = np.arange(n)
    state[ids, ids // 64] = np.left_shift(
        np.uint64(1), (ids % 64).astype(np.uint64)
    )
    for step in sched.steps:
        batch = step.transfers
        if len(batch) == 0:
            continue
        order = np.argsort(batch.dst, kind="stable")
        srcs, dsts = batch.src[order], batch.dst[order]
        gathered = state[srcs]  # all reads precede all writes within a step
        bounds = np.flatnonzero(np.r_[True, dsts[1:] != dsts[:-1]])
        if bounds.size == dsts.size:
            # every receiver gets exactly one transfer (e.g. broadcast):
            # reduceat over singleton groups is pathologically slow, skip it
            merged, receivers = gathered, dsts
        else:
            merged = np.bitwise_or.reduceat(gathered, bounds, axis=0)
            receivers = dsts[bounds]
        if step.kind == "broadcast":
            # broadcast overwrites with the rep's full value
            state[receivers] = merged
        else:
            state[receivers] |= merged
    return state


def _incomplete_nodes(words: np.ndarray, n: int) -> list[int]:
    full = np.full(words.shape[1], np.uint64(0xFFFFFFFFFFFFFFFF))
    tail = n % 64
    if tail:
        full[-1] = np.uint64((1 << tail) - 1)
    return np.flatnonzero((words != full).any(axis=1)).tolist()


def simulate_contribution_masks(sched: WRHTSchedule) -> list[int]:
    """Per-node contribution bitmask: node i starts with bit i; transfers OR.

    A correct all-reduce leaves every node with all n bits set (summation is
    a commutative-associative reduction, so bit-union tracks it faithfully).
    """
    words = _contribution_words(sched)
    return [
        int.from_bytes(words[i].astype("<u8").tobytes(), "little")
        for i in range(sched.n)
    ]


def simulate_contributions(sched: WRHTSchedule) -> list[frozenset[int]]:
    """Set view of :func:`simulate_contribution_masks` (test convenience)."""
    return [
        frozenset(i for i in range(sched.n) if mask >> i & 1)
        for mask in simulate_contribution_masks(sched)
    ]


def _chunk_contribution_words(sched: WRHTSchedule) -> np.ndarray:
    """Chunk-granular data-flow simulation for the ring passes.

    Returns an ``[n, n_chunks, n_words]`` uint64 cube: ``state[v, c]`` is the
    contribution bitset of node ``v``'s current partial of chunk ``c``.
    Initial state per the collective's spec — reduce-scatter starts every
    node with its own bit on EVERY chunk (it holds its full local vector);
    all-gather starts node ``i`` with its own bit on chunk ``i`` only (it
    contributes exactly its owned shard).  Each transfer ORs the source's
    partial of ``Step.chunks[row]`` into the destination's; reads precede
    writes within a step, like :func:`_contribution_words`.
    """
    n = sched.n
    n_words = (n + 63) // 64
    ids = np.arange(n)
    bit = np.left_shift(np.uint64(1), (ids % 64).astype(np.uint64))
    state = np.zeros((n, n, n_words), dtype=np.uint64)
    if sched.collective == "all_gather":
        state[ids, ids, ids // 64] = bit
    else:
        state[ids[:, None], np.arange(n)[None, :], (ids // 64)[:, None]] = \
            bit[:, None]
    for step in sched.steps:
        b = step.transfers
        if len(b) == 0:
            continue
        if step.chunks is None:
            raise AssertionError(
                f"chunked collective step {step.kind!r} carries no chunk ids"
            )
        key = b.dst * n + step.chunks
        order = np.argsort(key, kind="stable")
        srcs, dsts = b.src[order], b.dst[order]
        cks = step.chunks[order]
        gathered = state[srcs, cks]       # reads precede writes in a step
        ksorted = key[order]
        bounds = np.flatnonzero(np.r_[True, ksorted[1:] != ksorted[:-1]])
        if bounds.size == ksorted.size:
            merged, rd, rc = gathered, dsts, cks
        else:
            merged = np.bitwise_or.reduceat(gathered, bounds, axis=0)
            rd, rc = dsts[bounds], cks[bounds]
        state[rd, rc] |= merged
    return state


def simulate_chunk_contributions(
    sched: WRHTSchedule,
) -> list[list[frozenset[int]]]:
    """Set view of the chunk-granular data-flow: ``result[v][c]`` is the set
    of nodes whose contribution reached node ``v``'s partial of chunk ``c``
    (test convenience for the conformance harness, small ``n`` only)."""
    state = _chunk_contribution_words(sched)
    n = sched.n
    out = []
    for v in range(n):
        row = []
        for c in range(n):
            mask = int.from_bytes(state[v, c].astype("<u8").tobytes(),
                                  "little")
            row.append(frozenset(i for i in range(n) if mask >> i & 1))
        out.append(row)
    return out


def theoretical_steps(n: int, m: int) -> tuple[int, int]:
    """Closed form of Sec. III-D: (with all-to-all, without) step counts."""
    if n <= 1:
        return (0, 0)
    l = max(1, math.ceil(math.log(n, m)))
    return (2 * l - 1, 2 * l)
