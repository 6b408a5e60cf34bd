"""Pipelined multi-collective overlap composer (DESIGN.md §13).

A single WRHT collective is internally serial — every step waits for the
previous one — so ``timing="overlap"`` measures ≈0 gain on homogeneous
schedules (EXPERIMENTS.md §Perf).  The SWOT-style win comes from running
*different* collectives concurrently on one ring: bucket ``k+1``'s
reduce-scatter under bucket ``k``'s all-gather, or a broadcast prefetch
under a reduce-scatter.  This module composes ``k`` independently-built
collective schedules onto one ring:

* **Fused RWA**: at each composed slot the pending steps' transfers are
  concatenated into one union :class:`TransferBatch` and re-assigned by
  :func:`~repro.core.wavelength.first_fit_assign` (same λ budget ``w``,
  same hop budget, same failure mask), so concurrent collectives share the
  wavelength budget without conflicts.
* **Serialization fallback**: a pending step that cannot co-exist with the
  slot's union — :class:`WavelengthConflictError`,
  :class:`InsertionLossError` or :class:`FailedResourceError` from the
  fused assignment — simply waits; its constituent emits in a later slot
  (alone at worst, reusing its original already-assigned batch, so a
  depth-1 composition is bit-identical to the uncomposed schedule).
* **Constituent views**: each input schedule's steps appear in order,
  exactly once, with identical src/dst/direction/bits/chunks (only the
  wavelength assignment may differ on fused slots), so every constituent
  still satisfies its own per-collective semantic oracle
  (``tests/test_collective_conformance.py``) after interleaving.

The composed step list feeds the unchanged timing engines
(``ScheduleProfile.from_composed``, ``simulator.simulate_composed``): the
overlap recurrence then legitimately hides one constituent's
reconfiguration under another's communication — the gain a homogeneous
schedule cannot show.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from . import wrht
from .topology import FailureMask, TransferBatch
from .wavelength import (
    FailedResourceError,
    InsertionLossError,
    WavelengthConflictError,
    first_fit_assign,
    validate_no_conflicts,
)

# the uniform "this step pair cannot co-exist" signal of the fused RWA —
# anything else is a real bug and propagates
_RWA_ERRORS = (WavelengthConflictError, InsertionLossError,
               FailedResourceError)

# pipelined gradient sync alternates the two sharded-sync phases: bucket
# k+1's reduce-scatter runs under bucket k's all-gather.  Collectives with
# no natural partner pipeline against themselves (broadcast prefetch etc.).
PIPELINE_PARTNER = {"reduce_scatter": "all_gather",
                    "all_gather": "reduce_scatter"}


@dataclass(frozen=True)
class ComposedPart:
    """One constituent step's rows inside a composed slot."""

    constituent: int               # index into ComposedSchedule.schedules
    step: int                      # step index within that constituent
    lo: int                        # rows [lo, hi) of the slot's fused batch
    hi: int


@dataclass
class ComposedStep:
    """One slot of the composed timeline: a (possibly fused) batch plus the
    bookkeeping mapping its rows back to constituent steps."""

    transfers: TransferBatch
    parts: tuple[ComposedPart, ...]

    @property
    def fused(self) -> bool:
        return len(self.parts) > 1


@dataclass
class ComposedSchedule:
    """``k`` collective schedules interleaved onto one ring."""

    n: int
    w: int
    schedules: tuple[wrht.WRHTSchedule, ...]
    steps: list[ComposedStep]
    max_hops: int | None = None
    failures: FailureMask | None = None

    @property
    def depth(self) -> int:
        return len(self.schedules)

    @property
    def num_steps(self) -> int:
        return len(self.steps)

    @property
    def fused_steps(self) -> int:
        """Slots carrying ≥ 2 constituents concurrently."""
        return sum(1 for s in self.steps if s.fused)

    @property
    def serial_steps(self) -> int:
        """Slot count of the serial execution (sum of constituent steps)."""
        return sum(len(s.steps) for s in self.schedules)

    @property
    def slots_saved(self) -> int:
        """Reconfigurations the fusion removed vs serial execution."""
        return self.serial_steps - self.num_steps

    @property
    def fusion_efficiency(self) -> float:
        """Fraction of the theoretically removable slots the greedy fusion
        actually removed, in ``[0, 1]``.  A depth-``k`` composition can at
        best shrink ``serial_steps`` down to the longest constituent, so the
        denominator is ``serial_steps - max_j len(schedules[j].steps)``;
        ``1.0`` means perfect interleaving, ``0.0`` full serialization —
        the storm harness (DESIGN.md §14) watches this decay as a shrinking
        λ pool forces the fallback."""
        longest = max(len(s.steps) for s in self.schedules)
        removable = self.serial_steps - longest
        if removable <= 0:
            return 1.0
        return self.slots_saved / removable

    # -- constituent views ------------------------------------------------

    def part_step(self, slot: int, part: ComposedPart) -> wrht.Step:
        """Materialize one part as a :class:`wrht.Step` of its constituent.

        Single-part slots return the constituent's original Step object
        (batch identity preserved — this is what makes depth-1 composition
        bit-identical); fused slots slice the part's rows out of the fused
        batch, keeping the original kind/level/chunks.
        """
        cs = self.steps[slot]
        orig = self.schedules[part.constituent].steps[part.step]
        if not cs.fused:
            return orig
        b = cs.transfers
        lo, hi = part.lo, part.hi
        sub = TransferBatch(b.src[lo:hi], b.dst[lo:hi], b.direction[lo:hi],
                            b.bits[lo:hi], b.wavelength[lo:hi])
        return wrht.Step(orig.kind, orig.level, sub, chunks=orig.chunks)

    def constituent_steps(self, j: int) -> list[wrht.Step]:
        """Constituent ``j``'s steps in composed order (wavelengths as the
        fused assignment left them; src/dst/chunks untouched)."""
        out = []
        for slot, cs in enumerate(self.steps):
            for part in cs.parts:
                if part.constituent == j:
                    out.append(self.part_step(slot, part))
        return out

    def constituent_view(self, j: int) -> wrht.WRHTSchedule:
        """Constituent ``j`` as a standalone :class:`WRHTSchedule` whose
        steps are the composed-order materialization — the object the
        per-collective semantic oracles run against."""
        return replace(self.schedules[j], steps=self.constituent_steps(j))

    def as_steps(self) -> list[wrht.Step]:
        """The fused timeline as plain steps for the timing engines.

        ``kind="composed"`` marks fused slots; single-part slots keep the
        constituent's original Step object so the profile compiler's
        segment dedup (keyed on batch identity) still collapses a ring
        pass's shared batch.
        """
        out = []
        for slot, cs in enumerate(self.steps):
            if not cs.fused:
                out.append(self.part_step(slot, cs.parts[0]))
            else:
                out.append(wrht.Step("composed", 0, cs.transfers))
        return out


def _fuse(batches: list[TransferBatch], n: int, w: int,
          max_hops: int | None, failures: FailureMask | None,
          cache: dict | None) -> TransferBatch:
    """First-Fit RWA over the union of concurrent step batches.

    Raises the usual RWA errors when the union does not fit under ``w``,
    the hop budget or the failure mask — the caller's serialization
    fallback.  Memoized on the batch identities: a pipelined ring pass
    re-fuses the same pair of shared batches every slot, and returning the
    same fused object lets the profile compiler dedup the segment.
    """
    key = tuple(id(b) for b in batches)
    if cache is not None and key in cache:
        return cache[key]
    cat, _ = wrht._concat_batches(batches)
    fused = first_fit_assign(cat, n, w, max_hops=max_hops,
                             failures=failures)
    if cache is not None:
        cache[key] = fused
    return fused


def compose_schedules(
    schedules: "list[wrht.WRHTSchedule] | tuple[wrht.WRHTSchedule, ...]",
    offsets: "tuple[int, ...] | None" = None,
    max_hops: int | None = None,
) -> ComposedSchedule:
    """Interleave ``k`` collective schedules onto one ring.

    Greedy slot fusion with per-constituent cursors: each slot starts from
    the first constituent with a pending step, then tries to add every
    other pending step via the fused RWA over the union batch; a step that
    cannot co-exist waits for a later slot (serialization fallback).  Each
    constituent's steps retain their relative order, so constituent
    semantics are preserved by construction.

    ``offsets`` staggers constituent start slots (default: all start at
    slot 0 — the steady state of a bucket pipeline).  ``max_hops`` bounds
    fused lightpaths; it defaults to the tightest constituent budget.  All
    constituents must share one ring (``n``, ``w``) and one failure mask.
    """
    schedules = tuple(schedules)
    if not schedules:
        raise ValueError("need at least one schedule to compose")
    n, w = schedules[0].n, schedules[0].w
    for s in schedules:
        if (s.n, s.w) != (n, w):
            raise ValueError(
                f"constituents must share one ring: ({s.n}, {s.w}) != "
                f"({n}, {w})")
    masks = {s.failures if (s.failures and not s.failures.empty) else None
             for s in schedules}
    if len(masks) > 1:
        raise ValueError("constituents must share one failure mask")
    failures = masks.pop()
    hop_budgets = [s.max_hops for s in schedules if s.max_hops is not None]
    if max_hops is None and hop_budgets:
        max_hops = min(hop_budgets)

    k = len(schedules)
    if offsets is None:
        offsets = (0,) * k
    if len(offsets) != k or any(o < 0 for o in offsets):
        raise ValueError("offsets must give one slot >= 0 per constituent")
    base = min(offsets)
    offsets = tuple(o - base for o in offsets)

    cursors = [0] * k
    lens = [len(s.steps) for s in schedules]
    fuse_cache: dict = {}
    steps: list[ComposedStep] = []
    slot = 0
    while any(c < L for c, L in zip(cursors, lens)):
        ready = [j for j in range(k)
                 if cursors[j] < lens[j] and slot >= offsets[j]]
        if not ready:
            # every pending constituent is staggered past this slot; the
            # clock advances without emitting (nothing reconfigures)
            slot += 1
            continue
        j0 = ready[0]
        taken = [j0]
        batches = [schedules[j0].steps[cursors[j0]].transfers]
        fused: TransferBatch | None = None
        for j in ready[1:]:
            trial = batches + [schedules[j].steps[cursors[j]].transfers]
            try:
                cand = _fuse(trial, n, w, max_hops, failures, fuse_cache)
            except _RWA_ERRORS:
                continue                    # j waits — serialization fallback
            batches = trial
            fused = cand
            taken.append(j)
        ptr = np.zeros(len(batches) + 1, dtype=np.int64)
        np.cumsum([len(b) for b in batches], out=ptr[1:])
        parts = tuple(
            ComposedPart(j, cursors[j], int(ptr[i]), int(ptr[i + 1]))
            for i, j in enumerate(taken))
        steps.append(ComposedStep(fused if fused is not None else batches[0],
                                  parts))
        for j in taken:
            cursors[j] += 1
        slot += 1
    return ComposedSchedule(n=n, w=w, schedules=schedules, steps=steps,
                            max_hops=max_hops, failures=failures)


def pipeline_collectives(collective: str, depth: int) -> tuple[str, ...]:
    """The constituent sequence of a depth-``k`` pipeline starting with
    ``collective``: alternating with its partner phase (RS↔AG), or ``k``
    copies for partnerless collectives."""
    first = wrht.coerce_collective(collective)
    partner = PIPELINE_PARTNER.get(first, first)
    return tuple(first if j % 2 == 0 else partner for j in range(depth))


def build_pipeline_schedule(
    collective: str,
    n: int,
    w: int,
    d_bits: float,
    depth: int,
    m: int | None = None,
    allow_alltoall: bool = True,
    max_hops: int | None = None,
    rwa: str = "fast",
    failures: FailureMask | None = None,
    validate: bool = False,
    offsets: "tuple[int, ...] | None" = None,
) -> ComposedSchedule:
    """Build and compose the depth-``k`` pipeline of ``collective`` (the
    ``planned_pipelined`` traffic shape — successive buckets' alternating
    RS/AG phases concurrent on one ring).  All constituents are built at
    the same ``d_bits`` (the plan cache uses the d-independent ``d=1``
    structure; heterogeneous bucket payloads time through per-class grids
    downstream)."""
    if depth < 1:
        raise ValueError("pipeline depth must be >= 1")
    scheds = [
        wrht.build_collective_schedule(
            c, n, w, d_bits, m=m, allow_alltoall=allow_alltoall,
            validate=validate, rwa=rwa, max_hops=max_hops, failures=failures)
        for c in pipeline_collectives(collective, depth)
    ]
    return compose_schedules(scheds, offsets=offsets, max_hops=max_hops)


def validate_composed(composed: ComposedSchedule) -> None:
    """Structural validation of a composed schedule.

    Fused slots are checked for wavelength-conflict freedom under the
    composed hop budget and failure mask (:func:`validate_no_conflicts` on
    the fused batch — the negative the differential tests exercise);
    single-part slots are checked under their own constituent's budget
    (a constituent with a laxer hop budget than the composed minimum is
    legal while it runs alone).  Constituent *semantics* are validated via
    :meth:`ComposedSchedule.constituent_view` +
    :func:`wrht.validate_schedule`.
    """
    for cs in composed.steps:
        if cs.fused:
            validate_no_conflicts(cs.transfers, composed.n, composed.w,
                                  max_hops=composed.max_hops,
                                  failures=composed.failures)
        else:
            own = composed.schedules[cs.parts[0].constituent]
            validate_no_conflicts(cs.transfers, composed.n, composed.w,
                                  max_hops=own.max_hops,
                                  failures=composed.failures)
    for j in range(composed.depth):
        # every constituent step must appear exactly once, in order
        seen = [p.step for cs in composed.steps for p in cs.parts
                if p.constituent == j]
        if seen != list(range(len(composed.schedules[j].steps))):
            raise AssertionError(
                f"constituent {j} steps out of order or dropped: {seen}")
