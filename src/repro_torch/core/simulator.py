"""Optical ring interconnect simulator (the paper's in-house simulator, re-built).

Executes explicit per-step transfer schedules on the TeraRack-style ring of
``topology.Ring``.  Two timing engines (DESIGN.md §7):

* **lock-step** (:func:`simulate_steps`): each step pays the MRR
  reconfiguration delay ``a`` plus the duration of its *slowest* concurrent
  transfer (transfers inside one step are wavelength-parallel by
  construction; the RWA validator guarantees conflict-freedom).  This is the
  paper's model and the golden upper bound.
* **event-timed** (:func:`simulate_steps_event`): per-transfer start/finish
  times over the ``TransferBatch`` arrays, tracked per node.  With
  ``overlap=True`` it models SWOT-style reconfiguration–communication
  overlap: a node retunes its MRRs for the next step as soon as *its own*
  transfers finish, hiding the reconfiguration delay behind other nodes'
  tail transfers.  Never slower than lock-step; equal when overlap is off.

Flit alignment and O/E/O conversion follow Table II; when the ring carries a
``PhysicalParams`` model, receivers additionally pay per-hop propagation
delay, and every step is checked against the insertion-loss hop budget.

Besides WRHT (schedule from ``wrht.build_schedule``) this module builds the
explicit optical schedules of the three baselines the paper compares against
(Sec. IV-B): Ring, Binary-Tree and H-Ring — all validated for wavelength
conflicts before timing.  Baseline steps are emitted directly as
``TransferBatch`` arrays (DESIGN.md §1), so even the N-transfer flat-ring
step is built in O(1) NumPy calls.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace

import numpy as np

from . import step_models, wrht
from .topology import (CCW, CW, FailureMask, FaultTimeline,
                       ResourceObservation, Ring, TransferBatch)
from .wavelength import InsertionLossError, validate_no_conflicts


@dataclass
class SimResult:
    algorithm: str
    n: int
    d_bits: float
    steps: int
    serialization_s: float
    reconfig_s: float
    max_wavelengths: int = 0
    per_step_s: list[float] = field(default_factory=list)
    timing: str = "lockstep"           # engine that produced the result
    event_total_s: float | None = None  # overlap mode: makespan (not additive)

    @property
    def total_s(self) -> float:
        if self.event_total_s is not None:
            return self.event_total_s
        return self.serialization_s + self.reconfig_s


def _step_durations(
    ring: Ring, batch: TransferBatch, bits_override: float | None
) -> tuple[np.ndarray, np.ndarray]:
    """Per-transfer (transmit, receive) durations for one step.

    Transmit ends after flit-aligned serialization + O/E/O; the receiver is
    additionally ``hops`` segments of flight time downstream when the ring
    carries a physical model (zero otherwise, preserving the seed timing).
    """
    if bits_override is not None:
        ser = np.full(len(batch), ring.serialization_time(bits_override))
    else:
        ser = ring.serialization_time_array(batch.bits)
    if ring.physical is None:
        return ser, ser
    return ser, ser + ring.propagation_time(batch.arcs(ring.n)[2])


def simulate_steps(
    name: str, steps: list[wrht.Step], ring: Ring, d_bits: float,
    validate: bool = True, bits_override: float | None = None,
) -> SimResult:
    """Lock-step engine: Σ over steps of (reconfig + slowest transfer)."""
    ser = 0.0
    per_step = []
    maxw = 0
    for step in steps:
        batch = step.transfers
        if validate:
            validate_no_conflicts(batch, ring.n, ring.w, max_hops=ring.max_hops)
        if len(batch) == 0:
            s = 0.0
        else:
            # durations are monotone in bits, so the slowest concurrent
            # transfer bounds the step (with propagation: max over rx ends)
            s = float(_step_durations(ring, batch, bits_override)[1].max())
        ser += s
        per_step.append(s + ring.reconfig_delay_s)
        maxw = max(maxw, step.wavelengths)
    return SimResult(
        algorithm=name,
        n=ring.n,
        d_bits=d_bits,
        steps=len(steps),
        serialization_s=ser,
        reconfig_s=len(steps) * ring.reconfig_delay_s,
        max_wavelengths=maxw,
        per_step_s=per_step,
    )


def simulate_steps_event(
    name: str, steps: list[wrht.Step], ring: Ring, d_bits: float,
    overlap: bool = False, validate: bool = True,
    bits_override: float | None = None,
) -> SimResult:
    """Event-timed engine: per-transfer finish times over the batch arrays.

    Per-node readiness ``ready[v]`` tracks when node ``v`` is data-current
    and free.  A transfer starts once both endpoints are ready and retuned:

    * ``overlap=False`` — global step barrier: every transfer of step ``s``
      starts at ``max(ready) + a``.  Totals equal :func:`simulate_steps`
      bit-for-bit (same accumulation order), which the tests pin down.
    * ``overlap=True`` — SWOT-style: transfer ``i`` starts at
      ``max(ready[src_i], ready[dst_i]) + a``, so nodes whose step-``s-1``
      work finished early pay their MRR reconfiguration *during* the tail
      transfers of step ``s-1``.  Segment-level circuit teardown is modelled
      as endpoint availability (the binding constraint on a WDM ring where
      successive steps reuse disjoint wavelength sets); data dependencies
      are exact: a source transmits only after all its receptions finished.

    The transmitter frees at ``start + serialization``; the receiver at
    ``start + serialization + propagation`` (physical model permitting).
    """
    a = ring.reconfig_delay_s
    ready = np.zeros(ring.n)
    per_step: list[float] = []
    maxw = 0
    ser = 0.0     # lock-step-comparable per-step-max accumulation
    t_prev = 0.0
    for step in steps:
        batch = step.transfers
        if validate:
            validate_no_conflicts(batch, ring.n, ring.w, max_hops=ring.max_hops)
        if len(batch) == 0:
            # an empty step still retunes every node's MRRs — charge the
            # reconfiguration delay here exactly as ``reconfig_s`` (and the
            # lock-step engine's per_step) account for it, so sum(per_step)
            # equals the reported total in every engine
            ready += a
            t_prev += a
            per_step.append(a)
            continue
        tx, rx = _step_durations(ring, batch, bits_override)
        if overlap:
            start = np.maximum(ready[batch.src], ready[batch.dst]) + a
        else:
            start = np.full(len(batch), ready.max() + a)
        np.maximum.at(ready, batch.src, start + tx)
        np.maximum.at(ready, batch.dst, start + rx)
        t = float(ready.max())
        per_step.append(t - t_prev)
        t_prev = t
        ser += float(rx.max())
        maxw = max(maxw, step.wavelengths)
    if overlap:
        # the barrier execution is always admissible, so the makespan is
        # capped by the lock-step total; min() also pins the `event <=
        # lockstep` invariant exactly under FP accumulation-order noise.
        # Clamp audit for composed schedules (DESIGN.md §13): `ser` sums
        # the maxes of the steps as GIVEN — for a ComposedSchedule that is
        # the FUSED timeline (both collectives' transfers inside one
        # step), so the cap is the composition's own barrier execution,
        # not the serial sum of the constituents' lockstep totals.  The
        # cross-schedule credit (B's reconfiguration under A's
        # communication) lives inside each fused step and survives the
        # clamp; tests/test_compose.py pins the three engines' agreement
        # on the serial path and `overlap <= event == lockstep` composed.
        lockstep_total = ser + len(steps) * ring.reconfig_delay_s
        return SimResult(
            algorithm=name, n=ring.n, d_bits=d_bits, steps=len(steps),
            serialization_s=ser, reconfig_s=len(steps) * ring.reconfig_delay_s,
            max_wavelengths=maxw, per_step_s=per_step, timing="overlap",
            event_total_s=min(float(ready.max()), lockstep_total),
        )
    # barrier mode: report the same additive decomposition as lock-step so
    # the two are exactly comparable (event_total_s left unset on purpose)
    return SimResult(
        algorithm=name, n=ring.n, d_bits=d_bits, steps=len(steps),
        serialization_s=ser, reconfig_s=len(steps) * ring.reconfig_delay_s,
        max_wavelengths=maxw, per_step_s=per_step, timing="event",
    )


# ---------------------------------------------------------------------------
# Per-resource health telemetry: the observation source of the closed
# fault-management loop (DESIGN.md §14).
# ---------------------------------------------------------------------------

def _schedule_touches(steps: list[wrht.Step], n: int, kind: str,
                      ident: tuple[int, int]) -> bool:
    """Does any transfer of the schedule exercise the resource?

    ``segment (lane, seg)``: some lightpath covers the directed span.
    ``wavelength (node, λ)``: some transfer adds or drops λ at the node.
    ``transceiver (node, lane)``: some transfer starts or ends at the node
    on that fiber (pass-through traffic exercises neither λ banks nor
    transceivers — the exact semantics the :class:`FailureMask` classes
    enforce).
    """
    a, b = ident
    for step in steps:
        batch = step.transfers
        if len(batch) == 0:
            continue
        lane, start, hops = batch.arcs(n)
        if kind == "segment":
            off = (b - start) % n
            if bool(((lane == a) & (off < hops)).any()):
                return True
        elif kind == "wavelength":
            at_node = (batch.src == a) | (batch.dst == a)
            if bool((at_node & (batch.wavelength == b)).any()):
                return True
        else:  # transceiver
            at_node = (batch.src == a) | (batch.dst == a)
            if bool((at_node & (lane == b)).any()):
                return True
    return False


def observe_faults(
    timeline: FaultTimeline, step: int,
    steps: "list[wrht.Step] | None" = None, n: int | None = None,
) -> list[ResourceObservation]:
    """Per-resource health telemetry for one training step.

    Emits one :class:`~repro.core.topology.ResourceObservation` per
    resource the ``timeline`` tracks — ``ok=False`` while the resource's
    :class:`~repro.core.topology.FlapSchedule` says it is down (a per-λ /
    per-span error or timeout event), ``ok=True`` otherwise.  This is the
    raw signal the :class:`~repro.runtime.fault_tolerance.HealthMonitor`
    smooths with confirm/cooldown hysteresis (DESIGN.md §14); the monitor,
    not this probe, decides what becomes a :class:`FailureMask`.

    With ``steps``/``n`` given, observations are restricted to resources
    the schedule actually exercises — a dead λ nobody adds or drops
    produces no error event, so detection latency genuinely depends on
    traffic, exactly like hardware monitoring.
    """
    if steps is not None and n is None:
        raise ValueError("observe_faults(steps=...) needs the ring size n")
    out = []
    for f in timeline.flaps:
        if steps is not None and not _schedule_touches(steps, n, f.kind,
                                                       f.ident):
            continue
        out.append(ResourceObservation(step, f.kind, f.ident,
                                       ok=not f.is_down(step)))
    return out


# ---------------------------------------------------------------------------
# Baseline schedules on the optical ring.
# ---------------------------------------------------------------------------

def ring_allreduce_schedule(n: int, d_bits: float) -> list[wrht.Step]:
    """Bandwidth-optimal ring all-reduce: reduce-scatter + all-gather,
    2(N-1) steps, every node forwards a d/N chunk to its CW neighbour.
    Neighbour hops occupy disjoint segments -> wavelength 0 everywhere
    (the paper's point: only ONE of w wavelengths is ever used)."""
    src = np.arange(n)
    batch = TransferBatch.from_arrays(
        src, (src + 1) % n, CW, d_bits / n, wavelength=0, check=False
    )
    # every step is the identical neighbour pattern; batches are immutable
    # by convention, so one array set backs all 2(N-1) steps
    return [wrht.Step("ring", 0, batch) for _ in range(2 * (n - 1))]


def bt_allreduce_schedule(n: int, d_bits: float) -> list[wrht.Step]:
    """Binary-tree all-reduce (Sec. III-B, Fig. 2a): ⌈log₂N⌉ reduce steps
    (sender at offset 2^{i-1} inside each 2^i-group sends the FULL vector to
    the group head) + the mirrored broadcast."""
    levels = max(1, math.ceil(math.log2(n)))
    reduce_steps = []
    for i in range(1, levels + 1):
        span, half = 2**i, 2 ** (i - 1)
        heads = np.arange(0, n, span)
        senders = heads + half
        heads, senders = heads[senders < n], senders[senders < n]
        reduce_steps.append(wrht.Step("reduce", i - 1, TransferBatch.from_arrays(
            senders, heads, CCW, d_bits, wavelength=0, check=False
        )))
    bcast_steps = [
        wrht.Step("broadcast", s.level, TransferBatch.from_arrays(
            s.transfers.dst, s.transfers.src, CW, d_bits, wavelength=0, check=False
        ))
        for s in reversed(reduce_steps)
    ]
    return reduce_steps + bcast_steps


def hring_group_size(n: int, g: int) -> int:
    """Largest usable H-Ring group size ``<= g`` dividing ``n`` (1 when none
    exists, e.g. prime N — callers fall back to the flat ring).  Shared by
    ``run_optical`` and the batched ``timing`` front-end so both always time
    the same schedule."""
    g = min(g, n)
    while g > 1 and n % g:
        g -= 1
    return g


def check_hring_span(ring: Ring, n: int, g: int) -> None:
    """Longest H-Ring lightpath vs the insertion-loss hop budget.

    The inter-group hop spans ``g`` segments (when >= 2 groups exist), the
    intra wrap link ``g - 1``; the analytic lock-step shortcut skips
    per-transfer validation, so this single check gates both the per-point
    and the batched H-Ring paths (shared for the same reason as
    :func:`hring_group_size`)."""
    span = g if n // g >= 2 else g - 1
    if ring.max_hops is not None and span > ring.max_hops:
        raise InsertionLossError(
            f"H-Ring lightpath spans {span} segments, exceeding the "
            f"insertion-loss hop budget of {ring.max_hops}"
        )


def hring_allreduce_schedule(n: int, g: int, d_bits: float) -> list[wrht.Step]:
    """Hierarchical ring [13]: intra-group ring reduce-scatter (chunks d/g),
    inter-group ring all-reduce among the g-group heads on each d/g shard,
    intra-group all-gather.  Intra wrap-links ride the CCW fiber; all other
    hops ride CW, so one wavelength per fiber suffices."""
    if g < 2:
        raise ValueError("H-Ring needs group size g >= 2 (g=1 degenerates to "
                         "a self-transfer on the intra wrap link)")
    if n % g:
        raise ValueError("H-Ring needs g | N")
    n_groups = n // g
    steps: list[wrht.Step] = []

    def intra_step(chunk_bits: float) -> wrht.Step:
        heads = np.arange(0, n, g)
        fwd_src = (heads[:, None] + np.arange(g - 1)[None, :]).ravel()
        src = np.concatenate([fwd_src, heads + g - 1])
        dst = np.concatenate([fwd_src + 1, heads])
        direction = np.concatenate([
            np.full(fwd_src.size, CW),
            np.full(heads.size, CCW),  # wrap link of the logical intra ring
        ])
        return wrht.Step("intra", 0, TransferBatch.from_arrays(
            src, dst, direction, chunk_bits, wavelength=0, check=False
        ))

    def inter_step(chunk_bits: float) -> wrht.Step:
        heads = np.arange(n_groups) * g
        # wrap link closes the logical ring CW through the last group's span
        dst = np.roll(heads, -1)
        return wrht.Step("inter", 1, TransferBatch.from_arrays(
            heads, dst, CW, chunk_bits, wavelength=0, check=False
        ))

    intra = intra_step(d_bits / g)
    inter = inter_step((d_bits / g) / n_groups)
    steps.extend([intra] * (g - 1))                 # intra reduce-scatter
    steps.extend([inter] * (2 * (n_groups - 1)))    # inter ring all-reduce
    steps.extend([intra] * (g - 1))                 # intra all-gather
    return steps


# ---------------------------------------------------------------------------
# Front-ends used by the benchmarks.
# ---------------------------------------------------------------------------

def _cached_wrht_schedule(
    n: int, w: int, m: int | None, max_hops: int | None = None,
    allow_alltoall: bool = True, failures: FailureMask | None = None,
) -> wrht.WRHTSchedule:
    """WRHT schedule structure is independent of the payload size — build and
    fully validate (structural + semantic, both vectorized) once per
    (n, w, m, hop budget, all-to-all policy).  Historically an ad-hoc
    ``lru_cache``; now a thin front-end over the two-tier plan cache
    (``repro.core.plan_cache``, DESIGN.md §10), which also holds the
    compiled timing profiles keyed on the same d-independent structure."""
    from . import plan_cache

    return plan_cache.get_default().schedule(plan_cache.PlanKey(
        n=n, w=w, m=m, alltoall=allow_alltoall, max_hops=max_hops,
        failures=failures))


def _simulate(
    name: str, steps: list[wrht.Step], ring: Ring, d_bits: float, timing: str,
    validate: bool = True, bits_override: float | None = None,
) -> SimResult:
    if timing == "lockstep":
        return simulate_steps(name, steps, ring, d_bits, validate=validate,
                              bits_override=bits_override)
    if timing in ("event", "overlap"):
        return simulate_steps_event(name, steps, ring, d_bits,
                                    overlap=timing == "overlap",
                                    validate=validate,
                                    bits_override=bits_override)
    raise ValueError(f"unknown timing {timing!r} "
                     "(expected 'lockstep', 'event' or 'overlap')")


def run_optical(
    algorithm: str,
    n: int,
    d_bits: float,
    p: step_models.OpticalParams | None = None,
    g: int = 8,
    m: int | str | None = None,
    timing: str | None = None,
    failures: FailureMask | None = None,
) -> SimResult:
    """Simulate one all-reduce on the optical ring.

    ``timing`` overrides ``p.timing`` ("lockstep" | "event" | "overlap").
    With ``p.physical`` set, WRHT schedules are built under the insertion-
    loss hop budget and every simulated step is checked against it — a
    baseline whose fixed schedule needs longer lightpaths than the budget
    allows (e.g. binary tree at small budgets) raises ``InsertionLossError``,
    which ``benchmarks/bench_insertion_loss.py`` reports as infeasible.

    ``m="auto"`` hands the WRHT fan-out choice to the simulator-backed
    auto-tuner (:func:`repro.core.timing.tune_wrht`): every feasible group
    size — and the final all-to-all on/off — is swept through the batched
    timing engine and the simulated argmin is used here.

    ``failures`` simulates the degraded ring (DESIGN.md §12) — WRHT only:
    the baselines' schedules are fixed patterns with no route-around, so a
    non-empty mask on them is an error, not a silently wrong number.
    """
    p = p or step_models.OpticalParams()
    timing = timing or p.timing
    if failures is not None and failures.empty:
        failures = None
    ring = Ring(n, p.wavelengths, bandwidth_bps=p.bandwidth_bps,
                reconfig_delay_s=p.reconfig_delay_s, physical=p.physical,
                failures=failures)
    if algorithm == "wrht":
        allow_alltoall = True
        if m == "auto":
            from . import timing as _timing  # import here: timing builds on us
            tuned = _timing.tune_wrht(n, p.wavelengths, d_bits, ring.max_hops,
                                      p=p, timing=timing, failures=failures)
            m, allow_alltoall = tuned.best(0)
        sched = _cached_wrht_schedule(n, p.wavelengths, m, ring.max_hops,
                                      allow_alltoall, failures)
        # every WRHT transfer carries the constant full vector d
        return _simulate("wrht", sched.steps, ring, d_bits, timing,
                         validate=False, bits_override=d_bits)
    if failures is not None:
        raise ValueError(
            f"algorithm {algorithm!r} has a fixed schedule and cannot route "
            "around failures — only 'wrht' supports a failure mask"
        )
    if algorithm == "ring":
        # every one of the 2(N-1) steps is the identical neighbour pattern
        # and every node is both a sender and a receiver, so all three
        # timing engines coincide (uniform per-node finish times): validate/
        # time one representative step and scale (exact, since the per-step
        # payload d/N is constant).
        src = np.arange(n)
        one = [wrht.Step("ring", 0, TransferBatch.from_arrays(
            src, (src + 1) % n, CW, d_bits / n, wavelength=0, check=False
        ))]
        r = simulate_steps("ring", one, ring, d_bits)
        k = 2 * (n - 1)
        return SimResult("ring", n, d_bits, k, r.serialization_s * k,
                         k * ring.reconfig_delay_s, r.max_wavelengths,
                         timing=timing)
    if algorithm == "bt":
        return _simulate("bt", bt_allreduce_schedule(n, d_bits), ring, d_bits,
                         timing)
    if algorithm == "hring":
        g = hring_group_size(n, g)
        if g < 2:
            # prime (or tiny) N admits no proper grouping: H-Ring degenerates
            # to the flat ring; report that schedule under the hring label
            return replace(run_optical("ring", n, d_bits, p, timing=timing),
                           algorithm="hring")
        check_hring_span(ring, n, g)
        if timing != "lockstep":
            # heads and members have genuinely different idle patterns, so
            # the event engines need the explicit full-N schedule
            return _simulate("hring", hring_allreduce_schedule(n, g, d_bits),
                             ring, d_bits, timing)
        sched = hring_allreduce_schedule(2 * g, g, d_bits)  # one intra + inter template
        intra = simulate_steps("hring-intra", [sched[0]], Ring(2 * g, ring.w,
                               bandwidth_bps=ring.bandwidth_bps,
                               reconfig_delay_s=ring.reconfig_delay_s,
                               physical=ring.physical), d_bits)
        n_groups = n // g
        intra_steps = 2 * (g - 1)
        inter_steps = 2 * (n_groups - 1)
        inter_ser = ring.serialization_time((d_bits / g) / n_groups)
        if ring.physical is not None:
            # inter-group heads are g segments apart: receivers pay flight time
            inter_ser += float(ring.propagation_time(np.asarray([g]))[0])
        total_steps = intra_steps + inter_steps
        ser = intra_steps * intra.serialization_s + inter_steps * inter_ser
        return SimResult("hring", n, d_bits, total_steps, ser,
                         total_steps * ring.reconfig_delay_s, 1)
    raise ValueError(f"unknown optical algorithm {algorithm!r}")


def run_collective(
    collective: str,
    n: int,
    d_bits: float,
    p: step_models.OpticalParams | None = None,
    m: int | None = None,
    timing: str | None = None,
    allow_alltoall: bool = True,
    failures: FailureMask | None = None,
) -> SimResult:
    """Simulate one scheduled collective on the optical ring (DESIGN.md §11).

    The per-point counterpart of :func:`repro.core.timing.collective_times`
    (which is golden-tested bit-identical to this path): the schedule's
    d-independent structure comes from the plan cache, and the payload
    accounting follows the collective's spec — the ring passes and the
    all-to-all carry ``d/n`` per transfer, the trees the constant full
    vector.  Infeasible schedules raise exactly like the builders
    (``WavelengthConflictError`` / ``InsertionLossError``).
    """
    from . import plan_cache

    p = p or step_models.OpticalParams()
    timing = timing or p.timing
    name = wrht.coerce_collective(collective)
    spec = wrht.COLLECTIVES[name]
    if failures is not None and failures.empty:
        failures = None
    ring = Ring(max(n, 2), p.wavelengths, bandwidth_bps=p.bandwidth_bps,
                reconfig_delay_s=p.reconfig_delay_s, physical=p.physical,
                failures=failures)
    km, ka = wrht.collective_plan_fields(name, m, allow_alltoall)
    sched = plan_cache.get_default().schedule(plan_cache.PlanKey(
        n=n, w=p.wavelengths, m=km, alltoall=ka, max_hops=ring.max_hops,
        collective=name, failures=failures))
    # the same division chain as the profile's PayloadClass((n,)) — float /
    # int division promotes identically, so the two paths stay bit-identical
    bits = d_bits / n if spec.chunked else d_bits
    return _simulate(name, sched.steps, ring, d_bits, timing,
                     validate=False, bits_override=bits)


def simulate_composed(
    composed,
    d_bits: float,
    p: step_models.OpticalParams | None = None,
    timing: str | None = None,
    validate: bool = False,
) -> SimResult:
    """Per-point timing of a :class:`~repro.core.compose.ComposedSchedule`
    (DESIGN.md §13) — the scalar counterpart of
    :meth:`~repro.core.timing.ScheduleProfile.from_composed`.

    The fused timeline runs through the unchanged engines with
    ``bits_override=None``: composed steps mix payload classes (an RS
    chunk under a broadcast full vector), so every transfer times at its
    own build-time bits — the constituents must therefore have been built
    at this ``d_bits``.  With ``timing="overlap"`` the per-node readiness
    recurrence grants the SWOT-style credit across constituents: one
    schedule's reconfiguration hides under the other's communication
    inside each fused step (see the clamp-audit note in
    :func:`simulate_steps_event`).
    """
    p = p or step_models.OpticalParams()
    timing = timing or p.timing
    ring = Ring(max(composed.n, 2), composed.w,
                bandwidth_bps=p.bandwidth_bps,
                reconfig_delay_s=p.reconfig_delay_s, physical=p.physical,
                failures=composed.failures)
    name = "composed:" + "+".join(s.collective for s in composed.schedules)
    return _simulate(name, composed.as_steps(), ring, d_bits, timing,
                     validate=validate, bits_override=None)
