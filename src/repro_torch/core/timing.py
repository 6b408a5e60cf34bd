"""Payload-vectorized schedule timing (DESIGN.md §9).

Schedule *construction* is an array program; this module does the
same for schedule *evaluation*.  A ``list[wrht.Step]`` is compiled once into
a :class:`ScheduleProfile` — stacked per-step arrays (step→segment map,
flattened src/dst/hops, per-transfer payload-class ids) — and an entire grid
of payload sizes ``d_bits`` (shape ``[D]``) is then timed for any of the
three engines (lockstep / event / overlap) in broadcasted NumPy passes:

* **lockstep** — for a fixed schedule the total is affine in ``d`` between
  flit boundaries: every step's duration is ``max over transfers of
  ser(frac·d) + prop(hops)``.  Serialization depends only on the transfer's
  *payload class* (the exact division chain producing its bits from ``d``)
  and propagation only on its hop count, so each step collapses at compile
  time to its unique ``(class, hops)`` candidate pairs and the whole grid
  evaluates as one ``[D, candidates]`` max-reduce per schedule.
* **event / overlap** — the per-node readiness recurrence of
  ``simulator.simulate_steps_event`` runs once over ``[D, n]`` arrays
  instead of ``D`` separate Python walks; duplicate-endpoint max-scatters
  are pre-grouped at compile time so the inner loop is pure ``reduceat``.

Numbers are **bit-identical** to the per-point
:func:`repro.core.simulator.run_optical` path — same division chains, same
flit arithmetic, same accumulation order, same analytic shortcuts for the
flat ring and the lock-step H-Ring — pinned by
``tests/test_timing_grid.py``.

Front-ends:

* :func:`evaluate_grid` — ``algorithms × N × d_bits × timing`` in one call
  with cross-point schedule/profile caching; what the sweep benchmarks use.
* :func:`tune_wrht` — simulator-backed auto-tuner: sweep every feasible
  WRHT fan-out ``m`` (and the final all-to-all on/off) through the batched
  engine, return the simulated argmin.  Wired into
  ``run_optical(m="auto")`` and ``planner.plan_bucket(backend="simulated")``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field, replace

import numpy as np

from . import simulator, step_models, wrht
from .topology import CW, FailureMask, Ring, TransferBatch
from .wavelength import InsertionLossError, validate_no_conflicts


@dataclass(frozen=True)
class PayloadClass:
    """How one group of transfers derives its bits from the payload ``d``.

    ``bits(d) = d / divisors[0] / divisors[1] / ... · width_bits/32`` — kept
    as the explicit division *chain* (not a collapsed fraction) so the
    floating-point result is bit-identical to the schedule builders'.  E.g.
    the H-Ring inter-group chunk is ``(d / g) / n_groups``, which differs in
    the last ulp from ``d / (g · n_groups)``.

    ``width_bits`` is the wire width per element (DESIGN.md §15): ``d`` is
    always the *logical* fp32 payload, and a compressed schedule's β-term
    shrinks by the exact factor ``width_bits/32``.  The supported widths
    (32/16/8/4) are power-of-two fractions of 32, so the scaling is a pure
    FP exponent shift that commutes with the division chain — width-scaled
    evaluation at ``d`` is bit-identical to width-32 evaluation at
    ``d·width_bits/32``.  Class *matching* in :meth:`ScheduleProfile.from_steps`
    uses :meth:`structural_bits` (chain only): builders emit width-32
    structure, width is a pure evaluation-time attribute.
    """

    divisors: tuple[float, ...] = ()
    width_bits: float = 32.0

    def bits(self, d: np.ndarray) -> np.ndarray:
        b = self.structural_bits(d)
        if self.width_bits != 32.0:
            b = b * (self.width_bits / 32.0)
        return b

    def structural_bits(self, d: np.ndarray) -> np.ndarray:
        b = np.asarray(d, dtype=np.float64)
        for q in self.divisors:
            b = b / q
        return b


FULL_VECTOR = PayloadClass()  # every transfer carries the constant full d


@dataclass(frozen=True)
class _Scatter:
    """Compile-time grouping of one segment's endpoint updates.

    ``vals[:, perm]`` reduced at ``ptr`` gives the per-unique-node max, so
    the event engine's duplicate-safe max-scatter (``np.maximum.at`` in the
    per-point engine) becomes one C-speed ``reduceat`` over the grid.  When
    every endpoint is distinct (flat ring, binary tree, H-Ring — only WRHT
    representatives drain several members at once) ``direct`` marks that no
    grouping is needed at all and the update is a plain fancy assignment.
    """

    nodes: np.ndarray   # unique endpoint ids               [G]
    perm: np.ndarray    # argsort of the endpoint column    [T]
    ptr: np.ndarray     # group starts into perm            [G]
    direct: bool        # all endpoints unique: skip the reduceat

    def apply(self, ready: np.ndarray, vals: np.ndarray,
              buf: np.ndarray | None = None) -> None:
        """``ready[node] = max(ready[node], max of node's vals)``.

        ``ready`` is ``[n, D]`` and ``vals`` ``[T, D]`` — node-major layout,
        so every gather/scatter runs on axis 0, NumPy's fast path.  ``buf``
        (shape ``[T, D]``, direct case only) makes the update allocation-free
        for the hot repeated-segment loop.
        """
        if self.direct:
            if buf is not None:
                # mode="clip" keeps take() on its fast unbuffered path; the
                # node ids are always in range so it never actually clips
                np.take(ready, self.nodes, axis=0, out=buf, mode="clip")
                np.maximum(buf, vals, out=buf)
                ready[self.nodes] = buf
            else:
                ready[self.nodes] = np.maximum(ready[self.nodes], vals)
            return
        gmax = np.maximum.reduceat(vals[self.perm], self.ptr, axis=0)
        ready[self.nodes] = np.maximum(ready[self.nodes], gmax)


def _scatter(idx: np.ndarray) -> _Scatter:
    perm = np.argsort(idx, kind="stable")
    sorted_idx = idx[perm]
    marks = np.empty(sorted_idx.size, dtype=bool)
    marks[0] = True
    np.not_equal(sorted_idx[1:], sorted_idx[:-1], out=marks[1:])
    ptr = np.flatnonzero(marks)
    if ptr.size == idx.size:  # no duplicates: update in input order
        return _Scatter(idx, perm, ptr, True)
    return _Scatter(sorted_idx[ptr], perm, ptr, False)


class ScheduleProfile:
    """A ``list[wrht.Step]`` compiled to stacked arrays for grid evaluation.

    Steps sharing one ``TransferBatch`` object (the flat ring repeats one
    batch for all ``2(N-1)`` steps; H-Ring repeats its intra/inter templates)
    collapse to a single *segment*: transfers are stored once, validated
    once, and the per-step view is just an index into the segment table.
    """

    __slots__ = (
        "n", "num_steps", "max_wavelengths", "step_seg", "seg_ptr",
        "src", "dst", "hops", "cls", "classes", "cand_ptr", "cand_cls",
        "cand_hops", "scatter_src", "scatter_dst",
    )

    def __init__(self) -> None:  # populated by from_steps
        pass

    @classmethod
    def from_steps(
        cls,
        steps: list[wrht.Step],
        ring: Ring,
        classes: tuple[PayloadClass, ...] = (FULL_VECTOR,),
        d_ref: float = 1.0,
        validate: bool = True,
        seg_cache: dict | None = None,
    ) -> "ScheduleProfile":
        """Compile ``steps`` against ``ring``.

        ``classes`` lists the payload classes present in the schedule; each
        transfer is matched to its class by comparing the batch's build-time
        bits against ``class.bits(d_ref)`` (exact float equality — both were
        produced by the same division chain).  With the default single
        ``FULL_VECTOR`` class the batch bits are ignored (the
        ``bits_override`` convention of the WRHT/BT simulators).

        ``validate`` runs the conflict/hop-budget check once per unique
        segment — the per-point engines re-validated every step of every
        call.

        ``seg_cache`` shares per-batch compile work *across* ``from_steps``
        calls, keyed on batch object identity: the batched auto-tuner's
        candidate schedules share their level batches between the
        all-to-all/no-all-to-all variants (DESIGN.md §10), so each shared
        segment is compiled once.  Only pass a cache between calls whose
        ``(ring.n, classes, d_ref, validate)`` agree, and only while the
        batches stay alive (the dict is id-keyed).
        """
        self = cls()
        self.n = ring.n
        self.num_steps = len(steps)
        self.classes = tuple(classes)

        seg_of: dict[int, int] = {}
        seg_batches = []
        step_seg = np.empty(len(steps), dtype=np.int64)
        for i, step in enumerate(steps):
            key = id(step.transfers)
            if key not in seg_of:
                seg_of[key] = len(seg_batches)
                seg_batches.append(step.transfers)
            step_seg[i] = seg_of[key]
        self.step_seg = step_seg

        src_parts, dst_parts, hops_parts, cls_parts = [], [], [], []
        seg_ptr = [0]
        cand_cls_parts, cand_hops_parts = [], []
        cand_ptr = [0]
        max_wavelengths = 0
        # match on the structural chain only: builders emit width-32 bits,
        # a class's wire width is evaluation-time (PayloadClass docstring)
        ref_bits = np.array(
            [c.structural_bits(np.float64(d_ref)) for c in self.classes],
            dtype=np.float64
        )
        for batch in seg_batches:
            t = len(batch)
            compiled = seg_cache.get(id(batch)) if seg_cache is not None else None
            if compiled is None:
                if validate and t:
                    validate_no_conflicts(batch, ring.n, ring.w,
                                          max_hops=ring.max_hops)
                hops = batch.arcs(ring.n)[2] if t else np.zeros(0, dtype=np.int64)
                if len(self.classes) == 1:
                    cls_ids = np.zeros(t, dtype=np.int64)
                else:
                    cls_ids = np.full(t, -1, dtype=np.int64)
                    for k, v in enumerate(ref_bits):
                        cls_ids[batch.bits == v] = k
                    if t and (cls_ids < 0).any():
                        raise ValueError(
                            "transfer bits do not match any payload class at "
                            f"d_ref={d_ref!r}"
                        )
                # lockstep candidates: unique (class, hops) pairs per segment
                if not t:
                    keep = np.zeros(0, dtype=np.int64)
                elif len(self.classes) == 1:
                    # one class means one serialization time, and propagation
                    # is monotone in hops, so the step max is exactly the
                    # max-hops candidate — no dedup sort needed
                    keep = np.asarray([hops.argmax()], dtype=np.int64)
                else:
                    pair = cls_ids * (int(hops.max()) + 1) + hops
                    _, keep = np.unique(pair, return_index=True)
                wmax = 1 + int(batch.wavelength.max()) if t else 0
                compiled = (hops, cls_ids, cls_ids[keep], hops[keep], wmax)
                if seg_cache is not None:
                    seg_cache[id(batch)] = compiled
            hops, cls_ids, keep_cls, keep_hops, wmax = compiled
            max_wavelengths = max(max_wavelengths, wmax)
            src_parts.append(batch.src)
            dst_parts.append(batch.dst)
            hops_parts.append(hops)
            cls_parts.append(cls_ids)
            seg_ptr.append(seg_ptr[-1] + t)
            cand_cls_parts.append(keep_cls)
            cand_hops_parts.append(keep_hops)
            cand_ptr.append(cand_ptr[-1] + keep_cls.size)

        def cat(parts, dtype=np.int64):
            return (np.concatenate(parts).astype(dtype, copy=False)
                    if parts else np.zeros(0, dtype=dtype))

        self.src = cat(src_parts)
        self.dst = cat(dst_parts)
        self.hops = cat(hops_parts)
        self.cls = cat(cls_parts)
        self.seg_ptr = np.asarray(seg_ptr, dtype=np.int64)
        self.cand_cls = cat(cand_cls_parts)
        self.cand_hops = cat(cand_hops_parts)
        self.cand_ptr = np.asarray(cand_ptr, dtype=np.int64)
        self.max_wavelengths = max_wavelengths
        # endpoint scatter groupings are only needed by the overlap engine:
        # built lazily (_ensure_scatters) so lockstep-only consumers — the
        # auto-tuner sweep above all — never pay for them
        self.scatter_src = None
        self.scatter_dst = None
        return self

    @classmethod
    def from_composed(
        cls,
        composed,
        ring: Ring,
        classes: "tuple[PayloadClass, ...] | None" = None,
        d_ref: float = 1.0,
        validate: bool = False,
        seg_cache: dict | None = None,
        width_bits: float = 32.0,
    ) -> "ScheduleProfile":
        """Compile a :class:`~repro.core.compose.ComposedSchedule`
        (DESIGN.md §13) through the same machinery as :meth:`from_steps`.

        The fused timeline becomes the step list — so the event engine's
        barrier recurrence and the overlap engine's per-node readiness
        recurrence apply unchanged, and the SWOT-style credit (schedule
        B's reconfiguration hiding under schedule A's communication) falls
        out of the recurrence because both schedules' transfers share each
        fused step.  ``classes`` defaults to the union of the
        constituents' payload classes (deduplicated, order-preserving);
        all constituents must have been built at the same payload
        reference ``d_ref`` so the exact-bits class matching of
        :meth:`from_steps` resolves (the plan cache's d-independent
        ``d=1`` builds satisfy this by construction).

        Single-part slots reuse the constituent's original ``Step``
        objects, so the identity-keyed segment dedup still collapses a
        ring pass's shared batch — and a depth-1 composition compiles to a
        profile bit-identical to the uncomposed schedule's
        (``tests/test_compose.py``).
        """
        if classes is None:
            seen: list[PayloadClass] = []
            for s in composed.schedules:
                c = PayloadClass(
                    wrht.COLLECTIVES[s.collective].payload_divisors(s.n),
                    width_bits)
                if all(c.divisors != o.divisors for o in seen):
                    seen.append(c)
            classes = tuple(seen)
        return cls.from_steps(composed.as_steps(), ring, classes=classes,
                              d_ref=d_ref, validate=validate,
                              seg_cache=seg_cache)

    def _ensure_scatters(self) -> None:
        if self.scatter_src is not None:
            return
        scatter_src, scatter_dst = [], []
        for lo, hi in zip(self.seg_ptr[:-1].tolist(), self.seg_ptr[1:].tolist()):
            scatter_src.append(_scatter(self.src[lo:hi]) if hi > lo else None)
            scatter_dst.append(_scatter(self.dst[lo:hi]) if hi > lo else None)
        self.scatter_src = scatter_src
        self.scatter_dst = scatter_dst

    @property
    def num_segments(self) -> int:
        return len(self.seg_ptr) - 1

    @property
    def num_transfers(self) -> int:
        return int(self.seg_ptr[-1])

    # ------------------------------------------------------------------
    # grid evaluation
    # ------------------------------------------------------------------

    def _class_ser(self, ring: Ring, d: np.ndarray) -> np.ndarray:
        """Per-class serialization times, shape ``[D, n_classes]``."""
        cols = [ring.serialization_time_array(c.bits(d)) for c in self.classes]
        return np.stack(cols, axis=1)

    def _step_maxes(self, ring: Ring, d: np.ndarray) -> np.ndarray:
        """Lock-step per-step durations for the whole grid, shape ``[D, S]``.

        ``max over transfers of ser + prop`` reduced over the compile-time
        ``(class, hops)`` candidates — the max is order-independent, so the
        reduction over deduplicated candidates is bit-identical to the
        per-transfer max of the per-point engine.
        """
        ser_c = self._class_ser(ring, d)
        seg_max = np.zeros((d.size, self.num_segments))
        nonempty = self.cand_ptr[:-1] < self.cand_ptr[1:]
        if nonempty.any():
            cand = (ser_c[:, self.cand_cls]
                    + ring.propagation_time(self.cand_hops)[None, :])
            seg_max[:, nonempty] = np.maximum.reduceat(
                cand, self.cand_ptr[:-1][nonempty], axis=1
            )
        return seg_max[:, self.step_seg]

    def lockstep(self, ring: Ring, d_bits,
                 keep_per_step: bool = True) -> "BatchedTimes":
        """Batched :func:`simulator.simulate_steps` (same accumulation order)."""
        d = np.atleast_1d(np.asarray(d_bits, dtype=np.float64))
        step_max = self._step_maxes(ring, d)
        a = ring.reconfig_delay_s
        ser = np.zeros(d.size)
        for s in range(self.num_steps):   # sequential, like the scalar engine
            ser += step_max[:, s]
        return BatchedTimes(
            n=self.n, steps=self.num_steps,
            max_wavelengths=self.max_wavelengths, timing="lockstep",
            d_bits=d, serialization_s=ser,
            reconfig_s=np.full(d.size, self.num_steps * a),
            per_step_s=step_max + a if keep_per_step else None,
        )

    def _step_empty(self) -> np.ndarray:
        empty_seg = self.seg_ptr[:-1] == self.seg_ptr[1:]
        return empty_seg[self.step_seg]

    def _event_barrier(self, ring: Ring, d: np.ndarray,
                       keep_per_step: bool = True) -> "BatchedTimes":
        """Barrier-mode event engine, derived from the per-step maxes.

        Under a global step barrier every transfer of step ``s`` starts at
        ``t_{s-1} + a`` and the step's makespan delta is its slowest receive
        — the same quantity the lock-step engine maxes over — so the whole
        ``[D, n]`` readiness recurrence collapses to a scalar-per-payload
        recurrence replaying the per-point engine's exact additions
        (``t = (t + a) + max_rx``; ``per_step = t_new - t_old``).
        """
        step_max = self._step_maxes(ring, d)
        a = ring.reconfig_delay_s
        empty = self._step_empty()
        ser = np.zeros(d.size)
        t = np.zeros(d.size)
        per_step = (np.empty((d.size, self.num_steps))
                    if keep_per_step else None)
        for s in range(self.num_steps):
            if empty[s]:
                t = t + a
                if keep_per_step:
                    per_step[:, s] = a
                continue
            nt = (t + a) + step_max[:, s]
            if keep_per_step:
                per_step[:, s] = nt - t
            t = nt
            ser += step_max[:, s]
        return BatchedTimes(
            n=self.n, steps=self.num_steps,
            max_wavelengths=self.max_wavelengths, timing="event",
            d_bits=d, serialization_s=ser,
            reconfig_s=np.full(d.size, self.num_steps * a),
            per_step_s=per_step,
        )

    def event(self, ring: Ring, d_bits, overlap: bool = False,
              keep_per_step: bool = True) -> "BatchedTimes":
        """Batched :func:`simulator.simulate_steps_event`.

        Barrier mode short-circuits through :meth:`_event_barrier` (exact).
        Overlap mode runs the per-node readiness recurrence over ``[D, n]``
        arrays; per-segment serialization/receive grids are computed once
        and reused across the steps sharing a ``TransferBatch``.
        ``keep_per_step=False`` skips the per-step makespan tracking (one
        ``[D, n]`` max per step) when only totals are needed.
        """
        d = np.atleast_1d(np.asarray(d_bits, dtype=np.float64))
        if not overlap:
            return self._event_barrier(ring, d, keep_per_step)
        self._ensure_scatters()
        D = d.size
        a = ring.reconfig_delay_s
        # node-major [n, D] state: all per-step gathers/scatters hit axis 0
        ser_cT = np.ascontiguousarray(self._class_ser(ring, d).T)  # [K, D]
        prop = ring.propagation_time(self.hops)
        ready = np.zeros((self.n, D))
        ser = np.zeros(D)
        per_step = np.empty((D, self.num_steps)) if keep_per_step else None
        t_prev = np.zeros(D)
        seg_cache: dict[int, tuple] = {}
        for s in range(self.num_steps):
            seg = int(self.step_seg[s])
            lo, hi = int(self.seg_ptr[seg]), int(self.seg_ptr[seg + 1])
            if lo == hi:
                # an empty step still retunes every node's MRRs: the clock
                # advances by the reconfiguration delay (see the matching
                # branch in simulate_steps_event)
                ready += a
                t_prev += a
                if keep_per_step:
                    per_step[:, s] = a
                continue
            cached = seg_cache.get(seg)
            if cached is None:
                tx = ser_cT[self.cls[lo:hi]]                # [T_s, D]
                rx = tx + prop[lo:hi][:, None]
                cached = (self.src[lo:hi], self.dst[lo:hi], tx, rx,
                          rx.max(axis=0),
                          np.empty_like(tx), np.empty_like(tx),
                          np.empty_like(tx))
                seg_cache[seg] = cached
            src, dst, tx, rx, rx_max, b_start, b_vals, b_gather = cached
            # allocation-free steady state: start = max(ready@src, ready@dst)+a
            # (mode="clip" for the unbuffered take() path; ids never clip)
            np.take(ready, src, axis=0, out=b_start, mode="clip")
            np.take(ready, dst, axis=0, out=b_vals, mode="clip")
            np.maximum(b_start, b_vals, out=b_start)
            b_start += a
            np.add(b_start, tx, out=b_vals)
            self.scatter_src[seg].apply(ready, b_vals, b_gather)
            np.add(b_start, rx, out=b_vals)
            self.scatter_dst[seg].apply(ready, b_vals, b_gather)
            if keep_per_step:
                t = ready.max(axis=0)
                per_step[:, s] = t - t_prev
                t_prev = t
            ser += rx_max
        reconfig = np.full(D, self.num_steps * a)
        # Clamp audit (DESIGN.md §13): the cap is the lockstep total of
        # THIS step sequence — for a composed schedule that is the fused
        # timeline's barrier execution (Σ fused-step maxes + S·a), which is
        # always an admissible execution of the composition, NOT the sum of
        # the constituents' per-schedule lockstep totals.  Cross-schedule
        # overlap (B's reconfiguration hiding under A's communication)
        # lives inside each fused step and is therefore never clamped
        # away; by induction per-node readiness can only exceed the
        # barrier clock through FP accumulation noise, which is all the
        # min() removes (regression: tests/test_compose.py).
        event_total = np.minimum(ready.max(axis=0), ser + self.num_steps * a)
        return BatchedTimes(
            n=self.n, steps=self.num_steps,
            max_wavelengths=self.max_wavelengths, timing="overlap",
            d_bits=d, serialization_s=ser, reconfig_s=reconfig,
            event_total_s=event_total, per_step_s=per_step,
        )

    def evaluate(self, ring: Ring, d_bits, timing: str = "lockstep",
                 keep_per_step: bool = True) -> "BatchedTimes":
        if timing == "lockstep":
            return self.lockstep(ring, d_bits, keep_per_step)
        if timing in ("event", "overlap"):
            return self.event(ring, d_bits, overlap=timing == "overlap",
                              keep_per_step=keep_per_step)
        raise ValueError(f"unknown timing {timing!r} "
                         "(expected 'lockstep', 'event' or 'overlap')")


@dataclass(frozen=True)
class BatchedTimes:
    """One schedule timed over a payload grid (the batched ``SimResult``)."""

    n: int
    steps: int
    max_wavelengths: int
    timing: str
    d_bits: np.ndarray                 # [D]
    serialization_s: np.ndarray        # [D]
    reconfig_s: np.ndarray             # [D] (constant across D)
    event_total_s: np.ndarray | None = None   # overlap only
    per_step_s: np.ndarray | None = None      # [D, S]; None for analytic paths
    algorithm: str = ""

    @property
    def total_s(self) -> np.ndarray:
        if self.event_total_s is not None:
            return self.event_total_s
        return self.serialization_s + self.reconfig_s

    def sim_result(self, i: int = 0) -> simulator.SimResult:
        """Materialize payload ``i`` as a per-point ``SimResult``."""
        return simulator.SimResult(
            algorithm=self.algorithm,
            n=self.n,
            d_bits=float(self.d_bits[i]),
            steps=self.steps,
            serialization_s=float(self.serialization_s[i]),
            reconfig_s=float(self.reconfig_s[i]),
            max_wavelengths=self.max_wavelengths,
            per_step_s=([] if self.per_step_s is None
                        else [float(x) for x in self.per_step_s[i]]),
            timing=self.timing,
            event_total_s=(None if self.event_total_s is None
                           else float(self.event_total_s[i])),
        )


def _with_meta(times: BatchedTimes, algorithm: str, **overrides) -> BatchedTimes:
    """Attach front-end metadata (algorithm label, timing-string quirks)."""
    return replace(times, algorithm=algorithm, **overrides)


# ---------------------------------------------------------------------------
# Profile (de)serialization — the plan cache's disk tier (DESIGN.md §10).
# ---------------------------------------------------------------------------

_PROFILE_ARRAYS = ("step_seg", "seg_ptr", "src", "dst", "hops", "cls",
                   "cand_ptr", "cand_cls", "cand_hops")


def profile_to_arrays(prof: ScheduleProfile) -> tuple[dict, dict[str, np.ndarray]]:
    """Split a compiled profile into JSON-able metadata + stacked arrays."""
    meta = {
        "n": prof.n,
        "num_steps": prof.num_steps,
        "max_wavelengths": prof.max_wavelengths,
        "classes": [list(c.divisors) for c in prof.classes],
        "class_widths": [c.width_bits for c in prof.classes],
    }
    return meta, {name: getattr(prof, name) for name in _PROFILE_ARRAYS}


def profile_from_arrays(meta: dict, arrays: dict) -> ScheduleProfile:
    """Rebuild a profile from :func:`profile_to_arrays` output.

    The endpoint scatter groupings are recomputed from the stored ``src``/
    ``dst`` columns — they are a pure function of them, so the round-trip
    is exact (pinned by ``tests/test_plan_cache.py``).
    """
    prof = ScheduleProfile()
    prof.n = int(meta["n"])
    prof.num_steps = int(meta["num_steps"])
    prof.max_wavelengths = int(meta["max_wavelengths"])
    widths = meta.get("class_widths") or [32.0] * len(meta["classes"])
    prof.classes = tuple(PayloadClass(tuple(d), float(w))
                         for d, w in zip(meta["classes"], widths))
    for name in _PROFILE_ARRAYS:
        setattr(prof, name, np.asarray(arrays[name]))
    prof.scatter_src = None   # lazy, like from_steps (_ensure_scatters)
    prof.scatter_dst = None
    return prof


# ---------------------------------------------------------------------------
# Profile cache + per-algorithm front-ends (bit-identical to run_optical).
# ---------------------------------------------------------------------------

def _ring_of(n: int, p: step_models.OpticalParams) -> Ring:
    return Ring(n, p.wavelengths, bandwidth_bps=p.bandwidth_bps,
                reconfig_delay_s=p.reconfig_delay_s, physical=p.physical)


def _collective_profile(
    collective: str, n: int, p: step_models.OpticalParams, m: int | None,
    allow_alltoall: bool = True, max_hops: int | None = None,
    failures: FailureMask | None = None, depth: int = 1, bits: int = 32,
) -> ScheduleProfile:
    """Any scheduled collective's profile via the two-tier plan cache
    (DESIGN.md §10, §11).

    The cache key is the d-independent structure ``(collective, n, w, m,
    alltoall, max_hops, rwa, depth, bits)`` — deliberately *not* the whole
    ``OpticalParams``: bandwidth/reconfiguration only enter at evaluation
    time, so every parameter flavour shares one compiled profile.  ``(m,
    alltoall)`` are normalized per collective so keys never fragment on
    axes the collective does not have.  ``depth>1`` yields the composed
    pipeline's profile (DESIGN.md §13); ``bits<32`` a width-scaled
    compressed profile (DESIGN.md §15).
    """
    from . import plan_cache

    collective = wrht.coerce_collective(collective)
    m, allow_alltoall = wrht.collective_plan_fields(collective, m,
                                                    allow_alltoall)
    ring = _ring_of(n, p)
    hops = ring.max_hops if max_hops is None else max_hops
    return plan_cache.get_default().profile(plan_cache.PlanKey(
        n=n, w=p.wavelengths, m=m, alltoall=allow_alltoall, max_hops=hops,
        collective=collective, failures=failures, depth=depth, bits=bits))


def _wrht_profile(
    n: int, p: step_models.OpticalParams, m: int | None,
    allow_alltoall: bool = True, max_hops: int | None = None,
    failures: FailureMask | None = None,
) -> ScheduleProfile:
    """The all-reduce view of :func:`_collective_profile` (historical name)."""
    return _collective_profile("allreduce", n, p, m, allow_alltoall, max_hops,
                               failures)


@functools.lru_cache(maxsize=256)
def _bt_profile(n: int, p: step_models.OpticalParams) -> ScheduleProfile:
    ring = _ring_of(n, p)
    steps = simulator.bt_allreduce_schedule(n, 1.0)
    return ScheduleProfile.from_steps(steps, ring)  # validates (may raise)


@functools.lru_cache(maxsize=256)
def _ring_step_profile(n: int, p: step_models.OpticalParams) -> ScheduleProfile:
    ring = _ring_of(n, p)
    # the one neighbour-pattern template step (run_optical builds the same
    # batch; no need to materialize all 2(N-1) identical Step objects)
    src = np.arange(n)
    step = wrht.Step("ring", 0, TransferBatch.from_arrays(
        src, (src + 1) % n, CW, 1.0 / n, wavelength=0, check=False
    ))
    return ScheduleProfile.from_steps(
        [step], ring, classes=(PayloadClass((n,)),)
    )


@functools.lru_cache(maxsize=256)
def _hring_profile(n: int, g: int, p: step_models.OpticalParams) -> ScheduleProfile:
    ring = _ring_of(n, p)
    steps = simulator.hring_allreduce_schedule(n, g, 1.0)
    n_groups = n // g
    return ScheduleProfile.from_steps(
        steps, ring,
        classes=(PayloadClass((g,)), PayloadClass((g, n_groups))),
    )


@functools.lru_cache(maxsize=256)
def _hring_intra_profile(g: int, p: step_models.OpticalParams) -> ScheduleProfile:
    """The 2g-node intra-step template of run_optical's analytic H-Ring path."""
    template = simulator.hring_allreduce_schedule(2 * g, g, 1.0)[0]
    ring = _ring_of(2 * g, p)
    return ScheduleProfile.from_steps(
        [template], ring, classes=(PayloadClass((g,)),)
    )


def wrht_times(
    n: int, d_bits, p: step_models.OpticalParams, timing: str = "lockstep",
    m: int | None = None, allow_alltoall: bool = True,
    max_hops: int | None = None, keep_per_step: bool = True,
    failures: FailureMask | None = None,
) -> BatchedTimes:
    ring = _ring_of(n, p)
    prof = _wrht_profile(n, p, m, allow_alltoall, max_hops, failures)
    return _with_meta(prof.evaluate(ring, d_bits, timing, keep_per_step),
                      "wrht")


def collective_times(
    collective: str, n: int, d_bits, p: step_models.OpticalParams | None = None,
    timing: str = "lockstep", m: int | None = None,
    allow_alltoall: bool = True, max_hops: int | None = None,
    keep_per_step: bool = True, failures: FailureMask | None = None,
    depth: int = 1, bits: int = 32,
) -> BatchedTimes:
    """Batched timing of any scheduled collective over a payload grid
    (DESIGN.md §11): the profile comes from the plan cache (one compile per
    d-independent structure), the grid evaluates through the same three
    engines as all-reduce, and every number is bit-identical to the
    per-point :func:`repro.core.simulator.run_collective`.

    ``depth>1`` times the composed depth-k pipeline of the collective
    (alternating with its partner phase — RS↔AG — DESIGN.md §13); the
    total then covers all ``depth`` concurrent phases at payload ``d``
    *each*, to be compared against the sum of the constituents' serial
    totals.

    ``bits<32`` times the compressed schedule: ``d_bits`` stays the
    *logical* fp32 payload and the profile's width-scaled classes shrink
    the β-term by exactly ``bits/32`` (DESIGN.md §15 — the quantize compute
    overhead is the planner's, not the wire model's).

    Infeasible collectives raise like the builders do — a single-step
    all-to-all beyond the wavelength or hop budget is an error here, not a
    silently worse schedule.
    """
    collective = wrht.coerce_collective(collective)
    p = p or step_models.OpticalParams()
    ring = _ring_of(n, p)
    prof = _collective_profile(collective, n, p, m, allow_alltoall, max_hops,
                               failures, depth=depth, bits=bits)
    label = collective if depth == 1 else f"{collective}:pipe{depth}"
    return _with_meta(prof.evaluate(ring, d_bits, timing, keep_per_step),
                      label)


def bt_times(n: int, d_bits, p: step_models.OpticalParams,
             timing: str = "lockstep", keep_per_step: bool = True) -> BatchedTimes:
    ring = _ring_of(n, p)
    return _with_meta(
        _bt_profile(n, p).evaluate(ring, d_bits, timing, keep_per_step), "bt")


def ring_times(n: int, d_bits, p: step_models.OpticalParams,
               timing: str = "lockstep") -> BatchedTimes:
    """Flat ring, replicating run_optical's scale-one-step shortcut: all
    2(N-1) steps are the identical neighbour pattern, so every engine times
    one representative step and multiplies (exact — constant d/N payload)."""
    ring = _ring_of(n, p)
    one = _ring_step_profile(n, p).lockstep(ring, d_bits)
    k = 2 * (n - 1)
    return BatchedTimes(
        n=n, steps=k, max_wavelengths=one.max_wavelengths,
        timing=timing, d_bits=one.d_bits,
        serialization_s=one.serialization_s * k,
        reconfig_s=np.full(one.d_bits.size, k * ring.reconfig_delay_s),
        algorithm="ring",
    )


def hring_times(n: int, d_bits, p: step_models.OpticalParams,
                timing: str = "lockstep", g: int = 8,
                keep_per_step: bool = True) -> BatchedTimes:
    ring = _ring_of(n, p)
    g = simulator.hring_group_size(n, g)
    if g < 2:
        # prime (or tiny) N: flat-ring fallback under the hring label
        return _with_meta(ring_times(n, d_bits, p, timing), "hring")
    simulator.check_hring_span(ring, n, g)
    if timing != "lockstep":
        prof = _hring_profile(n, g, p)
        return _with_meta(prof.evaluate(ring, d_bits, timing, keep_per_step),
                          "hring")
    # analytic lock-step decomposition (identical to run_optical): time the
    # 2g-node intra template, close-form the inter-group ring
    d = np.atleast_1d(np.asarray(d_bits, dtype=np.float64))
    intra_ring = _ring_of(2 * g, p)
    intra_ser = _hring_intra_profile(g, p)._step_maxes(intra_ring, d)[:, 0]
    n_groups = n // g
    intra_steps = 2 * (g - 1)
    inter_steps = 2 * (n_groups - 1)
    inter_ser = ring.serialization_time_array((d / g) / n_groups)
    if ring.physical is not None:
        inter_ser = inter_ser + float(ring.propagation_time(np.asarray([g]))[0])
    total_steps = intra_steps + inter_steps
    ser = intra_steps * intra_ser + inter_steps * inter_ser
    return BatchedTimes(
        n=n, steps=total_steps, max_wavelengths=1, timing="lockstep",
        d_bits=d, serialization_s=ser,
        reconfig_s=np.full(d.size, total_steps * ring.reconfig_delay_s),
        algorithm="hring",
    )


_ALGORITHMS = ("wrht", "ring", "bt", "hring")


def algorithm_times(
    algorithm: str, n: int, d_bits, p: step_models.OpticalParams,
    timing: str = "lockstep", g: int = 8, m: int | None = None,
    keep_per_step: bool = True,
) -> BatchedTimes:
    """Batched counterpart of ``run_optical`` for one ``(algorithm, n)``."""
    if algorithm == "wrht":
        return wrht_times(n, d_bits, p, timing, m=m,
                          keep_per_step=keep_per_step)
    if algorithm == "ring":
        return ring_times(n, d_bits, p, timing)
    if algorithm == "bt":
        return bt_times(n, d_bits, p, timing, keep_per_step=keep_per_step)
    if algorithm == "hring":
        return hring_times(n, d_bits, p, timing, g=g,
                           keep_per_step=keep_per_step)
    raise ValueError(f"unknown optical algorithm {algorithm!r}")


# ---------------------------------------------------------------------------
# Grid front-end.
# ---------------------------------------------------------------------------

@dataclass
class GridResult:
    """``algorithms × ns × d_bits × timings`` evaluation of the optical ring.

    ``total_s``/``serialization_s``/``reconfig_s``/``event_total_s`` are
    ``[A, N, T, D]`` float arrays (NaN on infeasible cells);
    ``steps``/``max_wavelengths``/``feasible`` are per-``(A, N)``.
    ``errors`` maps ``(algorithm, n)`` to the infeasibility message (e.g.
    the binary tree's fixed lightpaths exceeding the hop budget).
    """

    algorithms: tuple[str, ...]
    ns: tuple[int, ...]
    d_bits: np.ndarray
    timings: tuple[str, ...]
    total_s: np.ndarray
    serialization_s: np.ndarray
    reconfig_s: np.ndarray
    event_total_s: np.ndarray
    steps: np.ndarray
    max_wavelengths: np.ndarray
    feasible: np.ndarray
    errors: dict = field(default_factory=dict)
    _cells: dict = field(default_factory=dict, repr=False)

    def _index(self, algorithm: str, n: int, timing: str) -> tuple[int, int, int]:
        return (self.algorithms.index(algorithm), self.ns.index(n),
                self.timings.index(timing))

    def cell(self, algorithm: str, n: int, timing: str) -> BatchedTimes | None:
        """The full batched record for one ``(algorithm, n, timing)`` cell
        (None when the cell is infeasible)."""
        return self._cells.get((algorithm, n, timing))

    def total(self, algorithm: str, n: int, timing: str) -> np.ndarray:
        a, i, t = self._index(algorithm, n, timing)
        return self.total_s[a, i, t]

    def is_feasible(self, algorithm: str, n: int) -> bool:
        return bool(self.feasible[self.algorithms.index(algorithm),
                                  self.ns.index(n)])

    def sim_result(self, algorithm: str, n: int, d: float,
                   timing: str) -> simulator.SimResult:
        times = self.cell(algorithm, n, timing)
        if times is None:
            raise InsertionLossError(self.errors[(algorithm, n)])
        matches = np.flatnonzero(self.d_bits == d)
        if matches.size == 0:
            raise KeyError(f"payload {d!r} is not on this grid's d_bits axis")
        return times.sim_result(int(matches[0]))


def evaluate_grid(
    algorithms=_ALGORITHMS,
    ns=(64,),
    d_bits=(1e6,),
    timings=("lockstep",),
    p: step_models.OpticalParams | None = None,
    g: int = 8,
    m: int | None = None,
    keep_per_step: bool = True,
) -> GridResult:
    """Evaluate the whole parameter grid through the batched engine.

    Schedules and compiled profiles are cached across grid points (and
    across calls), so the marginal cost of an extra payload size or timing
    mode is a broadcasted array pass, not a schedule walk.  Per-cell numbers
    are bit-identical to calling :func:`simulator.run_optical` point-wise;
    physically infeasible cells (``InsertionLossError``) are recorded in
    ``feasible``/``errors`` instead of raising.
    """
    p = p or step_models.OpticalParams()
    algorithms = tuple(algorithms)
    ns = tuple(int(n) for n in ns)
    timings = tuple(timings)
    d = np.atleast_1d(np.asarray(list(d_bits), dtype=np.float64))
    A, N, T, D = len(algorithms), len(ns), len(timings), d.size
    shape = (A, N, T, D)
    out = GridResult(
        algorithms=algorithms, ns=ns, d_bits=d, timings=timings,
        total_s=np.full(shape, np.nan),
        serialization_s=np.full(shape, np.nan),
        reconfig_s=np.full(shape, np.nan),
        event_total_s=np.full(shape, np.nan),
        steps=np.zeros((A, N), dtype=np.int64),
        max_wavelengths=np.zeros((A, N), dtype=np.int64),
        feasible=np.ones((A, N), dtype=bool),
    )
    for ai, alg in enumerate(algorithms):
        for ni, n in enumerate(ns):
            try:
                for ti, timing in enumerate(timings):
                    times = algorithm_times(alg, n, d, p, timing, g=g, m=m,
                                            keep_per_step=keep_per_step)
                    out._cells[(alg, n, timing)] = times
                    out.total_s[ai, ni, ti] = times.total_s
                    out.serialization_s[ai, ni, ti] = times.serialization_s
                    out.reconfig_s[ai, ni, ti] = times.reconfig_s
                    if times.event_total_s is not None:
                        out.event_total_s[ai, ni, ti] = times.event_total_s
                    out.steps[ai, ni] = times.steps
                    out.max_wavelengths[ai, ni] = times.max_wavelengths
            except InsertionLossError as e:
                # only the physical power budget marks a cell infeasible;
                # anything else (e.g. a wavelength conflict from a builder
                # regression) propagates loudly, like the per-point path
                out.feasible[ai, ni] = False
                out.errors[(alg, n)] = str(e)
    return out


# ---------------------------------------------------------------------------
# Simulator-backed WRHT auto-tuner.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TuneResult:
    """Outcome of a fan-out sweep through the batched simulator.

    ``total_s[c, i]`` is candidate ``c`` at payload ``i``; ``best_*`` are the
    per-payload argmins (ties broken toward the earlier candidate — smaller
    ``m``, all-to-all first — matching a brute-force first-argmin scan).
    ``analytic_m`` is what the closed-form rule (Lemma 1 capped by the
    insertion-loss fan-out limit) would have picked, for comparison.
    """

    n: int
    w: int
    max_hops: int | None
    timing: str
    d_bits: np.ndarray                       # [D]
    candidates: tuple[tuple[int, bool], ...]  # (m, alltoall) per row
    total_s: np.ndarray                      # [C, D]
    steps: np.ndarray                        # [C]
    best_m: np.ndarray                       # [D]
    best_alltoall: np.ndarray                # [D] bool
    best_total_s: np.ndarray                 # [D]
    analytic_m: int

    def best(self, i: int = 0) -> tuple[int, bool]:
        return int(self.best_m[i]), bool(self.best_alltoall[i])


def _tune_candidates(n, w, d_bits, max_hops, p, m_candidates, failures=None):
    """Shared candidate-sweep preamble of the two tuner implementations."""
    p = p or step_models.OpticalParams(wavelengths=w)
    if p.wavelengths != w:
        p = replace(p, wavelengths=w)
    if max_hops is None:
        max_hops = p.physical.max_hops if p.physical is not None else None
    analytic_m = wrht.feasible_group_size(w, max_hops, failures=failures)
    # every m >= n yields the identical single-group schedule, so cap the
    # sweep at n — smaller m wins argmin ties anyway, and this keeps small
    # rings from building hundreds of duplicate candidates
    m_cap = min(analytic_m, n)
    if m_candidates is None:
        m_candidates = range(2, m_cap + 1)
    ms = sorted({int(m) for m in m_candidates
                 if 2 <= int(m) <= m_cap})
    if not ms:
        raise ValueError("no feasible WRHT fan-out candidates")
    d = np.atleast_1d(np.asarray(d_bits, dtype=np.float64))
    return p, max_hops, analytic_m, ms, d


def _tune_result(n, w, max_hops, timing, d, candidates, totals, steps,
                 analytic_m) -> TuneResult:
    total_s = np.stack(totals, axis=0)              # [C, D]
    best = np.argmin(total_s, axis=0)               # first argmin per payload
    cand_m = np.array([c[0] for c in candidates])
    cand_a2a = np.array([c[1] for c in candidates])
    return TuneResult(
        n=n, w=w, max_hops=max_hops, timing=timing, d_bits=d,
        candidates=tuple(candidates), total_s=total_s,
        steps=np.asarray(steps, dtype=np.int64),
        best_m=cand_m[best], best_alltoall=cand_a2a[best],
        best_total_s=total_s[best, np.arange(d.size)],
        analytic_m=analytic_m,
    )


@functools.lru_cache(maxsize=64)
def _candidate_schedules(n: int, w: int, ms: tuple[int, ...],
                         max_hops: int | None,
                         collective: str = "allreduce",
                         failures: FailureMask | None = None):
    """Memoized batched candidate build — the tuner's repeat calls (one per
    ``plan_buckets`` invocation, one per ``run_optical(m="auto")`` point)
    share one construction per sweep signature.  ``FailureMask`` is frozen
    and hashable, so degraded sweeps memoize per-mask like any other axis."""
    return wrht.build_candidate_schedules(
        n, w, 1.0, ms, allow_alltoall=True, validate=False,
        max_hops=max_hops, collective=collective, failures=failures)


def tune_wrht(
    n: int,
    w: int,
    d_bits,
    max_hops: int | None = None,
    p: step_models.OpticalParams | None = None,
    timing: str = "lockstep",
    m_candidates=None,
    collective: str = "allreduce",
    failures: FailureMask | None = None,
    bits: int = 32,
) -> TuneResult:
    """Sweep every feasible WRHT fan-out ``m`` (and the final all-to-all
    on/off) through the batched simulator; return the simulated argmin.

    The analytic rule picks ``m = 2w + 1`` capped by the insertion-loss
    fan-out limit; the simulator-backed sweep also sees relay sub-steps,
    all-to-all feasibility and (under a physical model) per-hop propagation,
    so its argmin can differ — ``benchmarks/bench_sweep.py`` records the
    comparison.

    All candidate schedules come from one pass of the batched
    multi-candidate builder (``wrht.build_candidate_schedules``,
    DESIGN.md §10) — bit-identical to the per-candidate loop, which is kept
    as :func:`tune_wrht_reference` (the golden oracle;
    ``benchmarks/bench_planner.py`` records the ≥5× speedup).  Compiled
    profiles are published to the plan cache keyed on the d-independent
    structure, so the sweep's winner — and every loser — is a warm plan for
    ``run_optical(m="auto")`` and ``planner.plan_buckets``.  The batched
    construction skips the per-step re-validation (it is conflict-free by
    construction and golden-tested); materializing a schedule through the
    plan cache re-validates it fully.

    ``collective`` widens the sweep beyond all-reduce to the other
    fan-out-swept collective, ``"broadcast"`` (DESIGN.md §11) — its
    candidates have no all-to-all variant, so every row is ``(m, False)``.

    ``failures`` re-tunes under a degraded ring (DESIGN.md §12): the
    candidate pool shrinks to what the degraded builder can route, relay
    sub-steps change every candidate's cost, and the argmin can move —
    which is exactly why a mid-run failure re-plans instead of reusing the
    healthy winner.  Raises ``wrht.DegradedInfeasibleError`` when no
    candidate survives the mask.

    ``bits<32`` tunes the compressed schedule (DESIGN.md §15): candidate
    structure is width-independent (one batched build serves every width),
    but each candidate evaluates with width-scaled payload classes and the
    compiled profiles publish under ``bits``-stamped keys — the argmin can
    move because the α/β balance shifts when the wire shrinks.
    """
    from . import plan_cache

    collective = wrht.coerce_collective(collective)
    if not wrht.COLLECTIVES[collective].tree:
        raise ValueError(
            f"collective {collective!r} has no fan-out axis to tune — "
            "evaluate it directly with collective_times"
        )
    if failures is not None and failures.empty:
        failures = None
    p, max_hops, analytic_m, ms, d = _tune_candidates(
        n, w, d_bits, max_hops, p, m_candidates, failures)
    ring = _ring_of(n, p)
    hops = ring.max_hops if max_hops is None else max_hops
    scheds = _candidate_schedules(n, p.wavelengths, tuple(ms), hops,
                                  collective, failures)
    variants = (True, False) if collective == "allreduce" else (False,)
    cache = plan_cache.get_default()
    seg_cache: dict = {}
    candidates: list[tuple[int, bool]] = []
    totals, steps = [], []
    for m in ms:
        for alltoall in variants:
            sched = scheds.get((m, alltoall))
            if sched is None:
                continue  # the a2a=True build never took the all-to-all:
                          # both schedules are identical, evaluate once
            key = plan_cache.PlanKey(n=n, w=p.wavelengths, m=m,
                                     alltoall=alltoall, max_hops=hops,
                                     collective=collective,
                                     failures=failures, bits=bits)
            prof = cache.peek_profile(key)   # memory, then disk tier
            if prof is None:
                classes = ((FULL_VECTOR,) if bits == 32
                           else (PayloadClass((), float(bits)),))
                prof = ScheduleProfile.from_steps(
                    sched.steps, ring, validate=False, seg_cache=seg_cache,
                    classes=classes)
                cache.put_profile(key, prof)
            times = prof.evaluate(ring, d, timing, keep_per_step=False)
            candidates.append((m, alltoall))
            totals.append(times.total_s)
            steps.append(times.steps)
    return _tune_result(n, w, max_hops, timing, d, candidates, totals, steps,
                        analytic_m)


def tune_wrht_reference(
    n: int,
    w: int,
    d_bits,
    max_hops: int | None = None,
    p: step_models.OpticalParams | None = None,
    timing: str = "lockstep",
    m_candidates=None,
) -> TuneResult:
    """The original per-candidate tuner loop, kept verbatim as the golden
    oracle for :func:`tune_wrht`: one full ``build_schedule`` + compile per
    ``(m, alltoall)`` candidate.  Bit-identical results (argmin and totals)
    are asserted by ``tests/test_amortized_planning.py`` and recorded by
    ``benchmarks/bench_planner.py``."""
    p, max_hops, analytic_m, ms, d = _tune_candidates(
        n, w, d_bits, max_hops, p, m_candidates)
    ring = _ring_of(n, p)
    hops = ring.max_hops if max_hops is None else max_hops
    candidates: list[tuple[int, bool]] = []
    totals, steps = [], []
    for m in ms:
        with_a2a = simulator._cached_wrht_schedule(n, p.wavelengths, m, hops,
                                                   True)
        took_a2a = any(s.kind == "alltoall" for s in with_a2a.steps)
        for alltoall in (True, False):
            if not alltoall and not took_a2a:
                continue
            prof = _wrht_profile(n, p, m, alltoall, max_hops)
            times = prof.evaluate(ring, d, timing, keep_per_step=False)
            candidates.append((m, alltoall))
            totals.append(times.total_s)
            steps.append(times.steps)
    return _tune_result(n, w, max_hops, timing, d, candidates, totals, steps,
                        analytic_m)


def clear_caches() -> None:
    """Drop all compiled profiles and candidate sweeps, and install a fresh
    *memory-only* default plan cache (benchmarks and tests use this for fair
    cold timing — a ``REPRO_PLAN_CACHE_DIR`` disk tier would otherwise turn
    "cold" lookups into disk hits).  Long-lived processes that only want to
    shed memory should call ``plan_cache.get_default().clear()`` instead,
    which keeps their disk tier attached."""
    from . import plan_cache

    for fn in (_bt_profile, _ring_step_profile,
               _hring_profile, _hring_intra_profile, _candidate_schedules):
        fn.cache_clear()
    plan_cache.set_default(plan_cache.PlanCache())
