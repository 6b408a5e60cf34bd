"""Optical ring topology model (TeraRack-style).

The physical substrate of the paper: ``N`` nodes on a bidirectional WDM ring.
Each direction is an independent fiber ring carrying ``w`` wavelengths; a
directed transfer from ``src`` to ``dst`` occupies every unit *segment*
(i, i+1 mod N) (clockwise) or (i, i-1 mod N) (counter-clockwise) along its
path, on one wavelength.  Two transfers conflict iff they share a directed
segment *and* a wavelength.

This module is pure Python/NumPy — it backs the schedule builder, the RWA
(routing and wavelength assignment) pass and the optical simulator.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Iterable, Iterator

import numpy as np

CW = +1   # clockwise
CCW = -1  # counter-clockwise


def _canonical_pairs(pairs) -> tuple[tuple[int, int], ...]:
    """Sorted, deduplicated ``(int, int)`` tuples — one canonical form per
    logical set, so equal masks hash and fingerprint identically."""
    return tuple(sorted({(int(a), int(b)) for a, b in pairs}))


@dataclass(frozen=True)
class FailureMask:
    """Which optical resources of the ring are dead (DESIGN.md §12).

    Three independent failure classes, each a canonical sorted tuple so the
    mask is hashable (plan-cache keys carry it directly) and two masks
    describing the same failures compare — and fingerprint — equal:

    ``dead_segments``      ``(lane, segment)`` pairs: the directed fiber
                           span is cut.  Lane 0 is the CW fiber, lane 1 the
                           CCW fiber (the :meth:`TransferBatch.arcs`
                           convention); segment ids are the ones
                           :func:`path_segments` yields.  No lightpath on
                           that lane may cover the segment.
    ``dead_wavelengths``   ``(node, λ)`` pairs: the node's MRR add/drop bank
                           for wavelength λ is dead, so no transfer may be
                           *added or dropped* at that node on λ (transfers
                           passing through optically are unaffected).
    ``dead_transceivers``  ``(node, lane)`` pairs: the node's Tx/Rx set on
                           that fiber direction is dead — it can neither
                           transmit nor receive on the lane (and cannot act
                           as an O/E/O relay there).

    An empty mask is semantically "healthy" everywhere; builders and
    validators treat ``failures=None`` and an empty mask identically.
    """

    dead_segments: tuple[tuple[int, int], ...] = ()
    dead_wavelengths: tuple[tuple[int, int], ...] = ()
    dead_transceivers: tuple[tuple[int, int], ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "dead_segments",
                           _canonical_pairs(self.dead_segments))
        object.__setattr__(self, "dead_wavelengths",
                           _canonical_pairs(self.dead_wavelengths))
        object.__setattr__(self, "dead_transceivers",
                           _canonical_pairs(self.dead_transceivers))
        for lane, _ in self.dead_segments:
            if lane not in (0, 1):
                raise ValueError(f"dead segment lane must be 0/1, got {lane}")
        for _, lane in self.dead_transceivers:
            if lane not in (0, 1):
                raise ValueError(f"dead transceiver lane must be 0/1, got {lane}")

    # -------------------------------------------------- identity
    @property
    def empty(self) -> bool:
        return not (self.dead_segments or self.dead_wavelengths
                    or self.dead_transceivers)

    def fingerprint(self) -> str:
        """Canonical short hash of the mask — the plan-cache key/filename
        stamp (DESIGN.md §12).  ``"ok"`` for the healthy (empty) mask."""
        if self.empty:
            return "ok"
        payload = repr((self.dead_segments, self.dead_wavelengths,
                        self.dead_transceivers)).encode()
        return hashlib.sha256(payload).hexdigest()[:12]

    def to_lists(self) -> dict:
        """JSON-able view (plan-cache artifact metadata)."""
        return {
            "dead_segments": [list(p) for p in self.dead_segments],
            "dead_wavelengths": [list(p) for p in self.dead_wavelengths],
            "dead_transceivers": [list(p) for p in self.dead_transceivers],
        }

    @classmethod
    def from_lists(cls, d: dict) -> "FailureMask":
        return cls(
            dead_segments=tuple(map(tuple, d.get("dead_segments", ()))),
            dead_wavelengths=tuple(map(tuple, d.get("dead_wavelengths", ()))),
            dead_transceivers=tuple(map(tuple, d.get("dead_transceivers", ()))),
        )

    # -------------------------------------------------- array views
    def segment_dead(self, n: int) -> np.ndarray:
        """Bool ``[2, n]``: ``[lane, seg]`` is True iff the span is cut."""
        out = np.zeros((2, n), dtype=bool)
        for lane, seg in self.dead_segments:
            out[lane, seg % n] = True
        return out

    def transceiver_dead(self, n: int) -> np.ndarray:
        """Bool ``[n, 2]``: ``[node, lane]`` is True iff the Tx/Rx is dead."""
        out = np.zeros((n, 2), dtype=bool)
        for node, lane in self.dead_transceivers:
            out[node % n, lane] = True
        return out

    def forbidden_lambda_bits(self, n: int) -> list[int]:
        """Per-node forbidden-wavelength bitmask (arbitrary-precision Python
        ints, so ``w > 64`` works): a dead λ at a node forbids adding or
        dropping that λ there."""
        out = [0] * n
        for node, lam in self.dead_wavelengths:
            if lam >= 0:
                out[node % n] |= 1 << lam
        return out

    def max_dead_lambda_per_node(self) -> int:
        """Largest count of dead wavelengths at any single node — the
        conservative shrink applied to the Lemma-1 group size
        (:func:`repro.core.wrht.feasible_group_size`)."""
        counts: dict[int, int] = {}
        for node, _ in self.dead_wavelengths:
            counts[node] = counts.get(node, 0) + 1
        return max(counts.values(), default=0)

    def union(self, other: "FailureMask") -> "FailureMask":
        """The mask with every failure of both operands — cumulative
        degradation (DESIGN.md §14).  Canonicalization makes the result
        order-independent: ``a.union(b) == b.union(a)``."""
        return FailureMask(
            dead_segments=self.dead_segments + other.dead_segments,
            dead_wavelengths=self.dead_wavelengths + other.dead_wavelengths,
            dead_transceivers=(self.dead_transceivers
                               + other.dead_transceivers),
        )

    def covers(self, other: "FailureMask") -> bool:
        """True iff every failure of ``other`` is also in this mask — the
        nesting relation the storm harness escalates along."""
        return (set(other.dead_segments) <= set(self.dead_segments)
                and set(other.dead_wavelengths) <= set(self.dead_wavelengths)
                and (set(other.dead_transceivers)
                     <= set(self.dead_transceivers)))

    def disconnects(self, n: int) -> bool:
        """True iff the mask provably severs the ring for all-pairs traffic
        (DESIGN.md §14) — either some node lost its transceivers on *both*
        fibers (it can no longer receive at all), or the segment cuts leave
        the unit-step routing graph not strongly connected.

        Every lightpath — including the degraded builders' O/E/O detours —
        decomposes into unit segments, and a cut span blocks any lightpath
        covering it regardless of wavelengths or transceivers, so failing
        this check is a *sound* infeasibility certificate: the analytic
        planner uses it to raise the uniform
        :class:`~repro.core.wrht.DegradedInfeasibleError` instead of
        costing a fabric no schedule can use.  (Transceiver and λ failures
        other than the total-node case are deliberately NOT folded into the
        graph: pass-through traffic needs neither, so doing so would flag
        feasible rings.)
        """
        tdead = {}
        for node, lane in self.dead_transceivers:
            tdead.setdefault(node % n, set()).add(lane)
        if any(len(lanes) == 2 for lanes in tdead.values()):
            return True
        if not self.dead_segments:
            return False
        dead = self.segment_dead(n)
        cw_ok, ccw_ok = ~dead[0], ~dead[1]
        if cw_ok.all() or ccw_ok.all():
            return False  # one intact fiber ring reaches everyone
        # strong connectivity of the 2n-edge unit-step graph: node u reaches
        # u+1 over CW segment u, and u-1 over CCW segment u-1.  The ring is
        # usable iff node 0 reaches everyone and everyone reaches node 0.
        for forward in (True, False):
            seen = np.zeros(n, dtype=bool)
            seen[0] = True
            frontier = [0]
            while frontier:
                u = frontier.pop()
                cw_next = (u + 1) % n if forward else (u - 1) % n
                cw_seg = u if forward else cw_next
                if cw_ok[cw_seg] and not seen[cw_next]:
                    seen[cw_next] = True
                    frontier.append(cw_next)
                ccw_next = (u - 1) % n if forward else (u + 1) % n
                ccw_seg = ccw_next if forward else u
                if ccw_ok[ccw_seg] and not seen[ccw_next]:
                    seen[ccw_next] = True
                    frontier.append(ccw_next)
            if not seen.all():
                return True
        return False


# ---------------------------------------------------------------------------
# Transient (flapping) faults: per-resource up/down schedules over training
# steps, the ground truth the closed fault-management loop observes
# (DESIGN.md §14).
# ---------------------------------------------------------------------------

FAULT_KINDS = ("segment", "wavelength", "transceiver")


@dataclass(frozen=True)
class ResourceObservation:
    """One per-resource health sample: per-λ/per-span error or ok telemetry
    the simulator emits and the :class:`~repro.runtime.fault_tolerance.
    HealthMonitor` consumes (DESIGN.md §14).  ``ident`` follows the
    :class:`FailureMask` conventions for the kind: ``(lane, segment)`` /
    ``(node, λ)`` / ``(node, lane)``."""

    step: int
    kind: str
    ident: tuple[int, int]
    ok: bool

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown resource kind {self.kind!r} "
                             f"(expected one of {FAULT_KINDS})")
        object.__setattr__(self, "ident",
                           (int(self.ident[0]), int(self.ident[1])))


@dataclass(frozen=True)
class FlapSchedule:
    """Up/down timetable of ONE optical resource.

    Two specification forms, combinable (a step is down if either says so):

    * ``down_intervals`` — explicit half-open ``[lo, hi)`` step intervals
      (a permanent fault is ``(t, FOREVER)``, see :meth:`permanent`);
    * ``up_steps``/``down_steps``/``phase`` — periodic flapping: starting
      at ``phase`` the resource repeats ``up_steps`` healthy steps followed
      by ``down_steps`` dead ones (the flapping-λ model of DESIGN.md §14).

    ``kind``/``ident`` follow the :class:`FailureMask` conventions
    (``segment`` → ``(lane, segment)``, ``wavelength`` → ``(node, λ)``,
    ``transceiver`` → ``(node, lane)``).
    """

    kind: str
    ident: tuple[int, int]
    down_intervals: tuple[tuple[int, int], ...] = ()
    up_steps: int = 0
    down_steps: int = 0
    phase: int = 0

    FOREVER = 1 << 62

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown resource kind {self.kind!r} "
                             f"(expected one of {FAULT_KINDS})")
        object.__setattr__(self, "ident",
                           (int(self.ident[0]), int(self.ident[1])))
        object.__setattr__(
            self, "down_intervals",
            tuple(sorted((int(lo), int(hi))
                         for lo, hi in self.down_intervals)))
        for lo, hi in self.down_intervals:
            if hi <= lo:
                raise ValueError(f"empty down interval [{lo}, {hi})")
        if (self.up_steps > 0) != (self.down_steps > 0):
            raise ValueError("periodic flapping needs both up_steps and "
                             "down_steps > 0 (or neither)")
        if not self.down_intervals and not self.up_steps:
            raise ValueError("flap schedule is never down — specify "
                             "down_intervals or up_steps/down_steps")

    @classmethod
    def permanent(cls, kind: str, ident, at: int = 0) -> "FlapSchedule":
        """A hard fault: down from step ``at`` onwards, never healing."""
        return cls(kind, tuple(ident), down_intervals=((at, cls.FOREVER),))

    @classmethod
    def periodic(cls, kind: str, ident, up_steps: int, down_steps: int,
                 phase: int = 0) -> "FlapSchedule":
        """A flapping fault: ``up_steps`` healthy / ``down_steps`` dead,
        repeating from ``phase``."""
        return cls(kind, tuple(ident), up_steps=up_steps,
                   down_steps=down_steps, phase=phase)

    def is_down(self, step: int) -> bool:
        for lo, hi in self.down_intervals:
            if lo <= step < hi:
                return True
        if self.up_steps:
            period = self.up_steps + self.down_steps
            return (step - self.phase) % period >= self.up_steps
        return False

    def transitions(self, lo: int, hi: int) -> int:
        """Number of up↔down edges of this resource in steps ``(lo, hi]``."""
        return sum(self.is_down(t) != self.is_down(t - 1)
                   for t in range(lo + 1, hi + 1))


@dataclass(frozen=True)
class FaultTimeline:
    """The ground-truth fault state of a ring over training steps: a set of
    per-resource :class:`FlapSchedule` timetables (DESIGN.md §14).

    ``mask_at(step)`` materializes the instantaneous
    :class:`FailureMask`; the closed-loop tests compare the
    :class:`~repro.runtime.fault_tolerance.FaultManager`'s bounded replan
    count against :meth:`transitions` — the replans a naive
    one-per-transition policy would perform.
    """

    flaps: tuple[FlapSchedule, ...]

    def __post_init__(self) -> None:
        object.__setattr__(self, "flaps", tuple(self.flaps))
        seen = set()
        for f in self.flaps:
            if not isinstance(f, FlapSchedule):
                raise TypeError(f"FaultTimeline entries must be "
                                f"FlapSchedule, got {type(f).__name__}")
            if (f.kind, f.ident) in seen:
                raise ValueError(f"duplicate flap schedule for "
                                 f"{(f.kind, f.ident)}")
            seen.add((f.kind, f.ident))

    def mask_at(self, step: int) -> FailureMask:
        """The instantaneous failure mask at ``step`` (empty = healthy)."""
        segs, lams, txs = [], [], []
        for f in self.flaps:
            if f.is_down(step):
                {"segment": segs, "wavelength": lams,
                 "transceiver": txs}[f.kind].append(f.ident)
        return FailureMask(dead_segments=tuple(segs),
                           dead_wavelengths=tuple(lams),
                           dead_transceivers=tuple(txs))

    def transitions(self, lo: int, hi: int) -> int:
        """Total per-resource up↔down edges in steps ``(lo, hi]`` — the
        replan count of a naive one-replan-per-transition policy."""
        return sum(f.transitions(lo, hi) for f in self.flaps)


@dataclass(frozen=True)
class PhysicalParams:
    """Optical power budget of one lightpath (paper Sec. III, insertion loss;
    DESIGN.md §6 describes the layered enforcement).

    A signal leaves the laser at ``laser_power_dbm``, loses a fixed
    ``coupling_loss_db`` entering/leaving the fiber, and loses
    ``insertion_loss_db_per_hop`` at every node it passes through (each hop
    traverses one node's MRR add/drop bank).  The path is feasible iff the
    power arriving at the receiver stays at or above
    ``receiver_sensitivity_dbm``:

        laser - coupling - hops * per_hop  >=  sensitivity

    which yields the *hop budget* :attr:`max_hops` — the insertion-loss
    constraint the paper's analysis applies to WRHT group sizes (a
    representative can only drain members whose lightpaths fit the budget).
    Wavelength routing treats the budget per directed lightpath; paths longer
    than the budget must be O/E/O-regenerated at a relay node
    (:func:`repro.core.wavelength.split_overlong_arcs`).

    ``propagation_s_per_hop`` is the time of flight across one unit segment
    (~5 ns for a metre of fiber); the event-timed simulator adds it to each
    transfer's receive-side finish time, so distant receivers genuinely
    finish later than near ones.  Defaults give a 32 dB budget and a 64-hop
    reach.
    """

    laser_power_dbm: float = 10.0
    receiver_sensitivity_dbm: float = -26.0
    coupling_loss_db: float = 4.0
    insertion_loss_db_per_hop: float = 0.5
    propagation_s_per_hop: float = 5e-9

    def __post_init__(self) -> None:
        if self.insertion_loss_db_per_hop < 0:
            raise ValueError("insertion loss must be >= 0 dB/hop")
        if self.power_budget_db < self.insertion_loss_db_per_hop:
            raise ValueError(
                f"power budget {self.power_budget_db:.1f} dB cannot cover a "
                "single hop — no lightpath is feasible"
            )

    @property
    def power_budget_db(self) -> float:
        """dB available for per-hop insertion loss."""
        return (self.laser_power_dbm - self.receiver_sensitivity_dbm
                - self.coupling_loss_db)

    @property
    def max_hops(self) -> int:
        """Largest number of unit segments one lightpath may traverse."""
        if self.insertion_loss_db_per_hop == 0:
            return int(1e18)  # lossless: effectively unbounded
        return int(self.power_budget_db // self.insertion_loss_db_per_hop)

    @property
    def fan_out_cap(self) -> int:
        """Largest WRHT group size on a unit-spaced ring: the representative
        sits in the middle, so the farthest member is ``⌈(m-1)/2⌉`` hops away
        and ``m = 2·max_hops + 1`` is the limit (insertion-loss Lemma-1 cap)."""
        return 2 * self.max_hops + 1

    def feasible(self, hops) -> np.ndarray:
        """Vectorized feasibility of per-transfer hop counts."""
        return np.asarray(hops) <= self.max_hops


@dataclass(frozen=True)
class Transfer:
    """One directed optical transmission within a communication step."""

    src: int
    dst: int
    direction: int          # CW or CCW
    bits: float             # payload size in bits
    wavelength: int = -1    # assigned by RWA; -1 = unassigned

    def __post_init__(self) -> None:
        if self.direction not in (CW, CCW):
            raise ValueError(f"direction must be +1/-1, got {self.direction}")
        if self.src == self.dst:
            raise ValueError("transfer src == dst")


def ring_distance(src: int, dst: int, n: int, direction: int) -> int:
    """Number of unit segments traversed from src to dst going `direction`."""
    if direction == CW:
        return (dst - src) % n
    return (src - dst) % n


def shortest_direction(src: int, dst: int, n: int) -> int:
    """Direction with the fewest hops (ties broken clockwise)."""
    return CW if (dst - src) % n <= (src - dst) % n else CCW


def path_segments(src: int, dst: int, n: int, direction: int) -> Iterator[int]:
    """Yield directed segment ids along the path.

    Segment ``i`` on the CW ring is the fiber from node ``i`` to ``i+1``;
    on the CCW ring it is the fiber from node ``i+1`` to ``i``.  The two
    rings are physically distinct so segment ids never collide across
    directions (callers key conflicts on (direction, segment)).
    """
    hops = ring_distance(src, dst, n, direction)
    node = src
    for _ in range(hops):
        if direction == CW:
            yield node
            node = (node + 1) % n
        else:
            node = (node - 1) % n
            yield node


class TransferBatch:
    """Structure-of-arrays schedule step: the batch counterpart of ``Transfer``.

    One row per directed transmission; columns are NumPy arrays so that RWA,
    validation and data-flow simulation run as array programs instead of
    per-object Python loops.  ``wavelength`` is ``-1`` until RWA assigns it.

    The batch is treated as immutable by convention: RWA returns a new batch
    via :meth:`with_wavelengths` rather than mutating in place, so a batch may
    safely be shared between schedule steps (the flat-ring schedule reuses one
    batch for all ``2(N-1)`` identical steps).
    """

    __slots__ = ("src", "dst", "direction", "bits", "wavelength", "_arcs")

    def __init__(
        self,
        src: np.ndarray,
        dst: np.ndarray,
        direction: np.ndarray,
        bits: np.ndarray,
        wavelength: np.ndarray,
    ) -> None:
        self.src = src
        self.dst = dst
        self.direction = direction
        self.bits = bits
        self.wavelength = wavelength
        self._arcs = None  # (n, lane, start, hops) memo — see arcs()
        if not (len(src) == len(dst) == len(direction) == len(bits) == len(wavelength)):
            raise ValueError("TransferBatch columns must have equal length")

    # -------------------------------------------------- constructors
    @classmethod
    def from_arrays(
        cls,
        src,
        dst,
        direction,
        bits,
        wavelength=None,
        check: bool = True,
    ) -> "TransferBatch":
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        direction = np.broadcast_to(
            np.asarray(direction, dtype=np.int64), src.shape
        ).copy()
        bits = np.broadcast_to(np.asarray(bits, dtype=np.float64), src.shape).copy()
        if wavelength is None:
            wavelength = np.full(src.shape, -1, dtype=np.int64)
        else:
            wavelength = np.broadcast_to(
                np.asarray(wavelength, dtype=np.int64), src.shape
            ).copy()
        if check and src.size:
            if not np.isin(direction, (CW, CCW)).all():
                raise ValueError("direction must be +1/-1")
            if (src == dst).any():
                raise ValueError("transfer src == dst")
        return cls(src, dst, direction, bits, wavelength)

    @classmethod
    def from_transfers(cls, transfers: Iterable["Transfer"]) -> "TransferBatch":
        ts = list(transfers)
        return cls.from_arrays(
            [t.src for t in ts],
            [t.dst for t in ts],
            [t.direction for t in ts],
            [t.bits for t in ts],
            [t.wavelength for t in ts],
            check=False,  # Transfer.__post_init__ already validated each row
        )

    @classmethod
    def empty(cls) -> "TransferBatch":
        return cls.from_arrays([], [], [], [], check=False)

    @classmethod
    def coerce(cls, transfers) -> "TransferBatch":
        if isinstance(transfers, cls):
            return transfers
        return cls.from_transfers(transfers)

    # -------------------------------------------------- views
    def __len__(self) -> int:
        return int(self.src.size)

    def __getitem__(self, i: int) -> "Transfer":
        return Transfer(
            int(self.src[i]), int(self.dst[i]), int(self.direction[i]),
            float(self.bits[i]), int(self.wavelength[i]),
        )

    def __iter__(self) -> Iterator["Transfer"]:
        for i in range(len(self)):
            yield self[i]

    def to_transfers(self) -> list["Transfer"]:
        return list(self)

    def with_wavelengths(self, wavelength: np.ndarray) -> "TransferBatch":
        batch = TransferBatch(
            self.src, self.dst, self.direction, self.bits,
            np.asarray(wavelength, dtype=np.int64),
        )
        batch._arcs = self._arcs  # geometry is wavelength-independent
        return batch

    # -------------------------------------------------- geometry
    def arcs(self, n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Each directed lightpath as a ring arc.

        Returns ``(lane, start, hops)``: ``lane`` 0 for CW / 1 for CCW (the
        two fibers are independent), and the path covers directed segments
        ``start, start+1, ..., start+hops-1 (mod n)`` — the exact segment ids
        of :func:`path_segments` for either direction.

        The result is memoized per ring size (geometry never changes after
        construction — batches are immutable by convention), so RWA,
        validation and profile compilation share one computation.
        """
        memo = self._arcs
        if memo is not None and memo[0] == n:
            return memo[1], memo[2], memo[3]
        # direction is ±1, so both branches collapse to arithmetic:
        # lane = 0/1 for CW/CCW, hops = (dst-src)%n resp. (src-dst)%n
        lane = (1 - self.direction) >> 1
        hops = ((self.dst - self.src) * self.direction) % n
        start = np.where(self.direction == CW, self.src, self.dst)
        self._arcs = (n, lane, start, hops)
        return lane, start, hops

    @property
    def max_wavelength(self) -> int:
        return -1 if len(self) == 0 else int(self.wavelength.max())

    def __repr__(self) -> str:
        return f"TransferBatch(len={len(self)})"


@dataclass
class Ring:
    """A bidirectional WDM ring with ``n`` nodes and ``w`` wavelengths/fiber."""

    n: int
    w: int
    bandwidth_bps: float = 40e9        # per wavelength (Table II)
    reconfig_delay_s: float = 25e-6    # MRR reconfiguration delay (Table II)
    flit_bits: int = 32 * 8            # flit size (Table II)
    oeo_cycle_s: float = field(default=0.0)  # O/E/O conversion, per flit
    physical: PhysicalParams | None = None   # power budget; None = unconstrained
    failures: FailureMask | None = None      # dead resources; None = healthy

    def __post_init__(self) -> None:
        if self.n < 2:
            raise ValueError("ring needs >= 2 nodes")
        if self.w < 1:
            raise ValueError("need >= 1 wavelength")
        if self.oeo_cycle_s == 0.0:
            # Table II: O/E/O delay is 1 cycle/flit.  At 40 Gb/s a 32 B flit
            # serializes in 256/40e9 s; one extra cycle per flit models the
            # conversion pipeline.
            self.oeo_cycle_s = self.flit_bits / self.bandwidth_bps

    @property
    def max_hops(self) -> int | None:
        """Insertion-loss hop budget, or None when no physical model is set."""
        return None if self.physical is None else self.physical.max_hops

    def serialization_time(self, bits: float) -> float:
        """Wire time for one transfer: flit-aligned serialization + O/E/O."""
        if bits <= 0:
            return 0.0
        flits = -(-int(bits) // self.flit_bits)  # ceil
        return flits * self.flit_bits / self.bandwidth_bps + self.oeo_cycle_s

    def serialization_time_array(self, bits: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`serialization_time` (same flit arithmetic)."""
        b = np.asarray(bits, dtype=np.float64)
        flits = -(-b.astype(np.int64) // self.flit_bits)  # ceil, as the scalar
        out = flits * self.flit_bits / self.bandwidth_bps + self.oeo_cycle_s
        return np.where(b <= 0, 0.0, out)

    def propagation_time(self, hops: np.ndarray) -> np.ndarray:
        """Receive-side time of flight for per-transfer hop counts."""
        if self.physical is None:
            return np.zeros_like(np.asarray(hops, dtype=np.float64))
        return np.asarray(hops, dtype=np.float64) * self.physical.propagation_s_per_hop
