"""Fault-tolerance runtime: closed-loop fault management, straggler watchdog,
failure injection (DESIGN.md §12/§14).

At 1000+ nodes the per-step failure probability is O(hours⁻¹); the trainer
treats every step as restartable AND the optical fabric as mutable:

  * ``HealthMonitor`` consumes per-resource telemetry
    (:class:`~repro.core.topology.ResourceObservation` — per-λ/per-span
    error or timeout events from the simulator probe
    ``repro.core.simulator.observe_faults``) plus ``StragglerEvent``s from
    the watchdog, and runs one hysteresis state machine per resource:
    *confirm-before-demote* (``ReplanPolicy.confirm_k`` consecutive errors
    before a resource enters the mask) and *cooldown-before-readmit*
    (``recover_k`` consecutive oks AND ``cooldown_steps`` since demotion
    before it leaves).  A flapping λ faster than the confirm window never
    thrashes the planner.
  * ``FaultManager`` closes the loop: probe → monitor → mask proposal →
    ``Trainer.replan`` (rate-limited by ``min_replan_interval``), replacing
    caller-injected ``degrade_at`` masks as the primary path.  Recovery
    replans shrink the mask back toward the healthy plan — a plan-cache /
    controller-memo hit, zero retraces (DESIGN.md §12).
  * ``StepWatchdog`` tracks a running median of step wall-times and flags
    steps slower than ``threshold ×`` median (straggler / pre-failure
    symptom).  Policy hooks: "log" (default), "checkpoint" (force an early
    checkpoint so the inevitable restart loses less), or a user callback.
  * ``FailureInjector`` deterministically raises at configured steps —
    the integration tests use it to prove checkpoint/restart reproduces the
    uninterrupted run bit-for-bit (same data source, same RNG).
"""

from __future__ import annotations

import logging
import statistics
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Iterable

from ..core.topology import FailureMask, ResourceObservation

log = logging.getLogger("repro.fault")


class InjectedFailure(RuntimeError):
    """Simulated node failure."""


@dataclass
class FailureInjector:
    """Deterministic failure injection for restart/re-plan tests.

    ``fail_at_steps`` raise :class:`InjectedFailure` once each (hard crash →
    trainer restart).  ``degrade_at`` maps a step to the
    :class:`~repro.core.topology.FailureMask` that becomes active there
    (soft optical failure → trainer re-plan, DESIGN.md §12); each mask is
    reported exactly once via :meth:`degradation`.  Masks are validated at
    construction — a wrong value type fails HERE with a clear error, not
    steps later deep inside ``Trainer.replan``.  ``reset()`` re-arms
    everything so a restarted trainer can reuse one injector without
    double-firing inside a single run loop.
    """

    fail_at_steps: tuple[int, ...] = ()
    fired: set[int] = field(default_factory=set)
    degrade_at: dict[int, FailureMask] = field(default_factory=dict)
    degraded_fired: set[int] = field(default_factory=set)

    def __post_init__(self) -> None:
        for step, mask in self.degrade_at.items():
            if not isinstance(mask, FailureMask):
                raise TypeError(
                    f"degrade_at[{step}] must be a FailureMask, got "
                    f"{type(mask).__name__} — build one with "
                    "topology.FailureMask(dead_segments=..., ...)")

    def check(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise InjectedFailure(f"injected node failure at step {step}")

    def degradation(self, step: int) -> FailureMask | None:
        """The failure mask newly active at ``step`` (one-shot), else None."""
        if step in self.degrade_at and step not in self.degraded_fired:
            self.degraded_fired.add(step)
            return self.degrade_at[step]
        return None

    def reset(self) -> None:
        """Re-arm every configured failure and degradation."""
        self.fired.clear()
        self.degraded_fired.clear()


@dataclass
class StragglerEvent:
    step: int
    duration_s: float
    median_s: float


class StepWatchdog:
    """Flags steps slower than ``threshold ×`` the running median.

    ``window`` bounds the median history (an O(1) ``deque(maxlen=...)``);
    ``warmup`` is the number of recorded steps before flagging starts, so
    the first compile-heavy steps never count as stragglers.
    """

    def __init__(self, threshold: float = 3.0, window: int = 32,
                 on_straggler: Callable[[StragglerEvent], None] | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 warmup: int = 4):
        if warmup < 1:
            raise ValueError("warmup must be >= 1 recorded step")
        self.threshold = threshold
        self.window = window
        self.warmup = warmup
        self.on_straggler = on_straggler
        self.clock = clock
        self._times: deque[float] = deque(maxlen=window)
        self.events: list[StragglerEvent] = []
        self._t0: float | None = None

    def start(self) -> None:
        self._t0 = self.clock()

    def stop(self, step: int) -> float:
        assert self._t0 is not None, "stop() without start()"
        dt = self.clock() - self._t0
        self._t0 = None
        if len(self._times) >= self.warmup:
            med = statistics.median(self._times)
            if dt > self.threshold * med:
                ev = StragglerEvent(step, dt, med)
                self.events.append(ev)
                if self.on_straggler is not None:
                    self.on_straggler(ev)
        self._times.append(dt)
        return dt


# ---------------------------------------------------------------------------
# Closed-loop fault management (DESIGN.md §14): observations -> hysteresis
# state machines -> FailureMask proposals -> Trainer.replan -> recovery.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ReplanPolicy:
    """Hysteresis and rate limits of the fault-management loop.

    ``confirm_k``           consecutive error observations before a resource
                            is demoted into the mask (confirm-before-demote:
                            a λ flapping faster than this never replans).
    ``recover_k``           consecutive ok observations before a demoted
                            resource becomes readmission-eligible.
    ``cooldown_steps``      minimum steps a resource stays masked after its
                            demotion (cooldown-before-readmit: a slow
                            flapper is held out instead of oscillating).
    ``min_replan_interval`` minimum steps between two replans — the global
                            rate limit bounding planner thrash even when
                            many resources churn independently.
    ``straggler_probe``     consecutive stragglers before the manager runs
                            an out-of-band probe of its observation source
                            (timeouts are a pre-failure symptom; 0 disables).
    ``on_infeasible``       ``"keep"`` (default): a mask proposal the
                            planner rejects with ``DegradedInfeasibleError``
                            keeps the previous plan installed and the loop
                            running (failure-storm survival); ``"raise"``
                            propagates.
    """

    confirm_k: int = 3
    recover_k: int = 3
    cooldown_steps: int = 8
    min_replan_interval: int = 1
    straggler_probe: int = 2
    on_infeasible: str = "keep"

    def __post_init__(self) -> None:
        if min(self.confirm_k, self.recover_k) < 1:
            raise ValueError("confirm_k and recover_k must be >= 1")
        if self.cooldown_steps < 0 or self.min_replan_interval < 0:
            raise ValueError("cooldown_steps/min_replan_interval must be "
                             ">= 0")
        if self.on_infeasible not in ("keep", "raise"):
            raise ValueError(f"on_infeasible must be 'keep' or 'raise', "
                             f"got {self.on_infeasible!r}")


# per-resource hysteresis states
UP, SUSPECT, DOWN, RECOVERING = "up", "suspect", "down", "recovering"


@dataclass
class _ResourceRecord:
    state: str = UP
    errors: int = 0          # consecutive errors while UP/SUSPECT
    oks: int = 0             # consecutive oks while DOWN/RECOVERING
    demoted_at: int | None = None


class HealthMonitor:
    """Per-resource hysteresis state machines over raw telemetry.

    Feed :class:`~repro.core.topology.ResourceObservation`s via
    :meth:`observe`; read the confirmed-down set as :attr:`mask`.  The
    state machine per resource (DESIGN.md §14):

    ``up --error--> suspect --confirm_k'th error--> down``
    ``suspect --ok--> up`` (transient glitch absorbed, nothing replans)
    ``down --ok--> recovering --recover_k'th ok AND cooldown elapsed--> up``
    ``recovering --error--> down`` (flap caught, cooldown restarts)

    Demotions and readmissions mutate :attr:`mask`; :meth:`advance` reports
    the new mask once per change (the :class:`FaultManager` turns that into
    a rate-limited replan).
    """

    def __init__(self, policy: ReplanPolicy | None = None) -> None:
        self.policy = policy or ReplanPolicy()
        self._records: dict[tuple[str, tuple[int, int]], _ResourceRecord] = {}
        self._mask = FailureMask()
        self._dirty = False
        self.demotions = 0
        self.readmissions = 0
        self.straggler_streak = 0

    # ------------------------------------------------------------- state
    @property
    def mask(self) -> FailureMask:
        """The currently confirmed-down resources as a
        :class:`~repro.core.topology.FailureMask`."""
        return self._mask

    def state(self, kind: str, ident) -> str:
        rec = self._records.get((kind, (int(ident[0]), int(ident[1]))))
        return UP if rec is None else rec.state

    def _rebuild_mask(self) -> None:
        segs, lams, txs = [], [], []
        for (kind, ident), rec in self._records.items():
            if rec.state in (DOWN, RECOVERING):
                {"segment": segs, "wavelength": lams,
                 "transceiver": txs}[kind].append(ident)
        self._mask = FailureMask(dead_segments=tuple(segs),
                                 dead_wavelengths=tuple(lams),
                                 dead_transceivers=tuple(txs))

    # ------------------------------------------------------------ inputs
    def observe(self, obs: ResourceObservation) -> None:
        """Advance one resource's state machine by one telemetry sample."""
        key = (obs.kind, obs.ident)
        rec = self._records.get(key)
        if rec is None:
            if obs.ok:
                return  # healthy resource we were not tracking: stay lazy
            rec = self._records[key] = _ResourceRecord()
        p = self.policy
        if rec.state in (UP, SUSPECT):
            if obs.ok:
                rec.state, rec.errors = UP, 0
            else:
                rec.state = SUSPECT
                rec.errors += 1
                if rec.errors >= p.confirm_k:
                    rec.state, rec.oks = DOWN, 0
                    rec.demoted_at = obs.step
                    self.demotions += 1
                    self._dirty = True
        else:  # DOWN / RECOVERING
            if not obs.ok:
                rec.state, rec.oks = DOWN, 0
            else:
                rec.state = RECOVERING
                rec.oks += 1
                if (rec.oks >= p.recover_k
                        and obs.step - rec.demoted_at >= p.cooldown_steps):
                    rec.state, rec.errors = UP, 0
                    rec.demoted_at = None
                    self.readmissions += 1
                    self._dirty = True
        if self._dirty:
            self._rebuild_mask()
            self._dirty = False
            self._changed = True

    _changed = False

    def observe_straggler(self, event: StragglerEvent) -> None:
        """Stragglers are a pre-failure symptom without resource
        attribution: they raise :attr:`straggler_streak`, which the
        :class:`FaultManager` uses to trigger an out-of-band probe of its
        observation source (``ReplanPolicy.straggler_probe``)."""
        self.straggler_streak += 1

    def note_healthy_step(self) -> None:
        """A step finished without straggling — the streak resets."""
        self.straggler_streak = 0

    # ----------------------------------------------------------- output
    def advance(self, step: int) -> FailureMask | None:
        """The new mask if the confirmed-down set changed since the last
        call, else ``None``."""
        if self._changed:
            self._changed = False
            return self._mask
        return None


class FaultManager:
    """The closed loop: probe → :class:`HealthMonitor` → rate-limited
    ``replan`` (DESIGN.md §14).

    ``probe(step)`` returns the step's telemetry (an iterable of
    :class:`~repro.core.topology.ResourceObservation`) — in the simulated
    system that is ``simulator.observe_faults(timeline, step)``; a real
    deployment would adapt its transport telemetry.  ``attach(replan_fn)``
    connects the trainer (done automatically by ``Trainer.__post_init__``);
    the loop then runs from :meth:`on_step` once per training step.

    A mask proposal the planner rejects as infeasible keeps the previous
    plan installed when ``policy.on_infeasible == "keep"`` — the storm-
    survival mode: the loop logs, counts, and keeps training on the last
    feasible plan instead of crashing mid-storm.
    """

    def __init__(self,
                 probe: Callable[[int], Iterable[ResourceObservation]],
                 policy: ReplanPolicy | None = None,
                 monitor: HealthMonitor | None = None) -> None:
        self.policy = policy or ReplanPolicy()
        self.monitor = monitor or HealthMonitor(self.policy)
        self.probe = probe
        self._replan: Callable[[FailureMask | None], object] | None = None
        self.current_mask: FailureMask | None = None
        self.replan_count = 0
        self.infeasible_count = 0
        self.last_replan_step: int | None = None
        self.deferred: FailureMask | None = None
        self.history: list[dict] = []

    def attach(self, replan_fn: Callable[[FailureMask | None], object]) -> None:
        """Connect the replan sink (``Trainer.replan`` or a test stub)."""
        self._replan = replan_fn

    # ------------------------------------------------------------- loop
    def observe_straggler(self, event: StragglerEvent) -> None:
        self.monitor.observe_straggler(event)

    def on_step(self, step: int) -> FailureMask | None:
        """Run one loop iteration: feed the step's telemetry through the
        monitor and apply any mask change as a (rate-limited) replan.
        Returns the mask applied this step, or ``None``."""
        for obs in self.probe(step):
            self.monitor.observe(obs)
        proposal = self.monitor.advance(step)
        if proposal is None and self.deferred is not None:
            proposal = self.deferred  # rate-limited earlier; retry now
        if proposal is None and self.policy.straggler_probe and (
                self.monitor.straggler_streak >= self.policy.straggler_probe):
            # persistent timeouts with no confirmed fault: the next loop
            # iterations keep probing; nothing to apply yet
            self.monitor.straggler_streak = 0
        if proposal is None:
            return None
        if (self.last_replan_step is not None
                and step - self.last_replan_step
                < self.policy.min_replan_interval):
            self.deferred = proposal  # hold until the rate limit clears
            return None
        self.deferred = None
        return self._apply(step, proposal)

    def _apply(self, step: int, mask: FailureMask) -> FailureMask | None:
        from ..core.wrht import DegradedInfeasibleError

        if self._replan is None:
            raise RuntimeError("FaultManager.on_step before attach() — the "
                               "trainer attaches its replan in __post_init__")
        normalized = None if mask.empty else mask
        if normalized == self.current_mask:
            return None
        try:
            self._replan(mask)
        except DegradedInfeasibleError as e:
            self.infeasible_count += 1
            self.history.append({"step": step, "mask": mask.fingerprint(),
                                 "applied": False, "reason": str(e)})
            if self.policy.on_infeasible == "raise":
                raise
            log.warning("step %d: proposed mask %s infeasible — keeping the "
                        "previous plan (%s)", step, mask.fingerprint(), e)
            return None
        self.current_mask = normalized
        self.replan_count += 1
        self.last_replan_step = step
        self.history.append({"step": step, "mask": mask.fingerprint(),
                             "applied": True})
        return mask
