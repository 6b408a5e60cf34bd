"""Training loop: checkpointing, auto-resume, watchdog, failure recovery.
The port of ``repro/train/trainer.py``.

The loop is restart-transparent: the data source is a pure function of the
step index and the train state carries its own step counter, so ``run()``
after an ``InjectedFailure`` resumes from the latest checkpoint and gives
bit-identical results to an uninterrupted run.  The trainer runs on
``device`` (``cuda`` unless the caller asks for the CPU) over ``mesh``, a
``ProcessMesh`` (default: one rank, ``{"data": 1}``).  The state is
replicated over the DP ranks, so on a mesh of several ranks rank 0 writes
each checkpoint, synchronously, and every rank waits for it at a barrier
before going on; one rank writes in the background, as the reference does.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data.pipeline import shard_batch
from repro_torch.parallel.mesh import ProcessMesh
from repro_torch.runtime.fault_tolerance import (
    FailureInjector, FaultManager, InjectedFailure, StepWatchdog)
from .train_step import make_train_state, make_train_step

log = logging.getLogger("repro_torch.trainer")


@dataclass
class TrainerOptions:
    ckpt_dir: str | Path = "checkpoints"
    ckpt_every: int = 50
    keep_n: int = 3
    max_restarts: int = 3
    watchdog_threshold: float = 3.0
    log_every: int = 10
    # what a flagged straggler triggers: "log" (record only), "checkpoint"
    # (force an early checkpoint), or a callable(StragglerEvent)
    straggler_policy: object = "log"


@dataclass
class Trainer:
    cfg: ModelConfig
    tc: TrainConfig
    source: object                      # .batch(step) -> host batch dict
    mesh: object | None = None
    options: TrainerOptions = field(default_factory=TrainerOptions)
    injector: FailureInjector | None = None
    fault_manager: FaultManager | None = None
    device: str | torch.device = "cuda"

    def __post_init__(self):
        policy = self.options.straggler_policy
        if not callable(policy) and policy not in ("log", "checkpoint"):
            raise ValueError(
                f"unknown straggler_policy {policy!r} "
                "(expected 'log', 'checkpoint' or a callable)")
        self.device = resolve_device(self.device)
        if self.mesh is None:
            self.mesh = ProcessMesh({"data": 1})
        self.ckpt = Checkpointer(self.options.ckpt_dir, keep_n=self.options.keep_n)
        self.watchdog = StepWatchdog(self.options.watchdog_threshold,
                                     on_straggler=self._on_straggler)
        self._step_fn = make_train_step(self.cfg, self.tc, self.mesh, device=self.device)
        self.controller = self._step_fn.controller
        self._plan_codes = self.controller.arrays()
        self._ckpt_requested = False
        self.history: list[dict] = []
        if self.fault_manager is not None:
            self.fault_manager.attach(self.replan)

    # --------------------------------------------------------- fault hooks
    def _on_straggler(self, event):
        if self.fault_manager is not None:
            self.fault_manager.observe_straggler(event)
        policy = self.options.straggler_policy
        if callable(policy):
            policy(event)
            return
        log.warning("straggler at step %d: %.3fs vs median %.3fs",
                    event.step, event.duration_s, event.median_s)
        if policy == "checkpoint":
            self._ckpt_requested = True

    def replan(self, failure_mask=None):
        """Swap in degraded (or restored-healthy) gradient-sync schedules;
        they take effect on the next step."""
        self._plan_codes = self.controller.replan(failure_mask)
        log.warning("re-planned gradient sync (mask=%s, %.1f ms)",
                    self.controller.failures, 1e3 * self.controller.last_replan_s)
        return self._plan_codes

    # -------------------------------------------------------------- state
    def _save(self, step: int, state) -> None:
        if self.mesh.size == 1:
            self.ckpt.save(step, state)
            return
        if self.mesh.rank == 0:
            self.ckpt.save(step, state, blocking=True)
        dist.barrier()

    def init_or_restore(self):
        state = make_train_state(self.cfg, self.tc, device=self.device)
        steps = self.ckpt.steps()
        if steps:
            state = self.ckpt.restore(steps[-1], state)
            log.info("restored checkpoint at step %d", steps[-1])
        return state

    # ---------------------------------------------------------------- run
    def run(self, total_steps: int | None = None):
        total = total_steps if total_steps is not None else self.tc.total_steps
        restarts = 0
        while True:
            try:
                return self._run_inner(total)
            except InjectedFailure as e:
                restarts += 1
                log.warning("%s — restart %d/%d", e, restarts, self.options.max_restarts)
                if restarts > self.options.max_restarts:
                    raise

    def _run_inner(self, total: int):
        state = self.init_or_restore()
        step = int(state["step"])
        while step < total:
            if self.fault_manager is not None:
                self.fault_manager.on_step(step)
            if self.injector is not None:
                self.injector.check(step)
                mask = self.injector.degradation(step)
                if mask is not None:
                    self.replan(mask)
            batch = shard_batch(self.source.batch(step), self.mesh, self.device)
            self.watchdog.start()
            state, metrics = self._step_fn(state, batch, self._plan_codes)
            loss = float(metrics["loss"])   # waits for the step's device work
            dt = self.watchdog.stop(step)
            step += 1
            if step % self.options.log_every == 0 or step == total:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(loss=loss, step=step, sec_per_step=dt)
                self.history.append(m)
                log.info("step %d loss %.4f (%.2fs)", step, m["loss"], dt)
            if self._ckpt_requested:
                self._ckpt_requested = False
                log.warning("straggler policy: forcing early checkpoint at step %d", step)
                self._save(step, state)
            if step % self.options.ckpt_every == 0 or step == total:
                self._save(step, state)
        self.ckpt.wait()
        return state
