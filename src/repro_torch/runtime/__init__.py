"""Fault tolerance of the port: a verbatim copy of the reference's
``repro/runtime/fault_tolerance.py`` (pure Python), pointed at the port's
``core.topology`` and ``core.wrht``."""

from .fault_tolerance import (  # noqa: F401
    FailureInjector,
    InjectedFailure,
    StepWatchdog,
)
