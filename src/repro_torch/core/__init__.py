"""The port's NumPy optical core and its gradient-sync modules.

``topology``, ``wavelength``, ``wrht``, ``step_models``, ``timing``,
``simulator``, ``planner`` and ``compose`` are verbatim copies of the
reference's ``repro/core`` modules of the same names (imports are
package-relative, so their docstrings' ``repro.core`` cross-references read
as this package).  They import only NumPy: one plan means the same schedule
on both backends, which the CPU tests check plan for plan.  ``plan_cache``
and ``traffic`` are not copied yet; the analytic planner path never reaches
them.

``compression``, ``collectives`` and ``bucketing`` are ports: the EF
quantization and the planned reduce-scatter / all-gather over
``torch.distributed`` process groups.
"""
