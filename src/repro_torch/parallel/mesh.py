"""Process meshes: the port's counterpart of ``jax.sharding.Mesh`` and
``repro/launch/mesh.py``.

A ``ProcessMesh`` lays the ranks of a ``torch.distributed`` job out on named
axes, row-major like ``Mesh(np.array(devices).reshape(shape), axis_names)``:
with ``{"data": 4, "pod": 2}`` rank ``r`` sits at ``(data, pod) =
divmod(r, 2)``.  Along each axis the ranks that share every other coordinate
form one line, with one process group per line; every rank creates every
group, in the same order, as ``torch.distributed.new_group`` requires.  A
mesh whose axes all have size 1 needs no process group and no initialized
``torch.distributed``.

``plan_gradient_sync`` reads only ``axis_names`` and ``shape``, like the
reference's, so stub meshes work there too.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch.distributed as dist


class ProcessMesh:
    def __init__(self, shape: dict[str, int]):
        if not shape or any(int(s) < 1 for s in shape.values()):
            raise ValueError(f"mesh shape {shape}: every axis needs a size >= 1")
        self.shape = {a: int(s) for a, s in shape.items()}
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        if self.size > 1:
            if not dist.is_initialized():
                raise RuntimeError(f"a mesh of {self.size} ranks needs an initialized "
                                   f"torch.distributed process group")
            if dist.get_world_size() != self.size:
                raise ValueError(f"mesh {self.shape} holds {self.size} ranks, the job "
                                 f"{dist.get_world_size()}")
        self.rank = dist.get_rank() if self.size > 1 else 0
        dims = tuple(self.shape.values())
        self._grid = np.arange(self.size).reshape(dims)
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(self.rank, dims))))
        self._lines: dict[str, list[int]] = {}
        self._groups: dict[str, object] = {}
        for k, axis in enumerate(self.axis_names):
            others = [range(d) if j != k else [slice(None)] for j, d in enumerate(dims)]
            for idx in itertools.product(*others):
                line = [int(r) for r in self._grid[idx]]
                group = dist.new_group(line) if self.size > 1 and dims[k] > 1 else None
                if self.rank in line:
                    self._lines[axis], self._groups[axis] = line, group

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def axis_rank(self, axis: str, index: int) -> int:
        """The global rank at ``index`` on this rank's line along ``axis``."""
        return self._lines[axis][index]

    def group(self, axis: str):
        """The process group of this rank's line along ``axis`` (None at size 1)."""
        return self._groups[axis]

    def __repr__(self) -> str:
        return f"ProcessMesh({self.shape}, rank={self.rank})"
