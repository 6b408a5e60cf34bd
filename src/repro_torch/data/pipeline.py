"""Host-side data: the port of ``repro/data/pipeline.py``.

``SyntheticLM`` gives the reference's numpy stream: the batch at step k is a
pure function of (seed, k), so a restarted run sees identical data and both
packages train on the same tokens.  ``shard_batch`` hands each rank its
block of the batch's leading dimension in ``P(("data", "pod"))`` order, the
order the reference's train step splits the batch in, and moves it to the
device.  ``CorpusLM`` and the prefetching iterator are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        toks = rng.integers(0, self.vocab_size, (self.global_batch, self.seq_len + 1),
                            dtype=np.int64)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }


def dp_block(mesh) -> tuple[int, int]:
    """(this rank's block index, number of blocks) of the batch's leading
    dimension, split over the DP axes in ``("data", "pod")`` order."""
    axes = [a for a in ("data", "pod") if mesh is not None and a in mesh.axis_names]
    index, count = 0, 1
    for a in axes:
        index = index * mesh.shape[a] + mesh.axis_index(a)
        count *= mesh.shape[a]
    return index, count


def shard_batch(batch: dict, mesh=None, device="cpu") -> dict[str, torch.Tensor]:
    """This rank's block of a host batch as int64 tensors on ``device``."""
    index, count = dp_block(mesh)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % count:
            raise ValueError(f"batch {k!r} of {v.shape[0]} rows does not split over "
                             f"{count} DP ranks")
        rows = v.shape[0] // count
        block = np.ascontiguousarray(v[index * rows:(index + 1) * rows])
        out[k] = torch.from_numpy(block).to(device=device, dtype=torch.int64)
    return out
