"""Integrity-checked, async-capable checkpointing: the port of
``repro/checkpoint/checkpointer.py``, on the same on-disk format.

Layout per step:  <dir>/step_<k>/
    manifest.json      {step, leaves: [{path, shape, dtype, crc32}]}
    arrays.npz         one entry per leaf

Leaves are named and ordered as the reference names them
(``['params']/['layers']/['attn']/['wq']``, ``['opt']/['count']``, ...):
per-layer tensors are stacked to ``[L, ...]`` on save and unstacked on
restore, so a checkpoint written by the JAX package restores into the port
and back.  The host copy is taken synchronously (the train step updates the
state in place afterwards); the write runs on a background thread that
``wait()`` joins.  A step directory is published by renaming
``_tmp_step_<k>`` to ``step_<k>``; retention keeps the newest ``keep_n``.
Leaves must have a numpy dtype (bf16 state is not supported yet).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import zlib
from pathlib import Path

import numpy as np
import torch

from .. import tree as T


def _host(leaf) -> np.ndarray:
    t = leaf.stack() if isinstance(leaf, T.Stacked) else leaf.detach()
    if t.dtype == torch.bfloat16:
        raise TypeError("bfloat16 leaves have no numpy dtype: checkpoint them in float32")
    return t.cpu().numpy().copy()


class Checkpointer:
    def __init__(self, directory: str | Path, keep_n: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_n = keep_n
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree, blocking: bool = False) -> None:
        self.wait()
        items = T.leaves_with_paths(tree)
        paths = [T.path_str(p) for p, _ in items]
        host = [_host(leaf) for _, leaf in items]
        manifest = {
            "step": step,
            "leaves": [
                {
                    "path": p,
                    "shape": list(a.shape),
                    "dtype": str(a.dtype),
                    "crc32": zlib.crc32(np.ascontiguousarray(a).tobytes()),
                }
                for p, a in zip(paths, host)
            ],
        }

        def write():
            tmp = self.dir / f"_tmp_step_{step}"
            tmp.mkdir(parents=True, exist_ok=True)
            np.savez(tmp / "arrays.npz", **dict(zip(paths, host)))
            with open(tmp / "manifest.json", "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            final = self.dir / f"step_{step}"
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            self._retain()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _retain(self) -> None:
        for s in sorted(self.steps())[: -self.keep_n]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ---------------------------------------------------------- restore
    def steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            m = re.fullmatch(r"step_(\d+)", p.name)
            if m and (p / "manifest.json").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def restore(self, step: int, target_tree, strict_crc: bool = True):
        """A new tree shaped like ``target_tree`` (same dtypes, devices and
        ``requires_grad``) holding the checkpoint's values."""
        d = self.dir / f"step_{step}"
        with open(d / "manifest.json") as f:
            manifest = json.load(f)
        data = np.load(d / "arrays.npz")
        by_path = {e["path"]: e for e in manifest["leaves"]}

        out = []
        for path, proto in T.leaves_with_paths(target_tree):
            p = T.path_str(path)
            if p not in by_path:
                raise KeyError(f"checkpoint missing leaf {p}")
            arr = data[p]
            if strict_crc:
                if zlib.crc32(np.ascontiguousarray(arr).tobytes()) != by_path[p]["crc32"]:
                    raise IOError(f"crc mismatch for {p} (corrupt checkpoint)")
            if tuple(arr.shape) != tuple(proto.shape):
                raise ValueError(f"shape mismatch for {p}: ckpt {arr.shape} vs target "
                                 f"{tuple(proto.shape)}")
            like = T.parts(proto)[0]
            out.append(torch.from_numpy(np.array(arr)).to(device=like.device, dtype=like.dtype))

        def own(t, like):
            # a layer's view of a stacked leaf becomes a tensor of its own
            t = t.clone() if t._base is not None else t
            return t.requires_grad_(like.requires_grad)

        return T.map_tensors(own, T.unflatten_like(target_tree, out), target_tree)

