"""Multi-rank check of the training CLI: one global batch through
``repro_torch.launch.train`` on several ranks and on one.

    # four GPUs of one host, NCCL
    PYTHONPATH=src python -m repro_torch.launch.compare_ranks
    # four CPU processes, gloo
    PYTHONPATH=src python -m repro_torch.launch.compare_ranks --device cpu

Three runs of 3 steps of qwen2-1.5b at ``--smoke`` size, batch 8 x 64, each
in processes of its own:

  1. 4 ranks under ``torch.distributed.run`` on a 2x2 (data x pod) mesh,
     ``planned_sharded``;
  2. the same with ``planned_sharded_compressed`` through the EF kernel
     (``--fused-kernel``) at 8 bits;
  3. one rank (a size-1 mesh), ``planned_sharded``.

Every rank of a run must report one last-step loss and grad norm.  Run 1's
loss and grad norm must equal run 3's within RTOL (the same math, summed in
another order), run 2's within COMPRESSED_RTOL (8-bit quantization of the
gradients).  Prints one JSON line; exits 1 if a check fails.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

SRC = Path(__file__).resolve().parents[2]
NPROC, MESH, STEPS = 4, "2x2", 3
TRAIN_ARGS = ["--arch", "qwen2-1.5b", "--smoke", "--steps", str(STEPS), "--batch", "8",
              "--seq", "64"]
# the sharded step differs from one rank's by summation order only (1.6e-5 on
# the loss over gloo); 8-bit compression moves the grad norm by ~2.3e-4
RTOL, COMPRESSED_RTOL = 1e-4, 1e-3
TIMEOUT_S = 600


def run_train(nproc: int, device: str, extra: list[str], ckpt_dir: str) -> list[dict]:
    """The last step's history entry of every rank of one training run."""
    cmd = [sys.executable]
    if nproc > 1:
        cmd += ["-m", "torch.distributed.run", "--standalone", f"--nproc-per-node={nproc}"]
    cmd += ["-m", "repro_torch.launch.train", *TRAIN_ARGS, "--device", device,
            "--ckpt-dir", ckpt_dir, "--ckpt-every", str(10**6), *extra]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(SRC), os.environ.get("PYTHONPATH")) if p))
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    if proc.returncode:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise RuntimeError(f"{' '.join(cmd)} exited with {proc.returncode}")
    # each rank prints its last history entries as dicts; ranks' lines may run together
    entries = (ast.literal_eval(m) for m in re.findall(r"\{'loss'[^{}]*\}", proc.stdout))
    last = [h for h in entries if h.get("step") == STEPS]
    if len(last) != nproc:
        raise RuntimeError(f"{len(last)} of {nproc} ranks reported step {STEPS}")
    return last


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    device = ap.parse_args(argv).device

    runs = {}
    with tempfile.TemporaryDirectory(prefix="compare_ranks_") as tmp:
        for name, nproc, extra in (
                ("sharded", NPROC, ["--mesh", MESH, "--sync", "planned_sharded"]),
                ("compressed", NPROC, ["--mesh", MESH, "--sync", "planned_sharded_compressed",
                                       "--fused-kernel", "--compress-bits", "8"]),
                ("one_rank", 1, ["--sync", "planned_sharded"])):
            runs[name] = run_train(nproc, device, extra, str(Path(tmp) / name))

    failures = []
    for name, ranks in runs.items():
        for k in ("loss", "grad_norm"):
            if len({h[k] for h in ranks}) != 1:
                failures.append(f"{name}: ranks disagree on {k}: {[h[k] for h in ranks]}")
    ref = runs["one_rank"][0]
    rel = {name: {k: abs(runs[name][0][k] - ref[k]) / abs(ref[k]) for k in ("loss", "grad_norm")}
           for name in ("sharded", "compressed")}
    for name, tol in (("sharded", RTOL), ("compressed", COMPRESSED_RTOL)):
        for k, v in rel[name].items():
            if not v <= tol:
                failures.append(f"{name} vs one rank: {k} rel {v} (tol {tol})")
    print(json.dumps({"ok": not failures, "failures": failures, "device": device,
                      "nproc": NPROC, "mesh": MESH, "train_args": TRAIN_ARGS,
                      "rel_to_one_rank": rel,
                      "last_step": {name: ranks[0] for name, ranks in runs.items()}}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
