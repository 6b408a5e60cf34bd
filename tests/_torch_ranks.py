"""Run a function on N gloo ranks of ``torch.distributed`` on the CPU: the
port's counterpart of ``run_subprocess`` with 8 fake XLA devices.

``run_ranks(fn, world, tmp_path, *args)`` spawns ``world`` processes (the
``spawn`` start method), joins them through a ``file://`` store under
``tmp_path`` (no TCP port to race for), calls ``fn(rank, world, *args)`` on
each and returns the ranks' results in rank order.  A rank that raises fails
the call with its traceback; ranks still alive after ``timeout`` seconds
are killed and the call fails, so a hung collective cannot hang the suite.

This module imports no jax: the ranks run the port alone.  Functions run on
the ranks must be importable by name (module level here or in the port).
"""

from __future__ import annotations

import multiprocessing as mp
import pickle
import time
import traceback
from pathlib import Path


def _entry(fn, rank, world, init, out_dir, args):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    out = Path(out_dir)
    try:
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
        result = fn(rank, world, *args)
        (out / f"rank{rank}.pkl").write_bytes(pickle.dumps(result))
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = 60.0) -> list:
    out = Path(tmp_path) / f"ranks_{fn.__name__}"
    out.mkdir(parents=True, exist_ok=True)
    init = f"file://{out / 'store'}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, init, str(out), args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [f"rank {r}:\n{(out / f'rank{r}.err').read_text()}"
              for r in range(world) if (out / f"rank{r}.err").exists()]
    if errors:
        raise AssertionError("\n".join(errors))
    if hung:
        raise TimeoutError(f"ranks {hung} of {world} still running after {timeout} s")
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise AssertionError(f"ranks exited with {bad}")
    return [pickle.loads((out / f"rank{r}.pkl").read_bytes()) for r in range(world)]


# ------------------------------------------------------------ rank bodies

MESH_SHAPE = {"data": 4, "pod": 2}


def rank_input(rank: int, n: int, kind: str):
    """Rank ``rank``'s payload: small integers in f32 (every sum exact, in
    any order) or normals."""
    import numpy as np

    rng = np.random.default_rng([rank, n, kind == "int"])
    if kind == "int":
        return rng.integers(-50, 50, n).astype(np.float32)
    return rng.normal(size=n).astype(np.float32)


def collectives_body(rank, world, sizes):
    """Every ported collective on both axes of the (data 4, pod 2) mesh."""
    import torch

    from repro_torch.core import collectives as C
    from repro_torch.parallel.mesh import ProcessMesh

    mesh = ProcessMesh(MESH_SHAPE)
    out = {"coords": dict(mesh.coords)}
    for n in sizes:
        for kind in ("int", "rand"):
            x = torch.from_numpy(rank_input(rank, n, kind))
            for axis, s in mesh.shape.items():
                rs_ring = C.reduce_scatter_ring(x, mesh, axis, s)
                rs_a2a = C.reduce_scatter_alltoall(x, mesh, axis, s)
                out[n, kind, axis] = {
                    "rs_ring": rs_ring.numpy(), "rs_a2a": rs_a2a.numpy(),
                    "ag_ring": C.all_gather_ring(rs_ring, mesh, axis, s).numpy(),
                    "ag_a2a": C.all_gather_alltoall(rs_a2a, mesh, axis, s).numpy(),
                }
    for axis, s in mesh.shape.items():
        # message j of this rank is (rank, j): row i of the result comes from index i
        msgs = torch.tensor([[float(rank), float(j)] for j in range(s)])
        out["a2a", axis] = C.alltoall_ppermute(msgs, mesh, axis, s).numpy()
    return out


def _by_path(tree) -> dict:
    """A tree of tensors as {reference path: numpy array}, layers stacked."""
    from repro_torch import tree as T

    return {T.path_str(p): (leaf.stack() if isinstance(leaf, T.Stacked) else leaf.detach())
            .float().numpy().copy() for p, leaf in T.leaves_with_paths(tree)}


def train_body(rank, world, params_np, batches, tc_kwargs):
    """The port's train step on this rank's block of each global batch,
    from the reference's initial params."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.mesh import ProcessMesh
    from repro_torch.train import train_step as TS

    cfg = registry.get("qwen2-1.5b", smoke=True)
    tc = TrainConfig(**tc_kwargs)
    mesh = ProcessMesh(MESH_SHAPE)
    params = params_from_jax(params_np, cfg, device="cpu")
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    if tc.sync_algorithm in TS.COMPRESSED_ALGOS:
        state["ef"] = TS.compression.init_ef_state(params)
    step = TS.make_train_step(cfg, tc, mesh, device="cpu")
    metrics = []
    for batch in batches:
        state, m = step(state, shard_batch(batch, mesh, "cpu"))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "params": _by_path(state["params"]),
            "bits": step.controller.plans.bits}


def compressed_sync_body(rank, world, params_np, batch, tc_kwargs):
    """One compressed gradient sync from this rank's local gradients: the
    local gradients, the synced ones, the new residual, and the local
    dequantized values and residual of the same step with no collective."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import bucketing
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.models import api as mapi
    from repro_torch.models.convert import params_from_jax
    from repro_torch.parallel.mesh import ProcessMesh
    from repro_torch.train import train_step as TS
    from repro_torch.tree import map_tensors

    cfg = registry.get("qwen2-1.5b", smoke=True)
    tc = TrainConfig(**tc_kwargs)
    mesh = ProcessMesh(MESH_SHAPE)
    params = map_tensors(lambda p: p.requires_grad_(True),
                         params_from_jax(params_np, cfg, device="cpu"))
    api = mapi.get_api(cfg, compute_dtype=torch.float32, device="cpu", remat=tc.remat)
    _, _, grads = TS._microbatched_grads(api.loss, params, shard_batch(batch, mesh), 1)
    local = _by_path(grads)
    plans = TS.SyncController(TS.abstract_params(cfg), tc, mesh).plans
    zeros = lambda: map_tensors(torch.zeros_like, grads)  # noqa: E731
    alone, alone_ef = bucketing.bucketed_apply_compressed(
        map_tensors(torch.clone, grads), zeros(), lambda f, n, i: f, plans.spec,
        bits=plans.bits, block=tc.compress_block, fused=tc.compress_fused_kernel)
    synced, ef = TS.sync_gradients(grads, tc, mesh, zeros(), sync_plans=plans)
    return {"local": local, "synced": _by_path(synced), "ef": _by_path(ef),
            "deq": _by_path(alone), "alone_ef": _by_path(alone_ef), "bits": plans.bits,
            "bucket_sizes": plans.spec.bucket_sizes, "leaf_buckets": plans.spec.leaf_buckets}


def scenarios_body(rank, world, scenarios):
    """Run each ``(name, body name, args)`` of ``scenarios`` on this rank, in
    one process group: one spawn serves a whole test module."""
    return {name: globals()[body](rank, world, *args) for name, body, args in scenarios}
