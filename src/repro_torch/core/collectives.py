"""Device-level collectives of the planned sharded sync: the port of the
reduce-scatter / all-gather bodies of ``repro/core/collectives.py``.

Each function runs on every rank of one mesh axis line at once, as the
reference's ``shard_map`` bodies run on every device of an axis.
``lax.ppermute`` becomes ``torch.distributed.batch_isend_irecv`` over the
axis's process group (NCCL on the card, gloo on the CPU); ``P2POp`` takes a
global rank, so the axis index is mapped through the mesh.  Ownership is the
reference's: device ``i`` of the axis owns chunk ``i`` of the padded flat
payload.

    reduce_scatter_ring / all_gather_ring        the ring passes, S-1 hops
    alltoall_ppermute                            personalized all-to-all
    reduce_scatter_alltoall / all_gather_alltoall  the single-step finishers

The all-reduce bodies (``allreduce_{psum,ring,rd,bt,wrht_tree}``,
``hierarchical_allreduce``, ``broadcast_wrht_tree``) come with their sync
modes.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _pad_to(x: torch.Tensor, multiple: int) -> tuple[torch.Tensor, int]:
    """Flatten to 1-D and zero-pad so length % multiple == 0."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % multiple
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, pad


def _exchange(sends: list[tuple[int, torch.Tensor]], recvs: list[tuple[int, torch.Tensor]],
              mesh, axis: str) -> None:
    """Post every (axis index, tensor) send and receive at once and wait."""
    group = mesh.group(axis)
    ops = [dist.P2POp(dist.isend, t.contiguous(), mesh.axis_rank(axis, j), group)
           for j, t in sends]
    ops += [dist.P2POp(dist.irecv, t, mesh.axis_rank(axis, j), group) for j, t in recvs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()


def _shift(x: torch.Tensor, mesh, axis: str, size: int) -> torch.Tensor:
    """``lax.ppermute`` with the +1 ring permutation: send to i+1, receive
    from i-1."""
    idx = mesh.axis_index(axis)
    out = torch.empty_like(x)
    _exchange([((idx + 1) % size, x)], [((idx - 1) % size, out)], mesh, axis)
    return out


def reduce_scatter_ring(x: torch.Tensor, mesh, axis: str, axis_size: int) -> torch.Tensor:
    """Ring reduce-scatter: this device's fully reduced 1/S chunk of the
    padded flat payload (device ``i`` owns chunk ``i``)."""
    s = axis_size
    if s == 1:
        return x.reshape(-1)
    flat, _ = _pad_to(x, s)
    chunks = flat.reshape(s, -1)
    idx = mesh.axis_index(axis)
    send = chunks[(idx + s - 1) % s]
    for t in range(1, s):
        send = _shift(send, mesh, axis, s) + chunks[(idx + s - 1 - t) % s]
    return send


def all_gather_ring(shard: torch.Tensor, mesh, axis: str, axis_size: int) -> torch.Tensor:
    """Ring all-gather: circulate the owned chunk S-1 hops and return the
    concatenation (chunk ``i`` from device ``i``), the inverse of
    :func:`reduce_scatter_ring`."""
    s = axis_size
    flat = shard.reshape(-1)
    if s == 1:
        return flat
    idx = mesh.axis_index(axis)
    out = flat.new_empty((s, flat.shape[0]))
    out[idx] = flat
    cur = flat
    for t in range(1, s):
        cur = _shift(cur, mesh, axis, s)
        out[(idx - t) % s] = cur
    return out.reshape(-1)


def alltoall_ppermute(x: torch.Tensor, mesh, axis: str, axis_size: int) -> torch.Tensor:
    """Personalized all-to-all: row ``j`` of the ``[S, ...]`` input is this
    device's message for device ``j``; row ``i`` of the output is the
    message received from device ``i``.  The S-1 rotations of the reference
    are posted as one batch of sends and receives."""
    s = axis_size
    if x.shape[0] != s:
        raise ValueError(f"leading dim {x.shape[0]} != axis size {s}")
    if s == 1:
        return x
    idx = mesh.axis_index(axis)
    out = torch.empty_like(x)
    out[idx] = x[idx]
    _exchange([((idx + off) % s, x[(idx + off) % s]) for off in range(1, s)],
              [((idx - off) % s, out[(idx - off) % s]) for off in range(1, s)], mesh, axis)
    return out


def reduce_scatter_alltoall(x: torch.Tensor, mesh, axis: str, axis_size: int) -> torch.Tensor:
    """Reduce-scatter by the single-step all-to-all finisher: every device
    posts its chunk ``j`` to device ``j`` and sums what it received.  Same
    ownership as :func:`reduce_scatter_ring`."""
    s = axis_size
    if s == 1:
        return x.reshape(-1)
    flat, _ = _pad_to(x, s)
    return alltoall_ppermute(flat.reshape(s, -1), mesh, axis, s).sum(dim=0)


def all_gather_alltoall(shard: torch.Tensor, mesh, axis: str, axis_size: int) -> torch.Tensor:
    """All-gather by the single-step all-to-all finisher: every device posts
    its owned shard to every peer in one exchange; same output as
    :func:`all_gather_ring`."""
    s = axis_size
    flat = shard.reshape(-1)
    if s == 1:
        return flat
    msgs = flat[None].expand(s, -1).contiguous()
    return alltoall_ppermute(msgs, mesh, axis, s).reshape(-1)
