"""Gradient bucketing: the port of ``repro/core/bucketing.py``.

Leaves are packed into size-capped flat buckets in the reference's order and
shapes (``repro_torch.tree``: ``jax.tree.flatten``'s sorted keys, each layer
leaf one ``[L, ...]`` leaf), so a bucket here holds the same elements in the
same order as the reference's, and the planner's bits and the 1024-element
quantization blocks fall on the same values.

The apply functions run one bucket at a time and write each bucket's result
back into the given tree's tensors, and the new EF residual into the EF
tree's, in place: at full width a bucket-at-a-time pass needs a few copies of
one bucket of scratch, where the reference's flatten-all-then-apply holds
copies of the whole tree.  The numbers are the reference's.  The bucketed
all-reduce and the pipelined apply come with their sync modes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .. import tree as T


@dataclass(frozen=True)
class BucketSpec:
    """Assignment of flat leaf ranges to buckets (static, set-up time)."""

    leaf_shapes: tuple[tuple[int, ...], ...]
    leaf_buckets: tuple[int, ...]       # bucket id per leaf
    bucket_sizes: tuple[int, ...]       # elements per bucket (unpadded)
    treedef: object                     # the tree with None leaves


def plan_buckets(tree, max_bucket_bytes: int = 32 * 2**20) -> BucketSpec:
    """Greedy sequential packing of leaves into <= max_bucket_bytes buckets.

    Leaves larger than the cap get their own bucket (never split).  ``tree``
    may hold meta tensors: only shapes and dtypes are read.
    """
    leaves = T.leaves(tree)
    shapes = tuple(tuple(leaf.shape) for leaf in leaves)
    sizes = [math.prod(s) for s in shapes]
    nbytes = [sz * leaves[i].dtype.itemsize for i, sz in enumerate(sizes)]

    leaf_buckets: list[int] = []
    bucket_sizes: list[int] = []
    cur_bytes = 0
    cur_id = -1
    for i, b in enumerate(nbytes):
        if cur_id < 0 or cur_bytes + b > max_bucket_bytes:
            cur_id += 1
            bucket_sizes.append(0)
            cur_bytes = 0
        leaf_buckets.append(cur_id)
        bucket_sizes[cur_id] += sizes[i]
        cur_bytes += b
    return BucketSpec(shapes, tuple(leaf_buckets), tuple(bucket_sizes),
                      T.map_tensors(lambda _: None, tree))


def _check(leaves, spec: BucketSpec) -> None:
    if tuple(tuple(leaf.shape) for leaf in leaves) != spec.leaf_shapes:
        raise ValueError("tree leaves do not match the precomputed BucketSpec")


def _bucket_parts(leaves, spec: BucketSpec, i: int) -> list[torch.Tensor]:
    return [p for leaf, bid in zip(leaves, spec.leaf_buckets) if bid == i
            for p in T.parts(leaf)]


def _flat(parts: list[torch.Tensor], dtype=None) -> torch.Tensor:
    flat = (torch.cat([p.reshape(-1) for p in parts]) if len(parts) > 1
            else parts[0].reshape(-1))
    return flat if dtype is None else flat.to(dtype)


def _write_back(parts: list[torch.Tensor], flat: torch.Tensor) -> None:
    off = 0
    for p in parts:
        n = p.numel()
        p.copy_(flat[off:off + n].view(p.shape))
        off += n


def flatten_to_buckets(tree, spec: BucketSpec, dtype=None) -> list[torch.Tensor]:
    leaves = T.leaves(tree)
    return [_flat(_bucket_parts(leaves, spec, i), dtype)
            for i in range(len(spec.bucket_sizes))]


def unflatten_buckets(buckets: list[torch.Tensor], spec: BucketSpec, dtypes=None):
    """The tree of ``spec`` from its buckets, each leaf a view of its bucket
    (a copy where ``dtypes`` casts it)."""
    leaves = []
    offsets = [0] * len(buckets)
    for i, (shape, bid) in enumerate(zip(spec.leaf_shapes, spec.leaf_buckets)):
        n = math.prod(shape)
        seg = buckets[bid][offsets[bid]:offsets[bid] + n]
        if dtypes is not None:
            seg = seg.to(dtypes[i])
        leaves.append(seg.view(shape))
        offsets[bid] += n
    return T.unflatten_like(spec.treedef, leaves)


@torch.no_grad()
def bucketed_apply_indexed(tree, apply_fn, spec: BucketSpec, sync_dtype=None):
    """Apply ``apply_fn(flat_bucket, bucket_bytes, bucket_index) ->
    flat_bucket`` to every bucket of ``tree`` against a precomputed ``spec``
    (the amortized planning entry point), writing each result back into
    ``tree``'s tensors.  Returns ``tree``."""
    leaves = T.leaves(tree)
    _check(leaves, spec)
    for i in range(len(spec.bucket_sizes)):
        parts = _bucket_parts(leaves, spec, i)
        b = _flat(parts, sync_dtype)
        _write_back(parts, apply_fn(b, b.numel() * b.element_size(), i))
    return tree


@torch.no_grad()
def bucketed_apply_compressed(tree, ef_tree, apply_fn, spec: BucketSpec, *, bits,
                              block: int = 1024, fused: bool = False, sync_dtype=None):
    """Error-feedback-compressed bucket sync: per bucket, quantize ``grad +
    residual`` to ``bits[i]`` with per-``block`` scales, hand the dequantized
    value to ``apply_fn(flat, bucket_bytes, i)`` (the planned collective) and
    keep the quantization error as the new residual.  ``bits[i] >= 32`` is an
    exact pass-through.  ``fused=True`` runs the CUDA quantize kernel.

    ``ef_tree`` shares ``tree``'s structure.  Both are updated in place (the
    synced grads, the new residual) and returned as ``(tree, ef_tree)``.
    """
    from . import compression

    leaves = T.leaves(tree)
    _check(leaves, spec)
    if len(bits) != len(spec.bucket_sizes):
        raise ValueError(f"bits has {len(bits)} entries for {len(spec.bucket_sizes)} buckets")
    ef_leaves = T.leaves(ef_tree)
    _check(ef_leaves, spec)
    for i in range(len(spec.bucket_sizes)):
        parts = _bucket_parts(leaves, spec, i)
        ef_parts = _bucket_parts(ef_leaves, spec, i)
        b = _flat(parts, sync_dtype)
        e = _flat(ef_parts, b.dtype)
        deq, res = compression.ef_compress_blocks(b, e, bits=bits[i], block=block,
                                                  fused=fused)
        out = apply_fn(deq, deq.numel() * deq.element_size(), i)
        _write_back(ef_parts, res)
        _write_back(parts, out)
    return tree, ef_tree
