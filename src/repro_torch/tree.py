"""The reference's view of the port's trees of tensors.

The port keeps ``params["layers"]`` as a list of per-layer dicts; the
reference stacks every layer leaf into one ``[L, ...]`` array and flattens
its pytrees with ``jax.tree.flatten``, which visits dict keys in sorted
order.  Gradient buckets, the EF quantization blocks, the planner's bits and
the checkpoint's leaves all follow that order and those shapes, so the port
reads its trees the same way:

* ``leaves_with_paths(tree)`` yields ``(path, leaf)`` in ``jax.tree.flatten``
  order, each list of dicts (the layer stack) seen as one ``Stacked`` leaf
  per path inside it;
* a ``Stacked`` leaf's flat form is the concatenation of its per-layer
  flats, which is the row-major flatten of the stacked array, so buckets
  need no ``torch.stack`` copy (only the checkpointer stacks, to write);
* ``unflatten_like(template, leaves)`` inverts it, handing each layer a view
  ``leaf[i]`` of a stacked leaf.
"""

from __future__ import annotations

import torch


class Stacked:
    """The L per-layer tensors at one path of the layer stack, seen as one
    ``[L, ...]`` leaf."""

    def __init__(self, parts: list[torch.Tensor]):
        self.parts = parts

    @property
    def shape(self) -> tuple[int, ...]:
        return (len(self.parts), *self.parts[0].shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    def stack(self) -> torch.Tensor:
        return torch.stack([p.detach() for p in self.parts])


def parts(leaf) -> list[torch.Tensor]:
    """The tensors whose concatenated flats make the leaf's flat form."""
    return leaf.parts if isinstance(leaf, Stacked) else [leaf]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def leaves_with_paths(tree, prefix: tuple = ()) -> list[tuple[tuple, object]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves_with_paths(tree[k], prefix + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        if not tree or not all(isinstance(t, dict) for t in tree):
            raise TypeError(f"{'/'.join(map(str, prefix))}: only lists of per-layer "
                            f"dicts (the layer stack) are trees here")
        return [(prefix + path, Stacked([_get(t, path) for t in tree]))
                for path, _ in leaves_with_paths(tree[0])]
    return [(prefix, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def path_str(path: tuple) -> str:
    """The reference checkpoint's name of a leaf: ``['params']/['layers']/...``."""
    return "/".join(f"['{k}']" for k in path)


def unflatten_like(template, flat_leaves):
    """A tree shaped like ``template`` from leaves in ``leaves(template)``
    order; a stacked leaf ``[L, ...]`` is split into per-layer views."""
    it = iter(flat_leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            stacked = build(t[0])
            return [map_tensors(lambda a, i=i: a[i], stacked) for i in range(len(t))]
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def map_tensors(fn, *trees):
    """``fn`` over the tensors of trees of one structure (per layer)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: map_tensors(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return [map_tensors(fn, *items) for items in zip(*trees)]
    return fn(*trees)
