"""Nested dicts and lists of tensors as JAX pytrees.

The port keeps the JAX package's parameter, optimizer and train-state
trees (dicts of tensors; the hybrid family's blocks a list of dicts).
:func:`flatten` walks a tree in ``jax.tree.flatten``'s leaf order (dict
keys sorted, lists and tuples in index order), so a global norm sums its
leaves in JAX's order and a checkpoint numbers its leaves as JAX's does.
A leaf is anything that is not a dict, list or tuple.
"""

from __future__ import annotations


def flatten(tree):
    """(leaves, spec): the leaves in JAX's order and a spec that
    :func:`unflatten` rebuilds the tree from."""
    leaves = []

    def walk(node):
        if isinstance(node, dict):
            return ("dict", tuple((k, walk(node[k])) for k in sorted(node)))
        if isinstance(node, (list, tuple)):
            return (type(node).__name__, tuple(walk(x) for x in node))
        leaves.append(node)
        return None
    return leaves, walk(tree)


def unflatten(spec, leaves):
    """The tree of ``spec`` with ``leaves`` in :func:`flatten`'s order."""
    it = iter(leaves)

    def build(sp):
        if sp is None:
            return next(it)
        kind, kids = sp
        if kind == "dict":
            return {k: build(c) for k, c in kids}
        out = [build(c) for c in kids]
        return out if kind == "list" else tuple(out)
    out = build(spec)
    if next(it, None) is not None:
        raise ValueError("more leaves than the spec holds")
    return out


def flatten_up_to(spec, tree):
    """The subtrees of ``tree`` at the leaf positions of ``spec`` (JAX's
    ``treedef.flatten_up_to``): e.g. each parameter's {"m", "v"} dict of
    an optimizer state whose structure extends the parameters'."""
    out = []

    def walk(sp, node):
        if sp is None:
            out.append(node)
            return
        kind, kids = sp
        if kind == "dict":
            for k, c in kids:
                walk(c, node[k])
        else:
            for c, x in zip(kids, node, strict=True):
                walk(c, x)
    walk(spec, tree)
    return out


def leaves(tree):
    return flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees in ``rest`` (of the same structure)."""
    flat, spec = flatten(tree)
    others = [flatten(t)[0] for t in rest]
    return unflatten(spec, [fn(*xs) for xs in zip(flat, *others)])
