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
    return leaves, _flatten(tree, leaves)


# the walks are module functions, not recursive closures: a closure that
# calls itself is a reference cycle holding the list it fills (here the
# leaves, tensors of a whole tree) until the cyclic collector runs


def _flatten(node, leaves):
    if isinstance(node, dict):
        return ("dict", tuple((k, _flatten(node[k], leaves))
                              for k in sorted(node)))
    if isinstance(node, (list, tuple)):
        return (type(node).__name__, tuple(_flatten(x, leaves)
                                           for x in node))
    leaves.append(node)
    return None


def unflatten(spec, leaves):
    """The tree of ``spec`` with ``leaves`` in :func:`flatten`'s order."""
    it = iter(leaves)
    out = _build(spec, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the spec holds")
    return out


def _build(sp, it):
    if sp is None:
        return next(it)
    kind, kids = sp
    if kind == "dict":
        return {k: _build(c, it) for k, c in kids}
    out = [_build(c, it) for c in kids]
    return out if kind == "list" else tuple(out)


def flatten_up_to(spec, tree):
    """The subtrees of ``tree`` at the leaf positions of ``spec`` (JAX's
    ``treedef.flatten_up_to``): e.g. each parameter's {"m", "v"} dict of
    an optimizer state whose structure extends the parameters'."""
    out = []
    _walk_up_to(spec, tree, out)
    return out


def _walk_up_to(sp, node, out):
    if sp is None:
        out.append(node)
        return
    kind, kids = sp
    if kind == "dict":
        for k, c in kids:
            _walk_up_to(c, node[k], out)
    else:
        for c, x in zip(kids, node, strict=True):
            _walk_up_to(c, x, out)


def leaves(tree):
    return flatten(tree)[0]


def leaves_with_paths(tree, path=""):
    """(path, leaf) pairs in :func:`flatten`'s order, a path's dict keys
    and list indices joined by "/" (e.g. ``/dec_blocks/x_bk``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaves_with_paths(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in leaves_with_paths(t, f"{path}/{i}")]
    return [(path, tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees in ``rest`` (of the same structure)."""
    flat, spec = flatten(tree)
    others = [flatten(t)[0] for t in rest]
    return unflatten(spec, [fn(*xs) for xs in zip(flat, *others)])
