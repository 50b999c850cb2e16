"""Trees of parameters: nested dicts and lists whose leaves are tensors.

The port keeps the JAX package's leaf names, with one dict per layer in a
list under ``"blocks"`` where the JAX tree stacks the layers on a leading
axis.  These helpers walk such trees in a fixed order (dict insertion
order, then list order), so two trees of one structure zip leaf by leaf.
"""

from __future__ import annotations


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of ``tree`` (and of same-shaped ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_paths(tree, prefix: tuple = ()) -> list[tuple]:
    """The path of every leaf (dict keys and list indices), in leaf order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in tree_paths(v, prefix + (k,))]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in tree_paths(v, prefix + (i,))]
    return [prefix]
