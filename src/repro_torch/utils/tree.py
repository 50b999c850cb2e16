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


# ---------------------------------------------------------------------------
# path-aware walks over whole states
# ---------------------------------------------------------------------------
#
# The checkpoint layer walks a whole ``TrainState``: NamedTuples (``TrainState``,
# ``AdamWState``, ``Fp8State``) as well as dicts and lists.  As in the JAX
# package's ``utils/pytree.py``, a leaf's path is its keys joined by ``/``
# (dict keys, list indices, NamedTuple field names, as ``GetAttrKey`` names
# them) and ``None`` is an empty subtree: it holds no leaf and maps to itself.


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map_with_path(fn, tree, prefix: str = ""):
    """Rebuild ``tree`` with every leaf replaced by ``fn(path, leaf)``; dicts,
    lists and NamedTuples keep their types, ``None`` stays ``None``.  A
    plain recursion: a nested walk that calls itself would sit in a
    reference cycle with ``fn``, and with whatever ``fn`` holds (the leaves
    ``flatten_with_paths`` collects), until the cyclic collector runs."""

    def sub(key):
        return f"{prefix}/{key}" if prefix else str(key)

    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, sub(k)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, sub(i)) for i, v in enumerate(tree)]
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map_with_path(fn, getattr(tree, f), sub(f)) for f in tree._fields))
    return fn(prefix, tree)


def flatten_with_paths(tree) -> list[tuple[str, object]]:
    """``(path, leaf)`` for every leaf of ``tree``, in walk order (dict
    insertion order; the JAX package sorts dict keys, so compare by path)."""
    out = []
    tree_map_with_path(lambda p, x: out.append((p, x)), tree)
    return out


def tree_size_bytes(tree) -> int:
    """Total bytes of the tensor leaves of ``tree``."""
    return sum(x.numel() * x.element_size() for _, x in flatten_with_paths(tree))
