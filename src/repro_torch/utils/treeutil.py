"""Small tree utilities over nested dicts (port of
``repro/utils/treeutil.py``).

``tree_flatten_with_paths`` visits a tree of nested dicts and lists in the
order ``jax.tree_util`` flattens one (each dict's keys sorted, lists by
index) and joins the keys of each leaf's path with ``/``
(``stack/layers/attn/wq``): the keys of the reference's checkpoint files.
"""
from __future__ import annotations

import math


def tree_flatten_with_paths(tree) -> list[tuple[str, object]]:
    """[(path, leaf)] for every leaf (anything but a dict or a list), dict
    keys sorted at every level."""
    out = []

    def walk(node, prefix: str) -> None:
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}/{k}" if prefix else str(k))
        elif isinstance(node, list):
            for i, x in enumerate(node):
                walk(x, f"{prefix}/{i}" if prefix else str(i))
        else:
            out.append((prefix, node))

    walk(tree, "")
    return out


def tree_map(fn, tree: dict) -> dict:
    """``fn`` on every leaf of nested dicts, the structure kept."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_paths(tree)]


def param_count(tree) -> int:
    return sum(math.prod(x.shape) for x in tree_leaves(tree))


def param_bytes(tree) -> int:
    return sum(math.prod(x.shape) * x.element_size() for x in tree_leaves(tree))
