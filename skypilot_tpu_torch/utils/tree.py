"""Nested parameter and state trees as flat ``'a/b/c'``-keyed dicts, the
leaf names of the JAX pytrees ('embed', 'layers/wq', 'opt_state/mu/...')."""
from __future__ import annotations

from typing import Any, Dict


def flatten(tree: Dict[str, Any], prefix: str = '') -> Dict[str, Any]:
    """{'layers': {'wq': x}} -> {'layers/wq': x}, in the tree's order."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flatten(value, f'{prefix}{key}/'))
        else:
            out[prefix + key] = value
    return out


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of ``flatten``."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        *parents, last = key.split('/')
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = value
    return tree
