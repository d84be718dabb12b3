"""Pytree flatten/unflatten with the reference's leaf order and names.

The checkpoint format identifies leaves by name and writes them in flatten
order (the shard round-robin and the manifest follow it), so both must
match ``jax.tree_util.tree_flatten_with_path`` + ``_path_str`` exactly:

- containers are dict, list and tuple; ``None`` is an empty subtree;
  anything else is a leaf;
- dict keys are visited in **sorted** order (``torch.utils._pytree`` keeps
  insertion order, which would reorder the leaves);
- a leaf's name is its path keys joined by ``/`` (dict keys as ``str``,
  sequence positions as their index), and ``<root>`` for a bare leaf.
"""

from __future__ import annotations

from typing import Any, List, Tuple

# A treedef is a nested tuple: ("leaf",), ("none",), ("dict", keys, kids),
# ("list", kids) or ("tuple", kids).
TreeDef = Tuple


def _flatten(tree, path, out) -> TreeDef:
    if tree is None:
        return ("none",)
    if isinstance(tree, dict):
        keys = sorted(tree)
        kids = tuple(_flatten(tree[k], path + (str(k),), out) for k in keys)
        return ("dict", tuple(keys), kids)
    if isinstance(tree, (list, tuple)):
        kids = tuple(_flatten(v, path + (str(i),), out)
                     for i, v in enumerate(tree))
        return ("list" if isinstance(tree, list) else "tuple", kids)
    out.append(("/".join(path) if path else "<root>", tree))
    return ("leaf",)


def flatten_with_names(tree) -> Tuple[List[Tuple[str, Any]], TreeDef]:
    """``([(name, leaf), ...], treedef)`` in the reference's leaf order."""
    out: List[Tuple[str, Any]] = []
    treedef = _flatten(tree, (), out)
    return out, treedef


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_names(tree)[0]]


def unflatten(treedef: TreeDef, leaves_: List[Any]):
    """Inverse of :func:`flatten_with_names`."""
    it = iter(leaves_)

    def build(td):
        kind = td[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(c) for k, c in zip(td[1], td[2])}
        kids = [build(c) for c in td[1]]
        return kids if kind == "list" else tuple(kids)

    out = build(treedef)
    if next(it, _END) is not _END:
        raise ValueError("unflatten: more leaves than the treedef holds")
    return out


_END = object()
