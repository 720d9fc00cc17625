"""Trees of tensors: nested dicts, lists, tuples and NamedTuples, the
port's counterpart of the pytrees ``repro`` passes around (params, the
optimizer state, batches)."""

from __future__ import annotations


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """``(keys, values, rebuild)`` of a container node, or None for a
    leaf. Keys follow ``jax.tree_util``'s paths: sorted dict keys,
    sequence positions, NamedTuple field names. A type that sets
    ``_tree_leaf`` (``_spec.PSpec``) is a leaf."""
    if getattr(type(tree), "_tree_leaf", False):
        return None
    if isinstance(tree, dict):
        keys = sorted(tree)
        return keys, [tree[k] for k in keys], lambda vs: dict(zip(keys, vs))
    if _is_namedtuple(tree):
        return (list(tree._fields), list(tree),
                lambda vs: type(tree)(*vs))
    if isinstance(tree, (list, tuple)):
        return (list(range(len(tree))), list(tree),
                lambda vs: type(tree)(vs))
    return None


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure). ``None`` is an empty node."""
    if tree is None:
        return None
    node = _children(tree)
    if node is None:
        return fn(tree, *rest)
    keys, vals, rebuild = node
    others = [[r[k] for k in keys] if isinstance(r, dict) else list(r)
              for r in rest]
    return rebuild([tree_map(fn, v, *(o[i] for o in others))
                    for i, v in enumerate(vals)])


def tree_flatten_with_path(tree, prefix=()) -> list:
    """``[(path, leaf)]`` in ``jax.tree_util`` order; a path is a tuple of
    dict keys, positions and field names."""
    if tree is None:
        return []
    node = _children(tree)
    if node is None:
        return [(prefix, tree)]
    keys, vals, _ = node
    out = []
    for k, v in zip(keys, vals):
        out += tree_flatten_with_path(v, prefix + (k,))
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_unflatten(template, leaves):
    """``leaves`` (in :func:`tree_leaves` order) in ``template``'s
    structure."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), template)
    rest = list(it)
    if rest:
        raise ValueError(f"{len(rest)} leaves left over for the template")
    return out
