"""Parameter trees as the JAX package walks them.

The port's parameters, optimizer states and train states are nested dicts
of tensors (a :class:`~repro_torch.train.step.TrainState` is a dataclass of
them).  ``jax.tree.leaves`` visits a dict's keys in sorted order and a
dataclass's fields in their declared order; the train step's gradient norm
sums its leaves in that order (the order of an f32 sum moves its last bit),
and the checkpoint manager names each leaf by its path, as the JAX
package's does.
"""
from __future__ import annotations

import dataclasses


def leaves_with_paths(tree, prefix=()):
    """(path, leaf) pairs in JAX's leaf order: dict keys sorted, dataclass
    fields and list items in order, None an empty subtree; anything else is
    a leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], (*prefix, k))
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from leaves_with_paths(getattr(tree, f.name), (*prefix, f.name))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, (*prefix, i))
    else:
        yield prefix, tree


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def get(tree, path):
    """The subtree of ``tree`` at ``path`` (keys, indices, field names)."""
    for key in path:
        tree = tree[key] if isinstance(tree, (dict, list, tuple)) else getattr(tree, key)
    return tree


def map_leaves(fn, tree, prefix=None):
    """``tree`` with every leaf replaced by ``fn(leaf)`` (dicts, lists,
    tuples and dataclasses rebuilt, None kept); ``fn(path, leaf)`` if
    ``prefix`` is given (the path of ``tree`` itself, ``()`` at the root)."""
    def one(k, v):
        return map_leaves(fn, v, None if prefix is None else (*prefix, k))

    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: one(k, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: one(f.name, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, (list, tuple)):
        return type(tree)(one(i, v) for i, v in enumerate(tree))
    return fn(tree) if prefix is None else fn(prefix, tree)


def put(tree: dict, path, value) -> None:
    """Set ``value`` at ``path`` of a nested dict, making the dicts on the
    way."""
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value
