"""Trees of tensors: nested dicts, lists and tuples with a tensor (or any
other object) at each end, the port's counterpart of the reference's JAX
pytrees of params, gradients and optimizer state.  Dicts keep their
insertion order, so a tree's leaves come in a stable order."""
from __future__ import annotations


def named_leaves(tree, path: tuple = ()) -> "list[tuple[tuple, object]]":
    """``(path, leaf)`` for every leaf, depth first: a path holds the dict
    keys and sequence indices from the root."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in named_leaves(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in named_leaves(v, path + (i,))]
    return [(path, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in named_leaves(tree)]


def tree_map(fn, tree, *rest):
    """``fn(leaf, *leaves of rest at the same place)`` over ``tree``'s
    structure (``rest`` are trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def get_path(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def path_name(path: tuple) -> str:
    return "/".join(str(k) for k in path)


def tree_from_paths(like, by_path: dict, path: tuple = ()):
    """A tree of ``like``'s structure holding ``by_path[path]`` at each
    leaf."""
    if isinstance(like, dict):
        return {k: tree_from_paths(v, by_path, path + (k,))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(tree_from_paths(v, by_path, path + (i,))
                          for i, v in enumerate(like))
    return by_path[path]
