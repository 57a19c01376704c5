"""Nested containers of tensors (the JAX package's pytrees).

Containers are tuples, lists, dicts, ``GasConcs`` (its values) and
``FluxesBroadband`` (up, dn, and its Jacobian where it has one);
everything else is a leaf.  A ``CKDModel`` is
one leaf, moved whole: the column split never reaches into a model's
tables (parallel/mesh.py).
"""
from __future__ import annotations

from typing import Any, Callable, List

from ecckd_tpu_torch.fluxes import FluxesBroadband
from ecckd_tpu_torch.gases import GasConcs


def _children(tree):
    """(children, rebuild) of a container, or None for a leaf."""
    if isinstance(tree, (tuple, list)):
        return list(tree), type(tree)
    if isinstance(tree, dict):
        keys = list(tree)
        return [tree[k] for k in keys], lambda vals: dict(zip(keys, vals))
    if isinstance(tree, GasConcs):
        return list(tree.values), lambda vals: GasConcs(
            values=tuple(vals), names=tree.names)
    if isinstance(tree, FluxesBroadband):
        kids = [tree.flux_up, tree.flux_dn]
        if tree.flux_up_jac is not None:
            kids.append(tree.flux_up_jac)
        return kids, lambda v: FluxesBroadband(*v)
    return None


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and, leaf by leaf, of ``rest``,
    which have its structure), in a container of the same structure."""
    node = _children(tree)
    if node is None:
        return fn(tree, *rest)
    kids, rebuild = node
    others = [_children(t)[0] for t in rest]
    return rebuild([tree_map(fn, *xs) for xs in zip(kids, *others)])


def tree_leaves(tree) -> List[Any]:
    """The leaves of ``tree``, depth first."""
    node = _children(tree)
    if node is None:
        return [tree]
    return [leaf for kid in node[0] for leaf in tree_leaves(kid)]
