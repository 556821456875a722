"""AdamW for adapter trees (port of ``repro.train.optimizer``).

Trees are nested dicts of tensors.  Integer leaves (Diff-Pruning's row
masks) are structural: they have ``None`` moments, take no gradient and
get no update.  ``lr_scales`` supports per-task
learning rates: a tree (same structure) of broadcastable multipliers, e.g.
per-task lr vectors expanded along each leaf's task axis.  ``step_counts``
gives each slot its own bias correction.  Rounding follows the JAX package:
moments and the update are f32, the update is cast to the parameter's type
and added in that type.
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor  # [] int32, global update count
    m: Any
    v: Any


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Map over the leaves of nested dicts; ``None`` leaves of ``tree`` stay
    ``None``.  Every tree in ``rest`` has ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_unflatten(tree: Any, leaves: List[torch.Tensor]) -> Any:
    """``tree``'s structure with its leaves replaced, in ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def adamw_init(params: Any) -> AdamWState:
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32) if p.is_floating_point() else None

    dev = tree_leaves(params)[0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      tree_map(zeros, params), tree_map(zeros, params))


def adamw_update(
    grads: Any,
    state: AdamWState,
    params: Any,
    lr: float = 1e-4,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    lr_scales: Optional[Any] = None,
    step_counts: Optional[Any] = None,
):
    """``step_counts``: optional tree (same structure as ``params``) of
    broadcastable per-slot update counts, already incremented for this
    update.  Bias correction then uses each slot's own count instead of the
    global step, so a task fused with others optimizes exactly as it would
    alone.  Returns ``(updates, new_state)``."""
    step = state.step + 1
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()

    def upd(p, g, m, v, s, n):
        if m is None:  # an integer leaf
            return None, None, None
        gf = g.float()
        m2 = b1 * m + (1 - b1) * gf
        v2 = b2 * v + (1 - b2) * gf * gf
        if n is None:
            k1, k2 = c1, c2
        else:
            nf = n.float().clamp_min(1.0)
            k1 = 1.0 - b1 ** nf
            k2 = 1.0 - b2 ** nf
        u = (m2 / k1) / (torch.sqrt(v2 / k2) + eps) + weight_decay * p.float()
        scale = lr if s is None else lr * s
        return (-scale * u).to(p.dtype), m2, v2

    none = tree_map(lambda _: None, params)
    out = tree_map(upd, params, grads, state.m, state.v,
                   none if lr_scales is None else lr_scales,
                   none if step_counts is None else step_counts)
    return _part(out, 0), AdamWState(step, _part(out, 1), _part(out, 2))


def _part(tree: Any, i: int) -> Any:
    """The i-th entry of every (update, m, v) leaf triple."""
    if isinstance(tree, dict):
        return {k: _part(v, i) for k, v in tree.items()}
    return tree[i]


def apply_updates(params: Any, updates: Any) -> Any:
    return tree_map(lambda p, u: p if u is None else p + u.to(p.dtype), params, updates)
