"""Fine-grained MoE: token-choice top-k routing with per-expert capacity
(port of ``repro.models.moe``, its local branch on one device).

Every token of the batch, padding and free decode-pool rows included,
routes and competes for the same ``_capacity`` slots of each expert, so one
tenant's tokens can drop another's.  A token's slot in an expert is its
rank in the flattened ``[T * top_k]`` order of the routed ids; tokens past
capacity are dropped.  The expert FFN runs at full capacity, empty slots
included, as three batched products over ``[E, C, d]``.

Routing follows the JAX package bit for bit: the router product runs in
full f32 (TF32 off, whatever the caller set), and ties between expert
probabilities break toward the lower expert index (the first ``top_k`` of
a stable descending sort, as ``jax.lax.top_k``).

Dispatch and combine are gathers, deterministic on the card: neither
direction uses an atomic scatter.  A token's expert outputs are summed in
ascending expert order, the order in which the JAX package's scatter-add
applies the ``[E, C]`` updates; each direction's backward is the other
direction's gather (:class:`_GatherSum`).

The expert-parallel branches of the JAX package (``shard_map`` over the
experts and the all-to-all dispatch) are multi-device and not ported.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig
from repro_torch.models.layers import ParamSpec


def moe_spec(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, e, f = cfg.d_model, cfg.num_experts, cfg.expert_d_ff
    return {
        "router": ParamSpec((d, e), scale=0.006),
        "w_gate": ParamSpec((e, d, f)),
        "w_up": ParamSpec((e, d, f)),
        "w_down": ParamSpec((e, f, d)),
    }


def _capacity(tokens: int, top_k: int, n_experts: int, cf: float) -> int:
    c = int(np.ceil(tokens * top_k / n_experts * cf))
    return max(8, (c + 7) // 8 * 8)


@contextlib.contextmanager
def _full_f32(t: torch.Tensor):
    """f32 products in full precision on the card (TF32 off) for the block."""
    if not t.is_cuda:
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class _RouterLogits(torch.autograd.Function):
    """``x_f32 @ w_f32`` with both directions' products in full f32."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        with _full_f32(x):
            return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with _full_f32(g):
            dx = g @ w.t() if ctx.needs_input_grad[0] else None
            dw = x.t() @ g if ctx.needs_input_grad[1] else None
        return dx, dw


def _route(x_flat: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """Top-k routing with renormalised softmax gates (deepseek / qwen style):
    (ids [T, k] int32, gates [T, k] f32, probs [T, E] f32)."""
    logits = _RouterLogits.apply(x_flat.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    ids = torch.sort(probs.detach(), dim=-1, descending=True, stable=True).indices[:, :top_k]
    gate_vals = probs.gather(-1, ids)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return ids.to(torch.int32), gate_vals, probs


def _aux_losses(probs: torch.Tensor, ids: torch.Tensor, n_experts: int
                ) -> Dict[str, torch.Tensor]:
    """Switch-style load balance ``E * sum(frac_tokens * frac_probs)`` (the
    token fractions carry no gradient) and the busiest expert's share."""
    counts = torch.bincount(ids.reshape(-1).long(), minlength=n_experts).float()
    frac_tokens = counts / torch.clamp(counts.sum(), min=1.0)
    frac_probs = probs.mean(dim=0)
    lb = n_experts * torch.sum(frac_tokens * frac_probs)
    return {"moe_load_balance": lb, "moe_max_frac": frac_tokens.max()}


def _gather_sum(src: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``out[i] = src_pad[index[i, 0]] + src_pad[index[i, 1]] + ...`` summed
    left to right in ``src``'s type, where ``src_pad`` is ``src`` with a zero
    row appended (``index == len(src)`` reads it)."""
    pad = torch.cat([src, src.new_zeros((1,) + tuple(src.shape[1:]))])
    rows = pad[index]
    acc = rows[:, 0]
    for j in range(1, index.shape[1]):
        acc = acc + rows[:, j]
    return acc


class _GatherSum(torch.autograd.Function):
    """:func:`_gather_sum` by ``index``, whose backward is the gather-sum of
    the incoming gradient by ``back`` (the adjoint map: ``back[j]`` lists
    the output rows that read source row ``j``).  No atomics either way."""

    @staticmethod
    def forward(ctx, src, index, back):
        ctx.save_for_backward(back)
        return _gather_sum(src, index)

    @staticmethod
    def backward(ctx, g):
        (back,) = ctx.saved_tensors
        return _gather_sum(g.contiguous(), back), None, None


def _slot_maps(ids: torch.Tensor, n_experts: int, capacity: int):
    """The capacity assignment of the routed ids [T, k]: ``slot_of`` [T, k],
    each token's slots ``e * C + rank`` in ascending expert order (``E * C``
    where dropped); ``assign_of`` [E * C], the flat ``[T * k]`` assignment
    each slot holds (``T * k`` where empty); and ``slot_flat`` [T * k], each
    assignment's slot in flat order."""
    T, k = ids.shape
    dev = ids.device
    flat = ids.reshape(-1).long()
    order = torch.sort(flat, stable=True).indices        # by expert, then flat order
    counts = torch.bincount(flat, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts
    e_sorted = flat[order]
    rank_sorted = torch.arange(T * k, device=dev) - starts[e_sorted]
    kept = rank_sorted < capacity
    dropped = n_experts * capacity
    slot_sorted = torch.where(kept, e_sorted * capacity + rank_sorted,
                              torch.full_like(rank_sorted, dropped))
    slot_flat = torch.empty_like(slot_sorted)
    slot_flat[order] = slot_sorted                      # a permutation: no collisions
    assign_of = torch.full((dropped + 1,), T * k, dtype=torch.long, device=dev)
    assign_of[slot_flat] = torch.arange(T * k, device=dev)
    slot_of = torch.sort(slot_flat.reshape(T, k), dim=-1).values
    return slot_of, assign_of[:dropped], slot_flat


def dropped_tokens(ids: torch.Tensor, n_experts: int, capacity: int) -> int:
    """Routed assignments past their expert's capacity (a host read)."""
    counts = torch.bincount(ids.reshape(-1).long(), minlength=n_experts)
    return int((counts - capacity).clamp(min=0).sum().item())


def _expert_core(x_flat: torch.Tensor, p: Dict[str, torch.Tensor], ids: torch.Tensor,
                 gates: torch.Tensor, capacity: int) -> torch.Tensor:
    """Capacity dispatch -> grouped expert FFN -> gate-weighted combine, all
    experts local: x_flat [T, d] -> [T, d] in x's type."""
    T, d = x_flat.shape
    k = ids.shape[1]
    E = p["w_gate"].shape[0]
    slot_of, assign_of, slot_flat = _slot_maps(ids, E, capacity)
    token_of = torch.where(assign_of < T * k, assign_of // k, torch.full_like(assign_of, T))
    xe = _GatherSum.apply(x_flat, token_of[:, None], slot_of).view(E, capacity, d)
    gt = _GatherSum.apply(gates.reshape(-1, 1), assign_of[:, None],
                          slot_flat[:, None]).view(E, capacity)

    g = torch.bmm(xe, p["w_gate"])
    u = torch.bmm(xe, p["w_up"])
    h = F.silu(g.float()).to(xe.dtype) * u
    ye = torch.bmm(h, p["w_down"])                      # [E, C, d]
    ye = ye * gt[..., None].to(ye.dtype)
    return _GatherSum.apply(ye.reshape(E * capacity, d), slot_of, token_of[:, None])


def moe_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, S, d] -> (y [B, S, d] in x's type, {"moe_load_balance",
    "moe_max_frac"})."""
    B, S, d = x.shape
    x_flat = x.reshape(-1, d)
    ids, gates, probs = _route(x_flat, p["router"], cfg.top_k)
    cap = _capacity(x_flat.shape[0], cfg.top_k, cfg.num_experts, cfg.capacity_factor)
    y = _expert_core(x_flat, p, ids, gates, cap)
    aux = _aux_losses(probs, ids, cfg.num_experts)
    return y.reshape(B, S, d).to(x.dtype), aux
