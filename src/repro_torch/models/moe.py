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

Under rules whose ``experts`` names a mesh axis (``activate_rules``), the
layer runs expert-parallel over that axis, each rank holding its
``E / ep`` experts (``launch.steps.local_tree``), as the JAX package's
``shard_map`` branches do:

* the psum branch (default): every EP rank routes the same local batch,
  runs its experts at the capacity of the local batch, and the outputs are
  summed with ``psum``; the aux losses are averaged with ``pmean`` over the
  mesh.  x enters through ``fan_out``, so its gradient (through the
  experts and the gates of every rank) is whole on each rank.
* the all-to-all branch (``moe_impl="a2a"``): each rank takes its block of
  the sequence, ships its tokens to the experts' owners with one
  ``all_to_all`` (``c_send`` slots a destination), runs its experts
  (``c_exp`` slots an expert) and ships the results back; the rank's
  outputs are all-gathered back into the sequence.  Under ``moe_fsdp`` the
  expert weights arrive cut on d_model over that axis and are all-gathered
  just in time; under ``moe_wire="int8"`` the wire carries int8 tokens with
  a per-token absmax scale (straight-through: the backward ships the f32
  cotangents).

A replicated parameter inside either branch (the router) gets the gradient
of this rank's share of the work; the backbone is frozen, so nothing reads
it.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import active_rules
from repro_torch.models.layers import ParamSpec


def moe_spec(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, e, f = cfg.d_model, cfg.num_experts, cfg.expert_d_ff
    return {
        "router": ParamSpec((d, e), scale=0.006, axes=("embed", None)),
        "w_gate": ParamSpec((e, d, f), axes=("experts", "embed", "expert_ff")),
        "w_up": ParamSpec((e, d, f), axes=("experts", "embed", "expert_ff")),
        "w_down": ParamSpec((e, f, d), axes=("experts", "expert_ff", "embed")),
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


def _ffn(xe: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """The grouped expert FFN over [E, C, d] slots."""
    g = torch.bmm(xe, wg)
    u = torch.bmm(xe, wu)
    h = F.silu(g.float()).to(xe.dtype) * u
    return torch.bmm(h, wd)


def _expert_core(x_flat: torch.Tensor, p: Dict[str, torch.Tensor], ids: torch.Tensor,
                 gates: torch.Tensor, capacity: int, n_experts: Optional[int] = None,
                 offset: int = 0) -> torch.Tensor:
    """Capacity dispatch -> grouped expert FFN -> gate-weighted combine over
    the experts ``p`` holds: x_flat [T, d] -> [T, d] in x's type.  ``p``
    holds every expert, or under EP the ``E_loc`` experts ``[offset, offset
    + E_loc)`` of ``n_experts``: the slots are then the global assignment's
    (a token's rank among all of the batch's assignments to its expert) and
    the output this rank's share of each token's sum (0 for tokens routed
    elsewhere)."""
    T, d = x_flat.shape
    k = ids.shape[1]
    n_local = p["w_gate"].shape[0]
    slot_of, assign_of, slot_flat = _slot_maps(ids, n_experts or n_local, capacity)
    first, n_slots = offset * capacity, n_local * capacity

    def local(slots):  # global slots -> this rank's ([0, n_slots), n_slots elsewhere)
        mine = (slots >= first) & (slots < first + n_slots)
        return torch.where(mine, slots - first, torch.full_like(slots, n_slots))

    local_of = torch.sort(local(slot_of), dim=-1).values
    assign = assign_of[first:first + n_slots]
    token_of = torch.where(assign < T * k, assign // k, torch.full_like(assign, T))
    xe = _GatherSum.apply(x_flat, token_of[:, None], local_of).view(n_local, capacity, d)
    gt = _GatherSum.apply(gates.reshape(-1, 1), assign[:, None],
                          local(slot_flat)[:, None]).view(n_local, capacity)
    ye = _ffn(xe, p["w_gate"], p["w_up"], p["w_down"])
    ye = ye * gt[..., None].to(ye.dtype)
    return _GatherSum.apply(ye.reshape(n_slots, d), local_of, token_of[:, None])


def _moe_apply_ep(p, x, cfg: ArchConfig, mesh, rules):
    """The psum branch: x [B_loc, S, d] is this rank's batch block, the same
    on every rank of the EP axis; ``p``'s experts are this rank's."""
    ep_axis = rules.lookup("experts")
    if not isinstance(ep_axis, str):
        raise ValueError(f"moe: the experts rule names one mesh axis, not {ep_axis!r}")
    B, S, d = x.shape
    n_local = cfg.num_experts // mesh.shape[ep_axis]
    cap = _capacity(B * S, cfg.top_k, cfg.num_experts, cfg.capacity_factor)
    x_flat = collectives.fan_out(x.reshape(-1, d), ep_axis, mesh)
    ids, gates, probs = _route(x_flat, p["router"], cfg.top_k)
    offset = collectives.axis_index(ep_axis, mesh) * n_local
    y = _expert_core(x_flat, p, ids, gates, cap, cfg.num_experts, offset)
    y = collectives.psum(y, ep_axis, mesh)
    aux = {k: collectives.pmean(v, mesh.axis_names, mesh)
           for k, v in _aux_losses(probs, ids, cfg.num_experts).items()}
    return y.reshape(B, S, d).to(x.dtype), aux


#: a list to which each call of the a2a branch appends this rank's dropped
#: assignments (``send``: past a destination's ``c_send`` slots; ``expert``:
#: received rows past an expert's ``c_exp`` slots), or None (no host reads)
a2a_drops: Optional[list] = None


def _ranked(keys: torch.Tensor, n_keys: int, capacity: int):
    """Slots of ``keys`` [N] (``n_keys`` marks an entry that takes none):
    each entry's slot ``key * C + rank`` by flat order (``n_keys * C`` when
    past capacity or unkeyed), and each slot's entry (``N`` where empty)."""
    _, assign_of, slot_flat = _slot_maps(keys[:, None], n_keys + 1, capacity)
    n_slots = n_keys * capacity
    return (torch.clamp(slot_flat, max=n_slots), assign_of[:n_slots])


class _Int8Wire(torch.autograd.Function):
    """The all-to-all of tokens [P, C, d] as int8 with a per-token absmax
    scale (JAX ``moe_wire="int8"``), dequantized on arrival; backward ships
    the f32 cotangents back (straight-through)."""

    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        xf = x.float()
        absmax = xf.abs().amax(dim=-1, keepdim=True) / 127.0
        q = torch.clamp(torch.round(xf / torch.clamp(absmax, min=1e-12)), -127, 127)
        rq = collectives._all_to_all(q.to(torch.int8), axis, mesh, 0, 0)
        rs = collectives._all_to_all(absmax, axis, mesh, 0, 0)
        return (rq.float() * rs).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return collectives._all_to_all(g.contiguous(), ctx.axis, ctx.mesh, 0, 0), None, None


def moe_apply_a2a(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The all-to-all branch (JAX ``moe_apply_a2a``): x [B_loc, S, d], the
    same on every rank of the EP axis; each rank takes its ``S / P`` block
    of the sequence, routes it, ships each destination its ``c_send`` slots
    with one ``all_to_all``, runs its experts at ``c_exp`` slots each, ships
    the results back and combines them at the origin; the blocks are
    all-gathered back into [B_loc, S, d].  ``p``'s experts are this rank's
    (cut on d_model over the ``moe_fsdp`` axis where that rule names one)."""
    mesh, rules = active_rules()
    ep_axis = rules.lookup("experts")
    fsdp_axis = rules.lookup("moe_fsdp")
    int8_wire = rules.lookup("moe_wire") == "int8"
    if not isinstance(ep_axis, str):
        raise ValueError(f"moe: the experts rule names one mesh axis, not {ep_axis!r}")
    P_sz = mesh.shape[ep_axis]
    n_local = cfg.num_experts // P_sz
    k = cfg.top_k
    B, S, d = x.shape
    t = B * (S // P_sz)
    c_send = max(8, int(np.ceil(t * k / P_sz * cfg.capacity_factor) + 7) // 8 * 8)
    c_recv = P_sz * c_send
    # cf is applied at dispatch; an expert's slots only need headroom for the
    # imbalance between the rank's local experts (the JAX package's rule)
    local_imbalance = 1.1 + 0.5 / np.sqrt(max(n_local, 1))
    c_exp = max(8, int(np.ceil(c_recv / n_local * local_imbalance) + 7) // 8 * 8)

    xl = collectives.split(x, ep_axis, 1, mesh)             # [B, S / P, d]
    xf = xl.reshape(t, d)
    ids, gates, probs = _route(xf, p["router"], k)
    # dispatch: each assignment's slot at its owner, in flat order
    slot_of, assign_of, slot_flat = _slot_maps(ids // n_local, P_sz, c_send)
    valid = assign_of < t * k
    tok = torch.where(valid, assign_of // k, torch.full_like(assign_of, t))
    send_x = _GatherSum.apply(xf, tok[:, None], slot_of).view(P_sz, c_send, d)
    s_eid = torch.where(valid, (ids % n_local).reshape(-1)[assign_of.clamp(max=t * k - 1)],
                        torch.zeros_like(assign_of))
    s_gate = _GatherSum.apply(gates.reshape(-1, 1), assign_of[:, None], slot_flat[:, None])
    if int8_wire:
        rx = _Int8Wire.apply(send_x, ep_axis, mesh)
    else:
        rx = collectives.all_to_all(send_x, ep_axis, 0, 0, mesh)
    r_gate = collectives.all_to_all(s_gate.view(P_sz, c_send), ep_axis, 0, 0, mesh)
    with torch.no_grad():
        r_eid = collectives._all_to_all(s_eid.view(P_sz, c_send), ep_axis, mesh, 0, 0)
        r_valid = collectives._all_to_all(valid.to(torch.int32).view(P_sz, c_send),
                                          ep_axis, mesh, 0, 0)
    rxf = rx.reshape(c_recv, d)
    flat_rgate = r_gate.reshape(-1) * r_valid.reshape(-1).float()
    # the local experts' slots over the received rows (rows whose gate is 0 take none)
    keys = torch.where(flat_rgate > 0, r_eid.reshape(-1).long(),
                       torch.full_like(r_eid.reshape(-1).long(), n_local))
    e_slot, e_row = _ranked(keys, n_local, c_exp)
    if a2a_drops is not None:  # host reads, only when asked for
        a2a_drops.append({"send": int((slot_flat == c_recv).sum()),
                          "expert": int(((e_slot == n_local * c_exp) & (keys < n_local)).sum()),
                          "c_send": c_send, "c_exp": c_exp})
    wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]
    if fsdp_axis:
        wg = collectives.all_gather(wg, fsdp_axis, 1, mesh)
        wu = collectives.all_gather(wu, fsdp_axis, 1, mesh)
        wd = collectives.all_gather(wd, fsdp_axis, 2, mesh)
    xe = _GatherSum.apply(rxf, e_row[:, None], e_slot[:, None]).view(n_local, c_exp, d)
    ye = _ffn(xe, wg, wu, wd)
    back = _GatherSum.apply(ye.reshape(n_local * c_exp, d), e_slot[:, None], e_row[:, None])
    back = back * flat_rgate[:, None].to(back.dtype)
    ret = collectives.all_to_all(back.view(P_sz, c_send, d), ep_axis, 0, 0, mesh)
    y = _GatherSum.apply(ret.reshape(c_recv, d), slot_of, tok[:, None])
    y = collectives.all_gather(y.view(B, S // P_sz, d), ep_axis, 1, mesh,
                               cotangent="replicated")
    aux = {kk: collectives.pmean(v, mesh.axis_names, mesh)
           for kk, v in _aux_losses(probs, ids, cfg.num_experts).items()}
    return y.to(x.dtype), aux


def moe_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, S, d] -> (y [B, S, d] in x's type, {"moe_load_balance",
    "moe_max_frac"}).  Under active rules whose ``experts`` names an axis,
    the expert-parallel branches (``moe_impl="a2a"``: all-to-all), with
    ``p``'s experts this rank's; else every expert local."""
    mesh, rules = active_rules()
    if mesh is not None and rules is not None and rules.lookup("experts") is not None:
        if rules.lookup("moe_impl") == "a2a":
            return moe_apply_a2a(p, x, cfg)
        return _moe_apply_ep(p, x, cfg, mesh, rules)
    B, S, d = x.shape
    x_flat = x.reshape(-1, d)
    ids, gates, probs = _route(x_flat, p["router"], cfg.top_k)
    cap = _capacity(x_flat.shape[0], cfg.top_k, cfg.num_experts, cfg.capacity_factor)
    y = _expert_core(x_flat, p, ids, gates, cap)
    aux = _aux_losses(probs, ids, cfg.num_experts)
    return y.reshape(B, S, d).to(x.dtype), aux
