"""Named-axis collectives over a mesh, and compressed gradient reduction
(port of ``repro.distributed.collectives``).

**Named-axis collectives.**  The port runs explicit SPMD: a rank holds
local tensors, and a collective names the mesh axes it runs over, as the
body of a JAX ``shard_map`` does.  ``mesh`` defaults to the active one
(``repro_torch.distributed.sharding.activate_rules``).  Each collective on a
gradient path is a ``torch.autograd.Function`` whose backward makes the
multi-rank gradient equal to the single-rank function's gradient, under
one convention: the loss is computed once, redundantly on every rank that
holds it, so the cotangent of a replicated value arrives *replicated* (the
whole of it on each rank), and the cotangent of a rank's block is that
block's.  A value that every rank holds but that feeds different work on
each (a gathered k/v under different local queries) has a *partial*
cotangent on each rank, whose sum over the ranks is its gradient; the
backwards below say which they take.

==============  =====================================  ==========================
collective      forward                                backward
==============  =====================================  ==========================
``psum``        sum over the axis (partial -> repl.)   identity (cotangent repl.)
``pmean``       mean over the axis                     cotangent / axis size
``fan_out``     identity (repl. -> feeds per-rank)     psum of the partial cot.
``all_gather``  blocks -> the tiled whole              reduce-scatter (partial
                                                       cotangent), or this rank's
                                                       slice (``cotangent=
                                                       "replicated"``)
``split``       the whole -> this rank's block         all-gather of the blocks
``all_to_all``  tiled exchange along ``split_axis``    all-to-all back (split and
                                                       concat axes swapped)
``ppermute``    moves blocks along ``perm``            the inverse permutation
==============  =====================================  ==========================

``pmax`` and ``axis_index`` take no gradient.

**Gloo on CUDA tensors.**  ``GLOO_CUDA_OPS`` says, for each primitive the
collectives use, whether gloo takes a CUDA tensor directly; it was checked
on an H100 (``chip_smoke.py``'s ``gloo_probe`` holds every direct entry to
it at each run).  A primitive marked ``False`` runs on a pinned host copy
made here, explicitly, and its bytes are counted in ``staged_bytes``.  The
route is read from the table, never chosen by catching an error.  On NCCL
and on CPU tensors every primitive runs directly.

``collective_bytes`` counts each primitive's payload on this rank (the
bytes it puts on the wire: its input), ``staged_bytes`` the bytes copied
through host memory for the staged primitives (out and back);
:func:`reset_counters` sets both to 0.

**Compressed reduction** (JAX ``collectives.py:26-91``):
``quantize_int8`` (bit-equal to the JAX function), ``dequantize_int8``,
``int8_psum``, ``exact_int8_psum``, ``psum_tree(compress=...)`` and
``compression_error``.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
import torch.distributed as dist

# gloo's support for CUDA tensors, by primitive (checked on an H100 under
# torch 2.11; ``chip_smoke.py``'s gloo_probe runs each True entry directly
# on CUDA tensors at every run).  send / recv hand gloo the raw pointer as
# host memory, so they are staged without being probed.
GLOO_CUDA_OPS: Dict[str, bool] = {
    "all_reduce": True,
    "all_gather": True,
    "all_to_all": True,
    "send_recv": False,
}

collective_bytes: Dict[str, int] = {}
staged_bytes: Dict[str, int] = {}


def reset_counters() -> None:
    collective_bytes.clear()
    staged_bytes.clear()


def _count(table: Dict[str, int], op: str, nbytes: int) -> None:
    table[op] = table.get(op, 0) + int(nbytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _mesh(mesh):
    if mesh is None:
        from repro_torch.distributed.sharding import active_rules

        mesh = active_rules()[0]
    if mesh is None:
        raise RuntimeError("a named-axis collective needs a mesh (none given or active)")
    return mesh


def _staged(mesh, t: torch.Tensor, op: str) -> bool:
    return mesh.backend == "gloo" and t.is_cuda and not GLOO_CUDA_OPS[op]


def _to_host(t: torch.Tensor, op: str) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    _count(staged_bytes, op, _nbytes(t))
    return h


def _from_host(h: torch.Tensor, like: torch.Tensor, op: str) -> torch.Tensor:
    _count(staged_bytes, op, _nbytes(h))
    return h.to(like.device)


# ---------------------------------------------------------------------------
# Primitives (no autograd): each runs in this rank's group along ``axes``
# ---------------------------------------------------------------------------


def _all_reduce(x: torch.Tensor, axes, mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: ``x`` reduced over the group.  bf16 / f16 reduce in f32
    (cast back after)."""
    pg, ranks = mesh.group(axes)
    wide = x.dtype in (torch.bfloat16, torch.float16)
    buf = x.float() if wide else x.clone()
    if pg is not None:
        _count(collective_bytes, "all_reduce", _nbytes(buf))
        if _staged(mesh, buf, "all_reduce"):
            h = _to_host(buf, "all_reduce")
            dist.all_reduce(h, op=op, group=pg)
            buf = _from_host(h, buf, "all_reduce")
        else:
            dist.all_reduce(buf, op=op, group=pg)
    return buf.to(x.dtype) if wide else buf


def _all_gather(x: torch.Tensor, axes, mesh, dim: int) -> torch.Tensor:
    """The group's blocks concatenated along ``dim`` in axis order."""
    pg, ranks = mesh.group(axes)
    if pg is None:
        return x
    x = x.contiguous()
    _count(collective_bytes, "all_gather", _nbytes(x))
    staged = _staged(mesh, x, "all_gather")
    src = _to_host(x, "all_gather") if staged else x
    parts = [torch.empty_like(src) for _ in ranks]
    dist.all_gather(parts, src, group=pg)
    out = torch.cat(parts, dim=dim)
    return _from_host(out, x, "all_gather") if staged else out


def _all_to_all(x: torch.Tensor, axes, mesh, split_axis: int, concat_axis: int) -> torch.Tensor:
    """Block ``j`` of ``x`` along ``split_axis`` goes to the group's ``j``-th
    rank; the blocks received are concatenated along ``concat_axis`` in
    sender order (JAX ``all_to_all(..., tiled=True)``)."""
    pg, ranks = mesh.group(axes)
    if pg is None:
        return x
    n = len(ranks)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} ({x.shape[split_axis]}) over {n} ranks")
    # send buffer: [n, ...block...] with the block's split_axis chunk
    blocks = torch.stack(torch.chunk(x, n, dim=split_axis)).contiguous()
    _count(collective_bytes, "all_to_all", _nbytes(blocks))
    staged = _staged(mesh, blocks, "all_to_all")
    src = _to_host(blocks, "all_to_all") if staged else blocks
    recv = torch.empty_like(src)
    dist.all_to_all_single(recv, src, group=pg)
    if staged:
        recv = _from_host(recv, blocks, "all_to_all")
    return torch.cat(list(recv.unbind(0)), dim=concat_axis)


def _ppermute(x: torch.Tensor, axes, mesh, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``x`` from axis index ``src`` lands on ``dst`` for each (src, dst) of
    ``perm``; a rank that receives nothing gets zeros (JAX ``ppermute``)."""
    pg, ranks = mesh.group(axes)
    if pg is None:
        return x.clone() if (0, 0) in perm else torch.zeros_like(x)
    me = mesh.axis_index(axes)
    send_to = [d for s, d in perm if s == me]
    recv_from = [s for s, d in perm if d == me]
    x = x.contiguous()
    staged = _staged(mesh, x, "send_recv")
    src = _to_host(x, "send_recv") if staged else x
    out = torch.zeros_like(src)
    ops = []
    for d in send_to:
        _count(collective_bytes, "send_recv", _nbytes(x))
        if d == me:
            out.copy_(src)
        else:
            ops.append(dist.P2POp(dist.isend, src, ranks[d], group=pg))
    for s in recv_from:
        if s != me:
            ops.append(dist.P2POp(dist.irecv, out, ranks[s], group=pg))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return _from_host(out, x, "send_recv") if staged else out


def all_gather_nograd(x: torch.Tensor, axes, mesh, dim: int) -> torch.Tensor:
    """``all_gather`` outside autograd (``sharding.gather_blocks``)."""
    with torch.no_grad():
        return _all_gather(x, axes, mesh, dim)


# ---------------------------------------------------------------------------
# Differentiable collectives
# ---------------------------------------------------------------------------


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        return _all_reduce(x, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _FanOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.axes, ctx.mesh), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, dim, partial):
        ctx.axes, ctx.mesh, ctx.dim, ctx.partial = axes, mesh, dim, partial
        ctx.block = x.shape[dim]
        return _all_gather(x, axes, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:  # reduce-scatter: the sum of the partial cotangents, my block
            g = _all_reduce(g.contiguous(), ctx.axes, ctx.mesh)
        i = ctx.mesh.axis_index(ctx.axes)
        return g.narrow(ctx.dim, i * ctx.block, ctx.block), None, None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, dim):
        ctx.axes, ctx.mesh, ctx.dim = axes, mesh, dim
        n = mesh.axis_size(axes)
        if x.shape[dim] % n:
            raise ValueError(f"split: dim {dim} ({x.shape[dim]}) over {n} ranks")
        size = x.shape[dim] // n
        return x.narrow(dim, mesh.axis_index(axes) * size, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g.contiguous(), ctx.axes, ctx.mesh, ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, split_axis, concat_axis):
        ctx.args = (axes, mesh, split_axis, concat_axis)
        return _all_to_all(x, axes, mesh, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        axes, mesh, split_axis, concat_axis = ctx.args
        return _all_to_all(g.contiguous(), axes, mesh, concat_axis, split_axis), \
            None, None, None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, perm):
        ctx.axes, ctx.mesh, ctx.perm = axes, mesh, perm
        return _ppermute(x, axes, mesh, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((d, s) for s, d in ctx.perm)
        return _ppermute(g.contiguous(), ctx.axes, ctx.mesh, inverse), None, None, None


def psum(x: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    """Sum over ``axis`` (a name or a tuple of names): partial summands in,
    the replicated sum out.  Backward: the cotangent arrives replicated (the
    loss is computed once, on every rank), so each summand's gradient is the
    cotangent itself."""
    return _Psum.apply(x, axis, _mesh(mesh))


def pmean(x: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    """Mean over ``axis``; backward: the replicated cotangent over the axis
    size (each rank's share of the mean)."""
    mesh = _mesh(mesh)
    return psum(x, axis, mesh) / mesh.axis_size(axis)


def pmax(x: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    """Elementwise maximum over ``axis`` (no gradient)."""
    with torch.no_grad():
        return _all_reduce(x, axis, _mesh(mesh), dist.ReduceOp.MAX)


def fan_out(x: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    """``x`` itself, replicated over ``axis``, marked as feeding work that
    differs on each rank of the axis (each EP rank's experts, the first
    pipeline stage alone): backward psums the partial cotangents, so every
    rank gets ``x``'s whole gradient (Megatron's copy-to-region)."""
    return _FanOut.apply(x, axis, _mesh(mesh))


def all_gather(x: torch.Tensor, axis, dim: int = 0, mesh=None,
               cotangent: str = "partial") -> torch.Tensor:
    """Tiled all-gather: every rank's block along ``dim``, in axis order.
    Backward: with ``cotangent="partial"`` (the gathered value feeds
    different work on each rank: CP's k / v under local queries, FSDP's
    weights under local tokens) a reduce-scatter, the sum of the partial
    cotangents cut to this rank's block; with ``"replicated"`` (the gathered
    value feeds the same work on every rank) this rank's slice of it."""
    if cotangent not in ("partial", "replicated"):
        raise ValueError(f"all_gather: cotangent {cotangent!r}")
    return _AllGather.apply(x, axis, _mesh(mesh), dim, cotangent == "partial")


def split(x: torch.Tensor, axis, dim: int, mesh=None) -> torch.Tensor:
    """This rank's block along ``dim`` of ``x``, replicated over ``axis``
    (the inverse of a tiled all-gather).  Backward all-gathers the blocks'
    cotangents, so every rank gets the whole of ``x``'s gradient."""
    return _Split.apply(x, axis, _mesh(mesh), dim)


def all_to_all(x: torch.Tensor, axis, split_axis: int = 0, concat_axis: int = 0,
               mesh=None) -> torch.Tensor:
    """Tiled all-to-all (JAX ``all_to_all(tiled=True)``); backward is the
    all-to-all back, split and concat axes swapped."""
    return _AllToAll.apply(x, axis, _mesh(mesh), split_axis, concat_axis)


def ppermute(x: torch.Tensor, axis, perm: Sequence[Tuple[int, int]], mesh=None) -> torch.Tensor:
    """Send ``x`` from axis index ``src`` to ``dst`` for each pair of
    ``perm``; ranks that receive nothing get zeros.  Backward moves the
    cotangents by the inverse permutation."""
    return _Ppermute.apply(x, axis, _mesh(mesh), tuple((int(s), int(d)) for s, d in perm))


def axis_index(axis, mesh=None) -> int:
    """This rank's index along ``axis`` (row-major over a tuple of axes)."""
    return _mesh(mesh).axis_index(axis)


# ---------------------------------------------------------------------------
# Compressed gradient reduction (the JAX package's functions)
# ---------------------------------------------------------------------------


def quantize_int8(x: torch.Tensor, block: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-wise absmax int8 quantization of a flat f32 array: (q [n_blocks,
    block] int8, scale [n_blocks, 1] f32), bit-equal to the JAX function
    (``absmax / 127`` and ``x / max(scale, 1e-12)`` in f32, round half to
    even)."""
    n = x.shape[0]
    pad = (-n) % block
    xp = torch.nn.functional.pad(x.float(), (0, pad)).reshape(-1, block)
    scale = xp.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(xp / torch.clamp(scale, min=1e-12)), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    return (q.float() * scale).reshape(-1)[:n]


def int8_psum(x: torch.Tensor, axis, block: int = 256, mesh=None) -> torch.Tensor:
    """Quantized all-reduce: int8 payload summed as int32, dequantized with
    the mean of the ranks' scales (each rank's q_i * scale_i approximated
    with one shared scale)."""
    mesh = _mesh(mesh)
    flat = x.reshape(-1).float()
    q, scale = quantize_int8(flat, block)
    with torch.no_grad():
        q_sum = _all_reduce(q.to(torch.int32), axis, mesh)
        scale_sum = _all_reduce(scale, axis, mesh)
    out = q_sum.float() * (scale_sum / mesh.axis_size(axis))
    return out.reshape(-1)[: flat.shape[0]].reshape(x.shape).to(x.dtype)


def exact_int8_psum(x: torch.Tensor, axis, block: int = 256, mesh=None) -> torch.Tensor:
    """int8 payload summed as int32, dequantized with the ranks' largest
    scale per block (exact when the scales agree)."""
    mesh = _mesh(mesh)
    flat = x.reshape(-1).float()
    q, scale = quantize_int8(flat, block)
    with torch.no_grad():
        q_sum = _all_reduce(q.to(torch.int32), axis, mesh)
    out = q_sum.float() * pmax(scale, axis, mesh)
    return out.reshape(-1)[: flat.shape[0]].reshape(x.shape).to(x.dtype)


def _flatten(tree: Any, out: list) -> Any:
    if isinstance(tree, dict):
        return {k: _flatten(tree[k], out) for k in sorted(tree)}
    if tree is None:
        return None
    out.append(tree)
    return len(out) - 1


def _unflatten(skel: Any, leaves: list) -> Any:
    if isinstance(skel, dict):
        return {k: _unflatten(v, leaves) for k, v in skel.items()}
    return None if skel is None else leaves[skel]


def psum_tree(tree: Any, axis, compress: bool = False, block: int = 256, mesh=None) -> Any:
    """Sum every leaf of a nested-dict tree over ``axis`` (no gradient: a
    reduction of gradients); with ``compress`` the leaves are fused into one
    f32 buffer (in sorted key order) and reduced by :func:`int8_psum`."""
    mesh = _mesh(mesh)
    leaves: list = []
    skel = _flatten(tree, leaves)
    with torch.no_grad():
        if not compress:
            return _unflatten(skel, [_all_reduce(l, axis, mesh) for l in leaves])
        flat = torch.cat([l.reshape(-1).float() for l in leaves])
        red = int8_psum(flat, axis, block, mesh)
    out, off = [], 0
    for l in leaves:
        n = l.numel()
        out.append(red[off: off + n].reshape(l.shape).to(l.dtype))
        off += n
    return _unflatten(skel, out)


def compression_error(x: torch.Tensor, block: int = 256) -> torch.Tensor:
    """Relative L2 error of the int8 round trip."""
    flat = x.reshape(-1).float()
    q, s = quantize_int8(flat, block)
    back = dequantize_int8(q, s, flat.shape[0])
    return torch.linalg.vector_norm(back - flat) / torch.clamp(
        torch.linalg.vector_norm(flat), min=1e-12)
