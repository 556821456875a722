"""Grouped multi-task LoRA: the Hopper kernels and their plain version.

Replaces the Pallas kernels of ``repro/kernels/grouped_lora.py``: the
forward ``_fwd_kernel`` / ``_fwd_call`` (with ``save_h``) and the backward
``_bwd_kernel`` / ``_bwd_call`` with its per-task reduction.
``y[m] = (x[m] @ A[t]) @ B[t] * scale[t]`` with ``t = row_task[m]``; a row
whose task is -1 gives 0 and contributes no gradient.

The CUDA kernels (``csrc/grouped_lora.cu``) take a different task on every
row, so the decode rows of four tenants share one launch; the rank-space
activations ``h`` stay in f32 on chip and are written out only for the
backward.  They run the stack rank in tiles of 64, with one rounding to
bf16 after the f32 sum over every tile.  On the H100 the least time of each
is set by bytes: the present tasks' A and B at decode (M = 8), the rows of
x, g, y and dx at training and prefill (M ~ 3-4 k).  The pair kernel runs
both rank-space products on the tensor cores (``mma.sync``, h fed back as
three bf16 terms) behind a 16-byte ``cp.async`` ring; at decode each task
of the call gets its own cluster of blocks, so its A and B are read once.
The backward's per-task reduction (dA, dB) runs on the tensor cores too
(dh and h as two bf16 terms), a cluster per (task, 128 columns) sharing
the task's 64-row chunks, and writes bf16 gradients itself; the source's
header says how the design spreads the work.
:class:`GroupedLoRAFunction` makes the kernels one differentiable op; the
scale is a constant (no gradient), as the training path holds it.

``grouped_lora_plain`` has the semantics of ``repro.kernels.ref.
grouped_lora_ref`` (f32 products, scale applied to the f32 result, cast to
x's type) but loops over tasks instead of gathering an ``[M, d_in, r]`` copy
of A; autograd differentiates it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

# launches of the CUDA kernels (plain calls are not counted); the backward
# wrapper's two kernels (the pair kernel's dh and dx, then the per-task
# reduction's dA and dB) count as one launch
launch_counts = {"grouped_lora": 0, "grouped_lora_bwd": 0}

# the largest stack rank (``RANK_LIMIT`` in the source: a 16-row tile's
# rank rows stay in shared memory); the kernels run the rank in tiles of 64
_RANK_LIMIT = 3072
# the most rows of a call (``RD_MAX_M``: the reduction keeps a flag and an
# index per 64-row chunk in shared memory)
_MAX_ROWS = 1 << 20


def grouped_lora_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       row_task: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [M, d_in], a [T, d_in, r], b [T, r, d_out], row_task [M] int,
    scale [T] f32 -> [M, d_out] in x's type."""
    xf = x.float()
    y = torch.zeros((x.shape[0], b.shape[-1]), dtype=torch.float32, device=x.device)
    for t in range(a.shape[0]):
        yt = (xf @ a[t].float()) @ b[t].float()
        y = torch.where((row_task == t)[:, None], yt * scale[t].float(), y)
    return y.to(x.dtype)


def _halves_mm(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y`` with the contraction summed as two halves added at the end:
    the same sum in another fixed f32 order."""
    h = x.shape[-1] // 2
    return x[..., :h] @ y[..., :h, :] + x[..., h:] @ y[..., h:, :]


class _HalvesMatmul(torch.autograd.Function):
    """``x @ y`` whose forward and both backward products sum their
    contraction as two halves (:func:`_halves_mm`)."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        return _halves_mm(x, y)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return _halves_mm(g, y.mT), _halves_mm(x.mT, g)


def grouped_lora_reordered_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                                 row_task: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """:func:`grouped_lora_plain` with every f32 contraction (x A, h B and
    the backward's products) summed as two halves added at the end: the
    same function in another order, no kernel involved; a second plain path
    for the noise floor of the training checks."""
    xf = x.float()
    y = torch.zeros((x.shape[0], b.shape[-1]), dtype=torch.float32, device=x.device)
    for t in range(a.shape[0]):
        yt = _HalvesMatmul.apply(_HalvesMatmul.apply(xf, a[t].float()), b[t].float())
        y = torch.where((row_task == t)[:, None], yt * scale[t].float(), y)
    return y.to(x.dtype)


def _check(x, a, b, row_task, scale):
    if not x.is_cuda:
        raise ValueError("grouped_lora_cuda takes CUDA tensors")
    for name, t in (("a", a), ("b", b), ("row_task", row_task), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"grouped_lora: {name} is on {t.device}, x on {x.device}")
    if x.dtype != torch.bfloat16 or a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"grouped_lora kernel takes bf16 x/a/b, got "
                        f"{x.dtype}/{a.dtype}/{b.dtype}")
    if row_task.dtype != torch.int32 or scale.dtype != torch.float32:
        raise TypeError("grouped_lora kernel takes int32 row_task and f32 scale")
    if x.dim() != 2 or a.dim() != 3 or b.dim() != 3:
        raise ValueError("grouped_lora kernel takes x [M, d_in], a [T, d_in, r], b [T, r, d_out]")
    M, d_in = x.shape
    T, _, r = a.shape
    if a.shape[1] != d_in or b.shape[:2] != (T, r) or row_task.shape != (M,) \
            or scale.shape != (T,):
        raise ValueError(f"grouped_lora: inconsistent shapes x{tuple(x.shape)} "
                         f"a{tuple(a.shape)} b{tuple(b.shape)} "
                         f"row_task{tuple(row_task.shape)} scale{tuple(scale.shape)}")
    if not 1 <= r <= _RANK_LIMIT:
        raise ValueError(f"grouped_lora kernel takes ranks 1..{_RANK_LIMIT}, got {r}")
    if not 1 <= M <= _MAX_ROWS:
        raise ValueError(f"grouped_lora kernel takes 1..{_MAX_ROWS} rows, got {M}")
    for name, t in (("x", x), ("a", a), ("b", b), ("row_task", row_task), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"grouped_lora kernel takes contiguous tensors ({name} is not)")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def grouped_lora_cuda(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                      row_task: torch.Tensor, scale: torch.Tensor, save_h: bool = False):
    """The CUDA forward on the same arguments as :func:`grouped_lora_plain`
    (bf16 x/a/b, int32 row_task, f32 scale, all contiguous on one card).
    Task ids outside ``[0, T)`` give 0 rows.  ``save_h`` also returns
    ``h = x @ A[t]`` [M, r] f32 (0 on rows without a task)."""
    _check(x, a, b, row_task, scale)
    M, d_in = x.shape
    T, _, r = a.shape
    d_out = b.shape[-1]
    y = torch.empty((M, d_out), dtype=x.dtype, device=x.device)
    h = torch.empty((M, r), dtype=torch.float32, device=x.device) if save_h else None
    fn = _build.function("grouped_lora", "grouped_lora_fwd",
                         [_build.P] * 7 + [_build.I] * 5 + [_build.P])
    err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), row_task.data_ptr(),
             scale.data_ptr(), y.data_ptr(), h.data_ptr() if save_h else None,
             M, d_in, d_out, T, r, _stream(x))
    _build.check("grouped_lora", err)
    launch_counts["grouped_lora"] += 1
    return (y, h) if save_h else y


def grouped_lora_bwd_cuda(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                          row_task: torch.Tensor, scale: torch.Tensor, h: torch.Tensor,
                          g: torch.Tensor):
    """The CUDA backward: the forward's arguments, its saved ``h`` [M, r]
    f32 and the output gradient ``g`` [M, d_out] -> ``(dx, da, db)`` in the
    types of x, a and b.  dA and dB are summed per task in f32 in a fixed
    order and rounded to bf16 once; a slot no row routes to gets exact
    zeros."""
    _check(x, a, b, row_task, scale)
    M, d_in = x.shape
    T, _, r = a.shape
    d_out = b.shape[-1]
    if h.dtype != torch.float32 or h.shape != (M, r) or not h.is_contiguous() \
            or h.device != x.device:
        raise ValueError(f"grouped_lora backward: h must be contiguous f32 [{M}, {r}]")
    if g.dtype != x.dtype or g.shape != (M, d_out) or not g.is_contiguous() \
            or g.device != x.device:
        raise ValueError(f"grouped_lora backward: g must be contiguous {x.dtype} [{M}, {d_out}]")
    dev = x.device
    dx = torch.empty_like(x)
    dh = torch.empty((M, r), dtype=torch.float32, device=dev)
    da = torch.empty((T, d_in, r), dtype=a.dtype, device=dev)
    db = torch.empty((T, r, d_out), dtype=b.dtype, device=dev)
    fn = _build.function("grouped_lora", "grouped_lora_bwd",
                         [_build.P] * 11 + [_build.I] * 5 + [_build.P])
    err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), row_task.data_ptr(),
             scale.data_ptr(), h.data_ptr(), g.data_ptr(), dx.data_ptr(), dh.data_ptr(),
             da.data_ptr(), db.data_ptr(), M, d_in, d_out, T, r, _stream(x))
    _build.check("grouped_lora", err)
    launch_counts["grouped_lora_bwd"] += 1
    return dx, da, db


class GroupedLoRAFunction(torch.autograd.Function):
    """The kernels as one differentiable op over (x, a, b); row_task and
    scale get no gradient (the Pallas vjp's dscale trains nothing)."""

    @staticmethod
    def forward(ctx, x, a, b, row_task, scale):
        y, h = grouped_lora_cuda(x, a, b, row_task, scale, save_h=True)
        ctx.save_for_backward(x, a, b, row_task, scale, h)
        return y

    @staticmethod
    def backward(ctx, g):
        x, a, b, row_task, scale, h = ctx.saved_tensors
        dx, da, db = grouped_lora_bwd_cuda(x, a, b, row_task, scale, h, g.contiguous())
        return dx, da, db, None, None
