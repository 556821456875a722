"""Grouped multi-task LoRA forward: the Hopper kernel and its plain version.

Replaces the Pallas kernel ``_fwd_kernel`` / ``_fwd_call`` of
``repro/kernels/grouped_lora.py`` (forward only).  ``y[m] = (x[m] @ A[t]) @
B[t] * scale[t]`` with ``t = row_task[m]``; a row whose task is -1 gives 0.

The CUDA kernel (``csrc/grouped_lora.cu``) takes a different task on every
row, so the decode rows of four tenants share one launch; the rank-space
activation ``h`` stays in f32 in shared memory.  On the H100 it is bound by
the bytes of the present tasks' A and B at decode (M = 8) and, in this first
version, by its CUDA-core f32 products at prefill (M = 4096); the header of
the source says how the design spreads that work.

``grouped_lora_plain`` has the semantics of ``repro.kernels.ref.
grouped_lora_ref`` (f32 products, scale applied to the f32 result, cast to
x's type) but loops over tasks instead of gathering an ``[M, d_in, r]`` copy
of A.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launch_count = 0  # launches of the CUDA kernel (plain calls are not counted)

_RMAX = 64


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
    if not 1 <= r <= _RMAX:
        raise ValueError(f"grouped_lora kernel takes ranks 1..{_RMAX}, got {r}")
    if M == 0:
        raise ValueError("grouped_lora kernel takes at least one row")
    for name, t in (("x", x), ("a", a), ("b", b), ("row_task", row_task), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"grouped_lora kernel takes contiguous tensors ({name} is not)")


def grouped_lora_cuda(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                      row_task: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel on the same arguments as :func:`grouped_lora_plain`
    (bf16 x/a/b, int32 row_task, f32 scale, all contiguous on one card).
    Task ids outside ``[0, T)`` give 0 rows."""
    global launch_count
    _check(x, a, b, row_task, scale)
    M, d_in = x.shape
    T, _, r = a.shape
    d_out = b.shape[-1]
    y = torch.empty((M, d_out), dtype=x.dtype, device=x.device)
    fn = _build.function("grouped_lora", "grouped_lora_fwd",
                         [_build.P] * 6 + [_build.I] * 5 + [_build.P])
    err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), row_task.data_ptr(),
             scale.data_ptr(), y.data_ptr(), M, d_in, d_out, T, r,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("grouped_lora", err)
    launch_count += 1
    return y
