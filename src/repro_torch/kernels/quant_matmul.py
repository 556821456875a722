"""Int8-weight matrix product of the int8 backbone tier: the Hopper kernel
and its plain version.

Replaces the Pallas kernel ``_qmm_kernel`` / ``_qmm_call`` of
``repro/kernels/quant_matmul.py``:
``y[M, N] = (x[M, K] @ q[K, N].float()) * scale[N]``, the sum in f32 and the
per-column scale applied once after it, rounded to x's type.  The weight
stays int8 in device memory; the CUDA kernel (``csrc/quant_matmul.cu``)
widens each tile on chip.  On the H100 its least time is set by the weight
bytes at decode (M = 8) and by the tensor-core operations at prefill and
training (M in the thousands); the source's header says how the design
meets each.

:class:`QuantMatmulFunction` makes the kernel differentiable with respect
to x (the backbone is frozen).  Its backward is the JAX package's plain
contraction ``dx = (g.float() * scale) @ q.float().T`` in f32, cast to x's
type; the f32 copy of q lives only inside that call.

``quant_matmul_plain`` is the kernel's function in PyTorch: the product in
f32, then the scale, then the cast.  Its output takes x's type, as the
Pallas tier's does (the JAX xla tier promotes a bf16 x to f32 instead).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

# launches of the CUDA kernel (plain calls are not counted); a split-K
# launch's reduction kernel counts with it as one
launch_counts = {"quant_matmul": 0}

# (BM, BN, BK) of the kernel's two tile shapes (csrc/quant_matmul.cu)
_SMALL_M_TILE = (16, 128, 64)
_LARGE_M_TILE = (128, 128, 32)
_SMALL_M_MAX = 64


def quant_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [M, K], q [K, N] int8, scale [N] f32 -> [M, N] in x's type."""
    return ((x.float() @ q.float()) * scale.float()).to(x.dtype)


def launch_plan(M: int, K: int, N: int, sms: int = 132):
    """(small-M tile?, k_chunk, splits) of one launch: K splits across
    blocks only when the output tiles number fewer than the SMs, into
    chunks of at least two BK steps, aiming at two blocks per SM."""
    small = M <= _SMALL_M_MAX
    bm, bn, bk = _SMALL_M_TILE if small else _LARGE_M_TILE
    tiles = math.ceil(M / bm) * math.ceil(N / bn)
    k_steps = math.ceil(K / bk)
    splits = 1
    if tiles < sms:
        splits = max(1, min(math.ceil(2 * sms / tiles), k_steps // 2))
    k_chunk = math.ceil(k_steps / splits) * bk
    return small, k_chunk, math.ceil(K / k_chunk)


def _check(x, q, scale):
    if not x.is_cuda:
        raise ValueError("quant_matmul_cuda takes CUDA tensors")
    for name, t in (("q", q), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"quant_matmul: {name} is on {t.device}, x on {x.device}")
    if x.dtype != torch.bfloat16 or q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"quant_matmul kernel takes bf16 x, int8 q and f32 scale, got "
                        f"{x.dtype}/{q.dtype}/{scale.dtype}")
    if x.dim() != 2 or q.dim() != 2 or scale.dim() != 1 or x.shape[1] != q.shape[0] \
            or scale.shape[0] != q.shape[1]:
        raise ValueError(f"quant_matmul kernel takes x [M, K], q [K, N], scale [N]; got "
                         f"x{tuple(x.shape)} q{tuple(q.shape)} scale{tuple(scale.shape)}")
    if min(x.shape[0], x.shape[1], q.shape[1]) == 0:
        raise ValueError("quant_matmul kernel takes non-empty operands")
    for name, t in (("x", x), ("q", q), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"quant_matmul kernel takes contiguous tensors ({name} is not)")


def quant_matmul_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel on the arguments of :func:`quant_matmul_plain` (bf16
    x, int8 q, f32 scale, contiguous on one card) -> bf16 [M, N]."""
    _check(x, q, scale)
    M, K = x.shape
    N = q.shape[1]
    dev = x.device
    small, k_chunk, splits = launch_plan(
        M, K, N, torch.cuda.get_device_properties(dev).multi_processor_count)
    vec = K % 8 == 0 and N % 16 == 0 and x.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0
    y = torch.empty((M, N), dtype=x.dtype, device=dev)
    part = torch.empty((splits, M, N), dtype=torch.float32, device=dev) if splits > 1 else None
    fn = _build.function("quant_matmul", "quant_matmul_fwd",
                         [_build.P] * 5 + [_build.I] * 7 + [_build.P])
    err = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
             part.data_ptr() if part is not None else None, M, K, N, int(small), k_chunk,
             splits, int(vec), torch.cuda.current_stream(dev).cuda_stream)
    _build.check("quant_matmul", err)
    launch_counts["quant_matmul"] += 1
    return y


def quant_matmul_dx(g: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """The backward's plain contraction: ``(g * scale) @ q^T`` in f32, cast
    to ``dtype``."""
    return ((g.float() * scale) @ q.float().t()).to(dtype)


class QuantMatmulFunction(torch.autograd.Function):
    """The kernel as an op differentiable in x; q and scale (references to
    the backbone's tensors, never a dense copy) get no gradient."""

    @staticmethod
    def forward(ctx, x, q, scale):
        ctx.save_for_backward(q, scale)
        ctx.x_dtype = x.dtype
        return quant_matmul_cuda(x, q, scale)

    @staticmethod
    def backward(ctx, g):
        q, scale = ctx.saved_tensors
        return quant_matmul_dx(g, q, scale, ctx.x_dtype), None, None
