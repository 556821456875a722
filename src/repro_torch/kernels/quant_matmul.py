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
meets each: ``wgmma`` fed by TMA above 64 rows, ``mma.sync`` with K split
over a thread-block cluster at and below.  Every call is one launch.

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

# launches of the CUDA kernel (plain calls are not counted)
launch_counts = {"quant_matmul": 0}

_TILE_N = 128       # columns n of a block, both kernels (csrc/quant_matmul.cu)
_BK = 64            # k of a pipeline stage
_SMALL_M_MAX = 64   # tokens of one slice of the mma.sync kernel
_MAX_CLUSTER = 16   # blocks of a cluster (past the portable 8; the H100 schedules 16)


def quant_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [M, K], q [K, N] int8, scale [N] f32 -> [M, N] in x's type."""
    return ((x.float() @ q.float()) * scale.float()).to(x.dtype)


def launch_plan(M: int, K: int, N: int, sms: int = 132, tma: bool = True):
    """(route, nt8, cluster, k_span) of one launch.  ``"wgmma"`` takes
    M > 64 when TMA can read the operands (``tma``: K % 8 == 0,
    N % 16 == 0, 16-byte aligned x and q); it covers K in one block.
    ``"mma"`` takes the rest in slices of ``8 * nt8`` tokens (nt8 a power
    of two up to 8); clusters of ``cluster`` blocks split K into shares of
    ``k_span``, doubling while the blocks number fewer than the SMs and
    each share keeps at least two 64-deep stages."""
    if M > _SMALL_M_MAX and tma:
        return "wgmma", 0, 1, K
    nt8 = 1
    while 8 * nt8 < min(M, _SMALL_M_MAX):
        nt8 *= 2
    tiles = math.ceil(N / _TILE_N) * math.ceil(M / (8 * nt8))
    k_steps = math.ceil(K / _BK)
    cluster = 1
    while cluster < _MAX_CLUSTER and tiles * cluster < sms and 4 * cluster <= k_steps:
        cluster *= 2
    return "mma", nt8, cluster, math.ceil(k_steps / cluster) * _BK


_SMS: dict = {}     # device index -> SM count, read once
_PLANS: dict = {}   # (M, K, N, device index, tma) -> launch_plan


def _plan(M: int, K: int, N: int, dev: torch.device, tma: bool):
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (M, K, N, idx, tma)
    plan = _PLANS.get(key)
    if plan is None:
        if idx not in _SMS:
            _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
        plan = _PLANS[key] = launch_plan(M, K, N, _SMS[idx], tma)
    return plan


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


_ROUTES = {"mma": 0, "wgmma": 1}  # the C entry's `route`


def plan_of(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor):
    """(plan, vec) of a call on these CUDA operands: ``vec`` when x and q
    allow 16-byte copies (K % 8 == 0, N % 16 == 0, both 16-byte aligned);
    TMA, and so the ``"wgmma"`` route, needs besides an 8-byte aligned
    scale, which its epilogue reads as pairs."""
    M, K = x.shape
    N = q.shape[1]
    vec = K % 8 == 0 and N % 16 == 0 and x.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0
    return _plan(M, K, N, x.device, vec and scale.data_ptr() % 8 == 0), vec


def quant_matmul_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel on the arguments of :func:`quant_matmul_plain` (bf16
    x, int8 q, f32 scale, contiguous on one card) -> bf16 [M, N]."""
    _check(x, q, scale)
    M, K = x.shape
    N = q.shape[1]
    (route, nt8, cluster, k_span), vec = plan_of(x, q, scale)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    fn = _build.function("quant_matmul", "quant_matmul_fwd",
                         [_build.P] * 4 + [_build.I] * 8 + [_build.P])
    err = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(), M, K, N,
             _ROUTES[route], nt8, cluster, k_span, int(vec),
             torch.cuda.current_stream(x.device).cuda_stream)
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
