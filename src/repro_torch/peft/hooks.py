"""BaseOp hook mechanism (port of ``repro.peft.hooks``).

Backbone layers never mention adapters: every adapter-capable linear op goes
through :func:`apply_base_op`, which consults the adapter context installed
by :func:`adapter_scope`.  With no context the op is a plain einsum.

An int8 backbone weight (``{"q": int8, "scale": f32}``,
``repro_torch.models.quantize``) goes through ``kops.quant_matmul``, which
reads the int8 blocks.  Where the JAX package also builds the dense weight
on every call and leaves it to XLA to drop, this branch builds none: no
ported method reads the weight (DoRA will, on its own sites).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Union

import torch

from repro_torch.kernels import ops as kops


class AdapterContext:
    """Interface: maps BaseOp names to adapter transforms.

    ``apply(name, x, base_out)`` implements Dispatch (prepare adapter input
    from ``x``), the adapter computation and Aggregate (merge with
    ``base_out``); it returns a tensor shaped like ``base_out``.  (The JAX
    protocol also passes the op's weight, for methods that renormalise
    against it; LoRA does not.)"""

    def has(self, name: str) -> bool:  # pragma: no cover - interface
        raise NotImplementedError

    def apply(self, name: str, x: torch.Tensor,
              base_out: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError  # pragma: no cover - interface


class _Env(threading.local):
    def __init__(self) -> None:
        self.ctx: Optional[AdapterContext] = None


_ENV = _Env()


@contextlib.contextmanager
def adapter_scope(ctx: Optional[AdapterContext]):
    prev = _ENV.ctx
    _ENV.ctx = ctx
    try:
        yield
    finally:
        _ENV.ctx = prev


def active_context() -> Optional[AdapterContext]:
    return _ENV.ctx


def apply_base_op(name: str, x: torch.Tensor, w: Union[torch.Tensor, Dict[str, torch.Tensor]],
                  einsum_str: str) -> torch.Tensor:
    """A BaseOp: einsum against a dense weight, or the int8 product against
    a quantized node, + optional adapter Dispatch/Aggregate around it."""
    ctx = _ENV.ctx
    if isinstance(w, dict):
        out = kops.quant_matmul(x, w["q"], w["scale"], einsum_str)
    else:
        out = torch.einsum(einsum_str, x, w)
    if ctx is not None and ctx.has(name):
        out = ctx.apply(name, x, out)
    return out
