"""BaseOp hook mechanism (port of ``repro.peft.hooks``).

Backbone layers never mention adapters: every adapter-capable linear op goes
through :func:`apply_base_op`, which consults the adapter context installed
by :func:`adapter_scope`.  With no context the op is a plain einsum.  The
int8 backbone branch of the JAX package waits for the ``quant_matmul``
kernel.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch


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


def apply_base_op(name: str, x: torch.Tensor, w: torch.Tensor,
                  einsum_str: str) -> torch.Tensor:
    """A BaseOp: einsum + optional adapter Dispatch/Aggregate around it."""
    if isinstance(w, dict):
        raise NotImplementedError(
            "int8 backbone weights need the quant_matmul kernel, not ported yet")
    ctx = _ENV.ctx
    out = torch.einsum(einsum_str, x, w)
    if ctx is not None and ctx.has(name):
        out = ctx.apply(name, x, out)
    return out
