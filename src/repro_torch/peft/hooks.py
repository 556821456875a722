"""BaseOp hook mechanism (port of ``repro.peft.hooks``).

Backbone layers never mention adapters: every adapter-capable linear op goes
through :func:`apply_base_op`, which consults the adapter context installed
by :func:`adapter_scope`.  With no context the op is a plain einsum.

An int8 backbone weight (``{"q": int8, "scale": f32}``,
``repro_torch.models.quantize``) goes through ``kops.quant_matmul``, which
reads the int8 blocks.  The JAX package also builds the dense weight on
every such call and leaves it to XLA to drop where nothing reads it;
PyTorch drops nothing, so this branch dequantizes only at a site where a
resident kind reads the weight (``PEFTMethod.reads_base_weight``: DoRA).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Union

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.quantize import dequantize


class AdapterContext:
    """Interface: maps BaseOp names to adapter transforms.

    ``apply(name, x, base_out, w)`` implements Dispatch (prepare adapter
    input from ``x``), the adapter computation and Aggregate (merge with
    ``base_out``); it returns a tensor shaped like ``base_out``.  ``w`` is
    the op's effective weight (DoRA renormalises against it), None on an
    int8 backbone where ``reads_base_weight(name)`` is False."""

    def has(self, name: str) -> bool:  # pragma: no cover - interface
        raise NotImplementedError

    def apply(self, name: str, x: torch.Tensor, base_out: torch.Tensor,
              w: Optional[torch.Tensor] = None) -> torch.Tensor:
        raise NotImplementedError  # pragma: no cover - interface

    def reads_base_weight(self, name: str) -> bool:
        """Whether ``apply`` at ``name`` reads the op's weight."""
        return False

    def attn_prefix(self):
        """Soft-prompt Dispatch: ``(pk, pv, keep)`` prefix rows for the
        current layer's attention (pk / pv [B, P, kv_dim], keep [B, P]), or
        None when no soft-prompt method is attached."""
        return None


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
                  einsum_str: str, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A BaseOp: einsum against a dense weight, or the int8 product against
    a quantized node, plus ``bias`` where given, + optional adapter
    Dispatch/Aggregate around it.  The bias is added before the adapter's
    ``apply``, as in the JAX package, so a method that reads ``base_out``
    (DoRA's re-norm) sees ``base_out + bias``."""
    ctx = _ENV.ctx
    active = ctx is not None and ctx.has(name)
    if isinstance(w, dict):
        out = kops.quant_matmul(x, w["q"], w["scale"], einsum_str)
        w = dequantize(w, dtype=x.dtype) if active and ctx.reads_base_weight(name) else None
    else:
        out = torch.einsum(einsum_str, x, w)
    if bias is not None:
        out = out + bias
    if active:
        out = ctx.apply(name, x, out, w)
    return out
