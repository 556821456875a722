"""PEFT method registry (port of ``repro.peft.methods``): the single place
method names resolve to code.  The port registers LoRA; the other seven
methods of the JAX package come with later slices."""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.peft.methods.base import ApplyContext, PEFTMethod, SiteDims

_REGISTRY: Dict[str, PEFTMethod] = {}


def register_method(method: PEFTMethod) -> PEFTMethod:
    if not method.name:
        raise ValueError("PEFTMethod.name must be a non-empty string")
    _REGISTRY[method.name] = method
    return method


def method_names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve_kind(kind: str) -> str:
    if kind in _REGISTRY:
        return kind
    raise KeyError(f"unknown or not yet ported PEFT method {kind!r}; "
                   f"registered: {', '.join(method_names())}")


def get_method(kind: str) -> PEFTMethod:
    return _REGISTRY[resolve_kind(kind)]


from repro_torch.peft.methods.lora import LoRA  # noqa: E402

register_method(LoRA())

from repro_torch.peft.methods.config import (  # noqa: E402
    DEFAULT_TARGETS,
    AdapterConfig,
    base_op_dims,
)

__all__ = [
    "AdapterConfig", "ApplyContext", "DEFAULT_TARGETS", "PEFTMethod", "SiteDims",
    "base_op_dims", "get_method", "method_names", "register_method",
    "resolve_kind",
]
