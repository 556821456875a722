"""PEFT method registry (port of ``repro.peft.methods``): the single place
method names resolve to code.  The port registers the JAX package's eight
methods (LoRA, Adapter-Tuning, Diff-Pruning, IA3, Prefix-Tuning, DoRA, VeRA,
BitFit) and its aliases (``adapter_tuning``, ``houlsby``, ``diff_pruning``,
``prefix_tuning``, ``prefix-tuning``), which resolve without its
deprecation warning."""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

from repro_torch.peft.methods.base import ApplyContext, PEFTMethod, SiteDims

_REGISTRY: Dict[str, PEFTMethod] = {}
_ALIASES: Dict[str, str] = {}


def register_method(method: PEFTMethod, aliases: Iterable[str] = ()) -> PEFTMethod:
    """Register a method instance under ``method.name`` and ``aliases``."""
    if not method.name:
        raise ValueError("PEFTMethod.name must be a non-empty string")
    _REGISTRY[method.name] = method
    for a in aliases:
        _ALIASES[a] = method.name
    return method


def method_names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve_kind(kind: str) -> str:
    if kind in _REGISTRY:
        return kind
    if kind in _ALIASES:
        return _ALIASES[kind]
    raise KeyError(f"unknown PEFT method {kind!r}; registered: {', '.join(method_names())}")


def get_method(kind: str) -> PEFTMethod:
    return _REGISTRY[resolve_kind(kind)]


def shared_leaf(kind: str, leaf: str) -> bool:
    """True if ``leaf`` of method ``kind`` has no task axis (frozen/shared)."""
    return leaf in get_method(kind).shared_params


def adapter_sites(adapter, dims: SiteDims, attention: bool = True
                  ) -> List[Tuple[str, int, int, float, int]]:
    """Flat per-site cost view for the planner:
    ``(site, d_in, d_out, flops_per_token, trainable_params)``."""
    m = get_method(adapter.kind)
    return [(site, din, dout, m.flops_per_token(adapter.rank, din, dout),
             m.param_count(adapter.rank, din, dout))
            for site, (din, dout) in m.sites(tuple(adapter.targets), dims,
                                             attention=attention).items()]


def adapter_shared_params(adapter, dims: SiteDims, attention: bool = True
                          ) -> Dict[str, int]:
    """Per-site params of the method's shared (task-axis-free) leaves."""
    m = get_method(adapter.kind)
    return {site: m.shared_param_count(adapter.rank, din, dout)
            for site, (din, dout) in m.sites(tuple(adapter.targets), dims,
                                             attention=attention).items()}


from repro_torch.peft.methods.adapter_tuning import AdapterTuning  # noqa: E402
from repro_torch.peft.methods.bitfit import BitFit  # noqa: E402
from repro_torch.peft.methods.diff_pruning import DiffPruning  # noqa: E402
from repro_torch.peft.methods.dora import DoRA  # noqa: E402
from repro_torch.peft.methods.ia3 import IA3  # noqa: E402
from repro_torch.peft.methods.lora import LoRA  # noqa: E402
from repro_torch.peft.methods.prefix_tuning import PrefixTuning  # noqa: E402
from repro_torch.peft.methods.vera import VeRA  # noqa: E402

register_method(LoRA())
register_method(AdapterTuning(), aliases=("adapter_tuning", "houlsby"))
register_method(DiffPruning(), aliases=("diff_pruning",))
register_method(IA3())
register_method(PrefixTuning(), aliases=("prefix_tuning", "prefix-tuning"))
register_method(DoRA())
register_method(VeRA())
register_method(BitFit())

from repro_torch.peft.methods.config import (  # noqa: E402
    DEFAULT_TARGETS,
    AdapterConfig,
    base_op_dims,
    supports_attention_prefix,
)

__all__ = [
    "AdapterConfig", "ApplyContext", "DEFAULT_TARGETS", "PEFTMethod", "SiteDims",
    "adapter_shared_params", "adapter_sites", "base_op_dims", "get_method",
    "method_names", "register_method", "resolve_kind", "shared_leaf",
    "supports_attention_prefix",
]
