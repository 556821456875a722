"""Unified submission specs (port of ``repro.serve.spec``).

``TenantSpec`` holds what ``MuxTuneService.submit`` takes besides the task
(``priority``, ``target_steps``, ``warm_start_dir``, ``backbone``), and
``RequestSpec`` the sampling / SLO knobs of ``submit_request``.  Both are
frozen: a spec is a durable submission record, from which a tenant or an
in-flight request can be re-created.

The legacy kwargs form keeps working through the ``coerce_*`` helpers
(DeprecationWarning, once per call site name), as in the JAX package.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.task import PEFTTask

_WARNED: set = set()

_TENANT_KEYS = ("priority", "target_steps", "warm_start_dir", "backbone")
_REQUEST_KEYS = ("max_new_tokens", "request_id", "temperature", "top_k",
                 "top_p", "seed", "slo_class")


def _warn_legacy(caller: str, hint: str) -> None:
    if caller in _WARNED:
        return
    _WARNED.add(caller)
    warnings.warn(
        f"{caller} with positional/keyword submission args is deprecated; "
        f"pass {hint} instead.",
        DeprecationWarning, stacklevel=4)


@dataclass(frozen=True)
class TenantSpec:
    """Everything a tenant submission says: the task plus placement and
    lifecycle knobs.  ``backbone`` only matters fleet-side (instance-label
    routing); a single service ignores it."""

    task: PEFTTask
    priority: int = 0
    target_steps: int = 10
    warm_start_dir: Optional[str] = None
    backbone: Optional[str] = None

    @property
    def task_id(self) -> str:
        return self.task.task_id


@dataclass(frozen=True)
class RequestSpec:
    """Sampling + SLO knobs of one inference request.  ``prompt`` is stored
    as an immutable tuple of token ids so the spec can serve as the durable
    record a crashed request is re-created from."""

    prompt: Tuple[int, ...]
    max_new_tokens: int = 8
    request_id: Optional[str] = None
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    slo_class: int = 0

    def __post_init__(self):
        object.__setattr__(
            self, "prompt",
            tuple(int(t) for t in np.asarray(self.prompt).reshape(-1)))

    def prompt_array(self) -> np.ndarray:
        return np.asarray(self.prompt, np.int32).reshape(-1)


def coerce_tenant_spec(spec, kwargs: Dict, caller: str) -> TenantSpec:
    """Accept a TenantSpec (new API) or a PEFTTask + legacy kwargs (old
    API, deprecation-warned once per caller)."""
    if isinstance(spec, TenantSpec):
        if kwargs:
            raise TypeError(
                f"{caller}: keyword args {sorted(kwargs)} are not accepted "
                f"alongside a TenantSpec — set them on the spec")
        return spec
    bad = set(kwargs) - set(_TENANT_KEYS)
    if bad:
        raise TypeError(f"{caller}: unknown submission args {sorted(bad)}")
    _warn_legacy(caller, "TenantSpec(task, priority=..., target_steps=...)")
    return TenantSpec(task=spec, **kwargs)


def coerce_request_spec(prompt_or_spec, kwargs: Dict,
                        caller: str) -> RequestSpec:
    """Accept a RequestSpec (new API) or a raw prompt + legacy kwargs."""
    if isinstance(prompt_or_spec, RequestSpec):
        if kwargs:
            raise TypeError(
                f"{caller}: keyword args {sorted(kwargs)} are not accepted "
                f"alongside a RequestSpec — set them on the spec")
        return prompt_or_spec
    bad = set(kwargs) - set(_REQUEST_KEYS)
    if bad:
        raise TypeError(f"{caller}: unknown request args {sorted(bad)}")
    _warn_legacy(caller, "RequestSpec(prompt, max_new_tokens=..., seed=...)")
    return RequestSpec(prompt=prompt_or_spec, **kwargs)
