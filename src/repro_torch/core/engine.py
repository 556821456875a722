"""PEFTEngine, decode half (port of the co-serving data plane of
``repro.core.engine.PEFTEngine``).

The engine owns the shared backbone, the tenants' stacked adapters and the
fused decode pool, and exposes the pool's entry points: allocate
(``ensure_decode_pool``), bind requests (``dispatch_decode_bind_batched`` /
``dispatch_decode_bind``), generate one fused token (``dispatch_decode_micro``)
and read the counters (``decode_accounting``) and outputs
(``decode_outputs``).  The JAX engine is built from a ``ModelGenerator`` and
an ``ExecutionPlan``; those arrive with the training slice, so this one takes
the model, backbone, adapters and their parameters directly.

On a CUDA device every adapter projection, prefill attention and decode
attention runs the hand-written kernels (``repro_torch.kernels``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.launch import steps
from repro_torch.models.transformer import Model
from repro_torch.peft.multitask import MultiTaskAdapters


class PEFTEngine:
    def __init__(self, model: Model, backbone: Dict[str, Any], mta: MultiTaskAdapters,
                 adapter_params: Dict[str, Any], device="cuda"):
        self.device = resolve_device(device)
        if model.device != self.device or mta.device != self.device:
            raise ValueError(f"model on {model.device} and adapters on {mta.device}, "
                             f"engine on {self.device}")
        self.model = model
        self.backbone = backbone
        self.mta = mta
        self.adapter_params = adapter_params
        self._decode_pool: Optional[Dict[str, Any]] = None
        self._decode_geom: Optional[tuple] = None  # (rows, max_len, cap, prefix)
        self.decode_pool_gen = 0  # bumps when the pool is (re)allocated

    def decode_prefix_reserve(self) -> int:
        return steps.decode_prefix_reserve(self.mta)

    def ensure_decode_pool(self, rows: int, max_len: int, max_new_cap: int) -> Dict[str, Any]:
        """Allocate (or re-allocate on a geometry change) the fused decode
        pool.  A re-allocation bumps ``decode_pool_gen``: in-flight rows are
        lost and their requests must be bound again."""
        pres = self.decode_prefix_reserve()
        geom = (rows, max_len, max_new_cap, pres)
        if self._decode_pool is None or self._decode_geom != geom:
            self._decode_pool = steps.init_decode_pool(self.model, rows, max_len,
                                                       max_new_cap, prefix_reserve=pres)
            self._decode_geom = geom
            self.decode_pool_gen += 1
        return self._decode_pool

    def decode_row_ctx(self, row_task: Sequence[int]):
        """(row_slots, scales) dicts of device tensors for a row -> task map
        (-1 = unbound row)."""
        slots = {k: torch.as_tensor(v, device=self.device)
                 for k, v in self.mta.decode_row_slots(row_task).items()}
        scales = {k: torch.as_tensor(self.mta.scales(k), device=self.device)
                  for k in self.mta.kind_tasks}
        return slots, scales

    def dispatch_decode_micro(self, row_slots, scales) -> None:
        """One fused decode token for the pool (no host sync of its own
        unless a row samples)."""
        fn = steps.build_decode_micro_step(self.model, self.mta, self._decode_geom[3])
        self._decode_pool = fn(self.backbone, self.adapter_params, self._decode_pool,
                               row_slots, scales)

    def dispatch_decode_bind(self, row: int, tokens: np.ndarray, length: int, row_slots,
                             scales, max_new: int, sampling=None) -> None:
        """Bind one request to pool row ``row`` (``tokens`` [1, Lp])."""
        self.dispatch_decode_bind_batched(
            np.asarray([row], np.int32), np.asarray(tokens, np.int32),
            np.asarray([length], np.int32), row_slots, scales,
            np.asarray([max_new], np.int32), sampling)

    def dispatch_decode_bind_batched(self, rows, tokens, lengths, row_slots, scales,
                                     max_new, sampling=None) -> None:
        """Bind ``R`` requests in one batched prefill.  ``tokens`` [R, Lp]
        (one prompt bucket); ``row_slots`` are the R bound rows' slots;
        ``sampling`` holds the per-request ``temp``, ``top_k``, ``top_p``
        and ``rng`` seeds [R] (greedy when None)."""
        dev = self.device
        R = int(np.shape(tokens)[0])
        fn = steps.build_decode_batched_bind_step(self.model, self.mta,
                                                  self._decode_geom[1], self._decode_geom[3])
        if sampling is None:
            sampling = steps.greedy_sampling(R, dev)
        else:
            sampling = {
                "temp": torch.as_tensor(sampling["temp"], dtype=torch.float32, device=dev),
                "top_k": torch.as_tensor(sampling["top_k"], dtype=torch.int32, device=dev),
                "top_p": torch.as_tensor(sampling["top_p"], dtype=torch.float32, device=dev),
                "rng": torch.as_tensor(sampling["rng"], dtype=torch.int64, device=dev),
            }

        def t32(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=dev)

        self._decode_pool = fn(self.backbone, self.adapter_params, self._decode_pool,
                               t32(rows), t32(tokens), t32(lengths), row_slots,
                               scales, t32(max_new), sampling)

    def decode_accounting(self) -> Dict[str, np.ndarray]:
        """The host sync of the decode pool: small counters only."""
        p = self._decode_pool
        return {"n_out": p["n_out"].cpu().numpy(), "active": p["active"].cpu().numpy(),
                "pos": p["state"]["pos"].cpu().numpy()}

    def decode_outputs(self, row: int) -> np.ndarray:
        """Generated token buffer of one pool row."""
        return self._decode_pool["out"][row].cpu().numpy()
