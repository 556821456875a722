"""Task-aware decode pool: bind, generation micro-step and sampling, and the
training loop's host-to-device batch queue (port of ``repro.launch.steps``).

The pool is a fixed-geometry fused decode batch: ``rows`` independent
requests share one micro-step, each row bound to a tenant's adapter slot
(-1 = idle).  Row -> task routing enters as per-row slot tensors
(``MultiTaskAdapters.ctx_factory_from_slots``), so binding a request never
rebuilds anything.  Generated tokens accumulate in the pool's ``out``
buffer on the device; the host reads only the small counters
(``PEFTEngine.decode_accounting``).

Where the JAX steps are jitted functions that return a new pool, these
update the pool's tensors in place and return the same dict.  Sampling
draws with a ``torch.Generator`` seeded per row from the pool's ``rng``
seeds; ``temp <= 0`` rows are an exact argmax with no draw.  The caller
names the rows that sample (``temp > 0``) in a host list, ``sampled_rows``,
so a greedy micro step reads nothing back from the device and can be
queued between training micro steps.  A Prefix-Tuning
row's learned k/v rows are folded into the cache's prefix region at bind
(:func:`fold_soft_prompts`).
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Iterable, Iterator

import numpy as np
import torch

from repro_torch.models.transformer import Model
from repro_torch.peft.methods import get_method
from repro_torch.peft.multitask import MultiTaskAdapters

_SEED_MAX = 2 ** 62


def device_put_batch(batch: Dict[str, np.ndarray], device: torch.device
                     ) -> Dict[str, torch.Tensor]:
    """Start the copy of one host batch to the device.  On a CUDA device
    each array goes through pinned host memory with a non-blocking copy, so
    the call returns with the transfer in flight on the current stream."""
    if device.type != "cuda":
        return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(device, non_blocking=True)
            for k, v in batch.items()}


def prefetch_to_device(it: Iterable[Dict[str, np.ndarray]], device: torch.device,
                       size: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Wrap a host batch iterator with a ``size``-deep device queue: the
    next batches' copies are in flight while the current step computes.
    Yields batches in order; safe for finite or infinite iterators."""
    it = iter(it)
    buf: deque = deque()

    def fill() -> None:
        while len(buf) < size:
            try:
                buf.append(device_put_batch(next(it), device))
            except StopIteration:
                return

    fill()
    while buf:
        out = buf.popleft()
        fill()
        yield out


def decode_prefix_reserve(mta: MultiTaskAdapters) -> int:
    """Static prefix region of the pool's KV cache: the widest soft-prompt
    row count any resident kind can fold in (0 when none is resident)."""
    return max((mta.kind_rank[k] for k in mta.kind_tasks
                if get_method(k).uses_attention_prefix), default=0)


def init_decode_pool(model: Model, rows: int, max_len: int, max_new_cap: int,
                     prefix_reserve: int = 0, cache_dtype=torch.bfloat16
                     ) -> Dict[str, torch.Tensor]:
    """Allocate the fused decode pool (all rows idle, greedy sampling)."""
    dev = model.device
    state = model.init_decode_state(rows, max_len, cache_dtype=cache_dtype,
                                    prefix_reserve=prefix_reserve)

    def z():
        return torch.zeros((rows,), dtype=torch.int32, device=dev)

    return {
        "state": state,
        "cur": z(),                                         # next input token per row
        "out": torch.zeros((rows, max_new_cap), dtype=torch.int32, device=dev),
        "n_out": z(),                                       # generated count per row
        "active": z(),                                      # 1 while generating
        "max_new": z(),                                     # per-row generation target
        **greedy_sampling(rows, dev),
    }


def greedy_sampling(rows: int, device) -> Dict[str, torch.Tensor]:
    """Per-row sampling params that reduce exactly to argmax."""
    return {
        "temp": torch.zeros((rows,), dtype=torch.float32, device=device),   # 0 => greedy
        "top_k": torch.zeros((rows,), dtype=torch.int32, device=device),    # 0 => off
        "top_p": torch.ones((rows,), dtype=torch.float32, device=device),   # 1 => off
        "rng": torch.zeros((rows,), dtype=torch.int64, device=device),      # per-row seed
    }


def sample_tokens(logits: torch.Tensor, temp: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor, rng: torch.Tensor, sampled_rows):
    """Per-row sampling over ``[B, V]`` logits -> (tokens [B] int32, next
    seeds [B] int64).

    ``temp <= 0`` makes a row exactly greedy (argmax, no draw).
    ``top_k <= 0`` and ``top_p >= 1`` turn those filters off; ties at the
    top-p cutoff are all kept (the JAX package's filters).  A sampled row
    draws from a ``torch.Generator`` seeded with its ``rng`` entry and takes
    its next seed from the same generator, so a fixed seed replays.
    ``sampled_rows`` lists on the host the rows with ``temp > 0`` (empty
    when every row is greedy), so that ``temp`` is never read back."""
    B, V = logits.shape
    lg = logits.float()
    greedy = lg.argmax(dim=-1).to(torch.int32)
    sampled_rows = list(sampled_rows)
    if not sampled_rows:
        return greedy, rng
    scaled = lg / temp.clamp_min(1e-6)[:, None]
    srt = scaled.sort(dim=-1, descending=True).values
    kth = srt.gather(-1, (top_k.long() - 1).clamp(0, V - 1)[:, None])
    keep = (top_k[:, None] <= 0) | (scaled >= kth)
    probs = torch.softmax(torch.where(keep, scaled, torch.full_like(scaled, -1e30)), dim=-1)
    ps = probs.sort(dim=-1, descending=True).values
    cum = ps.cumsum(dim=-1)
    in_nucleus = (cum - ps) < top_p[:, None]
    cutoff = torch.where(in_nucleus, ps, torch.full_like(ps, float("inf"))).amin(dim=-1)
    keep &= (top_p[:, None] >= 1.0) | (probs >= cutoff[:, None])
    filtered = torch.where(keep, scaled, torch.full_like(scaled, -1e30))
    nxt, new_rng = greedy.clone(), rng.clone()
    seeds = rng[sampled_rows].tolist()
    for b, seed in zip(sampled_rows, seeds):
        g = torch.Generator(device=logits.device)
        g.manual_seed(int(seed))
        p = torch.softmax(filtered[b], dim=-1)
        nxt[b] = torch.multinomial(p, 1, generator=g).to(torch.int32)[0]
        new_rng[b] = torch.randint(0, _SEED_MAX, (1,), generator=g, device=logits.device)[0]
    return nxt, new_rng


def build_decode_micro_step(model: Model, mta: MultiTaskAdapters, prefix_reserve: int = 0):
    """One fused generation token for every active pool row.

    Feeds each row's ``cur`` token, samples the continuation with the row's
    sampling params and advances only active rows.  Inactive rows still
    compute (fixed shapes) but their counters and seeds stay frozen; their
    cache write lands outside their window and is overwritten before the
    row is exposed again.  ``sampled_rows``: the pool rows bound with
    ``temp > 0`` (:func:`sample_tokens`)."""

    def decode_micro(backbone, adapters, pool, row_slots, scales, sampled_rows):
        ctxf = mta.ctx_factory_from_slots(row_slots, scales)
        st = pool["state"]
        active = pool["active"] > 0
        logits, new_st = model.decode_step(backbone, st, pool["cur"][:, None],
                                           adapters=adapters, ctx_factory=ctxf,
                                           prefix_reserve=prefix_reserve)
        nxt, rng2 = sample_tokens(logits[:, 0, :], pool["temp"], pool["top_k"],
                                  pool["top_p"], pool["rng"], sampled_rows)
        rows = torch.arange(nxt.shape[0], device=nxt.device)
        widx = pool["n_out"].clamp_max(pool["out"].shape[1] - 1).long()
        pool["out"][rows, widx] = torch.where(active, nxt, pool["out"][rows, widx])
        n_out = pool["n_out"] + active.to(torch.int32)
        new_st["pos"] = torch.where(active, new_st["pos"], st["pos"])
        pool["state"] = new_st
        pool["cur"] = torch.where(active, nxt, pool["cur"])
        pool["n_out"] = n_out
        pool["active"] = (active & (n_out < pool["max_new"])).to(torch.int32)
        pool["rng"] = torch.where(active, rng2, pool["rng"])
        return pool

    return decode_micro


def fold_soft_prompts(model: Model, mta: MultiTaskAdapters, adapters, row_slots,
                      state: Dict, prefix_reserve: int) -> Dict:
    """Fold each row's soft-prompt k/v rows into the reserved prefix region
    of a per-row decode ``state`` (in place): a row whose prefix-kind slot
    is >= 0 gets its ``pk`` / ``pv`` [L, P, kv_dim] written right-aligned at
    ``[prefix_reserve - P, prefix_reserve)`` and its window ``lo`` lowered
    by P; other rows keep ``lo``.  Returns ``state``."""
    if not prefix_reserve:
        return state
    cfg = model.cfg
    hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim()
    k1, v1 = state["kv"]["k"], state["kv"]["v"]
    R = k1.shape[1]
    for kind in mta.kind_tasks:
        kspec = adapters.get(kind, {}).get("attn_prefix")
        if not get_method(kind).uses_attention_prefix or kspec is None:
            continue
        slot = row_slots[kind].long()                      # [R]
        has = slot >= 0
        pk = kspec["pk"][:, slot.clamp_min(0)]             # [L, R, P, kv_dim]
        pv = kspec["pv"][:, slot.clamp_min(0)]
        P = pk.shape[2]
        pk = pk.reshape(pk.shape[0], R, P, hkv, dh).to(k1.dtype)
        pv = pv.reshape(pv.shape[0], R, P, hkv, dh).to(v1.dtype)
        gate = has[None, :, None, None, None]
        sl = slice(prefix_reserve - P, prefix_reserve)
        k1[:, :, sl] = torch.where(gate, pk, k1[:, :, sl])
        v1[:, :, sl] = torch.where(gate, pv, v1[:, :, sl])
        state["lo"] = torch.where(has, state["lo"] - P, state["lo"])
    return state


def build_decode_batched_bind_step(model: Model, mta: MultiTaskAdapters, max_len: int,
                                   prefix_reserve: int = 0):
    """Bind ``R`` requests to pool rows at once: batched chunked prefill of
    ``tokens [R, Lp]`` (padded; true ``lengths [R]``) into a fresh R-row
    cache, each soft-prompt row's learned k/v rows folded into its reserved
    prefix region (right-aligned, the row's window ``lo`` lowered over
    them), first tokens sampled at each row's last true position, then every
    bound row copied into the pool.  ``sampled_rows``: the indices into the R
    requests whose ``sampling`` has ``temp > 0`` (:func:`sample_tokens`)."""

    def bind_n(backbone, adapters, pool, rows, tokens, lengths, row_slots, scales,
               max_new, sampling, sampled_rows):
        R = tokens.shape[0]
        ctxf = mta.ctx_factory_from_slots(row_slots, scales)
        ps = pool["state"]
        st1 = model.init_decode_state(R, max_len, cache_dtype=ps["kv"]["k"].dtype,
                                      prefix_reserve=prefix_reserve)
        logits, st1 = model.prefill(backbone, {"tokens": tokens}, st1, adapters=adapters,
                                    ctx_factory=ctxf, prefix_reserve=prefix_reserve,
                                    lengths=lengths)
        fold_soft_prompts(model, mta, adapters, row_slots, st1, prefix_reserve)
        last = logits.float().gather(
            1, (lengths.long() - 1).clamp_min(0).reshape(R, 1, 1).expand(R, 1, logits.shape[-1]))
        first, rng1 = sample_tokens(last[:, 0], sampling["temp"], sampling["top_k"],
                                    sampling["top_p"], sampling["rng"], sampled_rows)
        rows = rows.long()
        ps["kv"]["k"][:, rows] = st1["kv"]["k"]
        ps["kv"]["v"][:, rows] = st1["kv"]["v"]
        ps["pos"][rows] = st1["pos"]
        ps["lo"][rows] = st1["lo"]
        pool["cur"][rows] = first
        pool["out"][rows] = 0
        pool["out"][rows, 0] = first
        pool["n_out"][rows] = 1
        pool["active"][rows] = (max_new > 1).to(torch.int32)
        pool["max_new"][rows] = max_new.to(torch.int32)
        for key in ("temp", "top_k", "top_p"):
            pool[key][rows] = sampling[key].to(pool[key].dtype)
        pool["rng"][rows] = rng1
        return pool

    return bind_n


def build_decode_bind_step(model: Model, mta: MultiTaskAdapters, max_len: int,
                           prefix_reserve: int = 0):
    """Single-request bind: the ``R == 1`` case of the batched bind with a
    scalar row, ``tokens [1, Lp]`` and a scalar length.  Sampling defaults
    to greedy; ``sampled_rows`` is ``[0]`` where ``sampling`` has
    ``temp > 0``."""
    bind_n = build_decode_batched_bind_step(model, mta, max_len, prefix_reserve)

    def bind(backbone, adapters, pool, row, tokens, length, row_slots, scales,
             max_new, sampling=None, sampled_rows=()):
        dev = tokens.device
        if sampling is None:
            sampling = greedy_sampling(1, dev)

        def one(v):
            return torch.as_tensor(v, dtype=torch.int32, device=dev).reshape(1)

        return bind_n(backbone, adapters, pool, one(row), tokens, one(length), row_slots,
                      scales, one(max_new), sampling, sampled_rows)

    return bind
