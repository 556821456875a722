"""Per-(architecture x shape) sharding-rule selection (port of
``repro.launch.rules``).

The baseline layout:
 * train / prefill: batch over ("pod", "data"); the sequence-sharded
   residual (SP) over "model"; MLP, vocab and experts TP over "model";
   attention head-sharded (``pairs``) when the heads divide over the TP
   degree, else context-parallel (``kvscan``: q sequence-sharded, k / v
   gathered).
 * decode: batch over ("pod", "data") (dropped when the global batch is
   smaller than the DP degree); the KV cache sharded on head_dim over
   "model" where it divides, else on kv_heads, else on cache_seq; a long
   context (batch 1) shards cache_seq over ("pod", "data").

``mesh`` is anything with ``shape`` (axis name -> size) and ``axis_names``:
a ``repro_torch.launch.mesh.Mesh`` or a ``MeshShape`` (no world needed).
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.configs import ArchConfig, ShapeSpec
from repro_torch.distributed.sharding import ShardingRules


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def dp_size(mesh) -> int:
    return _axis_size(mesh, "pod") * _axis_size(mesh, "data")


def tp_size(mesh) -> int:
    return _axis_size(mesh, "model")


def attn_mode_for(cfg: ArchConfig, mesh) -> str:
    if cfg.attention == "none":
        return "pairs"
    return "pairs" if cfg.num_heads % tp_size(mesh) == 0 else "kvscan"


def rules_for(cfg: ArchConfig, shape: ShapeSpec, mesh,
              overrides: Optional[Dict[str, object]] = None) -> ShardingRules:
    tp = tp_size(mesh)
    dp = dp_size(mesh)
    updates: Dict[str, object] = {}
    if shape.kind in ("train", "prefill"):
        updates["batch"] = ("pod", "data") if shape.global_batch % dp == 0 else None
        updates["seq"] = "model" if shape.seq_len % tp == 0 else None
        updates["heads"] = "model" if cfg.num_heads % tp == 0 else None
        updates["kv_heads"] = "model" if (
            cfg.num_heads % tp == 0 and cfg.num_kv_heads % tp == 0) else None
        updates["ff"] = "model" if (cfg.d_ff or tp) % tp == 0 else None
        updates["experts"] = "model" if (cfg.num_experts % tp == 0 and cfg.num_experts) else None
        updates["ssm_heads"] = "model" if (
            cfg.family in ("hybrid",)
            and ((cfg.ssm_expand * cfg.d_model) // cfg.ssm_head_dim) % tp == 0) else None
        updates["ssm_inner"] = "model" if (cfg.ssm_expand * cfg.d_model) % tp == 0 else None
    else:  # decode
        dh = cfg.resolved_head_dim()
        updates["batch"] = ("pod", "data") if shape.global_batch % dp == 0 else None
        updates["seq"] = None
        updates["heads"] = None
        updates["ff"] = "model" if (cfg.d_ff or tp) % tp == 0 else None
        updates["experts"] = "model" if (cfg.num_experts % tp == 0 and cfg.num_experts) else None
        updates["ssm_inner"] = "model" if (cfg.ssm_expand * cfg.d_model) % tp == 0 else None
        updates["ssm_heads"] = None
        if dh % tp == 0:  # the KV cache's layout
            updates["head_dim"] = "model"
            updates["cache_seq"] = ("pod", "data") if shape.global_batch < dp else None
        elif cfg.num_kv_heads % tp == 0:
            updates["kv_heads"] = "model"
            updates["cache_seq"] = ("pod", "data") if shape.global_batch < dp else None
        else:
            updates["cache_seq"] = "model"
        updates["cache_batch"] = ("pod", "data") if shape.global_batch % dp == 0 else None
    updates["vocab"] = "model"  # the vocab is padded to 256: divisible by tp <= 16
    if overrides:
        updates.update(overrides)
    return ShardingRules().with_updates(**updates)


def cache_logical_axes(cfg: ArchConfig):
    """Logical axes of the decode state's KV leaves."""
    return ("layers", "cache_batch", "cache_seq", "kv_heads", "head_dim")
