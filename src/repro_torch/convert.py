"""Carry the JAX package's parameter trees across to the port.

Both functions take nested dicts of numpy arrays laid out as the JAX
package lays them out, and return the same layout as torch tensors:

* ``backbone_from_numpy``: the ``Model`` tree.  Dense: layers stacked on
  axis 0 (``embed.tok``, ``final_norm.w``, ``layers.{ln1,ln2}.w``,
  ``layers.attn.w_{q,k,v,o}``, ``layers.mlp.w_{gate,up,down}`` or, with
  ``gated_mlp=False``, ``layers.mlp.w_{fc1,fc2}``), the BaseOp weights as
  ``{"q": int8, "scale": f32}`` nodes for an int8 backbone; a config with
  ``attention_bias`` adds ``layers.attn.b_{q,k,v,o}``, which stay dense.
  Hybrid: ``embed.{tok,unembed}``, ``final_norm.w``, the Mamba2 blocks
  ``blocks.mamba.{ln.w, mamba.{w_in, conv, dt_bias, a_log, d_skip, norm,
  w_out}}`` stacked ``[n_super, per, ...]`` and the one ``shared_attn``
  block (the dense layer's leaves, unstacked); on an int8 backbone ``w_in``,
  ``w_out`` and the shared block's seven BaseOp weights are quantized
  nodes (a stacked node's scale keeps both stack axes).  MoE: the dense layout with
  ``layers.moe.{router, w_gate, w_up, w_down}`` (the routed experts,
  ``[L, E, ...]``, never quantized) and, where the config has shared
  experts, ``layers.shared_mlp.w_{gate,up,down}`` in place of
  ``layers.mlp``; a config with ``qk_norm`` adds ``layers.attn.{q_norm,
  k_norm}``;
* ``adapters_from_numpy``: the ``MultiTaskAdapters`` tree
  ``{kind: {site: {leaf: [L, capacity, ...]}}}`` of any of the eight kinds,
  with stacks whose capacity exceeds the live task count as
  ``ModelGenerator`` sizes them; hybrid trees hold it twice, under
  ``mamba`` (``[n_super, per, capacity, ...]``) and ``shared_attn``
  (``[capacity, ...]``).  A kind's shared leaves (VeRA's ``A`` / ``B``)
  have no capacity axis, and Diff-Pruning's ``rows`` stay int32 (a leaf
  whose spec names its type keeps it, whatever ``dtype`` asks);
* ``registration_from_numpy``: a JAX registration (adapter tree, AdamW
  moments and slot map, after any ``register_tasks``, ``deregister_tasks``
  or ``compact``) written into the port's ``RegisteredTasks`` of the same
  task list, whole or only the slots of the tasks named, so that both
  packages go on from the same state (JAX's fresh tenants are then what the
  port's tenants start from).

The converters walk the port's spec, so any family the port's ``Model`` and
``MultiTaskAdapters`` lay out as the JAX package does converts.

Every leaf the port's spec declares must be present with its shape, and
every leaf given must be used: anything else raises.  ``torch.from_numpy``
refuses ``ml_dtypes.bfloat16`` arrays, so widen those to float32 first.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.models.layers import ParamSpec
from repro_torch.models.quantize import quantized_spec
from repro_torch.models.transformer import Model
from repro_torch.peft.multitask import MultiTaskAdapters


def _convert(spec: Any, tree: Any, path: str, device, dtype, moments: bool = False) -> Any:
    if isinstance(spec, ParamSpec):
        if moments and spec.dtype is not None and not spec.dtype.is_floating_point:
            if tree is not None:  # an integer leaf has no moments
                raise ValueError(f"leaf {path}: an integer leaf's moment is not None")
            return None
        arr = np.asarray(tree)
        if tuple(arr.shape) != tuple(spec.shape):
            raise ValueError(f"leaf {path}: shape {arr.shape}, expected {spec.shape}")
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if spec.dtype is not None:
            if t.dtype != spec.dtype:
                raise TypeError(f"leaf {path}: {t.dtype}, expected {spec.dtype}")
            return t.to(device=device)
        return t.to(device=device, dtype=dtype or t.dtype)
    if not isinstance(tree, dict):
        raise TypeError(f"{path or 'tree'}: expected a dict of leaves, got {type(tree)}")
    missing = sorted(set(spec) - set(tree))
    unused = sorted(set(tree) - set(spec))
    if missing:
        raise KeyError(f"missing leaves under {path or 'root'}: {missing}")
    if unused:
        raise KeyError(f"unused leaves under {path or 'root'}: {unused}")
    return {k: _convert(spec[k], tree[k], f"{path}.{k}" if path else k, device, dtype, moments)
            for k in spec}


def backbone_from_numpy(tree: Dict[str, Any], cfg: ArchConfig, device,
                        dtype: torch.dtype) -> Dict[str, Any]:
    """The JAX backbone tree of ``cfg`` as the port's parameter dict.  With
    ``cfg.backbone_dtype == "int8"`` each BaseOp weight is the JAX package's
    quantized node ``{"q": int8, "scale": f32}``, which keeps its types."""
    spec = Model(cfg, device=device).spec()
    if cfg.backbone_dtype == "int8":
        spec = quantized_spec(spec)
    return _convert(spec, tree, "", device, dtype)


def adapters_from_numpy(tree: Dict[str, Any], mta: MultiTaskAdapters,
                        device) -> Dict[str, Any]:
    """The JAX ``MultiTaskAdapters`` tree as the port's adapter dict (each
    leaf keeps its numpy dtype)."""
    return _convert(mta.spec(), tree, "", device, None)


def registration_from_numpy(reg, params: Dict[str, Any], m: Dict[str, Any],
                            v: Dict[str, Any], task_slot, task_ids=None) -> None:
    """Write a JAX registration into the port's ``reg`` (a
    ``RegisteredTasks``), in place: ``params`` the adapter tree (as
    :func:`adapters_from_numpy` takes it), ``m`` / ``v`` the AdamW moments
    (f32, None at integer leaves), ``task_slot`` the JAX slot map, which
    must equal the port's.  ``task_ids`` None replaces the three trees
    whole; otherwise only the named tasks' slots are written (their leaves
    at the task axis; shared leaves, which have none, stay)."""
    from repro_torch.core.registry import _group_depths
    from repro_torch.peft.methods import shared_leaf
    from repro_torch.train.optimizer import AdamWState

    mta = reg.mta
    if not np.array_equal(np.asarray(mta.task_slot), np.asarray(task_slot)):
        raise ValueError(f"slot maps differ: port {list(mta.task_slot)}, "
                         f"JAX {list(np.asarray(task_slot))}")
    dev = mta.device
    spec = mta.spec()
    new_p = _convert(spec, params, "", dev, None)
    new_m = _convert(spec, m, "", dev, torch.float32, moments=True)
    new_v = _convert(spec, v, "", dev, torch.float32, moments=True)
    if task_ids is None:
        reg.adapter_params = new_p
        reg.opt_state = AdamWState(reg.opt_state.step, new_m, new_v)
        return
    index = {t.task_id: i for i, t in enumerate(reg.tasks)}
    depths = _group_depths(mta.cfg)

    def write(dst, src, kind, slot, depth, name=None):
        if isinstance(dst, dict):
            for k in dst:
                write(dst[k], src[k], kind, slot, depth, k)
        elif dst is not None and not shared_leaf(kind, name):
            dst.select(depth, slot).copy_(src.select(depth, slot))

    for tid in task_ids:
        i = index[tid]
        kind, slot = mta.task_cfgs[i].kind, int(mta.task_slot[i])
        for dst, src in ((reg.adapter_params, new_p), (reg.opt_state.m, new_m),
                         (reg.opt_state.v, new_v)):
            groups = ([(dst, src, depths[""])] if "" in depths else
                      [(dst[g], src[g], d) for g, d in depths.items() if g in dst])
            for dg, sg, depth in groups:
                if kind in dg:
                    write(dg[kind], sg[kind], kind, slot, depth)
