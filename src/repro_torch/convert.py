"""Carry the JAX package's parameter trees across to the port.

Both functions take nested dicts of numpy arrays laid out as the JAX
package lays them out, and return the same layout as torch tensors:

* ``backbone_from_numpy``: the ``Model`` tree.  Dense: layers stacked on
  axis 0 (``embed.tok``, ``final_norm.w``, ``layers.{ln1,ln2}.w``,
  ``layers.attn.w_{q,k,v,o}``, ``layers.mlp.w_{gate,up,down}``), the last
  seven as ``{"q": int8, "scale": f32}`` nodes for an int8 backbone.
  Hybrid: ``embed.{tok,unembed}``, ``final_norm.w``, the Mamba2 blocks
  ``blocks.mamba.{ln.w, mamba.{w_in, conv, dt_bias, a_log, d_skip, norm,
  w_out}}`` stacked ``[n_super, per, ...]`` and the one ``shared_attn``
  block (the dense layer's leaves, unstacked);
* ``adapters_from_numpy``: the ``MultiTaskAdapters`` tree
  ``{kind: {site: {leaf: [L, capacity, ...]}}}`` of any of the eight kinds,
  with stacks whose capacity exceeds the live task count as
  ``ModelGenerator`` sizes them; hybrid trees hold it twice, under
  ``mamba`` (``[n_super, per, capacity, ...]``) and ``shared_attn``
  (``[capacity, ...]``).  A kind's shared leaves (VeRA's ``A`` / ``B``)
  have no capacity axis, and Diff-Pruning's ``rows`` stay int32 (a leaf
  whose spec names its type keeps it, whatever ``dtype`` asks).

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


def _convert(spec: Any, tree: Any, path: str, device, dtype) -> Any:
    if isinstance(spec, ParamSpec):
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
    return {k: _convert(spec[k], tree[k], f"{path}.{k}" if path else k, device, dtype)
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
