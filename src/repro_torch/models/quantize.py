"""Int8 backbone quantization, the QLoRA tier (port of ``repro.models.quantize``).

``quantize_backbone`` walks a backbone parameter tree and replaces every
adapter-capable BaseOp weight leaf with a ``{"q": int8, "scale": f32}``
node: symmetric, per-output-channel scale, computed once at model build
(``ModelGenerator.init_backbone``).  Everything else (norms, the tied
embedding) stays dense.  The BaseOp chokepoint
(:func:`repro_torch.peft.hooks.apply_base_op`) reads the int8 blocks through
the ``quant_matmul`` kernel.

The scale keeps the weight's rank with size-1 contracted axes (keepdims), so
dequantization is ``q.float() * scale`` under broadcasting for every site —
the 2D MLP and Mamba2 projections, attention q/k/v ``[d, H, dh]``
(contracted axis -3) and o ``[H, dh, d]`` (contracted axes -3, -2) — and a
stacked ``[L, ...]`` leaf (the hybrid family's ``[n_super, per, ...]``)
slices per layer into matching ``q[i]`` and ``scale[i]``.

``q`` and ``scale`` are bit-identical to the JAX package's on the same
weights: widen to f32, ``absmax`` over the contracted axes, divide by the
scale (not multiply by its reciprocal), round half to even, clip.  Unlike
the JAX walk, which returns a new tree, :func:`quantize_backbone` replaces
the leaves in place and quantizes a stacked leaf one layer at a time (one
slice of every leading stack axis), so a dense leaf is released as soon as
its node replaces it and the f32 copy never holds more than one layer.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models.layers import ParamSpec

#: BaseOp weight leaves eligible for int8 storage (the JAX package's set:
#: attention, the gated or plain MLP, the Mamba2 projections)
QUANT_LEAVES = frozenset({
    "w_q", "w_k", "w_v", "w_o",
    "w_gate", "w_up", "w_down", "w_fc1", "w_fc2",
    "w_in", "w_out",
})

#: subtrees never entered (MoE expert stacks run direct einsums, not BaseOps)
_SKIP_SUBTREES = frozenset({"moe"})


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "scale" in w


def _contract_axes(name: str, path: Tuple[str, ...]) -> Tuple[int, ...]:
    """Per-layer contracted axes of a BaseOp weight, as negative indices
    (robust to any number of leading layer-stack dims)."""
    if "mlstm" in path:
        return (-2,)  # xLSTM q/k/v are square 2D [d_in, d_in] projections
    if name == "w_o":
        return (-3, -2)  # [H, dh, d] -> contract heads x head_dim
    if name in ("w_q", "w_k", "w_v"):
        return (-3,)  # [d, H(kv), dh] -> contract embed
    return (-2,)  # [d_in, d_out]


def _quantizes(name: str, path: Tuple[str, ...]) -> bool:
    return name in QUANT_LEAVES and not (path and path[-1] == "cross"
                                         and name in ("w_k", "w_v"))


def quantize_weight(w: torch.Tensor, axes: Tuple[int, ...]) -> Dict[str, torch.Tensor]:
    """Symmetric int8 quantization with per-output-channel scale."""
    wf = w.float()
    absmax = wf.abs().amax(dim=axes, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def _scale_shape(shape: Tuple[int, ...], axes: Tuple[int, ...]) -> Tuple[int, ...]:
    """The keepdims shape of a weight's scale: 1 on the contracted axes."""
    n = len(shape)
    return tuple(1 if i - n in axes else s for i, s in enumerate(shape))


def _quantize_per_layer(w: torch.Tensor, axes: Tuple[int, ...]) -> Dict[str, torch.Tensor]:
    """``quantize_weight`` of a leaf with any number of leading stack axes
    ([L, ...], or the hybrid family's [n_super, per, ...]), one slice of
    them at a time; the contracted axes are trailing, so the slices are
    independent and the nodes equal the whole leaf's."""
    if w.dim() == max(-a for a in axes):  # one layer's weight
        return quantize_weight(w, axes)
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty(_scale_shape(tuple(w.shape), axes), dtype=torch.float32,
                        device=w.device)
    for i in range(w.shape[0]):
        part = _quantize_per_layer(w[i], axes)
        q[i] = part["q"]
        scale[i] = part["scale"]
    return {"q": q, "scale": scale}


def dequantize(w: Dict[str, torch.Tensor], dtype=torch.float32) -> torch.Tensor:
    """The dense effective weight.  On the serving and training paths only a
    site where a resident PEFT kind reads the weight (DoRA) builds it
    (``peft.hooks.apply_base_op``); references and checks do too."""
    return (w["q"].float() * w["scale"]).to(dtype)


def quantize_backbone(params: Any, cfg: ArchConfig) -> Any:
    """Replace the eligible weight leaves of ``params`` with quantized nodes,
    in place, and return ``params``.  Leaves under ``layers``, stacked on a
    leading layer axis, quantize one layer at a time.

    Callers gate on ``cfg.backbone_dtype == "int8"``; the walk itself is
    config-independent, as the JAX package's is: every eligible leaf of
    every subtree but ``moe`` (an MoE layer's routed experts stay bf16), so
    on the hybrid family the Mamba2 blocks' ``w_in`` / ``w_out`` and the
    shared block's attention and MLP; conv, ``dt_bias``, ``a_log``,
    ``d_skip`` and the norms stay dense."""
    def walk(node: Any, path: Tuple[str, ...]) -> None:
        for k in list(node):
            v = node[k]
            if isinstance(v, dict):
                if k not in _SKIP_SUBTREES and not is_quantized(v):
                    walk(v, path + (k,))
            elif _quantizes(k, path):
                axes = _contract_axes(k, path)
                node[k] = _quantize_per_layer(v, axes)
                del v  # the dense leaf goes once its node replaces it

    walk(params, ())
    return params


def quantized_spec(spec: Any, path: Tuple[str, ...] = ()) -> Any:
    """The parameter spec of an int8 backbone: each eligible ``ParamSpec``
    becomes ``{"q": int8 [shape], "scale": f32 keepdims shape}``."""
    out = {}
    for k, v in spec.items():
        if isinstance(v, dict):
            out[k] = v if k in _SKIP_SUBTREES else quantized_spec(v, path + (k,))
        elif _quantizes(k, path):
            axes = _contract_axes(k, path)
            scale_axes = tuple(None if i - len(v.shape) in axes else a
                               for i, a in enumerate(v.logical_axes()))
            out[k] = {"q": ParamSpec(v.shape, dtype=torch.int8, axes=v.axes),
                      "scale": ParamSpec(_scale_shape(v.shape, axes), dtype=torch.float32,
                                         axes=scale_axes)}
        else:
            out[k] = v
    return out


def quantized_param_count(cfg: ArchConfig) -> int:
    """Backbone params resident at ``backbone_dtype`` bytes (the BaseOp
    sites), for the Eq. 5 split accounting; the remainder (norms, embedding)
    stays at activation precision.  Analytic: per-layer BaseOp dims x layer
    count, clamped to the true total.  The JAX formula: on the hybrid family
    the first term counts the shared block's and the Mamba2 sites in every
    layer, so it clamps to ``param_count`` and Eq. 5 prices the whole
    backbone at one byte (zamba2: 2.068 G), below the bytes it holds."""
    from repro_torch.peft.methods import base_op_dims

    per_layer = sum(din * dout for din, dout in base_op_dims(cfg).values())
    return min(per_layer * cfg.num_layers, cfg.param_count())


def tensor_bytes(tree: Any) -> int:
    """Bytes of every tensor of a (possibly quantized) parameter tree."""
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()
