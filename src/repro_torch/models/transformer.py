"""Backbone assembly for the dense, MoE and hybrid families (port of
``repro.models.transformer``).

Parameters are nested dicts of tensors laid out like the JAX package's tree:
layers stacked on axis 0 (``layers.attn.w_q`` is ``[L, d, H, dh]``), so the
same tree converts both ways (``repro_torch.convert``).  Layers run in a
Python loop; each layer's slice of the stacked adapter tree is installed as
the BaseOp hook scope, as the JAX layer scan does.

The MoE family (deepseek-moe, qwen3-moe) lays out as the dense one, with
``moe`` (router and stacked expert weights) and, where the config has
shared experts, ``shared_mlp`` in each layer's place of ``mlp``; each
layer's load-balance loss and busiest-expert share are summed into
``out["aux"]``, which the engine adds to the training loss.

The hybrid family (zamba2) runs super-blocks of ``hybrid_period - 1``
Mamba2 blocks (``blocks.mamba``, stacked ``[n_super, per, ...]``) followed
by one application of a single weight-shared attention+MLP block
(``shared_attn``); its adapter tree has the same two groups.  It decodes
through ``decode_step`` (each Mamba2 block's recurrent state and conv
window, one KV cache per application of the shared block); ``prefill``
refuses it, as the JAX package's does, so a hybrid prompt is fed through
``decode_step`` a token at a time.

The dense family takes the gated (SwiGLU) MLP or the plain GELU one
(``gated_mlp=False``, starcoder2), and q/k/v/o biases where the config has
``attention_bias``.  Norms are RMSNorm in every family the port runs, as in
the JAX package (which keeps LayerNorm for its audio family).

The decode state is updated in place: ``prefill`` writes the prompt's k/v
rows into the state's cache tensors and ``decode_step`` writes each new
token's row there, where the JAX package returns new arrays.  Both still
return the state dict, with new ``pos`` tensors.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.layers import (
    ParamSpec,
    embed_apply,
    embed_spec,
    materialize,
    mlp_apply,
    mlp_spec,
    pad_vocab,
    rms_norm,
    unembed_apply,
)
from repro_torch.models.moe import moe_apply, moe_spec
from repro_torch.peft.hooks import adapter_scope

CtxFactory = Callable[[Any], Any]  # layer-adapter slice -> AdapterContext


def _stack_specs(spec: Any, n: int) -> Any:
    if isinstance(spec, ParamSpec):
        return ParamSpec((n,) + spec.shape, spec.init, spec.scale)
    return {k: _stack_specs(v, n) for k, v in spec.items()}


def _slice_layer(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _slice_layer(v, i) for k, v in tree.items()}
    return tree[i]


class Model:
    """Dense, MoE or hybrid decoder backbone on one device (``device="cuda"``
    by default; raises without CUDA unless the caller passes
    ``device="cpu"``)."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        if cfg.family not in ("dense", "moe", "hybrid"):
            raise NotImplementedError(
                f"repro_torch runs dense, MoE and hybrid backbones; "
                f"{cfg.name} ({cfg.family}) is not ported yet")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.vocab_padded = pad_vocab(cfg.vocab_size)

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------

    def spec(self) -> Dict[str, Any]:
        cfg = self.cfg
        layer = {
            "ln1": {"w": ParamSpec((cfg.d_model,), init="ones")},
            "attn": attn.attention_spec(cfg),
            "ln2": {"w": ParamSpec((cfg.d_model,), init="ones")},
        }
        if cfg.family == "moe":
            layer["moe"] = moe_spec(cfg)
            if cfg.num_shared_experts:
                layer["shared_mlp"] = mlp_spec(cfg.d_model,
                                               cfg.num_shared_experts * cfg.expert_d_ff,
                                               cfg.gated_mlp)
        else:
            layer["mlp"] = mlp_spec(cfg.d_model, cfg.d_ff, cfg.gated_mlp)
        spec: Dict[str, Any] = {
            "embed": embed_spec(self.vocab_padded, cfg.d_model, cfg.tie_embeddings),
            "final_norm": {"w": ParamSpec((cfg.d_model,), init="ones")},
        }
        if cfg.family in ("dense", "moe"):
            spec["layers"] = _stack_specs(layer, cfg.num_layers)
            return spec
        n_super = cfg.num_layers // cfg.hybrid_period
        mamba_layer = {"ln": {"w": ParamSpec((cfg.d_model,), init="ones")},
                       "mamba": ssm.mamba2_spec(cfg)}
        spec["blocks"] = {"mamba": _stack_specs(_stack_specs(mamba_layer, cfg.hybrid_period - 1),
                                                n_super)}
        if cfg.shared_attention:
            spec["shared_attn"] = layer  # one copy, applied once per super-block
        else:
            spec["blocks"]["attn"] = _stack_specs(layer, n_super)
        return spec

    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Random bf16 backbone from a seeded generator, on this model's device."""
        return materialize(self.spec(), generator, self.device)

    # ------------------------------------------------------------------
    # Forward (prefill)
    # ------------------------------------------------------------------

    def _ffn(self, lp, h, aux_sink: Optional[Dict[str, Any]] = None):
        """The layer's MLP, or its routed experts plus its shared experts;
        an MoE layer adds its auxiliary losses into ``aux_sink``."""
        gated = self.cfg.gated_mlp
        if "moe" not in lp:
            return mlp_apply(lp["mlp"], h, gated)
        y, aux = moe_apply(lp["moe"], h, self.cfg)
        if "shared_mlp" in lp:
            y = y + mlp_apply(lp["shared_mlp"], h, gated, prefix="shared_mlp")
        if aux_sink is not None:
            for k, v in aux.items():
                aux_sink[k] = aux_sink.get(k, 0.0) + v
        return y

    def _block(self, lp, x, *, positions, segment_ids, collect_kv, aux_sink=None):
        cfg = self.cfg
        h = rms_norm(x, lp["ln1"]["w"], cfg.norm_eps)
        a = attn.attention_apply(lp["attn"], h, cfg, positions=positions,
                                 segment_ids=segment_ids, return_kv=collect_kv)
        kv = None
        if collect_kv:
            a, kv = a
        x = x + a
        h = rms_norm(x, lp["ln2"]["w"], cfg.norm_eps)
        return x + self._ffn(lp, h, aux_sink), kv

    def forward(self, params: Dict[str, Any], batch: Dict[str, torch.Tensor],
                adapters: Any = None, ctx_factory: Optional[CtxFactory] = None,
                return_logits: bool = False, collect_kv: bool = False) -> Dict[str, Any]:
        """Forward over ``batch["tokens"]`` [B, S] (optional ``positions`` and
        ``segment_ids``).  ``collect_kv`` adds ``out["kv"] = (k, v)``, each
        [L, B, S, Hkv, dh] post-RoPE.  With ``batch["labels"]`` (and an
        optional ``loss_mask``) ``out["per_token_loss"]`` [B, S] f32 is the
        masked next-token cross-entropy.  ``out["aux"]`` holds auxiliary
        losses: the MoE family's ``moe_load_balance`` and ``moe_max_frac``,
        each summed over the layers (none in the other families).  The
        hybrid family reads the
        segment starts ``batch["reset"]`` [B, S] too, and collects no k/v."""
        x = embed_apply(params["embed"], batch["tokens"])
        kw = dict(positions=batch.get("positions"), segment_ids=batch.get("segment_ids"))
        aux: Dict[str, Any] = {}
        if self.cfg.family == "hybrid":
            kv = None
            x = self._run_hybrid(params, x, adapters, ctx_factory, reset=batch.get("reset"), **kw)
        else:
            x, kv = self._run_stack(params["layers"], x, adapters, ctx_factory,
                                    collect_kv=collect_kv, aux_sink=aux, **kw)
        x = rms_norm(x, params["final_norm"]["w"], self.cfg.norm_eps)
        out: Dict[str, Any] = {"aux": aux}
        if collect_kv:
            out["kv"] = kv
        if return_logits or "labels" in batch:
            logits = self._logits(params, x)
            if return_logits:
                out["logits"] = logits
            if "labels" in batch:
                out["per_token_loss"] = self._per_token_loss(logits, batch)
        return out

    def _per_token_loss(self, logits, batch):
        """f32 logsumexp over the padded vocab minus the label's logit,
        times ``loss_mask`` (1 where absent)."""
        lf = logits.float()
        ll = lf.gather(-1, batch["labels"].long()[..., None])[..., 0]
        loss = torch.logsumexp(lf, dim=-1) - ll
        mask = batch.get("loss_mask")
        return loss if mask is None else loss * mask.float()

    def _logits(self, params, x):
        logits = unembed_apply(params["embed"], x)
        if self.vocab_padded != self.cfg.vocab_size:
            pad = torch.arange(self.vocab_padded, device=x.device) >= self.cfg.vocab_size
            logits = torch.where(pad, torch.tensor(-1e9, device=x.device),
                                 logits.float()).to(logits.dtype)
        return logits

    def _run_stack(self, layers, x, adapters, ctx_factory, collect_kv=False, aux_sink=None,
                   **kw):
        ks, vs = [], []
        for i in range(self.cfg.num_layers):
            ad = _slice_layer(adapters, i) if adapters is not None else None
            with adapter_scope(ctx_factory(ad) if ctx_factory and ad is not None else None):
                x, kv = self._block(_slice_layer(layers, i), x, collect_kv=collect_kv,
                                    aux_sink=aux_sink, **kw)
            if collect_kv:
                ks.append(kv[0])
                vs.append(kv[1])
        return x, ((torch.stack(ks), torch.stack(vs)) if collect_kv else None)

    def _super_block(self, x, mb, ad, shared, ad_shared, ctx_factory, *, positions,
                     segment_ids, reset):
        """One hybrid super-block: the Mamba2 blocks of ``mb`` (stacked
        [per, ...]) with their adapter slices ``ad``, then the attention+MLP
        block ``shared`` under ``ad_shared``."""
        cfg = self.cfg
        for i in range(cfg.hybrid_period - 1):
            lp = _slice_layer(mb, i)
            adi = _slice_layer(ad, i) if ad is not None else None
            with adapter_scope(ctx_factory(adi) if ctx_factory and adi is not None else None):
                h = rms_norm(x, lp["ln"]["w"], cfg.norm_eps)
                x = x + ssm.mamba2_apply(lp["mamba"], h, cfg, reset=reset)
        with adapter_scope(ctx_factory(ad_shared)
                           if ctx_factory and ad_shared is not None else None):
            x, _ = self._block(shared, x, positions=positions, segment_ids=segment_ids,
                               collect_kv=False)
        return x

    def _run_hybrid(self, params, x, adapters, ctx_factory, **kw):
        """The super-blocks in order (the JAX ``_run_hybrid``, unrolled)."""
        cfg = self.cfg
        blocks = params["blocks"]
        ad_mamba = adapters.get("mamba") if isinstance(adapters, dict) else None
        ad_shared = adapters.get("shared_attn") if isinstance(adapters, dict) else None
        for i in range(cfg.num_layers // cfg.hybrid_period):
            shared = params["shared_attn"] if cfg.shared_attention \
                else _slice_layer(blocks["attn"], i)
            x = self._super_block(x, _slice_layer(blocks["mamba"], i),
                                  _slice_layer(ad_mamba, i) if ad_mamba is not None else None,
                                  shared, ad_shared, ctx_factory, **kw)
        return x

    # ------------------------------------------------------------------
    # Decode (serving)
    # ------------------------------------------------------------------

    def _refuse_hybrid(self, what: str) -> None:
        if self.cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"{what} supports the dense and MoE families, not {self.cfg.family}; "
                f"drive a hybrid prompt through decode_step instead")

    def init_decode_state(self, batch: int, max_len: int, cache_dtype=torch.bfloat16,
                          prefix_reserve: int = 0) -> Dict[str, Any]:
        """Per-row decode state (the JAX ``per_row=True`` layout): ``kv``
        caches [L, B, prefix_reserve + max_len, Hkv, dh] (the hybrid family:
        one per application of the shared block, [n_super, ...]), ``pos``
        [B] the real token count of each row, ``lo`` [B] each row's first
        valid cache index.  The hybrid family adds ``mamba``: each Mamba2
        block's state (``ssm.mamba2_init_state``: ``h`` f32 and the bf16
        conv window, whatever ``cache_dtype``), stacked [n_super, per, ...]."""
        cfg = self.cfg
        dev = self.device
        hybrid = cfg.family == "hybrid"
        n_cache = cfg.num_layers // cfg.hybrid_period if hybrid else cfg.num_layers
        shape = (n_cache, batch, prefix_reserve + max_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim())
        state = {
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "lo": torch.full((batch,), prefix_reserve, dtype=torch.int32, device=dev),
            "kv": {"k": torch.zeros(shape, dtype=cache_dtype, device=dev),
                   "v": torch.zeros(shape, dtype=cache_dtype, device=dev)},
        }
        if hybrid:
            lead = (n_cache, cfg.hybrid_period - 1)
            state["mamba"] = {k: v.expand(lead + v.shape).contiguous()
                              for k, v in ssm.mamba2_init_state(cfg, batch, dev).items()}
        return state

    def prefill(self, params, batch: Dict[str, torch.Tensor], state: Dict[str, Any],
                adapters: Any = None, ctx_factory: Optional[CtxFactory] = None,
                prefix_reserve: int = 0, lengths: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Chunked prompt processing into the decode KV cache: one forward
        over the (padded) prompt, whose post-RoPE k/v rows are written in
        place at offset ``prefix_reserve``.  ``lengths`` [B] are the true
        prompt lengths (junk past them stays outside the window).  Returns
        (logits over the prompt, state with ``pos`` set).  Dense and MoE
        families, as in the JAX package (which also serves vlm)."""
        self._refuse_hybrid("prefill-into-cache")
        out = self.forward(params, batch, adapters=adapters, ctx_factory=ctx_factory,
                           return_logits=True, collect_kv=True)
        ks, vs = out["kv"]
        B, S = batch["tokens"].shape
        state["kv"]["k"][:, :, prefix_reserve:prefix_reserve + S] = ks
        state["kv"]["v"][:, :, prefix_reserve:prefix_reserve + S] = vs
        if lengths is None:
            t = torch.full((B,), S, dtype=torch.int32, device=self.device)
        else:
            t = lengths.to(torch.int32).expand(B).clone()
        return out["logits"], dict(state, pos=t)

    def _decode_block(self, lp, x, cache):
        """One attention+MLP block (a dense or MoE layer, or the hybrid
        family's shared block) over one decode token a row."""
        cfg = self.cfg
        h = rms_norm(x, lp["ln1"]["w"], cfg.norm_eps)
        a, _ = attn.attention_decode_apply(lp["attn"], h, cfg, cache)
        x = x + a
        h = rms_norm(x, lp["ln2"]["w"], cfg.norm_eps)
        return x + self._ffn(lp, h)

    def decode_step(self, params, state: Dict[str, Any], tokens: torch.Tensor,
                    adapters: Any = None, ctx_factory: Optional[CtxFactory] = None,
                    prefix_reserve: int = 0) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One decode token for every row (``tokens`` [B, 1]); every layer's
        adapter slice is in scope, so LoRA applies as at train time.
        ``state["pos"]`` counts real tokens; the cache write index is
        ``prefix_reserve + pos``.  Every pool row routes through an MoE
        layer, free rows too, as in the JAX package.  The hybrid family
        walks its super-blocks as the JAX ``decode_step`` does: each Mamba2
        block under its (super-block, block) adapter slice and its state
        (updated in place), then the shared block under
        ``adapters["shared_attn"]`` over that super-block's KV cache."""
        cfg = self.cfg
        pos = state["pos"]
        x = embed_apply(params["embed"], tokens)
        kc_all, vc_all = state["kv"]["k"], state["kv"]["v"]
        new_state = dict(state, pos=pos + 1)

        def cache(i):
            return {"k": kc_all[i], "v": vc_all[i], "len": prefix_reserve + pos, "t": pos,
                    "lo": state["lo"]}

        def scope(ad):
            return adapter_scope(ctx_factory(ad) if ctx_factory and ad is not None else None)

        if cfg.family == "hybrid":
            mamba = dict(state["mamba"])
            dt = torch.promote_types(mamba["conv"].dtype, x.dtype)
            if mamba["conv"].dtype != dt:  # an f32 run widens the bf16 window, as JAX's concat
                mamba["conv"] = mamba["conv"].to(dt)
            new_state["mamba"] = mamba
            blocks = params["blocks"]
            ad_mamba = adapters.get("mamba") if isinstance(adapters, dict) else None
            ad_shared = adapters.get("shared_attn") if isinstance(adapters, dict) else None
            for i in range(cfg.num_layers // cfg.hybrid_period):
                mb = _slice_layer(blocks["mamba"], i)
                ad = _slice_layer(ad_mamba, i) if ad_mamba is not None else None
                for j in range(cfg.hybrid_period - 1):
                    lp = _slice_layer(mb, j)
                    with scope(_slice_layer(ad, j) if ad is not None else None):
                        h = rms_norm(x, lp["ln"]["w"], cfg.norm_eps)
                        x = x + ssm.mamba2_apply(lp["mamba"], h, cfg, state={
                            "h": mamba["h"][i, j], "conv": mamba["conv"][i, j]})
                shared = params["shared_attn"] if cfg.shared_attention \
                    else _slice_layer(blocks["attn"], i)
                with scope(ad_shared):
                    x = self._decode_block(shared, x, cache(i))
        else:
            for i in range(cfg.num_layers):
                with scope(_slice_layer(adapters, i) if adapters is not None else None):
                    x = self._decode_block(_slice_layer(params["layers"], i), x, cache(i))
        x = rms_norm(x, params["final_norm"]["w"], cfg.norm_eps)
        return self._logits(params, x), new_state
