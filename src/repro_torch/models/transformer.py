"""Backbone assembly for the dense and hybrid families (port of
``repro.models.transformer``).

Parameters are nested dicts of tensors laid out like the JAX package's tree:
layers stacked on axis 0 (``layers.attn.w_q`` is ``[L, d, H, dh]``), so the
same tree converts both ways (``repro_torch.convert``).  Layers run in a
Python loop; each layer's slice of the stacked adapter tree is installed as
the BaseOp hook scope, as the JAX layer scan does.

The hybrid family (zamba2) runs super-blocks of ``hybrid_period - 1``
Mamba2 blocks (``blocks.mamba``, stacked ``[n_super, per, ...]``) followed
by one application of a single weight-shared attention+MLP block
(``shared_attn``); its adapter tree has the same two groups.  It trains and
never serves: ``prefill`` and ``decode_step`` refuse it, as the JAX
package's ``prefill`` does.

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
    """Dense or hybrid decoder backbone on one device (``device="cuda"`` by
    default; raises without CUDA unless the caller passes ``device="cpu"``)."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        if cfg.family not in ("dense", "hybrid") or not cfg.gated_mlp:
            raise NotImplementedError(
                f"repro_torch runs dense and hybrid backbones with gated MLPs; {cfg.name} "
                f"({cfg.family}) is not ported yet")
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
            "mlp": mlp_spec(cfg.d_model, cfg.d_ff),
        }
        spec: Dict[str, Any] = {
            "embed": embed_spec(self.vocab_padded, cfg.d_model, cfg.tie_embeddings),
            "final_norm": {"w": ParamSpec((cfg.d_model,), init="ones")},
        }
        if cfg.family == "dense":
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

    def _block(self, lp, x, *, positions, segment_ids, collect_kv):
        cfg = self.cfg
        h = rms_norm(x, lp["ln1"]["w"], cfg.norm_eps)
        a = attn.attention_apply(lp["attn"], h, cfg, positions=positions,
                                 segment_ids=segment_ids, return_kv=collect_kv)
        kv = None
        if collect_kv:
            a, kv = a
        x = x + a
        h = rms_norm(x, lp["ln2"]["w"], cfg.norm_eps)
        return x + mlp_apply(lp["mlp"], h), kv

    def forward(self, params: Dict[str, Any], batch: Dict[str, torch.Tensor],
                adapters: Any = None, ctx_factory: Optional[CtxFactory] = None,
                return_logits: bool = False, collect_kv: bool = False) -> Dict[str, Any]:
        """Forward over ``batch["tokens"]`` [B, S] (optional ``positions`` and
        ``segment_ids``).  ``collect_kv`` adds ``out["kv"] = (k, v)``, each
        [L, B, S, Hkv, dh] post-RoPE.  With ``batch["labels"]`` (and an
        optional ``loss_mask``) ``out["per_token_loss"]`` [B, S] f32 is the
        masked next-token cross-entropy.  ``out["aux"]`` holds auxiliary
        losses (none in these families).  The hybrid family reads the
        segment starts ``batch["reset"]`` [B, S] too, and collects no k/v."""
        x = embed_apply(params["embed"], batch["tokens"])
        kw = dict(positions=batch.get("positions"), segment_ids=batch.get("segment_ids"))
        if self.cfg.family == "hybrid":
            kv = None
            x = self._run_hybrid(params, x, adapters, ctx_factory, reset=batch.get("reset"), **kw)
        else:
            x, kv = self._run_stack(params["layers"], x, adapters, ctx_factory,
                                    collect_kv=collect_kv, **kw)
        x = rms_norm(x, params["final_norm"]["w"], self.cfg.norm_eps)
        out: Dict[str, Any] = {"aux": {}}
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

    def _run_stack(self, layers, x, adapters, ctx_factory, collect_kv=False, **kw):
        ks, vs = [], []
        for i in range(self.cfg.num_layers):
            ad = _slice_layer(adapters, i) if adapters is not None else None
            with adapter_scope(ctx_factory(ad) if ctx_factory and ad is not None else None):
                x, kv = self._block(_slice_layer(layers, i), x, collect_kv=collect_kv, **kw)
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
        if self.cfg.family != "dense":
            raise NotImplementedError(
                f"{what} supports the dense family, not {self.cfg.family}; the hybrid "
                f"family trains only")

    def init_decode_state(self, batch: int, max_len: int, cache_dtype=torch.bfloat16,
                          prefix_reserve: int = 0) -> Dict[str, Any]:
        """Per-row decode state (the JAX ``per_row=True`` layout): ``kv``
        caches [L, B, prefix_reserve + max_len, Hkv, dh], ``pos`` [B] the real
        token count of each row, ``lo`` [B] each row's first valid cache
        index."""
        cfg = self.cfg
        shape = (cfg.num_layers, batch, prefix_reserve + max_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim())
        dev = self.device
        return {
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "lo": torch.full((batch,), prefix_reserve, dtype=torch.int32, device=dev),
            "kv": {"k": torch.zeros(shape, dtype=cache_dtype, device=dev),
                   "v": torch.zeros(shape, dtype=cache_dtype, device=dev)},
        }

    def prefill(self, params, batch: Dict[str, torch.Tensor], state: Dict[str, Any],
                adapters: Any = None, ctx_factory: Optional[CtxFactory] = None,
                prefix_reserve: int = 0, lengths: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Chunked prompt processing into the decode KV cache: one forward
        over the (padded) prompt, whose post-RoPE k/v rows are written in
        place at offset ``prefix_reserve``.  ``lengths`` [B] are the true
        prompt lengths (junk past them stays outside the window).  Returns
        (logits over the prompt, state with ``pos`` set).  Dense family only,
        as in the JAX package."""
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

    def decode_step(self, params, state: Dict[str, Any], tokens: torch.Tensor,
                    adapters: Any = None, ctx_factory: Optional[CtxFactory] = None,
                    prefix_reserve: int = 0) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One decode token for every row (``tokens`` [B, 1]); every layer's
        adapter slice is in scope, so LoRA applies as at train time.
        ``state["pos"]`` counts real tokens; the cache write index is
        ``prefix_reserve + pos``.  Dense family only (hybrid decode, the
        JAX package's ``gla_decode_step``, is not ported)."""
        self._refuse_hybrid("decode")
        cfg = self.cfg
        pos = state["pos"]
        x = embed_apply(params["embed"], tokens)
        kc_all, vc_all = state["kv"]["k"], state["kv"]["v"]
        for i in range(cfg.num_layers):
            lp = _slice_layer(params["layers"], i)
            ad = _slice_layer(adapters, i) if adapters is not None else None
            cache = {"k": kc_all[i], "v": vc_all[i], "len": prefix_reserve + pos, "t": pos,
                     "lo": state["lo"]}
            with adapter_scope(ctx_factory(ad) if ctx_factory and ad is not None else None):
                h = rms_norm(x, lp["ln1"]["w"], cfg.norm_eps)
                a, _ = attn.attention_decode_apply(lp["attn"], h, cfg, cache)
                x = x + a
                h = rms_norm(x, lp["ln2"]["w"], cfg.norm_eps)
                x = x + mlp_apply(lp["mlp"], h)
        x = rms_norm(x, params["final_norm"]["w"], cfg.norm_eps)
        return self._logits(params, x), dict(state, pos=pos + 1)
