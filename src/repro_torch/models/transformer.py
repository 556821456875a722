"""Backbone assembly for the dense, vlm, audio, MoE, hybrid and ``ssm``
families (port of ``repro.models.transformer``).

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

The ``ssm`` family (xlstm-1.3b) runs super-blocks of ``slstm_period - 1``
mLSTM blocks (``blocks.mlstm``, stacked ``[n_super, per, ...]``) and one
sLSTM block (``blocks.slstm``, ``[n_super, ...]``), each behind an RMSNorm
in a residual; its adapter tree has the groups ``mlstm`` and ``slstm``.
``forward`` passes ``batch["reset"]`` to the mLSTM blocks only (the JAX
``_run_xlstm``).  It decodes through ``decode_step`` (each block's
recurrent state, no KV cache); ``prefill`` refuses it, as the JAX
package's does.

The dense family takes the gated (SwiGLU) MLP or the plain GELU one
(``gated_mlp=False``, starcoder2), and q/k/v/o biases where the config has
``attention_bias``.  The vlm family (qwen2-vl) is the dense stack with
M-RoPE: ``forward`` reads ``batch["mrope_positions"]`` [3, B, S] where a
batch carries them (the bind does, training batches do not, so training
runs plain RoPE) and ``decode_step`` builds them from ``pos`` on all three
channels.  Norms are RMSNorm in every family but audio.

The audio family (whisper) is an encoder-decoder: ``encoder`` layers
(LayerNorm with bias, non-causal self-attention, the GELU MLP with biases)
over the frame embeddings ``batch["audio_embed"]`` [B, Sa, d] plus the
sinusoidal table, then ``layers`` of the decoder, each a causal
self-attention, a cross-attention (``ln_cross`` / ``cross``) over the
encoder's k/v and the MLP, with LayerNorms and MLP biases.  As in the JAX
package the decoder's self-attention takes no segments (packed rows would
see each other), every attention applies RoPE to q (and to its own k), the
decoder layer's adapter scope covers its cross-attention (so a tenant's
``attn_q`` / ``attn_o`` apply twice a layer) while the cross k/v are plain
products of the encoder output (``_cross_kv``), and the encoder carries no
adapters.  The cross-attention projects q alone: the JAX package also
projects x's k/v there and drops them, which changes no output.  It decodes
through ``decode_step`` over the fixed cross cache that
``init_decode_state(audio_embed=...)`` fills; ``prefill`` refuses it, as the
JAX package's does.

The decode state is updated in place: ``prefill`` writes the prompt's k/v
rows into the state's cache tensors and ``decode_step`` writes each new
token's row there, where the JAX package returns new arrays.  Both still
return the state dict, with new ``pos`` tensors.
"""
from __future__ import annotations

import dataclasses
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
    layer_norm,
    materialize,
    mlp_apply,
    mlp_spec,
    pad_vocab,
    rms_norm,
    sinusoidal_positions,
    unembed_apply,
)
from repro_torch.models.moe import moe_apply, moe_spec
from repro_torch.peft.hooks import adapter_scope

CtxFactory = Callable[[Any], Any]  # layer-adapter slice -> AdapterContext


def _norm_spec(d: int, audio: bool) -> Dict[str, ParamSpec]:
    """RMSNorm's weight, or on the audio family LayerNorm's weight and bias."""
    s = {"w": ParamSpec((d,), init="ones", axes=("embed",))}
    if audio:
        s["b"] = ParamSpec((d,), init="zeros", axes=("embed",))
    return s


def _apply_norm(p: Dict[str, torch.Tensor], x: torch.Tensor, eps: float) -> torch.Tensor:
    if "b" in p:
        return layer_norm(x, p["w"], p["b"], eps)
    return rms_norm(x, p["w"], eps)


def _stack_specs(spec: Any, n: int) -> Any:
    if isinstance(spec, ParamSpec):
        return dataclasses.replace(spec, shape=(n,) + spec.shape,
                                   axes=("layers",) + spec.logical_axes())
    return {k: _stack_specs(v, n) for k, v in spec.items()}


def _slice_layer(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _slice_layer(v, i) for k, v in tree.items()}
    return tree[i]


class Model:
    """Dense, vlm, audio, MoE, hybrid or ``ssm`` backbone (``device="cuda"``
    by default; raises without CUDA unless the caller passes
    ``device="cpu"``).  ``attn_mode`` is the attention mode of every
    self-attention (``pairs``, ``kvscan`` or ``striped_cp``;
    ``models.attention``): under an active mesh the last two run on this
    rank's block of the sequence, and ``striped_cp`` reads the batch's
    ``positions`` (the tokens' global positions in the striped layout)."""

    def __init__(self, cfg: ArchConfig, device="cuda", attn_mode: str = "pairs"):
        if attn_mode not in ("pairs", "kvscan", "striped_cp"):
            raise ValueError(f"attn_mode {attn_mode!r}: pairs, kvscan or striped_cp")
        if cfg.family not in ("dense", "vlm", "audio", "moe", "hybrid", "ssm"):
            raise NotImplementedError(
                f"repro_torch runs dense, vlm, audio, MoE, hybrid and ssm backbones; "
                f"{cfg.name} ({cfg.family}) is not ported yet")
        self.cfg = cfg
        self.attn_mode = attn_mode
        self.device = resolve_device(device)
        self.vocab_padded = pad_vocab(cfg.vocab_size)

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------

    def spec(self) -> Dict[str, Any]:
        cfg = self.cfg
        d, audio = cfg.d_model, cfg.family == "audio"
        layer = {
            "ln1": _norm_spec(d, audio),
            "attn": attn.attention_spec(cfg),
            "ln2": _norm_spec(d, audio),
        }
        if cfg.family == "moe":
            layer["moe"] = moe_spec(cfg)
            if cfg.num_shared_experts:
                layer["shared_mlp"] = mlp_spec(cfg.d_model,
                                               cfg.num_shared_experts * cfg.expert_d_ff,
                                               cfg.gated_mlp)
        else:
            layer["mlp"] = mlp_spec(d, cfg.d_ff, cfg.gated_mlp, bias=audio and cfg.attention_bias)
        spec: Dict[str, Any] = {
            "embed": embed_spec(self.vocab_padded, d, cfg.tie_embeddings),
            "final_norm": _norm_spec(d, audio),
        }
        if cfg.family in ("dense", "vlm", "moe"):
            spec["layers"] = _stack_specs(layer, cfg.num_layers)
            return spec
        if cfg.family == "ssm":
            n_super, per = cfg.num_layers // cfg.slstm_period, cfg.slstm_period - 1
            mlstm_layer = {"ln": _norm_spec(d, False), "mlstm": ssm.mlstm_spec(cfg)}
            slstm_layer = {"ln": _norm_spec(d, False), "slstm": ssm.slstm_spec(cfg)}
            spec["blocks"] = {"mlstm": _stack_specs(_stack_specs(mlstm_layer, per), n_super),
                              "slstm": _stack_specs(slstm_layer, n_super)}
            return spec
        if audio:
            enc_layer = {"ln1": _norm_spec(d, True), "attn": attn.attention_spec(cfg),
                         "ln2": _norm_spec(d, True),
                         "mlp": mlp_spec(d, cfg.d_ff, cfg.gated_mlp, bias=True)}
            layer.update(ln_cross=_norm_spec(d, True), cross=attn.attention_spec(cfg))
            spec["encoder"] = _stack_specs(enc_layer, cfg.num_encoder_layers)
            spec["enc_final_norm"] = _norm_spec(d, True)
            spec["layers"] = _stack_specs(layer, cfg.num_layers)
            return spec
        n_super = cfg.num_layers // cfg.hybrid_period
        mamba_layer = {"ln": _norm_spec(cfg.d_model, False),
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

    def _block(self, lp, x, *, positions, segment_ids, collect_kv, aux_sink=None,
               mrope_positions=None):
        cfg = self.cfg
        h = _apply_norm(lp["ln1"], x, cfg.norm_eps)
        a = attn.attention_apply(lp["attn"], h, cfg, mode=self.attn_mode, positions=positions,
                                 mrope_positions=mrope_positions,
                                 segment_ids=segment_ids, return_kv=collect_kv)
        kv = None
        if collect_kv:
            a, kv = a
        x = x + a
        h = _apply_norm(lp["ln2"], x, cfg.norm_eps)
        return x + self._ffn(lp, h, aux_sink), kv

    def forward(self, params: Dict[str, Any], batch: Dict[str, torch.Tensor],
                adapters: Any = None, ctx_factory: Optional[CtxFactory] = None,
                return_logits: bool = False, collect_kv: bool = False) -> Dict[str, Any]:
        """Forward over ``batch["tokens"]`` [B, S] (optional ``positions`` and
        ``segment_ids``; on the vlm family ``mrope_positions`` [3, B, S]; on
        the audio family ``audio_embed`` [B, Sa, d], which the encoder
        reads, and no positions or segments).  ``collect_kv`` adds ``out["kv"] = (k, v)``, each
        [L, B, S, Hkv, dh] post-RoPE.  With ``batch["labels"]`` (and an
        optional ``loss_mask``) ``out["per_token_loss"]`` [B, S] f32 is the
        masked next-token cross-entropy.  ``out["aux"]`` holds auxiliary
        losses: the MoE family's ``moe_load_balance`` and ``moe_max_frac``,
        each summed over the layers (none in the other families).  The
        hybrid family reads the
        segment starts ``batch["reset"]`` [B, S] too, and collects no k/v;
        so does the ``ssm`` family, whose mLSTM blocks alone read them."""
        cfg = self.cfg
        x = embed_apply(params["embed"], batch["tokens"])
        kw = dict(positions=batch.get("positions"), segment_ids=batch.get("segment_ids"))
        aux: Dict[str, Any] = {}
        kv = None
        if cfg.family == "hybrid":
            x = self._run_hybrid(params, x, adapters, ctx_factory, reset=batch.get("reset"), **kw)
        elif cfg.family == "ssm":
            x = self._run_xlstm(params, x, adapters, ctx_factory, reset=batch.get("reset"))
        elif cfg.family == "audio":
            if collect_kv:
                raise NotImplementedError("the audio family collects no k/v (it has no prefill)")
            x = self._run_audio(params, batch["audio_embed"], x, adapters, ctx_factory)
        else:
            mrope = batch.get("mrope_positions") if cfg.mrope else None
            x, kv = self._run_stack(params["layers"], x, adapters, ctx_factory,
                                    collect_kv=collect_kv, aux_sink=aux,
                                    mrope_positions=mrope, **kw)
        x = _apply_norm(params["final_norm"], x, cfg.norm_eps)
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

    # ---- xlstm ----

    def _xlstm_blocks(self, params, adapters):
        """Per super-block: its mLSTM blocks' parameters (stacked [per, ...])
        and adapter slices, its sLSTM block's and its adapter slice."""
        cfg = self.cfg
        blocks = params["blocks"]
        ad_m = adapters.get("mlstm") if isinstance(adapters, dict) else None
        ad_s = adapters.get("slstm") if isinstance(adapters, dict) else None
        for i in range(cfg.num_layers // cfg.slstm_period):
            yield (_slice_layer(blocks["mlstm"], i),
                   _slice_layer(ad_m, i) if ad_m is not None else None,
                   _slice_layer(blocks["slstm"], i),
                   _slice_layer(ad_s, i) if ad_s is not None else None)

    def _run_xlstm(self, params, x, adapters, ctx_factory, *, reset):
        """The super-blocks in order (the JAX ``_run_xlstm``, unrolled):
        ``reset`` goes to the mLSTM blocks only."""
        cfg = self.cfg

        def scope(ad):
            return adapter_scope(ctx_factory(ad) if ctx_factory and ad is not None else None)

        for mb, adm, sb, ads in self._xlstm_blocks(params, adapters):
            for j in range(cfg.slstm_period - 1):
                lp = _slice_layer(mb, j)
                with scope(_slice_layer(adm, j) if adm is not None else None):
                    h = _apply_norm(lp["ln"], x, cfg.norm_eps)
                    x = x + ssm.mlstm_apply(lp["mlstm"], h, cfg, reset=reset)
            with scope(ads):
                h = _apply_norm(sb["ln"], x, cfg.norm_eps)
                x = x + ssm.slstm_apply(sb["slstm"], h, cfg)
        return x

    # ---- audio (whisper) ----

    def _encode_audio(self, params, audio_embed: torch.Tensor) -> torch.Tensor:
        """The encoder over the frame embeddings [B, Sa, d] plus the
        sinusoidal table: non-causal self-attention and the MLP in each
        layer, no adapters, then ``enc_final_norm``."""
        cfg = self.cfg
        S = audio_embed.shape[1]
        pos = sinusoidal_positions(S, cfg.d_model, audio_embed.device).to(audio_embed.dtype)
        x = audio_embed + pos[None]
        for i in range(cfg.num_encoder_layers):
            lp = _slice_layer(params["encoder"], i)
            h = _apply_norm(lp["ln1"], x, cfg.norm_eps)
            x = x + attn.attention_apply(lp["attn"], h, cfg, mode=self.attn_mode, causal=False)
            h = _apply_norm(lp["ln2"], x, cfg.norm_eps)
            x = x + mlp_apply(lp["mlp"], h, cfg.gated_mlp)
        return _apply_norm(params["enc_final_norm"], x, cfg.norm_eps)

    @staticmethod
    def _cross_kv(p, enc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """A cross-attention's k/v [B, Sa, Hkv, dh] from the encoder output:
        plain products (no BaseOp, so no adapter), plus the biases."""
        k = torch.einsum("bsd,dhk->bshk", enc, p["w_k"])
        v = torch.einsum("bsd,dhk->bshk", enc, p["w_v"])
        if "b_k" in p:
            k, v = k + p["b_k"], v + p["b_v"]
        return k, v

    def _audio_block(self, lp, x, enc):
        """One decoder layer: causal self-attention (no segments, no
        positions: the JAX package's), the cross-attention over ``enc``,
        the MLP."""
        cfg = self.cfg
        h = _apply_norm(lp["ln1"], x, cfg.norm_eps)
        x = x + attn.attention_apply(lp["attn"], h, cfg, mode=self.attn_mode, causal=True)
        h = _apply_norm(lp["ln_cross"], x, cfg.norm_eps)
        x = x + attn.attention_apply(lp["cross"], h, cfg,
                                     kv_override=self._cross_kv(lp["cross"], enc))
        h = _apply_norm(lp["ln2"], x, cfg.norm_eps)
        return x + mlp_apply(lp["mlp"], h, cfg.gated_mlp)

    def _run_audio(self, params, audio_embed, x, adapters, ctx_factory):
        """The encoder, then the decoder over the token embeddings ``x``
        plus the sinusoidal table, each layer under its adapter slice (the
        JAX ``_forward_audio``)."""
        cfg = self.cfg
        enc = self._encode_audio(params, audio_embed)
        S = x.shape[1]
        x = x + sinusoidal_positions(S, cfg.d_model, x.device).to(x.dtype)[None]
        for i in range(cfg.num_layers):
            ad = _slice_layer(adapters, i) if adapters is not None else None
            with adapter_scope(ctx_factory(ad) if ctx_factory and ad is not None else None):
                x = self._audio_block(_slice_layer(params["layers"], i), x, enc)
        return x

    # ------------------------------------------------------------------
    # Decode (serving)
    # ------------------------------------------------------------------

    def _refuse_hybrid(self, what: str) -> None:
        if self.cfg.family not in ("dense", "vlm", "moe"):
            raise NotImplementedError(
                f"{what} supports the dense and MoE families and vlm, not "
                f"{self.cfg.family}; "
                f"drive a {self.cfg.family} prompt through decode_step instead")

    def init_decode_state(self, batch: int, max_len: int, cache_dtype=torch.bfloat16,
                          prefix_reserve: int = 0, *, params=None,
                          audio_embed: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """Per-row decode state (the JAX ``per_row=True`` layout): ``kv``
        caches [L, B, prefix_reserve + max_len, Hkv, dh] (the hybrid family:
        one per application of the shared block, [n_super, ...]), ``pos``
        [B] the real token count of each row, ``lo`` [B] each row's first
        valid cache index.  The hybrid family adds ``mamba``: each Mamba2
        block's state (``ssm.mamba2_init_state``: ``h`` f32 and the bf16
        conv window, whatever ``cache_dtype``), stacked [n_super, per, ...].
        The audio family adds the fixed cross caches ``cross_k`` /
        ``cross_v`` [L, B, Sa, Hkv, dh]: each decoder layer's ``_cross_kv``
        of the encoder's output over ``audio_embed`` [B, Sa, d] (with
        ``params``), or zeros of ``max_source_positions`` rows without it.
        The ``ssm`` family has no cache: ``pos``, ``lo``, and each block's
        state, ``mlstm`` (``ssm.mlstm_init_state``, stacked [n_super, per,
        ...]) and ``slstm`` ([n_super, ...]), all f32."""
        cfg = self.cfg
        dev = self.device
        if cfg.family == "ssm":
            n_super, per = cfg.num_layers // cfg.slstm_period, cfg.slstm_period - 1
            return {
                "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
                "lo": torch.full((batch,), prefix_reserve, dtype=torch.int32, device=dev),
                "mlstm": {k: v.expand((n_super, per) + v.shape).contiguous()
                          for k, v in ssm.mlstm_init_state(cfg, batch, dev).items()},
                "slstm": {k: v.expand((n_super,) + v.shape).contiguous()
                          for k, v in ssm.slstm_init_state(cfg, batch, dev).items()}}
        hybrid = cfg.family == "hybrid"
        n_cache = cfg.num_layers // cfg.hybrid_period if hybrid else cfg.num_layers
        hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim()
        shape = (n_cache, batch, prefix_reserve + max_len, hkv, dh)
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
        if cfg.family == "audio":
            src = audio_embed.shape[1] if audio_embed is not None else cfg.max_source_positions
            cshape = (cfg.num_layers, batch, src, hkv, dh)
            ck = torch.zeros(cshape, dtype=cache_dtype, device=dev)
            cv = torch.zeros(cshape, dtype=cache_dtype, device=dev)
            if audio_embed is not None:
                enc = self._encode_audio(params, audio_embed)
                for i in range(cfg.num_layers):
                    k, v = self._cross_kv(_slice_layer(params["layers"]["cross"], i), enc)
                    ck[i], cv[i] = k.to(cache_dtype), v.to(cache_dtype)
            state["cross_k"], state["cross_v"] = ck, cv
        return state

    def prefill(self, params, batch: Dict[str, torch.Tensor], state: Dict[str, Any],
                adapters: Any = None, ctx_factory: Optional[CtxFactory] = None,
                prefix_reserve: int = 0, lengths: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Chunked prompt processing into the decode KV cache: one forward
        over the (padded) prompt, whose post-RoPE k/v rows are written in
        place at offset ``prefix_reserve``.  ``lengths`` [B] are the true
        prompt lengths (junk past them stays outside the window).  Returns
        (logits over the prompt, state with ``pos`` set).  Dense, vlm and
        MoE families, as in the JAX package; a vlm batch carries its
        ``mrope_positions``."""
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

    def _decode_block(self, lp, x, cache, mrope=None, cross=None):
        """One attention+MLP block (a dense, vlm or MoE layer, or the hybrid
        family's shared block) over one decode token a row; ``mrope`` the
        token's M-RoPE channels; ``cross`` an audio decoder layer's fixed
        cross cache, read between the self-attention and the MLP."""
        cfg = self.cfg
        h = _apply_norm(lp["ln1"], x, cfg.norm_eps)
        a, _ = attn.attention_decode_apply(lp["attn"], h, cfg, cache, mrope_positions=mrope)
        x = x + a
        if cross is not None:
            h = _apply_norm(lp["ln_cross"], x, cfg.norm_eps)
            c, _ = attn.attention_decode_apply(lp["cross"], h, cfg, cross, update_cache=False)
            x = x + c
        h = _apply_norm(lp["ln2"], x, cfg.norm_eps)
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
        ``adapters["shared_attn"]`` over that super-block's KV cache.  The
        vlm family rotates by M-RoPE with ``pos`` on all three channels.
        The audio family adds each position's sinusoidal row to the token's
        embedding and runs each decoder layer's cross-attention over its
        fixed cross cache: the whole of it (``lo`` 0, ``len`` its rows),
        q rotated at the cache's row count as in the JAX package (whose
        cross cache has no ``t``).  The ``ssm`` family runs each mLSTM
        block's recurrent step and each sLSTM block's on their states
        (updated in place)."""
        cfg = self.cfg
        pos = state["pos"]
        x = embed_apply(params["embed"], tokens)
        new_state = dict(state, pos=pos + 1)

        def scope(ad):
            return adapter_scope(ctx_factory(ad) if ctx_factory and ad is not None else None)

        if cfg.family == "ssm":
            ml, sl = state["mlstm"], state["slstm"]
            for i, (mb, adm, sb, ads) in enumerate(self._xlstm_blocks(params, adapters)):
                for j in range(cfg.slstm_period - 1):
                    lp = _slice_layer(mb, j)
                    with scope(_slice_layer(adm, j) if adm is not None else None):
                        h = _apply_norm(lp["ln"], x, cfg.norm_eps)
                        x = x + ssm.mlstm_apply(lp["mlstm"], h, cfg,
                                                state={"h": ml["h"][i, j]})
                with scope(ads):
                    h = _apply_norm(sb["ln"], x, cfg.norm_eps)
                    x = x + ssm.slstm_apply(sb["slstm"], h, cfg,
                                            state={k: v[i] for k, v in sl.items()})
            x = _apply_norm(params["final_norm"], x, cfg.norm_eps)
            return self._logits(params, x), new_state
        kc_all, vc_all = state["kv"]["k"], state["kv"]["v"]
        B = tokens.shape[0]
        mrope = pos.reshape(1, -1, 1).expand(3, B, 1).to(torch.int32) if cfg.mrope else None
        cross = None
        if cfg.family == "audio":
            pe = sinusoidal_positions(kc_all.shape[2], cfg.d_model, x.device)
            x = x + pe[pos.long()][:, None].to(x.dtype)
            n_src = torch.full((B,), state["cross_k"].shape[2], dtype=torch.int32,
                               device=x.device)

            def cross(i):
                return {"k": state["cross_k"][i], "v": state["cross_v"][i], "len": n_src,
                        "t": n_src, "lo": torch.zeros_like(n_src)}

        def cache(i):
            return {"k": kc_all[i], "v": vc_all[i], "len": prefix_reserve + pos, "t": pos,
                    "lo": state["lo"]}

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
                    x = self._decode_block(_slice_layer(params["layers"], i), x, cache(i),
                                           mrope, cross(i) if cross else None)
        x = _apply_norm(params["final_norm"], x, cfg.norm_eps)
        return self._logits(params, x), new_state


def build_model(cfg: ArchConfig, tp_size: int = 1, device="cuda") -> Model:
    """The model with the attention mode for a TP degree: ``pairs`` when the
    heads divide over ``tp_size`` (or the config has no attention), else
    ``kvscan`` (the JAX ``build_model``)."""
    if cfg.attention == "none":
        return Model(cfg, device, attn_mode="pairs")
    mode = "pairs" if (tp_size <= 1 or cfg.num_heads % tp_size == 0) else "kvscan"
    return Model(cfg, device, attn_mode=mode)
