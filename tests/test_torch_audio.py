"""The audio family (whisper-large-v3) against the JAX package, on the CPU.

* ``layer_norm`` and ``sinusoidal_positions``;
* whisper's spec (full and smoke) and the tree ``convert`` carries across:
  the same leaves and shapes as JAX's (LayerNorm ``b``, the MLP's
  ``b_fc1`` / ``b_fc2``, ``encoder``, ``enc_final_norm``, ``ln_cross``,
  ``cross``);
* ``_encode_audio``: the non-causal encoder with RoPE inside and the
  sinusoidal table;
* the forward's logits and per-token loss with LoRA tenants and an IA3
  tenant on ``attn_k`` / ``attn_v``: the decoder's adapter scope covers the
  cross-attention's q / o, while the cross k / v take no adapter (an IA3
  scale there would move the logits); ``segment_ids`` in the batch are
  ignored by both (the decoder's self-attention takes none);
* ``init_decode_state(audio_embed=...)``'s cross caches and eight
  ``decode_step``s with adapters: the cross-attention's q is rotated at the
  cache's row count, as in the JAX package; the decode against the port's
  own forward (as JAX's ``test_decode_parity.py``);
* one ``build_train_step`` (loss, per-task losses, the gradient in AdamW's
  first moment, the updated adapters);
* the int8 walk's quantized and dense leaves (the cross k / v stay dense);
* ``prefill`` and ``MuxTuneService`` refuse the audio family as JAX's do.

Everything runs in f32 (weights carried across by ``repro_torch.convert``)
and is held within 2e-4 of the largest |value| (losses at rtol 2e-4); the
JAX side runs on its xla tier, both at ``attn_q_block=128``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.launch import steps as jsteps
from repro.models import layers as jlayers
from repro.models import quantize as jquant
from repro.models.layers import ParamSpec as JaxParamSpec
from repro.models.transformer import build_model
from repro.peft.methods import AdapterConfig as JaxAdapterConfig
from repro.peft.multitask import MultiTaskAdapters as JaxMultiTaskAdapters
from repro.peft.multitask import TaskSegments as JaxSegments
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import adapters_from_numpy, backbone_from_numpy
from repro_torch.core import ParallelismSpec
from repro_torch.launch import steps
from repro_torch.models import layers
from repro_torch.models import quantize as pquant
from repro_torch.models.layers import ParamSpec
from repro_torch.models.transformer import Model
from repro_torch.peft.methods import AdapterConfig
from repro_torch.peft.multitask import MultiTaskAdapters, TaskSegments
from repro_torch.train.optimizer import adamw_init

ARCH = "whisper-large-v3"
JCFG = jax_smoke_config(ARCH).with_overrides(attn_q_block=128)
PCFG = smoke_config(ARCH).with_overrides(attn_q_block=128)
# two LoRA tenants on the decoder's q / o / fc1 and an IA3 tenant on k / v
TENANTS = (("lora", 4, ("attn_q", "attn_o", "mlp_fc1")),
           ("lora", 2, ("attn_q", "attn_v", "mlp_fc2")),
           ("ia3", 0, ("attn_k", "attn_v")))
# the training step's tenants: LoRA / Adapter / IA3 on q, v, fc1, fc2
TRAIN = (("lora", 8), ("lora", 4), ("adapter", 4), ("ia3", 0))
TRAIN_TARGETS = ("attn_q", "attn_v", "mlp_fc1", "mlp_fc2")
FILLED = ("b", "up", "s")  # the adapter leaves that start at zero (IA3's s at 1)
B, S = 3, 8
REL = 2e-4


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        elif v is not None:
            out[prefix + (k,)] = v.detach().float().numpy() if torch.is_tensor(v) \
                else np.asarray(v, np.float32)
    return out


def _close(got, want, rel=REL, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


def _fill(tree, rs, leaves, scale):
    for k, v in tree.items():
        if isinstance(v, dict):
            _fill(v, rs, leaves, scale)
        elif k in leaves:
            tree[k] = (rs.randn(*v.shape) * scale + (1.0 if k == "s" else 0.0)).astype(np.float32)


def _adapter_cfgs(cls, tenants):
    return [cls(kind, rank=max(r, 1), alpha=8.0, targets=tg) for kind, r, tg in tenants]


@pytest.fixture(scope="module")
def pair():
    """JAX and port whisper models on one f32 backbone (biases, LayerNorm
    weights and biases random), one adapter set of ``TENANTS`` (zero leaves
    filled), the frame embeddings and tokens."""
    model = build_model(JCFG)
    bb_np = _np_tree(jax.jit(model.init)(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(0)
    _fill(bb_np, rs, ("b_q", "b_k", "b_v", "b_o", "b_fc1", "b_fc2", "b"), 0.1)
    mta = JaxMultiTaskAdapters(JCFG, _adapter_cfgs(JaxAdapterConfig, TENANTS))
    ad_np = _np_tree(mta.init(jax.random.PRNGKey(1)))
    _fill(ad_np, rs, FILLED, 0.3)
    mta_t = MultiTaskAdapters(PCFG, _adapter_cfgs(AdapterConfig, TENANTS), device="cpu")
    audio = rs.randn(B, JCFG.max_source_positions, JCFG.d_model).astype(np.float32)
    tokens = rs.randint(1, JCFG.vocab_size, (B, S)).astype(np.int32)
    return {"model": model, "mta": mta, "bb": jax.tree.map(jnp.asarray, bb_np),
            "ad": jax.tree.map(jnp.asarray, ad_np), "bb_np": bb_np, "ad_np": ad_np,
            "model_t": Model(PCFG, device="cpu"), "mta_t": mta_t,
            "bb_t": backbone_from_numpy(bb_np, PCFG, "cpu", torch.float32),
            "ad_t": adapters_from_numpy(ad_np, mta_t, "cpu"), "audio": audio, "tokens": tokens}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_layer_norm_matches_jax(dtype):
    rs = np.random.RandomState(1)
    x = (rs.randn(2, 5, 64) * 3 + 1).astype(np.float32)
    w, b = rs.randn(64).astype(np.float32), rs.randn(64).astype(np.float32)
    if dtype == "bf16":
        want = jlayers.layer_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b),
                                  1e-6)
        got = layers.layer_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                                torch.from_numpy(b), 1e-6)
        assert got.dtype == torch.bfloat16
        _close(got.float().numpy(), np.asarray(want, np.float32), rel=2.0 ** -7, what="bf16")
    else:
        want = jlayers.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-6)
        got = layers.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                                1e-6)
        _close(got.numpy(), want, rel=1e-6, what="f32")


@pytest.mark.parametrize("length,dim", [(1500, 1280), (16, 64)])
def test_sinusoidal_positions_match_jax(length, dim):
    want = np.asarray(jlayers.sinusoidal_positions(length, dim))
    got = layers.sinusoidal_positions(length, dim).numpy()
    assert got.shape == (length, dim)
    # f32 sin / cos of angles up to 1,500: a few f32 units of the angle
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


# ---------------------------------------------------------------------------
# the trees
# ---------------------------------------------------------------------------


def _shapes(tree, leaf_cls, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, leaf_cls, prefix + (k,)))
        else:
            out[prefix + (k,)] = (tuple(v.shape), v.init)
    return out


@pytest.mark.parametrize("smoke", [False, True])
def test_spec_has_the_jax_layout(smoke):
    jcfg, cfg = (jax_smoke_config(ARCH), smoke_config(ARCH)) if smoke else \
        (jax_get_config(ARCH), get_config(ARCH))
    want = _shapes(build_model(jcfg).spec(), JaxParamSpec)
    got = _shapes(Model(cfg, device="cpu").spec(), ParamSpec)
    assert got == want
    assert ("enc_final_norm", "b") in got and ("layers", "cross", "w_k") in got
    assert ("encoder", "mlp", "b_fc1") in got and ("layers", "ln_cross", "b") in got
    if not smoke:
        n = sum(int(np.prod(s)) for s, _ in got.values())
        assert n > cfg.param_count() > 1.53e9  # the count leaves out the biases


def test_converted_tree_equals_jax(pair):
    want, got = pair["bb_np"], _flat(pair["bb_t"])
    flat = _flat(want)
    assert sorted(got) == sorted(flat)
    for path, v in flat.items():
        np.testing.assert_array_equal(got[path], v, err_msg=str(path))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_encode_audio_matches_jax(pair):
    want = jax.jit(pair["model"]._encode_audio)(pair["bb"], jnp.asarray(pair["audio"]))
    with torch.no_grad():
        got = pair["model_t"]._encode_audio(pair["bb_t"], torch.from_numpy(pair["audio"]))
    _close(got.numpy(), want, what="encoder")


def _batch(pair, labels=True):
    rs = np.random.RandomState(9)
    batch = {"tokens": pair["tokens"], "audio_embed": pair["audio"],
             # the decoder's self-attention takes no segments: both ignore them
             "segment_ids": np.asarray([[0] * 4 + [1] * 4] * B, np.int32)}
    if labels:
        batch["labels"] = rs.randint(1, JCFG.vocab_size, (B, S)).astype(np.int32)
        batch["loss_mask"] = (rs.rand(B, S) > 0.2).astype(np.float32)
    return batch


def test_forward_matches_jax_and_cross_kv_takes_no_adapter(pair):
    """Logits and per-token loss with LoRA rows (q / o hit the self and the
    cross attention) and an IA3 row on k / v; then with the IA3 scales on
    the decoder's k / v set to 1 the logits of the IA3 row change, while a
    port forward with the cross k / v themselves scaled shows the scale
    would have mattered there."""
    batch = _batch(pair)
    jf = pair["mta"].ctx_factory(JaxSegments.contiguous([1, 1, 1]))
    pf = pair["mta_t"].ctx_factory(TaskSegments.contiguous([1, 1, 1]))
    want = jax.jit(lambda bb, b, ad: pair["model"].forward(
        bb, b, adapters=ad, ctx_factory=jf, return_logits=True))(
        pair["bb"], {k: jnp.asarray(v) for k, v in batch.items()}, pair["ad"])
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got = pair["model_t"].forward(pair["bb_t"], tb, adapters=pair["ad_t"], ctx_factory=pf,
                                      return_logits=True)
    vocab = JCFG.vocab_size
    _close(got["logits"].numpy()[..., :vocab], np.asarray(want["logits"])[..., :vocab],
           what="logits")
    np.testing.assert_allclose(got["per_token_loss"].numpy(),
                               np.asarray(want["per_token_loss"]), rtol=2e-4, atol=2e-4)
    # the cross k / v are plain products: were the IA3 scale applied there,
    # the IA3 row's logits would move
    model_t = pair["model_t"]
    orig = model_t._cross_kv
    try:
        model_t._cross_kv = lambda p, enc: tuple(t * 1.5 for t in orig(p, enc))
        with torch.no_grad():
            moved = model_t.forward(pair["bb_t"], tb, adapters=pair["ad_t"], ctx_factory=pf,
                                    return_logits=True)["logits"]
    finally:
        model_t._cross_kv = orig
    assert float((moved[2] - got["logits"][2]).abs().max()) > 1e-3


def _decode(pair, lib, steps_n=8):
    tokens = pair["tokens"]
    if lib == "jax":
        mta, model = pair["mta"], pair["model"]
        slots = {k: jnp.asarray(v) for k, v in mta.decode_row_slots([0, 1, 2]).items()}
        ctxf = mta.ctx_factory_from_slots(slots)
        st = model.init_decode_state(pair["bb"], B, S + 1, audio_embed=jnp.asarray(pair["audio"]),
                                     cache_dtype=jnp.float32, per_row=True)
        cross = (np.asarray(st["cross_k"]), np.asarray(st["cross_v"]))
        step = jax.jit(lambda bb, st, tok, ad: model.decode_step(bb, st, tok, adapters=ad,
                                                                 ctx_factory=ctxf))
        out = []
        for t in range(steps_n):
            lg, st = step(pair["bb"], st, jnp.asarray(tokens[:, t:t + 1]), pair["ad"])
            out.append(np.asarray(lg[:, 0]))
        return out, cross, np.asarray(st["kv"]["k"])
    mta, model = pair["mta_t"], pair["model_t"]
    slots = {k: torch.from_numpy(v) for k, v in mta.decode_row_slots([0, 1, 2]).items()}
    ctxf = mta.ctx_factory_from_slots(slots)
    with torch.no_grad():
        st = model.init_decode_state(B, S + 1, cache_dtype=torch.float32, params=pair["bb_t"],
                                     audio_embed=torch.from_numpy(pair["audio"]))
        cross = (st["cross_k"].numpy().copy(), st["cross_v"].numpy().copy())
        out = []
        for t in range(steps_n):
            lg, st = model.decode_step(pair["bb_t"], st, torch.from_numpy(tokens[:, t:t + 1]),
                                       adapters=pair["ad_t"], ctx_factory=ctxf)
            out.append(lg[:, 0].numpy())
    return out, cross, st["kv"]["k"].numpy()


def test_decode_matches_jax(pair):
    """The cross caches, eight decode steps' logits and the self cache."""
    (jl, jc, jk), (pl, pc, pk) = _decode(pair, "jax"), _decode(pair, "port")
    assert pc[0].shape == (PCFG.num_layers, B, PCFG.max_source_positions, PCFG.num_kv_heads,
                           PCFG.resolved_head_dim())
    _close(pc[0], jc[0], what="cross_k")
    _close(pc[1], jc[1], what="cross_v")
    vocab = JCFG.vocab_size
    for t, (a, b) in enumerate(zip(pl, jl)):
        _close(a[..., :vocab], b[..., :vocab], what=f"decode step {t}")
    _close(pk, jk, what="self k cache")


def test_decode_tracks_own_forward(pair):
    """Decode against the port's own forward over the same tokens, as the
    JAX package's ``test_decode_parity.py`` holds its own: the decode's
    cross-attention q is rotated at the cache's row count, the forward's at
    each token's index, so the two agree only in distribution."""
    pl, _, _ = _decode(pair, "port")
    pf = pair["mta_t"].ctx_factory(TaskSegments.contiguous([1, 1, 1]))
    with torch.no_grad():
        fwd = pair["model_t"].forward(pair["bb_t"], {k: torch.from_numpy(v) for k, v in
                                                     _batch(pair, labels=False).items()},
                                      adapters=pair["ad_t"], ctx_factory=pf,
                                      return_logits=True)["logits"].numpy()
    dec = np.stack(pl, axis=1)
    pf_, pd = torch.softmax(torch.from_numpy(fwd), -1), torch.softmax(torch.from_numpy(dec), -1)
    assert float((pf_ - pd).abs().max()) < 0.08
    assert float(np.mean(fwd.argmax(-1) == dec.argmax(-1))) > 0.85


def test_build_train_step_matches_jax(pair):
    """One step of LoRA / Adapter / IA3 tenants on q, v, fc1 and fc2: the
    loss, the per-task losses, the gradient (AdamW's first moment after one
    step is 0.1 g), the second moment and the updated adapters."""
    tenants = [(kind, r, TRAIN_TARGETS) for kind, r in TRAIN]
    mta = JaxMultiTaskAdapters(JCFG, _adapter_cfgs(JaxAdapterConfig, tenants))
    ad_np = _np_tree(mta.init(jax.random.PRNGKey(3)))
    _fill(ad_np, np.random.RandomState(4), FILLED, 0.05)
    mta_t = MultiTaskAdapters(PCFG, _adapter_cfgs(AdapterConfig, tenants), device="cpu")
    ad = jax.tree.map(jnp.asarray, ad_np)
    rs = np.random.RandomState(5)
    batch = {"tokens": rs.randint(1, JCFG.vocab_size, (4, S)).astype(np.int32),
             "labels": rs.randint(1, JCFG.vocab_size, (4, S)).astype(np.int32),
             "loss_mask": (rs.rand(4, S) > 0.2).astype(np.float32),
             "audio_embed": rs.randn(4, JCFG.max_source_positions, JCFG.d_model).astype(
                 np.float32)}
    jstep = jax.jit(jsteps.build_train_step(pair["model"], mta,
                                            JaxSegments.contiguous([1, 1, 1, 1]), lr=1e-3))
    jad, jopt, jloss, jpt = jstep(pair["bb"], ad, jax_adamw_init(ad),
                                  {k: jnp.asarray(v) for k, v in batch.items()})
    tad = adapters_from_numpy(ad_np, mta_t, "cpu")
    step = steps.build_train_step(pair["model_t"], mta_t, TaskSegments.contiguous([1, 1, 1, 1]),
                                  lr=1e-3)
    pad, popt, ploss, ppt = step(pair["bb_t"], tad, adamw_init(tad),
                                 {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=2e-4)
    np.testing.assert_allclose(ppt.numpy(), np.asarray(jpt), rtol=2e-4)
    assert sorted(pad) == ["adapter", "ia3", "lora"]
    for name, jtree, ptree in (("params", jad, pad), ("m", jopt.m, popt.m),
                               ("v", jopt.v, popt.v)):
        jf, pf = _flat(jtree), _flat(ptree)
        assert sorted(jf) == sorted(pf)
        for path in jf:
            np.testing.assert_allclose(pf[path], jf[path], rtol=2e-4,
                                       atol=2e-4 * max(np.abs(jf[path]).max(), 1e-12),
                                       err_msg=f"{name} {path}")
    assert np.abs(_flat(popt.m)[("lora", "mlp_fc2", "a")]).max() > 0


def test_int8_walk_matches_jax(pair):
    """The quantized and the dense leaves of the int8 walk (the cross k / v
    stay dense, every other attention and MLP weight is an int8 node, the
    biases and norms dense), q bit for bit."""
    jq = jquant.quantize_backbone(pair["bb"], JCFG.with_overrides(backbone_dtype="int8"))
    pq = pquant.quantize_backbone(backbone_from_numpy(pair["bb_np"], PCFG, "cpu", torch.float32),
                                  PCFG.with_overrides(backbone_dtype="int8"))

    def walk(node, path, is_q, out):
        if is_q(node):
            out[path] = ("q", node["q"])
            return
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,), is_q, out)
            else:
                out[path + (k,)] = ("dense", None)

    jw, pw = {}, {}
    walk(jq, (), jquant.is_quantized, jw)
    walk(pq, (), pquant.is_quantized, pw)
    assert {p: k for p, (k, _) in pw.items()} == {p: k for p, (k, _) in jw.items()}
    assert pw[("layers", "cross", "w_k")][0] == "dense"
    assert pw[("layers", "cross", "w_q")][0] == "q"
    assert pw[("encoder", "attn", "w_k")][0] == "q"
    for path, (kind, q) in pw.items():
        if kind == "q":
            np.testing.assert_array_equal(q.numpy(), np.asarray(jw[path][1]), err_msg=str(path))


def test_prefill_and_service_refuse_audio(pair):
    """As in the JAX package: ``prefill`` stays dense / vlm / MoE only (a
    whisper prompt goes through ``decode_step``) and the service rejects
    audio requests."""
    from repro import serve as jserve
    from repro.core import ParallelismSpec as JaxParallelism
    from repro_torch.serve import MuxTuneService, RequestSpec

    tok = np.zeros((1, 4), np.int32)
    with pytest.raises(NotImplementedError, match="decode_step"):
        pair["model_t"].prefill(pair["bb_t"], {"tokens": torch.from_numpy(tok)},
                                pair["model_t"].init_decode_state(1, 8))
    with pytest.raises(NotImplementedError, match="decode_step"):
        pair["model"].prefill(pair["bb"], {"tokens": jnp.asarray(tok)}, None)
    svc = MuxTuneService(PCFG, ParallelismSpec(), device="cpu")
    assert svc.submit_request("t", RequestSpec([3, 5], max_new_tokens=2)).reason == \
        "family_unsupported"
    jsvc = jserve.MuxTuneService(JCFG, JaxParallelism())
    assert jsvc.submit_request("t", jserve.RequestSpec([3, 5], max_new_tokens=2)).reason == \
        "family_unsupported"


# ---------------------------------------------------------------------------
# the reference's behaviour the port follows
# ---------------------------------------------------------------------------


class _Counter:
    """An adapter context that counts the BaseOp calls of each site and
    leaves their outputs as they are."""

    def __init__(self):
        self.calls = {}

    def has(self, name):
        return True

    def reads_base_weight(self, name):
        return False

    def apply(self, name, x, base_out, w=None):
        self.calls[name] = self.calls.get(name, 0) + 1
        return base_out

    def attn_prefix(self):
        return None


def test_decoder_scope_covers_the_cross_attention(pair):
    """Per decoder layer the adapter scope sees q and o twice (self and
    cross attention), k and v once (the cross k / v are plain products of
    the encoder output), fc1 and fc2 once; the encoder sees none."""
    from repro_torch.peft.hooks import adapter_scope

    counters = []

    def factory(_ad):
        counters.append(_Counter())
        return counters[-1]

    tb = {k: torch.from_numpy(v) for k, v in _batch(pair, labels=False).items()}
    with torch.no_grad():
        pair["model_t"].forward(pair["bb_t"], tb, adapters=pair["ad_t"], ctx_factory=factory)
        with adapter_scope(None):
            pair["model_t"]._encode_audio(pair["bb_t"], tb["audio_embed"])
    assert len(counters) == PCFG.num_layers
    for c in counters:
        assert c.calls == {"attn_q": 2, "attn_k": 1, "attn_v": 1, "attn_o": 2, "mlp_fc1": 1,
                           "mlp_fc2": 1}


def test_decoder_self_attention_takes_no_segments(pair):
    """Packed rows of the decoder see each other (JAX's ``_forward_audio``
    passes no ``segment_ids``): the logits ignore the batch's segments."""
    batch = {k: torch.from_numpy(v) for k, v in _batch(pair, labels=False).items()}
    with torch.no_grad():
        a = pair["model_t"].forward(pair["bb_t"], batch, return_logits=True)["logits"]
        batch.pop("segment_ids")
        b = pair["model_t"].forward(pair["bb_t"], batch, return_logits=True)["logits"]
    assert torch.equal(a, b)


def test_rope_runs_inside_whisper(monkeypatch):
    """Every attention of whisper rotates q by RoPE, as the JAX package
    does: the encoder's non-causal self-attention (q and k) and the
    cross-attention (q alone; the encoder's k rows are not rotated) match
    JAX's, and leave it with RoPE taken out of the port."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as pattn

    rs = np.random.RandomState(11)
    spec = Model(PCFG, device="cpu").spec()["layers"]["cross"]
    p_np = {k: (rs.randn(*s.shape[1:]) * 0.3).astype(np.float32) for k, s in spec.items()}
    jp = {n: jnp.asarray(a) for n, a in p_np.items()}
    tp = {n: torch.from_numpy(a) for n, a in p_np.items()}
    x = rs.randn(2, 12, PCFG.d_model).astype(np.float32)
    kv = [rs.randn(2, 16, PCFG.num_kv_heads, PCFG.resolved_head_dim()).astype(np.float32)
          for _ in range(2)]
    cases = {"encoder": (dict(causal=False), dict(causal=False)),
             "cross": (dict(kv_override=tuple(jnp.asarray(a) for a in kv)),
                       dict(kv_override=tuple(torch.from_numpy(a) for a in kv)))}
    for name, (jkw, pkw) in cases.items():
        want = np.asarray(jattn.attention_apply(jp, jnp.asarray(x), JCFG, **jkw))
        with torch.no_grad():
            got = pattn.attention_apply(tp, torch.from_numpy(x), PCFG, **pkw).numpy()
            with monkeypatch.context() as m:
                m.setattr(pattn, "apply_rope", lambda t, positions, theta: t)
                bare = pattn.attention_apply(tp, torch.from_numpy(x), PCFG, **pkw).numpy()
        _close(got, want, what=name)
        assert np.abs(bare - want).max() > 100 * REL * np.abs(want).max(), name


def test_cross_decode_rotates_q_at_the_cache_length():
    """The JAX cross-attention decode passes a cache with no ``t``, so q is
    rotated at ``len`` (the encoder's row count): the port's fixed-cache
    decode with ``t = len`` matches it, with ``t = 0`` it does not."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as pattn

    rs = np.random.RandomState(8)
    spec = Model(PCFG, device="cpu").spec()["layers"]["cross"]
    p_np = {k: (rs.randn(*s.shape[1:]) * 0.2).astype(np.float32) for k, s in spec.items()}
    Bd, Sa = 2, PCFG.max_source_positions
    x = rs.randn(Bd, 1, PCFG.d_model).astype(np.float32)
    k = rs.randn(Bd, Sa, PCFG.num_kv_heads, PCFG.resolved_head_dim()).astype(np.float32)
    v = rs.randn(*k.shape).astype(np.float32)
    want, _ = jattn.attention_decode_apply(
        {n: jnp.asarray(a) for n, a in p_np.items()}, jnp.asarray(x), JCFG,
        {"k": jnp.asarray(k), "v": jnp.asarray(v), "len": jnp.asarray(Sa, jnp.int32)},
        update_cache=False)
    tp = {n: torch.from_numpy(a) for n, a in p_np.items()}

    def port(t):
        cache = {"k": torch.from_numpy(k), "v": torch.from_numpy(v),
                 "len": torch.full((Bd,), Sa, dtype=torch.int32),
                 "t": torch.full((Bd,), t, dtype=torch.int32),
                 "lo": torch.zeros((Bd,), dtype=torch.int32)}
        y, out = pattn.attention_decode_apply(tp, torch.from_numpy(x), PCFG, cache,
                                              update_cache=False)
        assert out is cache and int(out["len"][0]) == Sa  # nothing written or advanced
        return y.numpy()

    _close(port(Sa), want, what="q at len")
    assert np.abs(port(0) - np.asarray(want)).max() > 100 * REL * np.abs(want).max()
