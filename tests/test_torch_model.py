"""The port's dense model with multi-task LoRA against the JAX package.

The JAX backbone and adapter trees (random, cast to float32, LoRA's B filled
with non-zero values from a numpy seed) are carried across with
``repro_torch.convert``; the forward logits of both must agree at rtol/atol
1e-4 on both JAX kernel tiers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.kernels import ops as jops
from repro.models.transformer import build_model
from repro.peft.methods import AdapterConfig as JaxAdapterConfig
from repro.peft.multitask import MultiTaskAdapters as JaxMultiTaskAdapters
from repro_torch.configs import smoke_config
from repro_torch.convert import adapters_from_numpy, backbone_from_numpy
from repro_torch.models.transformer import Model
from repro_torch.peft.methods import AdapterConfig
from repro_torch.peft.multitask import MultiTaskAdapters

SITES = ("attn_q", "attn_k", "attn_v", "attn_o", "mlp_gate", "mlp_up", "mlp_down")
TENANTS = ((4, 8.0), (8, 4.0), (2, 6.0))  # (rank, alpha): stack rank 8


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax backbone, jax mta, jax adapters, numpy trees, port objects)."""
    cfg = jax_smoke_config("llama3.2-3b")
    model = build_model(cfg)
    bb_np = _np_tree(model.init(jax.random.PRNGKey(0)))
    mta = JaxMultiTaskAdapters(cfg, [JaxAdapterConfig("lora", rank=r, alpha=a, targets=SITES)
                                     for r, a in TENANTS])
    ad_np = _np_tree(mta.init(jax.random.PRNGKey(1)))
    rs = np.random.RandomState(0)
    for site in ad_np["lora"].values():  # LoRA's B starts at 0: fill it
        site["b"] = (rs.randn(*site["b"].shape) * 0.1).astype(np.float32)

    cfg_t = smoke_config("llama3.2-3b")
    model_t = Model(cfg_t, device="cpu")
    mta_t = MultiTaskAdapters(cfg_t, [AdapterConfig("lora", rank=r, alpha=a, targets=SITES)
                                      for r, a in TENANTS], device="cpu")
    return {
        "model": model, "mta": mta, "bb": jax.tree.map(jnp.asarray, bb_np),
        "ad": jax.tree.map(jnp.asarray, ad_np), "bb_np": bb_np, "ad_np": ad_np,
        "model_t": model_t, "mta_t": mta_t,
        "bb_t": backbone_from_numpy(bb_np, cfg_t, "cpu", torch.float32),
        "ad_t": adapters_from_numpy(ad_np, mta_t, "cpu"),
    }


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_forward_logits_match_jax(pair, impl):
    """Three tenants and one row with no adapter, in one fused batch."""
    tokens = np.random.RandomState(1).randint(1, 256, (4, 16)).astype(np.int32)
    row_task = np.asarray([0, 1, 2, -1], np.int32)
    mta = pair["mta"]
    jops.set_impl(impl)
    try:
        ctxf = mta.ctx_factory_from_slots(
            {k: jnp.asarray(v) for k, v in mta.decode_row_slots(row_task).items()})
        want = pair["model"].forward(pair["bb"], {"tokens": jnp.asarray(tokens)},
                                     adapters=pair["ad"], ctx_factory=ctxf,
                                     return_logits=True)["logits"]
    finally:
        jops.set_impl("xla")
    mta_t = pair["mta_t"]
    ctxf_t = mta_t.ctx_factory_from_slots(
        {k: torch.from_numpy(v) for k, v in mta_t.decode_row_slots(row_task).items()})
    got = pair["model_t"].forward(pair["bb_t"], {"tokens": torch.from_numpy(tokens)},
                                  adapters=pair["ad_t"], ctx_factory=ctxf_t,
                                  return_logits=True)["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    # the adapters matter: the idle row differs from a LoRA row's output
    bare = pair["model_t"].forward(pair["bb_t"], {"tokens": torch.from_numpy(tokens)},
                                   return_logits=True)["logits"]
    np.testing.assert_allclose(got[3].numpy(), bare[3].numpy(), rtol=1e-5, atol=1e-5)
    assert (got[:3] - bare[:3]).abs().max().item() > 1e-3


def test_port_spec_matches_jax_trees(pair):
    """The port declares exactly the JAX trees' leaves, with their shapes, and
    the per-slot scales are each tenant's own alpha / rank."""
    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}."))
            else:
                out[prefix + k] = tuple(v.shape)
        return out

    assert flat(pair["bb_t"]) == flat(pair["bb_np"])
    assert flat(pair["ad_t"]) == flat(pair["ad_np"])
    np.testing.assert_allclose(pair["mta_t"].scales("lora"), pair["mta"].scales("lora"))
    np.testing.assert_allclose(pair["mta_t"].scales("lora"), [a / r for r, a in TENANTS])


@pytest.mark.parametrize("edit", ["unknown_leaf", "missing_leaf", "wrong_shape"])
def test_convert_rejects_mismatched_trees(pair, edit):
    import copy

    cfg_t = pair["model_t"].cfg
    for which in ("backbone", "adapters"):
        tree = copy.deepcopy(pair["bb_np"] if which == "backbone" else pair["ad_np"])
        node = tree["layers"]["attn"] if which == "backbone" else tree["lora"]["attn_q"]
        leaf = "w_q" if which == "backbone" else "a"
        if edit == "unknown_leaf":
            node["w_extra"] = np.zeros(3, np.float32)
        elif edit == "missing_leaf":
            del node[leaf]
        else:
            node[leaf] = node[leaf][..., :1]
        err = KeyError if edit != "wrong_shape" else ValueError
        with pytest.raises(err):
            if which == "backbone":
                backbone_from_numpy(tree, cfg_t, "cpu", torch.float32)
            else:
                adapters_from_numpy(tree, pair["mta_t"], "cpu")
