"""The port's five PEFT methods of slice 5 (Prefix-Tuning, Diff-Pruning,
DoRA, VeRA, BitFit) against the JAX package, at smoke size on the CPU.

Each kind trains two tenants in one fused hTask; the eight kinds train
together too (one tenant each).  Both sides train float32 weights carried
across from the JAX ``ModelGenerator`` (integer leaves kept), with the
leaves that start at zero filled from a numpy seed so that every gradient
is live, and one ``run_iteration`` must give the JAX engine's loss,
per-task losses, adapter values and AdamW moments.

The JAX tier held to: Prefix-Tuning against ``pallas_interpret``, since the
port pads the prefix rows as the Pallas tier does (``kernels/ops.py``) and
with ``attn_q_block = 32`` that padding moves the tile rule's key tiles on
the loader's layout; VeRA and the mix against ``xla``, since the JAX
package's own VeRA check under ``pallas_interpret`` fails
(``test_peft_methods.py``); at ``attn_q_block = 128`` the xla tier's prefix
carry and the Pallas tier's padded rows see the same keys.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core import ExecutionPlanner as JaxPlanner
from repro.core import ModelGenerator as JaxGenerator
from repro.core import ParallelismSpec as JaxParallelism
from repro.core import PEFTEngine as JaxEngine
from repro.core import cost_model as jax_cost_model
from repro.data import HTaskLoader as JaxLoader
from repro.kernels import ops as jops
from repro.launch.train import parse_tasks as jax_parse_tasks
from repro.peft import MultiTaskAdapters as JaxMultiTaskAdapters
from repro.peft.methods import AdapterConfig as JaxAdapterConfig
from repro.peft.methods import get_method as jax_get_method
from repro.peft.methods.vera import _det_rows as jax_det_rows
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro_torch.configs import smoke_config
from repro_torch.convert import adapters_from_numpy, backbone_from_numpy
from repro_torch.core import ExecutionPlanner, HardwareProfile, ModelGenerator, ParallelismSpec
from repro_torch.core import PEFTEngine
from repro_torch.data import HTaskLoader
from repro_torch.kernels import ops
from repro_torch.kernels import packed_attention as pa
from repro_torch.launch.train import parse_tasks
from repro_torch.peft import hooks
from repro_torch.peft.methods import AdapterConfig, get_method, method_names
from repro_torch.peft.methods.vera import _det_rows, _threefry2x32
from repro_torch.peft.multitask import MultiTaskAdapters
from repro_torch.train.optimizer import adamw_init

KINDS = ("prefix", "diff", "dora", "vera", "bitfit")
RANKS = {"prefix": (16, 8), "diff": (16, 8), "dora": (8, 4), "vera": (64, 32),
         "bitfit": (8, 8)}
MIX = ("sst2:lora:8,qa:adapter:8,rte:ia3,sst2:prefix:16,qa:diff:16,rte:dora:8,"
       "sst2:vera:64,qa:bitfit")
FILLED = ("b", "up", "s", "delta", "dm")  # the leaves that start at zero
FROZEN = ("rows", "A", "B")                # integer and shared leaves
LR = 1e-3
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _no_kernel_launch():
    ops.reset_launch_counts()
    yield
    assert not any(ops.launch_counts().values())


class jax_impl:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.prev = jops.get_impl()
        jops.set_impl(self.name)

    def __exit__(self, *a):
        jops.set_impl(self.prev)


def np_tree(tree):
    """A JAX tree as numpy: integer leaves as they are, the rest widened to
    f32."""
    return jax.tree.map(lambda a: np.asarray(a) if jnp.issubdtype(a.dtype, jnp.integer)
                        else np.asarray(a, np.float32), tree)


def flat(tree, prefix=()):
    """{path: leaf} of a nested dict (None leaves left out)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        elif v is not None:
            out[prefix + (k,)] = v
    return out


def flat_np(tree):
    return {k: v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)
            for k, v in flat(tree).items()}


def _retarget(tasks, targets):
    return [dataclasses.replace(t, adapter=dataclasses.replace(t.adapter, targets=targets[i]))
            if i in targets else t for i, t in enumerate(tasks)]


def build_pair(tasks, *, q_block=128, backbone_dtype="bfloat16", targets=None,
               micro_batch=2):
    """The JAX engine and the port's on the same weights, plans and loaders:
    ``(jax engine, jax loaders, port engine, port loaders)``."""
    targets = targets or {}
    cfg = jax_smoke_config("llama3.2-3b").with_overrides(attn_q_block=q_block,
                                                         backbone_dtype=backbone_dtype)
    jt = _retarget(jax_parse_tasks(tasks, micro_batch), targets)
    jplan = JaxPlanner(cfg, JaxParallelism(num_stages=1)).plan(jt, n_micro=1)
    jgen = JaxGenerator(cfg, seed=0)
    jgen.register_tasks(jt)
    bb_np = np_tree(jgen.init_backbone())
    ad_np = np_tree(jgen.registered.adapter_params)
    rs = np.random.RandomState(0)
    for kind in ad_np.values():
        for site in kind.values():
            for leaf in FILLED:
                if leaf in site:
                    site[leaf] = (rs.randn(*site[leaf].shape) * 0.05).astype(np.float32)
    jgen.backbone_params = jax.tree.map(jnp.asarray, bb_np)
    jgen.registered.adapter_params = jax.tree.map(jnp.asarray, ad_np)
    jgen.registered.opt_state = jax_adamw_init(jgen.registered.adapter_params)
    jeng = JaxEngine(jgen, jplan, lr=LR)

    cfg_t = smoke_config("llama3.2-3b").with_overrides(attn_q_block=q_block,
                                                       backbone_dtype=backbone_dtype)
    pt = _retarget(parse_tasks(tasks, micro_batch), targets)
    pplan = ExecutionPlanner(cfg_t, ParallelismSpec(num_stages=1),
                             hw=HardwareProfile(peak_flops=jax_cost_model.PEAK_FLOPS,
                                                hbm_bw=jax_cost_model.HBM_BW,
                                                ici_bw=jax_cost_model.ICI_BW),
                             memory_budget=jax_cost_model.HBM_BYTES).plan(pt, n_micro=1)
    gen = ModelGenerator(cfg_t, device="cpu")
    reg = gen.register_tasks(pt)
    gen.backbone_params = backbone_from_numpy(bb_np, cfg_t, "cpu", torch.float32)
    reg.adapter_params = adapters_from_numpy(ad_np, reg.mta, "cpu")
    reg.opt_state = adamw_init(reg.adapter_params)
    peng = PEFTEngine(gen, pplan, lr=LR, device="cpu")
    jloaders = {i: JaxLoader(jt, jplan.alignment[i], cfg.vocab_size)
                for i in range(len(jplan.htasks))}
    ploaders = {i: HTaskLoader(pt, pplan.alignment[i], cfg.vocab_size)
                for i in range(len(pplan.htasks))}
    return jeng, jloaders, peng, ploaders


def _iteration_matches(jeng, jloaders, peng, ploaders, tier):
    """One run_iteration on each side: losses at rtol 2e-4, every adapter
    leaf and moment at ``TOL``, the frozen leaves unchanged."""
    before = flat_np(peng.reg.adapter_params)
    with jax_impl(tier):
        jm = jeng.run_iteration(jloaders)
    pm = peng.run_iteration(ploaders)
    np.testing.assert_allclose(pm.per_task_loss, jm.per_task_loss, rtol=2e-4)
    np.testing.assert_allclose(pm.loss, jm.loss, rtol=2e-4)
    for name, jtree, ptree in (("params", jeng.reg.adapter_params, peng.reg.adapter_params),
                               ("m", jeng.reg.opt_state.m, peng.reg.opt_state.m),
                               ("v", jeng.reg.opt_state.v, peng.reg.opt_state.v)):
        jf, pf = flat_np(jtree), flat_np(ptree)
        assert sorted(jf) == sorted(pf), name
        for path in jf:
            np.testing.assert_allclose(pf[path], np.asarray(jf[path], pf[path].dtype),
                                       err_msg=f"{name} {path}", **TOL)
    after = flat_np(peng.reg.adapter_params)
    for path, leaf in before.items():
        if path[-1] in FROZEN:
            np.testing.assert_array_equal(after[path], leaf, err_msg=str(path))
    assert int(peng.reg.opt_state.step) == int(jeng.reg.opt_state.step) == 1
    return pm


@pytest.mark.parametrize("kind", KINDS)
def test_run_iteration_matches_jax(kind):
    hi, lo = RANKS[kind]
    tier, q_block = ("pallas_interpret", 32) if kind == "prefix" else ("xla", 128)
    pair = build_pair(f"sst2:{kind}:{hi},qa:{kind}:{lo}", q_block=q_block)
    assert len(pair[2].plan.htasks) == 1
    _iteration_matches(*pair, tier)


def test_eight_kind_mix_matches_jax():
    jeng, jloaders, peng, ploaders = build_pair(MIX)
    assert len(peng.plan.htasks) == 1 and peng.plan.htasks[0].row_len == 256
    assert sorted(peng.reg.mta.kind_tasks) == sorted(method_names())
    # the integer leaf and the shared leaves have no moments / zero moments,
    # as in the JAX package
    assert peng.reg.opt_state.m["diff"]["attn_q"]["rows"] is None
    assert peng.reg.opt_state.m["vera"]["attn_q"]["A"].abs().max() == 0
    _iteration_matches(jeng, jloaders, peng, ploaders, "xla")


def test_int8_dora_matches_jax_and_dequantizes_its_sites_only(monkeypatch):
    """DoRA on attn_q and LoRA on attn_v / attn_o of an int8 backbone: one
    iteration equals JAX's, and the dense weight is built once per layer a
    forward (DoRA's site), never at the LoRA-only sites."""
    built = []
    real = hooks.dequantize
    monkeypatch.setattr(hooks, "dequantize",
                        lambda w, dtype: built.append(tuple(w["q"].shape)) or real(w, dtype))
    pair = build_pair("sst2:dora:8,qa:lora:8", backbone_dtype="int8",
                      targets={0: ("attn_q",), 1: ("attn_v", "attn_o")})
    _iteration_matches(*pair, "xla")
    cfg = pair[2].model.cfg
    d, h, dh = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim()
    assert built == [(d, h, dh)] * cfg.num_layers  # w_q's int8 block, each layer


def _loader_layout(S):
    from repro_torch.core.alignment import align_tasks
    from repro_torch.data.synthetic import make_task
    tasks = [make_task(f"t{i}", ds, 2, seed=i) for i, ds in enumerate(("sst2", "qa"))]
    arr = align_tasks(tasks, [0, 1], "chunked", row_len=S).arrays()
    return arr["positions"], arr["segment_ids"]


def test_prefix_padding_moves_key_tiles_as_the_pallas_tier():
    """ops.packed_attention with a 16-row prefix at S = 256 pads it to 64
    rows (key tiles of 64, not 16) as the JAX Pallas tier does: forward and
    gradients (q, k, v, pk, pv) equal the Pallas kernel's in interpret mode,
    and the unpadded rows would give other outputs on this layout."""
    S, P, H, Hkv, dh, bq = 256, 16, 4, 2, 16, 32
    pos, seg = _loader_layout(S)
    B = pos.shape[0]
    rs = np.random.RandomState(3)
    q, do = (rs.randn(B, S, H, dh).astype(np.float32) for _ in range(2))
    k, v = (rs.randn(B, S, Hkv, dh).astype(np.float32) for _ in range(2))
    pk, pv = (rs.randn(B, P, Hkv, dh).astype(np.float32) for _ in range(2))
    keep = (np.arange(B)[:, None] % 2 == 0).astype(np.float32) * np.ones((1, P), np.float32)

    def jfn(q, k, v, pk, pv):
        return jops.packed_attention(q, k, v, jnp.asarray(seg), jnp.asarray(pos),
                                     prefix_kv=(pk, pv), prefix_keep=jnp.asarray(keep),
                                     block_q=bq)

    with jax_impl("pallas_interpret"):
        want, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v, pk, pv)))
        want_g = vjp(jnp.asarray(do))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, pk, pv)]
    got = ops.packed_attention(*ts[:3], torch.from_numpy(seg), torch.from_numpy(pos),
                               prefix_kv=tuple(ts[3:]), prefix_keep=torch.from_numpy(keep),
                               block_q=bq)
    got_g = torch.autograd.grad(got, ts, torch.from_numpy(do))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
    # the same rows unpadded (key tiles of gcd(272, 128) = 16) see other keys
    i32 = torch.int32
    kpos = torch.cat([torch.full((B, P), -1, dtype=i32), torch.from_numpy(pos)], 1)
    kseg = torch.cat([torch.where(torch.from_numpy(keep) > 0, -1, -2).to(i32),
                      torch.from_numpy(seg)], 1)
    unpadded = pa.packed_attention_plain(
        ts[0].detach(), torch.cat([ts[3], ts[1]], 1).detach(),
        torch.cat([ts[4], ts[2]], 1).detach(), torch.from_numpy(pos), torch.from_numpy(seg),
        kpos, kseg, True, *pa.tile_sizes(S, S + P, bq))
    assert pa.tile_sizes(S, S + P, bq)[1] == 16
    assert np.abs(unpadded.numpy() - np.asarray(want)).max() > 1e-2


def test_post_init_equals_jax():
    """Diff-Pruning's rows and VeRA's shared A / B, as ``init`` builds them,
    equal the JAX package's (the stack's bf16 values, bit for bit)."""
    tasks = [("diff", 16), ("vera", 64), ("diff", 8), ("vera", 16)]
    jmta = JaxMultiTaskAdapters(jax_smoke_config("llama3.2-3b"),
                                [JaxAdapterConfig(k, rank=r) for k, r in tasks])
    want = flat(jmta.init(jax.random.PRNGKey(0)))
    mta = MultiTaskAdapters(smoke_config("llama3.2-3b"),
                            [AdapterConfig(k, rank=r) for k, r in tasks], device="cpu")
    got = flat(mta.init(torch.Generator().manual_seed(0)))
    frozen = [p for p in want if p[-1] in FROZEN]
    assert len(frozen) == 3 * 4  # rows, A, B at each of the four sites
    for path in frozen:
        w, g = want[path], got[path]
        if path[-1] == "rows":
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=str(path))
        else:  # bf16 leaves: the same bits
            assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          np.asarray(w).view(np.int16), err_msg=str(path))


def test_vera_generator_against_jax_random():
    """The numpy threefry reproduces ``jax.random``'s bits exactly; the
    normals (sqrt(2) erfinv(u)) differ from JAX's by at most 3 f32 units in
    the last place on 1.26% of the values (XLA's CPU log1p is not ported),
    and by none after scaling and the cast to bf16."""
    key = jax.random.fold_in(jax.random.PRNGKey(12345), 7)
    want = np.asarray(jax.random.bits(key, (4096,), jnp.uint32))
    with np.errstate(over="ignore"):
        k0, k1 = _threefry2x32(np.uint32(0), np.uint32(12345), np.zeros(1, np.uint32),
                               np.full(1, 7, np.uint32))
        j = np.arange(4096, dtype=np.uint32)
        b0, b1 = _threefry2x32(k0, k1, np.zeros_like(j), j)
    np.testing.assert_array_equal(b0 ^ b1, want)
    n = ulp = bf16 = total = 0
    for tag, rows, width in (("vera:A:attn_q:64", 64, 64), ("vera:B:attn_q:64", 64, 64),
                             ("vera:B:attn_o:3072", 16, 3072),
                             ("vera:A:attn_v:3072", 64, 3072)):
        w = np.asarray(jax_det_rows(tag, rows, width))
        g = _det_rows(tag, rows, width)
        d = np.abs(w.view(np.int32).astype(np.int64) - g.view(np.int32).astype(np.int64))
        total += d.size
        n += int((d > 0).sum())
        ulp = max(ulp, int(d.max()))
        wb = np.asarray((jnp.asarray(w) * 0.02).astype(jnp.bfloat16).astype(jnp.float32))
        gb = torch.from_numpy(g * np.float32(0.02)).bfloat16().float().numpy()
        bf16 += int((wb != gb).sum())
    assert ulp <= 3 and n / total < 0.02 and bf16 == 0, (n, total, ulp, bf16)


def test_checkpoint_schema_equals_jax():
    assert method_names() == tuple(sorted(
        ("lora", "adapter", "diff", "ia3", "prefix", "dora", "vera", "bitfit")))
    for kind in method_names():
        want = jax_get_method(kind).checkpoint_schema(4, 16, 12)
        got = get_method(kind).checkpoint_schema(4, 16, 12)
        assert got == {k: dict(v, shape=tuple(v["shape"])) for k, v in want.items()}, kind
        assert get_method(kind).category == jax_get_method(kind).category


def test_aliases_resolve_as_in_jax():
    for alias, canon in (("diff_pruning", "diff"), ("adapter_tuning", "adapter"),
                         ("houlsby", "adapter"), ("prefix_tuning", "prefix"),
                         ("prefix-tuning", "prefix")):
        assert AdapterConfig(alias).kind == canon


def test_decode_pool_folds_a_prefix_tenants_rows_at_bind():
    """The pool serves every kind: bound through the engine, a prefix
    tenant's row opens its window at prefix_reserve - P over its own pk / pv
    rows (P the stack's rank, 16, which pads the rank-8 tenant's), and the
    LoRA tenant's row keeps lo = prefix_reserve over an empty prefix
    region."""
    cfg = smoke_config("llama3.2-3b")
    tasks = parse_tasks("sst2:lora:8,qa:prefix:16,rte:prefix:8", 2)
    plan = ExecutionPlanner(cfg, ParallelismSpec(num_stages=1)).plan(tasks, n_micro=1)
    gen = ModelGenerator(cfg, device="cpu")
    reg = gen.register_tasks(tasks)
    engine = PEFTEngine(gen, plan, device="cpu")
    pool = engine.ensure_decode_pool(3, 16, 4)
    pres = engine.decode_prefix_reserve()
    assert pres == 16 and pool["state"]["kv"]["k"].shape[2] == pres + 16
    slots, scales = engine.decode_row_ctx([0, 1, 2])
    with torch.no_grad():
        engine.dispatch_decode_bind_batched(np.asarray([2, 0, 1]), np.ones((3, 8), np.int32),
                                            np.asarray([8, 4, 6]), slots, scales,
                                            np.asarray([4, 4, 4]))
    st = engine._decode_pool["state"]
    # request i (task i) went to row [2, 0, 1][i]: row 2 LoRA, rows 0 and 1 prefix
    np.testing.assert_array_equal(st["lo"].numpy(), [pres - 16, pres - 16, pres])
    np.testing.assert_array_equal(st["pos"].numpy(), [4, 6, 8])
    kc, vc = st["kv"]["k"], st["kv"]["v"]
    L, hkv, dh = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim()
    for row, task, P in ((0, 1, 16), (1, 2, 16)):
        slot = int(reg.mta.task_slot[task])
        for cache, leaf in ((kc, "pk"), (vc, "pv")):
            want = reg.adapter_params["prefix"]["attn_prefix"][leaf][:, slot, :P]
            got = cache[:, row, pres - P:pres]
            assert torch.equal(got, want.reshape(L, P, hkv, dh).to(got.dtype))
    assert not kc[:, 2, :pres].any() and not vc[:, 2, :pres].any()
