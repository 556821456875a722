"""The port's multi-device tier against the JAX package on the CPU.

Pure checks: the sharding rules' defaults, ``logical_to_spec``,
``mesh_axes``, ``rules_for`` / ``attn_mode_for`` on every arch x dry-run
cell x mesh, ``opt_shardings``, the int8 quantizer bit for bit and the
compressed reductions at world size 1.

Multi-rank checks: one gloo world of 2 ranks and one of 4 (a (2, 2) mesh
and a (4,) one), each spawned once in the module fixture (``spawn``, a
``FileStore`` under ``tmp_path``, every collective bounded by 60 s, a
world unfinished after 180 s killed: a hang fails the tests, it does not
stall the suite).  Every scenario runs
inside those worlds and brings its results back as numpy arrays: the int8
collectives against the numpy formula, the pipeline, striped CP attention
and both MoE expert-parallel branches against the JAX functions, the
multi-rank gradients against the single-rank ones, and one
``run_iteration`` of smoke deepseek under EP against the JAX engine.

The scenario functions import no JAX (the ranks import this module).
"""
import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_NAMES, SHAPES, dryrun_cells
from repro_torch.configs import get_config as port_get_config
from repro_torch.configs import smoke_config as port_smoke_config
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import ShardingRules, activate_rules, local_block
from repro_torch.launch.mesh import MeshShape, make_mesh, run_world

WORLD_TIMEOUT_S = 60.0  # every collective
JOIN_TIMEOUT_S = 180.0  # a world unfinished by then is killed and fails the tests

# --- striped CP attention (test_perf_variants' shapes) ---
CP = dict(B=2, S=256, H=4, Hkv=2, dh=16, block=16, prefix=5)
CP_TOL = 3e-4
# --- MoE: smoke deepseek narrowed as the JAX multi-device check ---
MOE_OVERRIDES = dict(d_model=32, num_experts=8, top_k=2, expert_d_ff=16, capacity_factor=8.0)
MOE_TOL = 2e-4
GRAD_TOL = 1e-4  # multi-rank vs single-rank gradients, f32, the same function
# --- pipeline: tanh(x @ w) stages (tests/test_collectives.py) ---
PIPE = dict(n_micro=3, mb=2, d=8)
# --- end to end (test_torch_moe's engine) ---
ARCH = "deepseek-moe-16b"
TRAIN_TASKS = "sst2:lora:8,qa:lora:16,rte:adapter:4,sst2:ia3"
TRAIN_TARGETS = ("attn_q", "attn_v", "shared_mlp_up", "shared_mlp_down")


def _np(t):
    return t.detach().float().numpy().copy()


# ---------------------------------------------------------------------------
# Inputs (numpy seeds; the ranks and the references build the same)
# ---------------------------------------------------------------------------


def _cp_inputs(seed=0):
    B, S, H, Hkv, dh, P = (CP[k] for k in ("B", "S", "H", "Hkv", "dh", "prefix"))
    rs = np.random.RandomState(seed)
    q = rs.randn(B, S, H, dh).astype(np.float32)
    k = rs.randn(B, S, Hkv, dh).astype(np.float32)
    v = rs.randn(B, S, Hkv, dh).astype(np.float32)
    do = rs.randn(B, S, H, dh).astype(np.float32)
    seg = np.zeros((B, S), np.int32)
    pos = np.zeros((B, S), np.int32)
    for b in range(B):  # packed rows: segments of random length, positions restart
        starts = np.sort(rs.choice(np.arange(1, S), 5, replace=False))
        seg[b] = np.searchsorted(starts, np.arange(S), side="right")
        first = np.concatenate([[0], starts])[seg[b]]
        pos[b] = np.arange(S) - first
    pk = rs.randn(B, P, Hkv, dh).astype(np.float32)
    pv = rs.randn(B, P, Hkv, dh).astype(np.float32)
    keep = (rs.rand(B, P) > 0.3).astype(np.float32)
    return dict(q=q, k=k, v=v, do=do, seg=seg, pos=pos, pk=pk, pv=pv, keep=keep)


def _moe_cfg(lib_smoke):
    return lib_smoke(ARCH).with_overrides(**MOE_OVERRIDES)


def _moe_inputs(seed=0, B=4, S=16):
    cfg = _moe_cfg(port_smoke_config)
    d, E, f = cfg.d_model, cfg.num_experts, cfg.expert_d_ff
    rs = np.random.RandomState(seed)
    p = {"router": rs.randn(d, E).astype(np.float32) * 0.3,
         "w_gate": rs.randn(E, d, f).astype(np.float32) * 0.1,
         "w_up": rs.randn(E, d, f).astype(np.float32) * 0.1,
         "w_down": rs.randn(E, f, d).astype(np.float32) * 0.1}
    x = (rs.randn(B, S, d) * 0.5).astype(np.float32)
    dy = rs.randn(B, S, d).astype(np.float32)
    return p, x, dy


def _pipe_inputs(n_stages, seed=0):
    rs = np.random.RandomState(seed)
    ws = (rs.randn(n_stages, PIPE["d"], PIPE["d"]) * 0.3).astype(np.float32)
    micro = rs.randn(PIPE["n_micro"], PIPE["mb"], PIPE["d"]).astype(np.float32)
    return ws, micro


def _int8_inputs(rank):
    rs = np.random.RandomState(10 + rank)
    return {"flat": (rs.randn(1000) * (1 + rank)).astype(np.float32),
            "tree": {"b": rs.randn(3, 100).astype(np.float32),
                     "a": rs.randn(50).astype(np.float32)}}


# ---------------------------------------------------------------------------
# Scenarios (run inside the ranks)
# ---------------------------------------------------------------------------


def _int8_case(mesh, axes):
    from repro_torch.distributed.collectives import exact_int8_psum, int8_psum, psum_tree

    inp = _int8_inputs(mesh.rank)
    flat = torch.from_numpy(inp["flat"])
    tree = {k: torch.from_numpy(v) for k, v in inp["tree"].items()}
    return {"int8_psum": _np(int8_psum(flat, axes, mesh=mesh)),
            "exact_int8_psum": _np(exact_int8_psum(flat, axes, mesh=mesh)),
            "tree_compress": {k: _np(v) for k, v in
                              psum_tree(tree, axes, compress=True, mesh=mesh).items()},
            "tree_plain": {k: _np(v) for k, v in psum_tree(tree, axes, mesh=mesh).items()}}


def _pipe_case(mesh):
    from repro_torch.distributed.pipeline import pipeline_loss, pipeline_ranks

    n = mesh.shape["stage"]
    ws, micro = _pipe_inputs(n)
    r = mesh.coord("stage")
    w_loc = torch.from_numpy(ws[r:r + 1].copy()).requires_grad_(True)
    mb = torch.from_numpy(micro).requires_grad_(True)

    def stage_fn(w, x):
        return torch.tanh(x @ w)

    out = pipeline_ranks(stage_fn, w_loc, mb, mesh)
    (out ** 2).sum().backward()
    loss = pipeline_loss(stage_fn, lambda o: (o ** 2).sum(), w_loc.detach(), mb.detach(), n,
                         mesh=mesh)
    return {"out": _np(out), "dw": _np(w_loc.grad), "dmicro": _np(mb.grad),
            "loss": float(loss)}


def _cp_case(mesh, prefix):
    from repro_torch.models.cp_attention import stripe_permutation, striped_cp_attention

    a = _cp_inputs()
    P_sz = mesh.shape["model"]
    perm = stripe_permutation(CP["S"], CP["block"], P_sz)
    S_l = CP["S"] // P_sz
    r = mesh.coord("model")

    def local(x):
        return torch.from_numpy(np.ascontiguousarray(x[:, perm][:, r * S_l:(r + 1) * S_l]))

    q, k, v = (local(a[n]).requires_grad_(True) for n in ("q", "k", "v"))
    kv_prefix = None
    if prefix:
        pk = torch.from_numpy(a["pk"]).requires_grad_(True)
        pv = torch.from_numpy(a["pv"]).requires_grad_(True)
        kv_prefix = (pk, pv, torch.from_numpy(a["keep"]))
    o = striped_cp_attention(q, k, v, local(a["pos"]), local(a["seg"]), mesh, "model",
                             CP["block"], kv_prefix=kv_prefix)
    (o * local(a["do"])).sum().backward()
    out = {"o": _np(o), "dq": _np(q.grad), "dk": _np(k.grad), "dv": _np(v.grad)}
    if prefix:
        out.update(dpk=_np(kv_prefix[0].grad), dpv=_np(kv_prefix[1].grad))
    return out


ATTN = dict(B=2, S=64)


def _attn_inputs(seed=0):
    """Smoke llama's attention weights, x, segments and a cotangent (f32)."""
    cfg = port_smoke_config("llama3.2-3b")
    d, H, Hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    rs = np.random.RandomState(seed)
    p = {"w_q": rs.randn(d, H, dh), "w_k": rs.randn(d, Hkv, dh), "w_v": rs.randn(d, Hkv, dh),
         "w_o": rs.randn(H, dh, d)}
    p = {k: (v * 0.1).astype(np.float32) for k, v in p.items()}
    B, S = ATTN["B"], ATTN["S"]
    x = rs.randn(B, S, d).astype(np.float32)
    seg = (np.arange(S)[None] >= np.array([[20], [41]])).astype(np.int32)
    pos = (np.arange(S)[None] - np.where(seg > 0, np.array([[20], [41]]), 0)).astype(np.int32)
    dy = rs.randn(B, S, d).astype(np.float32)
    return p, x, seg, pos, dy


def _kvscan_case(mesh):
    """``attention_apply(mode="kvscan")`` under rules that shard ``seq`` over
    "model": x, positions and segments are this rank's contiguous block."""
    from repro_torch.models.attention import attention_apply

    cfg = port_smoke_config("llama3.2-3b")
    p, x, seg, pos, dy = _attn_inputs()
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    spec = (None, "model", None)
    xl = local_block(torch.from_numpy(x), spec, mesh).requires_grad_(True)
    rules = ShardingRules.replicated().with_updates(seq="model")
    with activate_rules(mesh, rules):
        y = attention_apply(tp, xl, cfg, mode="kvscan",
                            positions=local_block(torch.from_numpy(pos), spec[:2], mesh),
                            segment_ids=local_block(torch.from_numpy(seg), spec[:2], mesh))
    (y * local_block(torch.from_numpy(dy), spec, mesh)).sum().backward()
    with activate_rules(mesh, rules):  # no positions: each rank's block's global ones
        y_default = attention_apply(tp, xl.detach(), cfg, mode="kvscan")
    return {"y": _np(y), "dx": _np(xl.grad), "y_default": _np(y_default)}


def _moe_case(mesh, extra, batch_axis=None, seed=0):
    """One EP forward and backward of ``moe_apply`` under rules whose
    ``experts`` is "model" (and ``extra``); the batch cut over
    ``batch_axis`` where given.  Returns this rank's y, aux and dx."""
    from repro_torch.models.moe import moe_apply

    cfg = _moe_cfg(port_smoke_config)
    p, x, dy = _moe_inputs(seed)
    ep = ("model", None, None)
    fsdp = extra.get("moe_fsdp")
    specs = {"router": (None, None), "w_gate": ("model", fsdp, None),
             "w_up": ("model", fsdp, None), "w_down": ("model", None, fsdp)}
    p_loc = {k: local_block(torch.from_numpy(v), specs[k], mesh) for k, v in p.items()}
    bspec = (batch_axis, None, None)
    x_loc = local_block(torch.from_numpy(x), bspec, mesh).requires_grad_(True)
    rules = ShardingRules().with_updates(experts="model", batch=batch_axis, **extra)
    with activate_rules(mesh, rules):
        y, aux = moe_apply(p_loc, x_loc, cfg)
    (y * local_block(torch.from_numpy(dy), bspec, mesh)).sum().backward()
    return {"y": _np(y), "dx": _np(x_loc.grad), **{k: float(v) for k, v in aux.items()}}


def _engine_case(mesh, bb_np, ad_np, hw, batches):
    """One ``run_iteration`` of smoke deepseek with each rank holding its
    experts (``local_tree`` under rules with ``experts="model"``)."""
    from repro_torch.convert import adapters_from_numpy, backbone_from_numpy
    from repro_torch.core import (ExecutionPlanner, HardwareProfile, ModelGenerator,
                                  ParallelismSpec, PEFTEngine)
    from repro_torch.launch.steps import local_tree, param_shardings
    from repro_torch.launch.train import parse_tasks
    from repro_torch.train.optimizer import adamw_init

    cfg = port_smoke_config(ARCH).with_overrides(attn_q_block=128)
    tasks = [dataclasses.replace(t, adapter=dataclasses.replace(t.adapter,
                                                                targets=TRAIN_TARGETS))
             for t in parse_tasks(TRAIN_TASKS, 2)]
    plan = ExecutionPlanner(cfg, ParallelismSpec(num_stages=1), hw=HardwareProfile(**hw[0]),
                            memory_budget=hw[1]).plan(tasks, n_micro=1)
    gen = ModelGenerator(cfg, device="cpu")
    reg = gen.register_tasks(tasks)
    rules = ShardingRules.replicated().with_updates(experts="model")
    full = backbone_from_numpy(bb_np, cfg, "cpu", torch.float32)
    gen.backbone_params = local_tree(full, param_shardings(gen.model, mesh, rules), mesh)
    reg.adapter_params = adapters_from_numpy(ad_np, reg.mta, "cpu")
    reg.opt_state = adamw_init(reg.adapter_params)
    eng = PEFTEngine(gen, plan, lr=1e-3, device="cpu")
    assert len(plan.htasks) == len(batches)
    with activate_rules(mesh, rules):
        m = eng.run_iteration({i: iter([b]) for i, b in batches.items()})

    def flat(tree, prefix=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, prefix + (k,)))
            elif v is not None:
                out["/".join(prefix + (k,))] = _np(v)
        return out

    return {"loss": m.loss, "per_task_loss": np.asarray(m.per_task_loss),
            "experts_held": int(gen.backbone_params["layers"]["moe"]["w_gate"].shape[1]),
            "params": flat(reg.adapter_params), "m": flat(reg.opt_state.m),
            "v": flat(reg.opt_state.v)}


def _world2(rank, world, bb_np, ad_np, hw, batches):
    torch.set_num_threads(1)
    torch.manual_seed(0)
    ep = make_mesh((2,), ("model",), timeout_s=WORLD_TIMEOUT_S)
    stage = make_mesh((2,), ("stage",), timeout_s=WORLD_TIMEOUT_S)
    data = make_mesh((2,), ("data",), timeout_s=WORLD_TIMEOUT_S)
    one = make_mesh((1,), ("data",), timeout_s=WORLD_TIMEOUT_S)
    out = {"int8": _int8_case(data, "data"), "pipe": _pipe_case(stage),
           "cp": _cp_case(ep, prefix=False), "cp_prefix": _cp_case(ep, prefix=True),
           "moe_psum": _moe_case(ep, {}), "moe_a2a": _moe_case(ep, {"moe_impl": "a2a"}),
           "moe_a2a_int8": _moe_case(ep, {"moe_impl": "a2a", "moe_wire": "int8"}),
           "engine": _engine_case(ep, bb_np, ad_np, hw, batches), "kvscan": _kvscan_case(ep),
           "bytes": dict(C.collective_bytes)}
    if one.member:
        out["int8_one"] = _int8_case(one, "data")
    return out


def _world4(rank, world):
    torch.set_num_threads(1)
    grid = make_mesh((2, 2), ("data", "model"), timeout_s=WORLD_TIMEOUT_S)
    line = make_mesh((4,), ("model",), timeout_s=WORLD_TIMEOUT_S)
    stage = make_mesh((4,), ("stage",), timeout_s=WORLD_TIMEOUT_S)
    from repro_torch.distributed.sharding import gather_blocks

    t = torch.arange(4 * 6 * 2, dtype=torch.float32).reshape(4, 6, 2)
    spec = ("data", "model", None)
    gathered = gather_blocks(local_block(t, spec, grid), spec, grid)
    return {"coords": (grid.coord("data"), grid.coord("model")),
            "gathered": _np(gathered),
            "int8": _int8_case(grid, ("data", "model")), "pipe": _pipe_case(stage),
            "cp": _cp_case(line, prefix=False), "cp_prefix": _cp_case(line, prefix=True),
            "kvscan": _kvscan_case(line),
            "moe_psum": _moe_case(grid, {}, batch_axis="data"),
            "moe_a2a": _moe_case(grid, {"moe_impl": "a2a"}, batch_axis="data"),
            "moe_a2a_fsdp": _moe_case(grid, {"moe_impl": "a2a", "moe_fsdp": "data"},
                                      batch_axis="data")}


# ---------------------------------------------------------------------------
# The worlds and the JAX side
# ---------------------------------------------------------------------------


def _np_tree(tree):
    import jax

    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _jax_engine():
    """The JAX engine of test_torch_moe (smoke deepseek, f32, numpy-seeded
    adapters) and the numpy trees the ranks start from."""
    import jax
    import jax.numpy as jnp

    from repro.configs import smoke_config as jax_smoke_config
    from repro.core import ExecutionPlanner as JaxPlanner
    from repro.core import ModelGenerator as JaxGenerator
    from repro.core import ParallelismSpec as JaxParallelism
    from repro.core import PEFTEngine as JaxEngine
    from repro.core import cost_model as jcm
    from repro.data import HTaskLoader as JaxLoader
    from repro.launch.train import parse_tasks as jax_parse_tasks
    from repro.train.optimizer import adamw_init as jax_adamw_init

    jcfg = jax_smoke_config(ARCH).with_overrides(attn_q_block=128)
    jt = [dataclasses.replace(t, adapter=dataclasses.replace(t.adapter, targets=TRAIN_TARGETS))
          for t in jax_parse_tasks(TRAIN_TASKS, 2)]
    jplan = JaxPlanner(jcfg, JaxParallelism(num_stages=1)).plan(jt, n_micro=1)
    jgen = JaxGenerator(jcfg, seed=0)
    jgen.register_tasks(jt)
    bb_np = _np_tree(jgen.init_backbone())
    ad_np = _np_tree(jgen.registered.adapter_params)
    rs = np.random.RandomState(0)
    for kind in ad_np.values():
        for site in kind.values():
            for leaf in ("b", "up", "s"):
                if leaf in site:
                    site[leaf] = (rs.randn(*site[leaf].shape) * 0.05).astype(np.float32)
    jgen.backbone_params = jax.tree.map(jnp.asarray, bb_np)
    jgen.registered.adapter_params = jax.tree.map(jnp.asarray, ad_np)
    jgen.registered.opt_state = jax_adamw_init(jgen.registered.adapter_params)
    jeng = JaxEngine(jgen, jplan, lr=1e-3)
    # one batch an hTask, drawn here: the loaders' token streams hash the
    # task id, which differs between processes
    batches = {i: {k: np.asarray(v) for k, v in
                   next(JaxLoader(jt, jplan.alignment[i], jcfg.vocab_size)).items()}
               for i in range(len(jplan.htasks))}
    hw = (dict(peak_flops=jcm.PEAK_FLOPS, hbm_bw=jcm.HBM_BW, ici_bw=jcm.ICI_BW), jcm.HBM_BYTES)
    return jeng, batches, bb_np, ad_np, hw


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    jeng, batches, bb_np, ad_np, hw = _jax_engine()
    d = tmp_path_factory.mktemp("worlds")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        f2 = pool.submit(run_world, _world2, 2, str(d / "store2"), args=(bb_np, ad_np, hw, batches),
                         timeout_s=WORLD_TIMEOUT_S, join_timeout_s=JOIN_TIMEOUT_S)
        f4 = pool.submit(run_world, _world4, 4, str(d / "store4"), timeout_s=WORLD_TIMEOUT_S,
                         join_timeout_s=JOIN_TIMEOUT_S)
        jm = jeng.run_iteration({i: iter([b]) for i, b in batches.items()})  # meanwhile
        return {2: f2.result(), 4: f4.result(),
                "jax_engine": (jm, _np_tree(jeng.reg.adapter_params),
                               _np_tree(jeng.reg.opt_state.m), _np_tree(jeng.reg.opt_state.v))}


# ---------------------------------------------------------------------------
# Pure checks against JAX
# ---------------------------------------------------------------------------


class _MeshLike:
    """An abstract JAX mesh of a ``MeshShape`` (NamedSharding needs one)."""

    def __new__(cls, ms):
        from repro import compat

        return compat.make_abstract_mesh(tuple(ms.shape.values()), ms.axis_names)


class _JaxMeshStandIn:
    """What JAX's ``rules_for`` and ``mesh_axes`` read of a mesh."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))
        self.axis_names = tuple(names)


MESHES = (((1, 1), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")))


def test_default_rules_equal_jax():
    from repro.distributed.sharding import ShardingRules as JaxRules

    assert ShardingRules().rules == JaxRules().rules
    assert ShardingRules.FLAG_KEYS == JaxRules.FLAG_KEYS
    assert all(v is None for _, v in ShardingRules.replicated().rules)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
def test_logical_to_spec_and_mesh_axes_equal_jax(mesh):
    from repro.distributed.sharding import ShardingRules as JaxRules
    from repro.distributed.sharding import logical_to_spec as jax_l2s
    from repro_torch.distributed.sharding import logical_to_spec

    ms, stand_in = MeshShape(*mesh), _JaxMeshStandIn(*mesh)
    updates = dict(kv_heads="model", ff=("data", "model"), cache_seq=("pod", "data"))
    port_r = ShardingRules().with_updates(**updates).mesh_axes(ms)
    jax_r = JaxRules().with_updates(**updates).mesh_axes(stand_in)
    assert port_r.rules == jax_r.rules
    for axes in (("batch", "seq", "heads", "head_dim"),       # "model" reused by heads
                 ("batch", "seq", "kv_heads", None),
                 ("vocab", "embed"), ("experts", "embed", "expert_ff"),
                 ("cache_batch", "cache_seq", "kv_heads", "head_dim"),
                 ("ff", "batch"), ("layers", "adapter_tasks", "embed", None)):
        assert logical_to_spec(axes, port_r) == tuple(jax_l2s(axes, jax_r)), axes


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_rules_for_every_cell_and_mesh_equal_jax(arch):
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import dryrun_cells as jax_cells
    from repro.configs import get_config as jax_get_config
    from repro.launch.rules import attn_mode_for as jax_mode
    from repro.launch.rules import rules_for as jax_rules_for
    from repro_torch.launch.rules import attn_mode_for, dp_size, rules_for, tp_size
    from repro_torch.models.transformer import build_model

    cfg, jcfg = port_get_config(arch), jax_get_config(arch)
    assert dryrun_cells(arch) == jax_cells(arch)
    for mesh in MESHES:
        ms, stand_in = MeshShape(*mesh), _JaxMeshStandIn(*mesh)
        assert attn_mode_for(cfg, ms) == jax_mode(jcfg, stand_in)
        assert build_model(cfg, tp_size(ms), device="cpu").attn_mode == attn_mode_for(cfg, ms)
        assert dp_size(ms) * tp_size(ms) == ms.size
        for cell in dryrun_cells(arch):
            assert dataclasses.astuple(SHAPES[cell]) == dataclasses.astuple(JSHAPES[cell])
            got = rules_for(cfg, SHAPES[cell], ms).mesh_axes(ms)
            want = jax_rules_for(jcfg, JSHAPES[cell], stand_in).mesh_axes(stand_in)
            assert got.rules == want.rules, (arch, cell, mesh)


@pytest.mark.parametrize("shape", [(1, 1), (2, 1)])
def test_opt_shardings_equal_jax(shape):
    import jax

    from repro import compat
    from repro.configs import smoke_config as jax_smoke_config
    from repro.launch.steps import opt_shardings as jax_opt
    from repro.peft.methods import AdapterConfig as JaxAdapterConfig
    from repro.peft.multitask import MultiTaskAdapters as JaxMTA
    from repro.train.optimizer import adamw_init as jax_adamw_init
    from repro_torch.launch.steps import opt_shardings
    from repro_torch.peft.methods import AdapterConfig
    from repro_torch.peft.multitask import MultiTaskAdapters
    from repro_torch.train.optimizer import adamw_init

    kinds = (("lora", 4), ("vera", 8), ("ia3", 0))
    for n_tasks in (2, 3):
        jcfg, cfg = jax_smoke_config("llama3.2-3b"), port_smoke_config("llama3.2-3b")
        jm = JaxMTA(jcfg, [JaxAdapterConfig(k, rank=r) for k, r in kinds for _ in range(n_tasks)])
        pm = MultiTaskAdapters(cfg, [AdapterConfig(k, rank=r) for k, r in kinds
                                     for _ in range(n_tasks)], device="cpu")
        jspec = jax.eval_shape(jax_adamw_init, jm.abstract())
        pstate = adamw_init(pm.init(torch.Generator().manual_seed(0)))
        mesh = compat.make_abstract_mesh(shape, ("data", "model"))
        ms = MeshShape(shape, ("data", "model"))
        for kw in ({}, {"mta": None}):
            want = jax_opt(jspec, mesh, mta=jm, cfg=jcfg) if not kw else jax_opt(jspec, mesh)
            got = opt_shardings(pstate, ms, mta=pm, cfg=cfg) if not kw else \
                opt_shardings(pstate, ms)
            want_t = jax.tree.map(lambda s: tuple(s.spec), want,
                                  is_leaf=lambda s: hasattr(s, "spec"))
            assert got.step == want_t.step
            assert got.m == want_t.m and got.v == want_t.v, (shape, n_tasks, kw)


def test_param_specs_and_local_tree_cut_the_experts():
    """The port's parameter specs carry JAX's logical axes leaf for leaf, and
    ``param_shardings`` under EP (and ``moe_fsdp``) cuts the routed experts."""
    import jax

    from repro.configs import smoke_config as jax_smoke_config
    from repro.distributed.sharding import ShardingRules as JaxRules
    from repro.distributed.sharding import logical_to_spec as jax_l2s
    from repro.models.layers import spec_logical_axes
    from repro.models.transformer import Model as JaxModel
    from repro_torch.launch.steps import param_shardings
    from repro_torch.models.transformer import Model

    ms, stand_in = MeshShape((2, 4), ("data", "model")), _JaxMeshStandIn((2, 4),
                                                                          ("data", "model"))
    jr = JaxRules().mesh_axes(stand_in)
    for arch in ARCH_NAMES:
        got = param_shardings(Model(port_smoke_config(arch), device="cpu"), ms, ShardingRules())
        want = jax.tree.map(lambda ax: tuple(jax_l2s(ax, jr)),
                            spec_logical_axes(JaxModel(jax_smoke_config(arch)).spec()),
                            is_leaf=lambda x: isinstance(x, tuple))
        assert got == want, arch
    # the batch and adapter specs (adapter stacks: tasks on axis 1)
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jax_get_config
    from repro.launch.steps import adapter_shardings as jax_as
    from repro.launch.steps import batch_shardings as jax_bs
    from repro.launch.steps import batch_specs as jax_batch_specs
    from repro.peft.methods import AdapterConfig as JaxAdapterConfig
    from repro.peft.multitask import MultiTaskAdapters as JaxMTA
    from repro_torch.launch.steps import adapter_shardings, batch_shardings, batch_specs
    from repro_torch.peft.methods import AdapterConfig
    from repro_torch.peft.multitask import MultiTaskAdapters

    for arch in ("qwen2-vl-7b", "whisper-large-v3", "llama3.2-3b"):
        for cell, pos in (("train_4k", False), ("prefill_32k", True), ("decode_32k", False)):
            got = batch_specs(port_get_config(arch), SHAPES[cell], with_positions=pos)
            want = jax_batch_specs(jax_get_config(arch), JSHAPES[cell], with_positions=pos)
            assert {k: tuple(v.shape) for k, v in got.items()} == \
                {k: tuple(v.shape) for k, v in want.items()}
            assert batch_shardings(got, ms, ShardingRules()) == {
                k: tuple(v.spec) for k, v in jax_bs(want, _MeshLike(ms), JaxRules()).items()}
    kinds = [("lora", 4), ("dora", 4), ("prefix", 8)]
    jm = JaxMTA(jax_smoke_config("llama3.2-3b"), [JaxAdapterConfig(k, rank=r) for k, r in kinds])
    pm = MultiTaskAdapters(port_smoke_config("llama3.2-3b"),
                           [AdapterConfig(k, rank=r) for k, r in kinds], device="cpu")
    want = jax.tree.map(lambda s: tuple(s.spec), jax_as(jm, _MeshLike(ms), JaxRules()),
                        is_leaf=lambda s: hasattr(s, "spec"))
    assert adapter_shardings(pm, ms, ShardingRules()) == want

    model = Model(port_smoke_config(ARCH), device="cpu")
    rules = ShardingRules.replicated().with_updates(experts="model", moe_fsdp="data")
    specs = param_shardings(model, ms, rules)
    assert specs["layers"]["moe"]["w_gate"] == (None, "model", "data", None)
    assert specs["layers"]["moe"]["w_down"] == (None, "model", None, "data")
    assert specs["layers"]["attn"]["w_q"] == (None, None, None, None)


def test_quantize_int8_bit_for_bit_and_compression_error():
    import jax.numpy as jnp

    from repro.distributed import collectives as JC

    rs = np.random.RandomState(1)
    x = (rs.randn(1300) * np.exp(rs.randn(1300))).astype(np.float32)
    x[256:512] = 0.0                      # an all-zero block
    x[600] = 127.0 * 0.5                  # round-half ties within a block
    for block in (256, 64):
        jq, js = JC.quantize_int8(jnp.asarray(x), block)
        pq, ps = C.quantize_int8(torch.from_numpy(x), block)
        assert pq.dtype == torch.int8
        np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ps.numpy().view(np.uint32),
                                      np.asarray(js).view(np.uint32))
        np.testing.assert_array_equal(
            C.dequantize_int8(pq, ps, x.shape[0]).numpy(),
            np.asarray(JC.dequantize_int8(jq, js, x.shape[0])))
        np.testing.assert_allclose(float(C.compression_error(torch.from_numpy(x), block)),
                                   float(JC.compression_error(jnp.asarray(x), block)),
                                   rtol=1e-6)


def _jax_one_device(fn):
    import jax
    from jax.sharding import PartitionSpec as P

    from repro import compat

    mesh = compat.make_mesh((1,), ("data",), devices=jax.devices()[:1])
    return compat.shard_map(fn, mesh=mesh, in_specs=P(), out_specs=P(), check_vma=False)


def test_int8_psum_and_psum_tree_at_world_size_one_equal_jax(worlds):
    import jax.numpy as jnp

    from repro.distributed import collectives as JC

    inp = _int8_inputs(0)
    got = worlds[2][0]["int8_one"]
    x = jnp.asarray(inp["flat"])
    np.testing.assert_array_equal(got["int8_psum"], np.asarray(
        _jax_one_device(lambda a: JC.int8_psum(a, "data"))(x)))
    np.testing.assert_array_equal(got["exact_int8_psum"], np.asarray(
        _jax_one_device(lambda a: JC.exact_int8_psum(a, "data"))(x)))
    tree = {k: jnp.asarray(v) for k, v in inp["tree"].items()}
    for compress, key in ((True, "tree_compress"), (False, "tree_plain")):
        want = _jax_one_device(lambda t: JC.psum_tree(t, "data", compress=compress))(tree)
        for k in tree:
            np.testing.assert_array_equal(got[key][k], np.asarray(want[k]))


# ---------------------------------------------------------------------------
# Multi-rank checks
# ---------------------------------------------------------------------------


# the ranks' scales and values are summed in gloo's order, the formula's in
# rank order: f32 rounding apart
INT8_TOL = 1e-5


def _np_quantize(x, block=256):
    n = x.shape[0]
    xp = np.pad(x, (0, (-n) % block)).reshape(-1, block)
    scale = (np.abs(xp).max(axis=1, keepdims=True) / np.float32(127.0)).astype(np.float32)
    q = np.clip(np.round(xp / np.maximum(scale, np.float32(1e-12))), -127, 127)
    return q.astype(np.int32), scale


@pytest.mark.parametrize("world", [2, 4])
def test_int8_collectives_match_the_formula(worlds, world):
    res = worlds[world]
    inputs = [_int8_inputs(r) for r in range(world)]
    qs = [_np_quantize(i["flat"]) for i in inputs]
    q_sum = sum(q for q, _ in qs)
    n = inputs[0]["flat"].shape[0]
    mean_scale = sum(s for _, s in qs) / np.float32(world)
    want = (q_sum.astype(np.float32) * mean_scale).reshape(-1)[:n]
    want_exact = (q_sum.astype(np.float32) * np.max([s for _, s in qs], axis=0)).reshape(-1)[:n]
    flat_tree = [np.concatenate([i["tree"]["a"].reshape(-1), i["tree"]["b"].reshape(-1)])
                 for i in inputs]
    tq = [_np_quantize(f) for f in flat_tree]
    tree_sum = (sum(q for q, _ in tq).astype(np.float32)
                * (sum(s for _, s in tq) / np.float32(world))).reshape(-1)
    for r in range(world):
        got = res[r]["int8"]
        np.testing.assert_allclose(got["int8_psum"], want, rtol=INT8_TOL, atol=INT8_TOL)
        np.testing.assert_allclose(got["exact_int8_psum"], want_exact, rtol=INT8_TOL, atol=INT8_TOL)
        np.testing.assert_allclose(got["tree_compress"]["a"], tree_sum[:50], rtol=INT8_TOL,
                                   atol=INT8_TOL)
        np.testing.assert_allclose(got["tree_compress"]["b"].reshape(-1), tree_sum[50:350],
                                   rtol=INT8_TOL, atol=INT8_TOL)
        for k in ("a", "b"):
            np.testing.assert_allclose(got["tree_plain"][k],
                                       sum(i["tree"][k] for i in inputs), rtol=INT8_TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_pipeline_ranks_match_jax_reference(worlds, world):
    import jax
    import jax.numpy as jnp

    from repro.distributed.pipeline import pipeline_reference

    ws, micro = _pipe_inputs(world)

    def loss(w, m):
        out = pipeline_reference(lambda a, x: jnp.tanh(x @ a), w, m, world)
        return jnp.sum(out ** 2), out

    (val, out), (dw, dm) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(ws), jnp.asarray(micro))
    for r in range(world):
        got = worlds[world][r]["pipe"]
        np.testing.assert_allclose(got["out"], np.asarray(out), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["dw"], np.asarray(dw)[r:r + 1], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got["dmicro"], np.asarray(dm), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got["loss"], float(val), rtol=1e-5)


def test_pipeline_reference_matches_jax():
    import jax.numpy as jnp

    from repro.distributed.pipeline import pipeline_reference as jax_ref
    from repro_torch.distributed.pipeline import pipeline_loss, pipeline_reference

    for n_stages in (1, 3):
        ws, micro = _pipe_inputs(n_stages, seed=4)
        want = jax_ref(lambda a, x: jnp.tanh(x @ a), jnp.asarray(ws), jnp.asarray(micro),
                       n_stages)
        got = pipeline_reference(lambda a, x: torch.tanh(x @ a), torch.from_numpy(ws),
                                 torch.from_numpy(micro), n_stages)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
        loss = pipeline_loss(lambda a, x: torch.tanh(x @ a), lambda o: o.sum(),
                             torch.from_numpy(ws), torch.from_numpy(micro), n_stages)
        np.testing.assert_allclose(float(loss), float(np.asarray(want).sum()), rtol=1e-5)


def _unstripe(blocks, P_sz):
    from repro_torch.models.cp_attention import inverse_permutation, stripe_permutation

    whole = np.concatenate(blocks, axis=1)
    return whole[:, inverse_permutation(stripe_permutation(CP["S"], CP["block"], P_sz))]


def _jax_cp(a, prefix):
    """JAX's single-device striped_cp_attention (its pairs cover the causal
    triangle of the one-rank layout, the contiguous one), unstriped."""
    import jax.numpy as jnp

    from repro.models.cp_attention import stripe_permutation as jsp
    from repro.models.cp_attention import striped_cp_attention as jscp

    perm = jsp(CP["S"], CP["block"], 1)  # one device: the contiguous layout
    kv_prefix = ((jnp.asarray(a["pk"]), jnp.asarray(a["pv"]), jnp.asarray(a["keep"]))
                 if prefix else None)
    o = jscp(*(jnp.asarray(a[n][:, perm]) for n in ("q", "k", "v")),
             jnp.asarray(a["pos"][:, perm]), jnp.asarray(a["seg"][:, perm]), None,
             block=CP["block"], kv_prefix=kv_prefix)
    return np.asarray(o)[:, np.argsort(perm)]


def _port_cp_single(a, prefix):
    """The port's single-rank striped_cp_attention on the whole sequence (the
    one-rank layout): the output and the gradients."""
    from repro_torch.models.cp_attention import stripe_permutation, striped_cp_attention

    perm = stripe_permutation(CP["S"], CP["block"], 1)
    inv = np.argsort(perm)
    q, k, v = (torch.from_numpy(np.ascontiguousarray(a[n][:, perm])).requires_grad_(True)
               for n in ("q", "k", "v"))
    kv_prefix = None
    if prefix:
        kv_prefix = (torch.from_numpy(a["pk"]).requires_grad_(True),
                     torch.from_numpy(a["pv"]).requires_grad_(True), torch.from_numpy(a["keep"]))
    o = striped_cp_attention(q, k, v, torch.from_numpy(a["pos"][:, perm]),
                             torch.from_numpy(a["seg"][:, perm]), None, block=CP["block"],
                             kv_prefix=kv_prefix)
    (o * torch.from_numpy(a["do"][:, perm])).sum().backward()
    out = {n: _np(t)[:, inv] for n, t in (("o", o), ("dq", q.grad), ("dk", k.grad),
                                          ("dv", v.grad))}
    if prefix:
        out.update(dpk=_np(kv_prefix[0].grad), dpv=_np(kv_prefix[1].grad))
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("prefix", [False, True], ids=["segments", "prefix"])
def test_striped_cp_attention_matches_jax(worlds, world, prefix):
    import jax.numpy as jnp

    from repro.kernels.ref import packed_attention_ref

    a = _cp_inputs()
    case = "cp_prefix" if prefix else "cp"
    got = _unstripe([worlds[world][r][case]["o"] for r in range(world)], world)
    np.testing.assert_allclose(got, _jax_cp(a, prefix), rtol=CP_TOL, atol=CP_TOL)
    if not prefix:
        ref = packed_attention_ref(jnp.asarray(a["q"]), jnp.asarray(a["k"]), jnp.asarray(a["v"]),
                                   jnp.asarray(a["seg"]), jnp.asarray(a["pos"]), True)
        np.testing.assert_allclose(got, np.asarray(ref), rtol=CP_TOL, atol=CP_TOL)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("prefix", [False, True], ids=["segments", "prefix"])
def test_striped_cp_gradients_match_single_rank(worlds, world, prefix):
    a = _cp_inputs()
    case = "cp_prefix" if prefix else "cp"
    want = _port_cp_single(a, prefix)
    for name in ("o", "dq", "dk", "dv"):
        got = _unstripe([worlds[world][r][case][name] for r in range(world)], world)
        scale = np.abs(want[name]).max()
        np.testing.assert_allclose(got, want[name], rtol=GRAD_TOL, atol=GRAD_TOL * scale,
                                   err_msg=name)
    if prefix:
        for name in ("dpk", "dpv"):
            for r in range(world):
                got = worlds[world][r][case][name]
                np.testing.assert_allclose(got, want[name], rtol=GRAD_TOL,
                                           atol=GRAD_TOL * np.abs(want[name]).max(),
                                           err_msg=f"{name} rank {r}")


def _jax_moe(p, x):
    import jax
    import jax.numpy as jnp

    from repro.configs import smoke_config as jax_smoke_config
    from repro.models import moe as jmoe

    cfg = _moe_cfg(jax_smoke_config)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    y, aux = jax.jit(lambda pp, xx: jmoe.moe_apply(pp, xx, cfg))(jp, jnp.asarray(x))
    return np.asarray(y), {k: float(v) for k, v in aux.items()}


def _port_moe_local(p, x, dy, int8_tokens=False):
    """The port's local branch: y, aux and dx; with ``int8_tokens`` the
    experts read each token round-tripped through the per-token int8 wire
    (the routing reads x)."""
    from repro_torch.models import moe as pmoe

    cfg = _moe_cfg(port_smoke_config)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    if not int8_tokens:
        y, aux = pmoe.moe_apply(tp, tx, cfg)
        (y * torch.from_numpy(dy)).sum().backward()
        return _np(y), {k: float(v.detach()) for k, v in aux.items()}, _np(tx.grad)
    flat = tx.detach().reshape(-1, cfg.d_model)
    absmax = flat.abs().amax(dim=-1, keepdim=True) / 127.0
    xq = torch.clamp(torch.round(flat / torch.clamp(absmax, min=1e-12)), -127, 127) * absmax
    ids, gates, _ = pmoe._route(flat, tp["router"], cfg.top_k)
    cap = pmoe._capacity(flat.shape[0], cfg.top_k, cfg.num_experts, cfg.capacity_factor)
    return _np(pmoe._expert_core(xq, tp, ids, gates, cap).reshape(x.shape)), None, None


def _moe_rows(worlds, world, case):
    """The global y and dx from each rank's results (the (2, 2) mesh cuts the
    batch over "data"; ranks along "model" hold the same block)."""
    res = worlds[world]
    if world == 2:
        return res[0][case]["y"], res[0][case]["dx"]
    by_data = {}
    for r in range(world):
        dcoord, _ = res[r]["coords"]
        by_data.setdefault(dcoord, res[r][case])
    return (np.concatenate([by_data[i]["y"] for i in sorted(by_data)]),
            np.concatenate([by_data[i]["dx"] for i in sorted(by_data)]))


MOE_CASES = [(2, "moe_psum"), (2, "moe_a2a"), (4, "moe_psum"), (4, "moe_a2a"),
             (4, "moe_a2a_fsdp")]


@pytest.mark.parametrize("world,case", MOE_CASES)
def test_moe_ep_forward_matches_jax(worlds, world, case):
    p, x, dy = _moe_inputs()
    y_j, aux_j = _jax_moe(p, x)
    y, _ = _moe_rows(worlds, world, case)
    np.testing.assert_allclose(y, y_j, rtol=MOE_TOL, atol=MOE_TOL)
    for r in range(world):  # every rank of a batch block holds the same output
        assert np.isfinite(worlds[world][r][case]["y"]).all()
    if case == "moe_psum" and world == 2:  # the same tokens on every rank: the global aux
        for r in range(world):
            for k, v in aux_j.items():
                np.testing.assert_allclose(worlds[world][r][case][k], v, rtol=1e-5)


@pytest.mark.parametrize("world,case", MOE_CASES)
def test_moe_ep_gradients_match_local_branch(worlds, world, case):
    p, x, dy = _moe_inputs()
    _, _, dx_local = _port_moe_local(p, x, dy)
    _, dx = _moe_rows(worlds, world, case)
    np.testing.assert_allclose(dx, dx_local, rtol=GRAD_TOL,
                               atol=GRAD_TOL * np.abs(dx_local).max())


def test_moe_a2a_int8_wire_within_round_trip(worlds):
    p, x, dy = _moe_inputs()
    want, _, _ = _port_moe_local(p, x, dy, int8_tokens=True)
    y_f32, _, _ = _port_moe_local(p, x, dy)
    for r in range(2):
        got = worlds[2][r]["moe_a2a_int8"]["y"]
        np.testing.assert_allclose(got, want, rtol=MOE_TOL, atol=MOE_TOL)
    # the wire's error is the tokens' round trip: nonzero, and small
    err = np.abs(worlds[2][0]["moe_a2a_int8"]["y"] - y_f32).max()
    assert 0 < err < 0.02 * np.abs(y_f32).max()


def test_run_iteration_under_ep_matches_jax(worlds):
    """Each rank holds 4 of smoke deepseek's experts; the losses, the updated
    adapters and both AdamW moments after one iteration equal the JAX
    engine's (whose experts are all local), on both ranks."""
    jm, jparams, jm_m, jm_v = worlds["jax_engine"]
    assert isinstance(worlds[2][0]["engine"], dict), worlds[2][0]["engine"]

    def flat(tree, prefix=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, prefix + (k,)))
            elif v is not None:
                out["/".join(prefix + (k,))] = v
        return out

    for r in range(2):
        got = worlds[2][r]["engine"]
        assert got["experts_held"] == port_smoke_config(ARCH).num_experts // 2
        np.testing.assert_allclose(got["per_task_loss"], jm.per_task_loss, rtol=2e-4)
        np.testing.assert_allclose(got["loss"], jm.loss, rtol=2e-4)
        for name, jtree in (("params", jparams), ("m", jm_m), ("v", jm_v)):
            jf = flat(jtree)
            assert sorted(jf) == sorted(got[name])
            for path, want in jf.items():
                np.testing.assert_allclose(got[name][path], want, rtol=2e-4,
                                           atol=2e-4 * max(np.abs(want).max(), 1e-12),
                                           err_msg=f"rank {r} {name} {path}")


def test_collective_bytes_are_counted(worlds):
    counted = worlds[2][0]["bytes"]
    for op in ("all_reduce", "all_gather", "all_to_all", "send_recv"):
        assert counted.get(op, 0) > 0, (op, counted)


def test_local_block_and_gather_blocks_round_trip():
    """``local_block`` cuts by the spec's axes row-major (as JAX lays out a
    tuple entry) and refuses a dim that does not divide."""
    class _Coords(MeshShape):
        def __init__(self, shape, names, coords):
            super().__init__(shape, names)
            self._c = dict(zip(names, coords))

        def coord(self, a):
            return self._c[a]

    t = torch.arange(4 * 6 * 2).reshape(4, 6, 2)
    blocks = {}
    for d in range(2):
        for m in range(3):
            mesh = _Coords((2, 3), ("data", "model"), (d, m))
            blocks[d, m] = local_block(t, (None, ("data", "model"), None), mesh)
            assert blocks[d, m].shape == (4, 1, 2)
            np.testing.assert_array_equal(blocks[d, m].numpy(), t[:, d * 3 + m:d * 3 + m + 1])
            assert torch.equal(local_block(t, ("data", "model", None), mesh),
                               t[d * 2:(d + 1) * 2, m * 2:(m + 1) * 2])
    with pytest.raises(ValueError):
        local_block(t, ("model", None, None), _Coords((3,), ("model",), (0,)))


def test_gather_blocks_inverts_local_block(worlds):
    t = np.arange(4 * 6 * 2, dtype=np.float32).reshape(4, 6, 2)
    for r in range(4):
        np.testing.assert_array_equal(worlds[4][r]["gathered"], t)


def _port_attention(mode, with_grad=False):
    from repro_torch.models.attention import attention_apply

    cfg = port_smoke_config("llama3.2-3b")
    p, x, seg, pos, dy = _attn_inputs()
    tx = torch.from_numpy(x).requires_grad_(with_grad)
    y = attention_apply({k: torch.from_numpy(v) for k, v in p.items()}, tx, cfg, mode=mode,
                        positions=torch.from_numpy(pos), segment_ids=torch.from_numpy(seg))
    if not with_grad:
        return _np(y)
    (y * torch.from_numpy(dy)).sum().backward()
    return _np(y), _np(tx.grad)


@pytest.mark.parametrize("mode", ["pairs", "kvscan", "striped_cp"])
def test_attention_modes_on_one_rank_match_jax(mode):
    """One rank: the three modes against JAX's ``attention_apply`` in the
    same mode (and kvscan / striped_cp give what pairs gives)."""
    import jax.numpy as jnp

    from repro.configs import smoke_config as jax_smoke_config
    from repro.models.attention import attention_apply as jax_attention

    p, x, seg, pos, _ = _attn_inputs()
    want = np.asarray(jax_attention({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                    jax_smoke_config("llama3.2-3b"), mode=mode,
                                    positions=jnp.asarray(pos), segment_ids=jnp.asarray(seg)))
    got = _port_attention(mode)
    np.testing.assert_allclose(got, want, rtol=CP_TOL, atol=CP_TOL)
    np.testing.assert_allclose(got, _port_attention("pairs"), rtol=CP_TOL, atol=CP_TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_kvscan_under_a_sequence_mesh_matches_one_rank(worlds, world):
    """q stays each rank's block, k / v are gathered: the blocks' outputs
    and x's gradient (through the gathered k / v's reduce-scatter) equal
    one rank's."""
    y1, dx1 = _port_attention("kvscan", with_grad=True)
    y = np.concatenate([worlds[world][r]["kvscan"]["y"] for r in range(world)], axis=1)
    dx = np.concatenate([worlds[world][r]["kvscan"]["dx"] for r in range(world)], axis=1)
    np.testing.assert_allclose(y, y1, rtol=GRAD_TOL, atol=GRAD_TOL * np.abs(y1).max())
    np.testing.assert_allclose(dx, dx1, rtol=GRAD_TOL, atol=GRAD_TOL * np.abs(dx1).max())
    from repro_torch.models.attention import attention_apply

    p, x, _, _, _ = _attn_inputs()
    want = _np(attention_apply({k: torch.from_numpy(v) for k, v in p.items()},
                               torch.from_numpy(x), port_smoke_config("llama3.2-3b"),
                               mode="kvscan"))
    got = np.concatenate([worlds[world][r]["kvscan"]["y_default"] for r in range(world)], axis=1)
    np.testing.assert_allclose(got, want, rtol=GRAD_TOL, atol=GRAD_TOL * np.abs(want).max())


def test_model_attn_modes_on_one_rank():
    """``Model(attn_mode=...)`` runs each mode; on one rank every mode's
    forward equals pairs' (f32 weights, packed segments)."""
    from repro_torch.models.transformer import Model
    from repro_torch.train.optimizer import tree_map

    cfg = port_smoke_config("llama3.2-3b")
    params = tree_map(lambda t: t.float(),
                      Model(cfg, device="cpu").init(torch.Generator().manual_seed(0)))
    _, _, seg, pos, _ = _attn_inputs()
    tokens = np.random.RandomState(1).randint(1, cfg.vocab_size, (ATTN["B"], ATTN["S"]))
    batch = {"tokens": torch.from_numpy(tokens), "positions": torch.from_numpy(pos),
             "segment_ids": torch.from_numpy(seg)}
    outs = {m: Model(cfg, device="cpu", attn_mode=m).forward(params, batch,
                                                             return_logits=True)["logits"]
            for m in ("pairs", "kvscan", "striped_cp")}
    for m in ("kvscan", "striped_cp"):
        np.testing.assert_allclose(_np(outs[m]), _np(outs["pairs"]), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        Model(cfg, device="cpu", attn_mode="heads")


def test_production_mesh_shapes_and_refusal():
    """The production meshes' shapes without a world, and
    ``make_production_mesh`` refusing a world with too few ranks (here:
    none), as the JAX package's does."""
    from repro.launch.mesh import make_production_mesh as jax_production
    from repro_torch.launch.mesh import make_production_mesh, production_mesh_shape

    for multi_pod, shape in ((False, {"data": 16, "model": 16}),
                             (True, {"pod": 2, "data": 16, "model": 16})):
        ms = production_mesh_shape(multi_pod=multi_pod)
        assert ms.shape == shape and ms.size == int(np.prod(list(shape.values())))
        with pytest.raises(RuntimeError, match=f"need {ms.size} ranks"):
            make_production_mesh(multi_pod=multi_pod)
        with pytest.raises(RuntimeError, match=f"need {ms.size} devices"):
            jax_production(multi_pod=multi_pod)
