"""The port's training path (planner -> ModelGenerator -> PEFTEngine.
run_iteration -> member-masked AdamW) against the JAX engine on its xla
tier.

Four tenants — LoRA rank 8, LoRA rank 16, Adapter rank 4, IA3 — fused into
one hTask of row length 256 on ``smoke_config("llama3.2-3b")``.  Both sides
train float32 weights carried across from the JAX ``ModelGenerator``, with
the zero-initialised leaves (LoRA B, Adapter up, IA3 s) filled from a numpy
seed so that every gradient is live.

The model's ``attn_q_block`` is 128 on both sides: the port follows the JAX
Pallas kernel's tile-visibility rule (query tiles of gcd(S, attn_q_block),
key tiles of gcd(S, 128)), and the xla tier held here cuts both at
``_fit_block(S, attn_q_block)``; at 128 the two rules are one, and with
S = 256 the rule is live on the loader's padded layout.
"""
import os
import subprocess
import sys
from pathlib import Path

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
from repro.launch.train import parse_tasks as jax_parse_tasks
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro_torch.configs import smoke_config
from repro_torch.convert import adapters_from_numpy, backbone_from_numpy
from repro_torch.core import ExecutionPlanner, HardwareProfile, ModelGenerator, ParallelismSpec
from repro_torch.core import PEFTEngine
from repro_torch.data import HTaskLoader
from repro_torch.launch.train import parse_tasks
from repro_torch.train.optimizer import adamw_init, tree_leaves

ROOT = Path(__file__).resolve().parent.parent
TASKS = "sst2:lora:8,qa:lora:16,rte:adapter:4,sst2:ia3"
MICRO_BATCH = 2
LR = 1e-3
TOL = dict(rtol=1e-5, atol=1e-5)
FILLED = ("b", "up", "s")  # the leaves that start at zero


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _flat(tree, prefix=()):
    """{path: leaf} of a nested dict (numpy or torch leaves)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v, np.float32) if not torch.is_tensor(v) \
                else v.detach().float().numpy()
    return out


def _build(plan_kw=None):
    """JAX engine and port engine on the same weights, plans and loaders."""
    plan_kw = plan_kw or {}
    cfg = jax_smoke_config("llama3.2-3b").with_overrides(attn_q_block=128)
    jt = jax_parse_tasks(TASKS, MICRO_BATCH)
    jplan = JaxPlanner(cfg, JaxParallelism(num_stages=1)).plan(jt, n_micro=1, **plan_kw)
    jgen = JaxGenerator(cfg, seed=0)
    jgen.register_tasks(jt)
    bb_np = _np_tree(jgen.init_backbone())
    ad_np = _np_tree(jgen.registered.adapter_params)
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

    cfg_t = smoke_config("llama3.2-3b").with_overrides(attn_q_block=128)
    pt = parse_tasks(TASKS, MICRO_BATCH)
    pplan = ExecutionPlanner(cfg_t, ParallelismSpec(num_stages=1),
                             hw=HardwareProfile(peak_flops=jax_cost_model.PEAK_FLOPS,
                                                hbm_bw=jax_cost_model.HBM_BW,
                                                ici_bw=jax_cost_model.ICI_BW),
                             memory_budget=jax_cost_model.HBM_BYTES).plan(pt, n_micro=1,
                                                                          **plan_kw)
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


@pytest.fixture(scope="module")
def fused():
    return _build()


def test_plan_is_one_fused_htask_of_row_length_256(fused):
    _, _, peng, _ = fused
    assert len(peng.plan.htasks) == 1
    h = peng.plan.htasks[0]
    assert sorted(h.task_ids) == [0, 1, 2, 3] and h.row_len == 256
    assert peng.reg.mta.kind_capacity == {"lora": 2, "adapter": 1, "ia3": 1}


def test_run_iteration_matches_jax(fused):
    jeng, jloaders, peng, ploaders = fused
    for it in range(2):
        jm = jeng.run_iteration(jloaders)
        pm = peng.run_iteration(ploaders)
        np.testing.assert_allclose(pm.per_task_loss, jm.per_task_loss, rtol=2e-4,
                                   err_msg=f"iteration {it}")
        np.testing.assert_allclose(pm.loss, jm.loss, rtol=2e-4)
        assert (pm.tokens, pm.effective_tokens) == (jm.tokens, jm.effective_tokens)
        for name, jtree, ptree in (
                ("params", jeng.reg.adapter_params, peng.reg.adapter_params),
                ("m", jeng.reg.opt_state.m, peng.reg.opt_state.m),
                ("v", jeng.reg.opt_state.v, peng.reg.opt_state.v)):
            jf, pf = _flat(jtree), _flat(ptree)
            assert sorted(jf) == sorted(pf)
            for path in jf:
                np.testing.assert_allclose(pf[path], jf[path],
                                           err_msg=f"iteration {it} {name} {path}", **TOL)
        for kind, v in jeng._slot_steps.items():
            np.testing.assert_array_equal(peng._slot_steps[kind].numpy(), np.asarray(v))
        assert int(peng.reg.opt_state.step) == int(jeng.reg.opt_state.step) == it + 1


def _snapshot(eng):
    reg = eng.reg
    return [t.clone() for t in tree_leaves(reg.adapter_params) + tree_leaves(reg.opt_state.m)
            + tree_leaves(reg.opt_state.v) + list(eng._slot_steps.values())]


def _slot_state(eng, kind, slot):
    reg = eng.reg
    return [t[:, slot].clone() for tree in (reg.adapter_params, reg.opt_state.m,
                                            reg.opt_state.v)
            for t in tree_leaves(tree[kind])] + [eng._slot_steps[kind][slot].clone()]


def test_member_masks_and_nan_guard():
    """Unfused plan (one hTask per tenant): every micro-step leaves the
    other tenants' values, moments and step counts bit-identical, though
    their moments are non-zero after their own step.  A batch with a NaN
    loss mask leaves every leaf, moment and count unchanged."""
    _, _, peng, ploaders = _build({"enable_fusion": False})
    mta = peng.reg.mta
    order = peng._schedule(None)
    assert len(order) == 4
    batches = {hid: next(ploaders[hid]) for hid in order}
    n_acc = sum(mta.kind_capacity.values())
    acc = (torch.zeros(()), torch.zeros(n_acc))

    def run(hid, batch):
        nonlocal acc
        step = peng._step_for(hid)
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        (peng.reg.adapter_params, peng.reg.opt_state, peng._slot_steps, acc) = step(
            peng.backbone, peng.reg.adapter_params, peng.reg.opt_state, peng._slot_steps,
            batch, peng._member_ids[hid], acc)

    for hid in order:
        (member,) = peng.plan.htasks[hid].task_ids
        others = [(mta.task_cfgs[t].kind, int(mta.task_slot[t]))
                  for t in range(len(mta.task_cfgs)) if t != member]
        before = {ks: _slot_state(peng, *ks) for ks in others}
        mine = _slot_state(peng, mta.task_cfgs[member].kind, int(mta.task_slot[member]))
        run(hid, batches[hid])
        for ks, old in before.items():
            for a, b in zip(old, _slot_state(peng, *ks)):
                assert torch.equal(a, b), f"non-member {ks} changed in hTask {hid}"
        after = _slot_state(peng, mta.task_cfgs[member].kind, int(mta.task_slot[member]))
        assert not torch.equal(mine[0], after[0])  # the member did train
    assert all(float(v.abs().max()) > 0 for v in tree_leaves(peng.reg.opt_state.m))

    snap = _snapshot(peng)
    bad = dict(batches[order[0]], loss_mask=np.full_like(batches[order[0]]["loss_mask"], np.nan))
    run(order[0], bad)
    assert not np.isfinite(float(acc[0]))
    for a, b in zip(snap, _snapshot(peng)):
        assert torch.equal(a, b)


def test_train_entry_point_runs_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--arch",
         "llama3.2-3b", "--scale", "0.05", "--steps", "2", "--stages", "1",
         "--ckpt-dir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.splitlines()
    assert lines[-1] == f"done; checkpoints in {tmp_path}"
    losses = [float(l.split("loss=")[1].split()[0]) for l in lines if l.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))
