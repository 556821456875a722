"""The port's checkpoint store and restart supervisor (``repro_torch.
distributed``) against the JAX package's.

The store's own contract (atomic commit, crc32 per leaf, pruning, ordered
asynchronous saves) mirrors ``tests/test_checkpoint.py``.  Artifacts cross
between the packages bit for bit in both directions for a trained
``(adapter_params, opt_state)`` of all eight PEFT kinds, in the dtypes the
engines train (bf16 adapters, f32 moments, int32 Diff-Pruning rows, the
int32 AdamW step).  A ``TrainSupervisor`` run with one simulated failure
gives the JAX supervisor's per-step losses, and the training driver commits
its checkpoints.
"""
import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.checkpoint import restore_checkpoint as jax_restore_checkpoint
from repro.distributed.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.distributed.fault_tolerance import SupervisorConfig as JaxSupervisorConfig
from repro.distributed.fault_tolerance import TrainSupervisor as JaxTrainSupervisor
from repro.distributed.fault_tolerance import simulated_failure as jax_simulated_failure
from repro_torch.convert import adapters_from_numpy
from repro_torch.distributed import (
    AsyncCheckpointer,
    CheckpointStore,
    SupervisorConfig,
    TrainSupervisor,
    latest_step,
    prune_checkpoints,
    restore_checkpoint,
    save_checkpoint,
    simulated_failure,
)
from repro_torch.distributed.checkpoint import _flatten_with_paths
from repro_torch.launch import train
from repro_torch.train.optimizer import AdamWState
from test_torch_methods import MIX, build_pair, jax_impl

SUP_TASKS = "sst2:lora:8,qa:diff:16,rte:vera:16,sst2:prefix:8"


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return ({"w": torch.randn((8, 16), generator=g).bfloat16(),
             "b": {"x": torch.randn((4,), generator=g), "n": torch.arange(3, dtype=torch.int32)}},
            AdamWState(torch.tensor(5, dtype=torch.int32),
                       {"w": torch.randn((8, 16), generator=g), "n": None},
                       {"w": torch.rand((8, 16), generator=g), "n": None}))


def _zeros_like(tree):
    return jax.tree.map(torch.zeros_like, tree)


def _assert_equal_trees(a, b):
    fa, fb = _flatten_with_paths(a), _flatten_with_paths(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (key, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), key


def test_roundtrip_keeps_dtypes_and_structure(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 3, tree, extra={"next_step": 4})
    assert latest_step(str(tmp_path)) == 3
    out, extra = restore_checkpoint(str(tmp_path), 3, _zeros_like(tree))
    assert extra["next_step"] == 4
    assert isinstance(out[1], AdamWState) and out[1].m["n"] is None
    _assert_equal_trees(out, tree)
    with open(tmp_path / "step_00000003" / "manifest.json") as f:
        leaves = json.load(f)["leaves"]
    # keys as jax.tree_util joins them: dicts sorted, NamedTuple field names,
    # None leaves left out
    assert list(leaves) == ["0/b/n", "0/b/x", "0/w", "1/step", "1/m/w", "1/v/w"]
    assert [m["dtype"] for m in leaves.values()] == ["int32", "float32", "bfloat16", "int32",
                                                     "float32", "float32"]
    with pytest.raises(NotImplementedError, match="shardings"):
        restore_checkpoint(str(tmp_path), 3, _zeros_like(tree), shardings={})


def test_corruption_detected(tmp_path):
    tree = _tree()
    path = save_checkpoint(str(tmp_path), 1, tree)
    leaves = [n for n in os.listdir(path) if n.endswith(".npy")]
    victim = max(leaves, key=lambda n: os.path.getsize(os.path.join(path, n)))
    size = os.path.getsize(os.path.join(path, victim))
    with open(os.path.join(path, victim), "r+b") as f:
        f.seek(size - 8)  # inside the data payload
        f.write(b"\xde\xad\xbe\xef")
    with pytest.raises(IOError, match="checksum"):
        restore_checkpoint(str(tmp_path), 1, _zeros_like(tree))


def test_partial_write_never_visible(tmp_path, monkeypatch):
    tree = _tree()
    store = CheckpointStore(str(tmp_path))
    store.save(1, tree, extra={"steps_trained": 1})
    os.makedirs(str(tmp_path / "step_00000002.tmp"))  # an interrupted save
    real_save = np.save
    calls = {"n": 0}

    def dying_save(f, arr, **kw):
        calls["n"] += 1
        if calls["n"] > 1:  # die mid-way through the leaf files
            raise simulated_failure()
        return real_save(f, arr, **kw)

    monkeypatch.setattr(np, "save", dying_save)
    with pytest.raises(RuntimeError):
        store.save(3, tree)
    monkeypatch.setattr(np, "save", real_save)
    monkeypatch.setattr(os, "rename", lambda *a: (_ for _ in ()).throw(simulated_failure()))
    with pytest.raises(RuntimeError):  # dying at the commit itself
        store.save(4, tree)
    monkeypatch.undo()
    assert store.latest_step() == 1 and store.read_extra()["steps_trained"] == 1
    assert store.restore(_zeros_like(tree))[0] == 1


def test_prune_keeps_latest(tmp_path):
    tree = _tree()
    for s in range(5):
        save_checkpoint(str(tmp_path), s, tree)
    prune_checkpoints(str(tmp_path), keep=2)
    assert latest_step(str(tmp_path)) == 4
    assert sorted(n for n in os.listdir(str(tmp_path)) if n.startswith("step_")) == [
        "step_00000003", "step_00000004"]


def test_async_saves_are_ordered_and_raise_on_wait(tmp_path):
    trees = [_tree(s) for s in range(3)]
    store = CheckpointStore(str(tmp_path), keep=2)
    for s, tree in enumerate(trees, 1):
        store.save_async(s, tree, extra={"steps_trained": s})
        tree[0]["w"].zero_()  # the host copy was taken at the call
    store.wait()
    assert store.latest_step() == 3 and store.read_extra()["steps_trained"] == 3
    assert sorted(n for n in os.listdir(str(tmp_path))) == ["step_00000002", "step_00000003"]
    _assert_equal_trees(store.restore(_zeros_like(trees[0]))[1], _tree(2))
    blocked = tmp_path / "file"
    blocked.write_text("")
    ck = AsyncCheckpointer(str(blocked / "ckpt"))
    ck.save(1, trees[0])  # the directory cannot be made: raised on wait()
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()  # raised once


def _jax_trained_state():
    """The JAX engine's state for all eight kinds after one iteration on
    bf16 adapters, the port engine's state of the same structure, and the
    port's adapter layout."""
    jeng, jloaders, peng, _ = build_pair(MIX)
    jeng.reg.adapter_params = jax.tree.map(
        lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a,
        jeng.reg.adapter_params)
    with jax_impl("xla"):
        jeng.run_iteration(jloaders)
    padapters = jax.tree.map(lambda t: t.bfloat16() if t.is_floating_point() else t,
                             peng.reg.adapter_params)
    return ((jeng.reg.adapter_params, jeng.reg.opt_state), (padapters, peng.reg.opt_state),
            peng.reg.mta)


def _jax_keyed(tree):
    """{key: leaf} of a JAX tree, keyed as the JAX store keys it."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p))))
                     for p in path): leaf for path, leaf in flat}


def test_artifacts_cross_between_packages_bit_for_bit(tmp_path):
    jstate, like, mta = _jax_trained_state()
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_save_checkpoint(jdir, 1, jstate, extra={"next_step": 1})
    got, extra = restore_checkpoint(jdir, 1, like)
    assert extra == {"next_step": 1}
    jleaves = _jax_keyed(jstate)
    flat_got = _flatten_with_paths(got)
    assert [k for k, _ in flat_got] == list(jleaves)
    assert {k.split("/")[1] for k in jleaves if k.startswith("0/")} == set(mta.kind_tasks)
    assert len(mta.kind_tasks) == 8
    for key, t in flat_got:
        w = np.asarray(jleaves[key])
        assert str(t.dtype).removeprefix("torch.") == str(w.dtype), key
        np.testing.assert_array_equal(t.float().numpy() if t.dtype == torch.bfloat16
                                      else t.numpy(), w.astype(np.float32)
                                      if t.dtype == torch.bfloat16 else w, err_msg=key)
    # the adapters equal convert's tensors of the JAX tree
    widened = jax.tree.map(lambda a: np.asarray(a, np.float32)
                           if a.dtype == jnp.bfloat16 else np.asarray(a), jstate[0])
    want = _flatten_with_paths(adapters_from_numpy(widened, mta, "cpu"))
    for (key, g), (_, w) in zip(_flatten_with_paths(got[0]), want):
        assert torch.equal(g, w.to(g.dtype)), key
    # and back: the port's artifact restores in JAX; the same files, and the
    # same manifest but for its time
    save_checkpoint(pdir, 1, got, extra={"next_step": 1})
    back, _ = jax_restore_checkpoint(pdir, 1, jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    manifests = []
    for d in (jdir, pdir):
        with open(os.path.join(d, "step_00000001", "manifest.json")) as f:
            m = json.load(f)
        del m["time"]
        manifests.append(m)
    assert manifests[0] == manifests[1]
    names = [m["file"] for m in manifests[0]["leaves"].values()]
    match, mismatch, errors = filecmp.cmpfiles(os.path.join(jdir, "step_00000001"),
                                               os.path.join(pdir, "step_00000001"), names,
                                               shallow=False)
    assert match == names and not mismatch and not errors


def test_supervisor_restart_matches_jax(tmp_path):
    """Five steps, a checkpoint every two, a failure before step 3: both
    supervisors restart from step 2 (the loaders run on, the slot steps are
    kept), and every step's losses agree."""
    jeng, jloaders, peng, ploaders = build_pair(SUP_TASKS)
    runs = {}
    for name, eng, loaders, sup_cls, cfg_cls, fail in (
            ("jax", jeng, jloaders, JaxTrainSupervisor, JaxSupervisorConfig,
             jax_simulated_failure),
            ("port", peng, ploaders, TrainSupervisor, SupervisorConfig, simulated_failure)):
        reg = eng.reg
        pending = {3}
        losses = []

        def hook(i, pending=pending, fail=fail):
            if i in pending:
                pending.discard(i)
                raise fail()

        def step_fn(state, i, eng=eng, loaders=loaders, losses=losses):
            eng.reg.adapter_params, eng.reg.opt_state = state
            m = eng.run_iteration(loaders)
            losses.append((i, m.per_task_loss))
            return eng.reg.adapter_params, eng.reg.opt_state

        sup = sup_cls(cfg_cls(ckpt_dir=str(tmp_path / name), ckpt_every=2), failure_hook=hook)
        with jax_impl("xla"):
            sup.run((reg.adapter_params, reg.opt_state), step_fn, 5)
        assert sup.restarts == 1
        runs[name] = losses
    assert [i for i, _ in runs["port"]] == [i for i, _ in runs["jax"]] == [0, 1, 2, 2, 3, 4]
    for (i, p), (_, j) in zip(runs["port"], runs["jax"]):
        np.testing.assert_allclose(p, j, rtol=2e-4, err_msg=f"step {i}")
    state_keys = [k for k, _ in _flatten_with_paths((peng.reg.adapter_params,
                                                    peng.reg.opt_state))]
    for step in (2, 4, 5):
        for name in ("jax", "port"):
            with open(tmp_path / name / f"step_{step:08d}" / "manifest.json") as f:
                assert list(json.load(f)["leaves"]) == state_keys, (name, step)


def test_train_driver_commits_checkpoints(tmp_path, capsys):
    train.main(["--device", "cpu", "--arch", "llama3.2-3b", "--scale", "0.05", "--steps", "3",
                "--stages", "1", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000003"]
    assert CheckpointStore(str(tmp_path)).read_extra() == {"next_step": 3}
    assert "checkpoints in" in capsys.readouterr().out
