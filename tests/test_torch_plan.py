"""The port's planning stack and loader against the JAX package's.

``ExecutionPlanner.plan`` runs the same numpy code on the port's types, so
its plans must equal the JAX package's exactly: summary, hTasks, template
order and alignment arrays.  The port's cost model defaults to the H100's
spec-sheet constants; the comparison passes the JAX package's own constants
(``repro.core.cost_model``) to both planners, so it holds the code to the
code.  ``HTaskLoader`` batches must be equal too (both token streams seed
from the same per-process hash of the task id).
"""
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import ExecutionPlanner as JaxPlanner
from repro.core import ParallelismSpec as JaxParallelism
from repro.core import cost_model as jax_cost_model
from repro.data import HTaskLoader as JaxLoader
from repro.launch.train import parse_tasks as jax_parse_tasks
from repro_torch.configs import get_config
from repro_torch.core import ExecutionPlanner, HardwareProfile, ParallelismSpec
from repro_torch.data import HTaskLoader
from repro_torch.launch.train import parse_tasks

SPECS = {
    "lora_adapter_ia3": ("sst2:lora:8,qa:lora:16,rte:adapter:4,sst2:ia3", 4),
    "lora_only": ("qa:lora:4,sst2:lora:8,rte:lora:16,qa:lora:8,sst2:lora:4", 2),
}
JAX_HW = dict(peak_flops=jax_cost_model.PEAK_FLOPS, hbm_bw=jax_cost_model.HBM_BW,
              ici_bw=jax_cost_model.ICI_BW)


def _plans(spec, mode):
    tasks_spec, micro_batch = SPECS[spec]
    jt = jax_parse_tasks(tasks_spec, micro_batch)
    pt = parse_tasks(tasks_spec, micro_batch)
    jplan = JaxPlanner(jax_get_config("llama3.2-3b"), JaxParallelism(num_stages=2)).plan(
        jt, n_micro=2, alignment_mode=mode)
    pplan = ExecutionPlanner(get_config("llama3.2-3b"), ParallelismSpec(num_stages=2),
                             hw=HardwareProfile(**JAX_HW),
                             memory_budget=jax_cost_model.HBM_BYTES).plan(
        pt, n_micro=2, alignment_mode=mode)
    return jt, jplan, pt, pplan


@pytest.mark.parametrize("mode", ["chunked", "zero_pad", "pack_only"])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_plan_equals_jax(spec, mode):
    _, jplan, _, pplan = _plans(spec, mode)
    js, ps = jplan.summary(), pplan.summary()
    del js["planning_seconds"], ps["planning_seconds"]
    assert ps == js
    fields = ("task_ids", "rows", "row_len", "tokens", "effective_tokens")
    assert [tuple(getattr(h, f) for f in fields) for h in pplan.htasks] == \
        [tuple(getattr(h, f) for f in fields) for h in jplan.htasks]
    assert [(m.bucket, m.index) for m in pplan.template.micro_order] == \
        [(m.bucket, m.index) for m in jplan.template.micro_order]
    assert [b.htask_ids for b in pplan.template.buckets] == \
        [b.htask_ids for b in jplan.template.buckets]
    for pa, ja in zip(pplan.alignment, jplan.alignment):
        parr, jarr = pa.arrays(), ja.arrays()
        assert sorted(parr) == sorted(jarr)
        for key in jarr:
            np.testing.assert_array_equal(parr[key], jarr[key], err_msg=key)


def test_loader_batches_equal_jax():
    jt, jplan, pt, pplan = _plans("lora_adapter_ia3", "chunked")
    vocab = get_config("llama3.2-3b").vocab_size
    for i in range(len(jplan.htasks)):
        jl = JaxLoader(jt, jplan.alignment[i], vocab)
        pl = HTaskLoader(pt, pplan.alignment[i], vocab)
        for _ in range(3):
            jb, pb = next(jl), next(pl)
            assert sorted(pb) == sorted(jb)
            for key in jb:
                np.testing.assert_array_equal(pb[key], jb[key], err_msg=key)


def test_default_profile_is_the_h100():
    hw = HardwareProfile()
    assert (hw.peak_flops, hw.hbm_bw) == (989e12, 3.35e12)
    assert ExecutionPlanner(get_config("llama3.2-3b"), ParallelismSpec()).memory_budget == 80e9
