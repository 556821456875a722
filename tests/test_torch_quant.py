"""The port's int8 backbone tier against the JAX package's.

* ``quantize_weight`` / ``quantize_backbone``: ``q`` and ``scale`` equal the
  JAX package's exactly, on f32 and bf16 weights, with keepdims scales, and
  every other leaf untouched.
* ``quant_matmul``: the plain version against ``kops.quant_matmul`` on the
  xla and ``pallas_interpret`` tiers (f32 at 1e-5), its output type (x's, as
  on the Pallas tier; the xla tier promotes bf16 to f32), and dx against
  ``jax.vjp`` of the Pallas kernel in interpret mode.
* Adapter gradients under an int8 backbone equal a dense run on the
  explicitly dequantized f32 weights; the cost model and the planner price
  the int8 tier as the JAX package's do; ``backbone_from_numpy`` carries
  the JAX package's quantized tree.
* The slice: on ``smoke_config("llama3.2-3b")`` with ``backbone_dtype="int8"``
  and the JAX ``ModelGenerator``'s quantized tree on both sides (the other
  leaves widened to f32), the decode pool's bind-prefill logits agree at
  1e-4 and its greedy tokens are identical, and two training iterations of
  four LoRA/Adapter/IA3 tenants agree (losses rtol 2e-4, parameters and
  AdamW moments 1e-5).

On the CPU no CUDA kernel launches: the launch counters stay 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.core import ExecutionPlanner as JaxPlanner
from repro.core import ModelGenerator as JaxGenerator
from repro.core import ParallelismSpec as JaxParallelism
from repro.core import PEFTEngine as JaxEngine
from repro.core import cost_model as jax_cost_model
from repro.data import HTaskLoader as JaxLoader
from repro.kernels import ops as jops
from repro.kernels.quant_matmul import quant_matmul_pallas
from repro.launch import steps as jsteps
from repro.launch.train import parse_tasks as jax_parse_tasks
from repro.models import quantize as jquant
from repro.peft.methods import AdapterConfig as JaxAdapterConfig
from repro.peft.multitask import MultiTaskAdapters as JaxMultiTaskAdapters
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import adapters_from_numpy, backbone_from_numpy
from repro_torch.core import ExecutionPlanner, HardwareProfile, ModelGenerator, ParallelismSpec
from repro_torch.core import PEFTEngine
from repro_torch.core.cost_model import CostModel
from repro_torch.core.task import HTask
from repro_torch.data import HTaskLoader
from repro_torch.kernels import ops
from repro_torch.kernels.quant_matmul import launch_plan
from repro_torch.launch import steps
from repro_torch.launch.train import parse_tasks
from repro_torch.models import quantize
from repro_torch.models.transformer import Model
from repro_torch.peft.methods import AdapterConfig
from repro_torch.peft.multitask import MultiTaskAdapters, TaskSegments
from repro_torch.train.optimizer import adamw_init, tree_leaves, tree_map, tree_unflatten

F32 = dict(rtol=1e-5, atol=1e-5)
EINSUMS = [  # the three BaseOp site layouts (tests/test_quant_backbone.py)
    ("bsd,df->bsf", (2, 16, 32), (32, 64), (-2,)),            # MLP
    ("bsd,dhk->bshk", (2, 16, 32), (32, 4, 8), (-3,)),        # attention q/k/v
    ("bshk,hkd->bsd", (2, 16, 4, 8), (4, 8, 32), (-3, -2)),   # attention o
]
EINSUM_IDS = ["mlp", "attn_qkv", "attn_o"]
JAX_HW = dict(peak_flops=jax_cost_model.PEAK_FLOPS, hbm_bw=jax_cost_model.HBM_BW,
              ici_bw=jax_cost_model.ICI_BW)


@pytest.fixture(autouse=True)
def _counters_stay_zero():
    ops.reset_launch_counts()
    yield
    assert not any(ops.launch_counts().values())


class _impl:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.prev = jops.get_impl()
        jops.set_impl(self.name)

    def __exit__(self, *a):
        jops.set_impl(self.prev)


def _np_tree(tree):
    """A JAX tree as numpy: int8 leaves as they are, the rest widened to f32."""
    return jax.tree.map(lambda a: np.asarray(a) if a.dtype == jnp.int8
                        else np.asarray(a, np.float32), tree)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _qm_inputs(x_shape, w_shape, axes, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(*x_shape).astype(np.float32)
    w = (rs.randn(*w_shape) * 0.1).astype(np.float32)
    qw = jquant.quantize_weight(jnp.asarray(w), axes)
    return x, np.asarray(qw["q"]), np.asarray(qw["scale"])


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("einsum_str,x_shape,w_shape,axes", EINSUMS, ids=EINSUM_IDS)
def test_quantize_weight_equals_jax(dtype, einsum_str, x_shape, w_shape, axes):
    rs = np.random.RandomState(1)
    w = (rs.randn(3, *w_shape) * 0.05).astype(np.float32)  # a stack of 3 layers
    w[1, ..., 0] = 0.0  # all-zero output channels: their scale is the 1e-12 floor
    jw = jnp.asarray(w, dtype)
    want = jquant.quantize_weight(jw, axes)
    tw = torch.from_numpy(np.array(jw, np.float32)).to(getattr(torch, dtype))
    got = quantize.quantize_weight(tw, axes)
    assert got["q"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
    # the layer-at-a-time path gives the same nodes
    stacked = quantize._quantize_per_layer(tw, axes)
    assert torch.equal(stacked["q"], got["q"]) and torch.equal(stacked["scale"], got["scale"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_backbone_equals_jax(dtype):
    cfg_j = jax_smoke_config("llama3.2-3b").with_overrides(backbone_dtype="int8")
    dense = JaxGenerator(jax_smoke_config("llama3.2-3b"), seed=0).init_backbone()
    rs = np.random.RandomState(2)
    # f32 weights off the bf16 grid, so the f32 case is not a bf16 one
    dense_np = jax.tree.map(lambda a: (np.asarray(a, np.float32) * (
        1 + 1e-3 * rs.randn(*a.shape))).astype(np.float32), dense)
    if dtype == torch.bfloat16:
        dense_np = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16),
                                                     np.float32), dense_np)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = _flat(_np_tree(jquant.quantize_backbone(
        jax.tree.map(lambda a: jnp.asarray(a, jdtype), dense_np), cfg_j)))
    cfg = smoke_config("llama3.2-3b")
    params = backbone_from_numpy(dense_np, cfg, "cpu", dtype)
    before = _flat(params)
    got = _flat(quantize.quantize_backbone(params, cfg.with_overrides(backbone_dtype="int8")))
    assert sorted(got) == sorted(want)
    for path, t in got.items():
        if path[-1] in ("q", "scale"):
            assert path[-2] in quantize.QUANT_LEAVES, path
            np.testing.assert_array_equal(t.numpy(), want[path], err_msg=str(path))
        else:  # norms and the embedding: the same tensors, untouched
            assert t is before[path], path
    q, s = got[("layers", "attn", "w_o", "q")], got[("layers", "attn", "w_o", "scale")]
    assert q.shape == (2, 4, 16, 64) and s.shape == (2, 1, 1, 64)
    assert got[("layers", "attn", "w_k", "scale")].shape == (2, 1, 2, 16)
    assert got[("layers", "mlp", "w_down", "scale")].shape == (2, 1, 64)


def test_model_generator_quantizes_its_own_init():
    cfg = smoke_config("llama3.2-3b")
    dense = ModelGenerator(cfg, seed=5, device="cpu").init_backbone()
    gen = ModelGenerator(cfg.with_overrides(backbone_dtype="int8"), seed=5, device="cpu")
    bb = gen.init_backbone()
    assert gen.init_backbone() is bb
    want = _flat(quantize.quantize_backbone(dense, cfg))
    got = _flat(bb)
    assert sorted(got) == sorted(want)
    for path in got:
        assert torch.equal(got[path], want[path]), path
    assert all(t.dtype == torch.int8 for p, t in got.items() if p[-1] == "q")
    # 7 BaseOps of 2 layers: int8 q, f32 scale; the rest bf16
    L, d, ff, qd, kvd = 2, 64, 128, 64, 32
    n_quant = L * (d * (qd + 2 * kvd) + qd * d + 3 * d * ff)
    assert n_quant == quantize.quantized_param_count(cfg)
    n_scale = L * (qd + 2 * kvd + d + 2 * ff + d)
    n_dense = cfg.param_count() - n_quant
    assert quantize.tensor_bytes(bb) == n_quant + 4 * n_scale + 2 * n_dense


# ---------------------------------------------------------------------------
# quant_matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("einsum_str,x_shape,w_shape,axes", EINSUMS, ids=EINSUM_IDS)
def test_plain_quant_matmul_matches_jax(tier, einsum_str, x_shape, w_shape, axes):
    x, q, s = _qm_inputs(x_shape, w_shape, axes)
    with _impl(tier):
        want = jops.quant_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), einsum_str)
    got = ops.quant_matmul(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s),
                           einsum_str)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("einsum_str,x_shape,w_shape,axes", EINSUMS, ids=EINSUM_IDS)
def test_bf16_output_follows_the_pallas_tier(einsum_str, x_shape, w_shape, axes):
    """The port returns x's type, as the Pallas tier whose kernel it ports;
    the JAX xla tier promotes a bf16 x against the f32 dequantized weight to
    f32 (a reference quirk, pinned here)."""
    x, q, s = _qm_inputs(x_shape, w_shape, axes, seed=3)
    xb = jnp.asarray(x, jnp.bfloat16)
    with _impl("pallas_interpret"):
        pal = jops.quant_matmul(xb, jnp.asarray(q), jnp.asarray(s), einsum_str)
    with _impl("xla"):
        xla = jops.quant_matmul(xb, jnp.asarray(q), jnp.asarray(s), einsum_str)
    assert pal.dtype == jnp.bfloat16 and xla.dtype == jnp.float32
    got = ops.quant_matmul(torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16),
                           torch.from_numpy(q), torch.from_numpy(s), einsum_str)
    assert got.dtype == torch.bfloat16
    pal = np.asarray(pal, np.float32)
    unit = 2.0 ** -8 * np.abs(pal).max()  # one bf16 unit of the largest |y|
    assert np.abs(got.float().numpy() - pal).max() <= unit


@pytest.mark.parametrize("M,K,N", [(8, 64, 96), (5, 40, 72), (32, 128, 16)])
def test_quant_matmul_dx_matches_jax_vjp(M, K, N):
    rs = np.random.RandomState(M + K + N)
    x = rs.randn(M, K).astype(np.float32)
    g = rs.randn(M, N).astype(np.float32)
    qw = jquant.quantize_weight(jnp.asarray(rs.randn(K, N) * 0.1, jnp.float32), (-2,))
    q, s = np.asarray(qw["q"]), np.asarray(qw["scale"]).reshape(N)
    y, vjp = jax.vjp(lambda xx: quant_matmul_pallas(xx, jnp.asarray(q), jnp.asarray(s),
                                                    interpret=True), jnp.asarray(x))
    (dx_want,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = ops.quant_matmul(xt, torch.from_numpy(q), torch.from_numpy(s), "mk,kn->mn")
    (dx,) = torch.autograd.grad(yt, xt, torch.from_numpy(g))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y), **F32)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_want), **F32)


def test_adapter_grads_int8_equal_dense_dequantized():
    """Adapter gradients through an int8 backbone equal those of a dense
    run on the explicitly dequantized f32 weights."""
    cfg = smoke_config("llama3.2-3b")
    f32 = {k: {n: (w.float() if torch.is_tensor(w) else
                   {leaf: t.float() for leaf, t in w.items()}) for n, w in v.items()}
           for k, v in ModelGenerator(cfg, seed=0, device="cpu").init_backbone().items()}
    qbb = quantize.quantize_backbone(f32, cfg)
    dense = {k: {n: quantize.dequantize(w) if quantize.is_quantized(w) else w
                 for n, w in v.items()} for k, v in qbb.items() if k != "layers"}
    dense["layers"] = {k: {n: quantize.dequantize(w) if quantize.is_quantized(w) else w
                           for n, w in v.items()} for k, v in qbb["layers"].items()}
    model = Model(cfg, device="cpu")
    mta = MultiTaskAdapters(cfg, [AdapterConfig("lora", rank=4), AdapterConfig("lora", rank=4)],
                            device="cpu")
    ad = tree_map(lambda t: t.float(), mta.init(torch.Generator().manual_seed(1)))
    for site in ad["lora"].values():
        site["b"] = torch.randn(site["b"].shape, generator=torch.Generator().manual_seed(2)) * 0.1
    seg = TaskSegments.contiguous([2, 2])
    rs = np.random.RandomState(7)
    batch = {"tokens": torch.from_numpy(rs.randint(0, 256, (4, 32))),
             "labels": torch.from_numpy(rs.randint(0, 256, (4, 32))),
             "loss_mask": torch.ones((4, 32))}

    def grads(bb):
        leaves = [t.detach().clone().requires_grad_(True) for t in tree_leaves(ad)]
        out = model.forward(bb, batch, adapters=tree_unflatten(ad, leaves),
                            ctx_factory=mta.ctx_factory(seg))
        loss = seg.per_task_loss(out["per_token_loss"], batch["loss_mask"]).sum()
        return loss, torch.autograd.grad(loss, leaves)

    lq, gq = grads(qbb)
    ld, gd = grads(dense)
    np.testing.assert_allclose(float(lq.detach()), float(ld.detach()), **F32)
    assert len(gq) == len(gd) > 0
    for a, b in zip(gq, gd):
        assert float(b.abs().max()) > 0
        np.testing.assert_allclose(a.numpy(), b.numpy(), **F32)


def test_launch_plan_covers_k_on_the_main_path_shapes():
    # one launch per call at every M: wgmma over all of K above 64 rows,
    # else one mma.sync launch whose clusters split K (no second pass)
    for M in (1, 5, 8, 64, 65, 300, 2816, 4096):
        for K, N in ((3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072), (40, 72)):
            tma = K % 8 == 0 and N % 16 == 0
            route, nt8, cluster, k_span = launch_plan(M, K, N, tma=tma)
            if M > 64 and tma:
                assert (route, cluster, k_span) == ("wgmma", 1, K)
                continue
            assert route == "mma" and nt8 in (1, 2, 4, 8)
            assert 8 * nt8 >= min(M, 64) and (nt8 == 1 or 4 * nt8 < min(M, 64))
            assert cluster in (1, 2, 4, 8, 16)  # the H100 schedules clusters of 16
            assert k_span % 64 == 0 and cluster * k_span >= K > (cluster - 1) * k_span
    assert launch_plan(8, 3072, 1024)[2] == 16  # decode at N = 1024: the widest split
    assert launch_plan(8, 3072, 3072)[2] * 24 >= 132  # enough blocks to fill the card
    assert launch_plan(300, 40, 72, tma=False)[0] == "mma"  # TMA cannot read N = 72


def test_plan_is_cached_per_shape_and_device(monkeypatch):
    # the wrapper's plan: launch_plan at the card's SM count, read once and
    # cached per (M, K, N, device, TMA-able); no CUDA call once seeded
    from repro_torch.kernels import quant_matmul as qm

    monkeypatch.setattr(qm, "_SMS", {0: 132})
    monkeypatch.setattr(qm, "_PLANS", {})
    dev = torch.device("cuda", 0)
    for M, K, N, tma in ((8, 3072, 1024, True), (2816, 3072, 3072, True), (300, 40, 72, False)):
        plan = qm._plan(M, K, N, dev, tma)
        assert plan == launch_plan(M, K, N, 132, tma)
        assert qm._plan(M, K, N, dev, tma) is plan
    assert set(qm._PLANS) == {(8, 3072, 1024, 0, True), (2816, 3072, 3072, 0, True),
                              (300, 40, 72, 0, False)}


def test_plan_of_reads_operand_alignment(monkeypatch):
    # TMA (the wgmma route) needs 16-byte aligned x and q and an 8-byte
    # aligned scale; 16-byte copies (vec) ask nothing of scale
    from repro_torch.kernels import quant_matmul as qm

    monkeypatch.setattr(qm, "_plan", lambda M, K, N, dev, tma: (M, K, N, tma))
    M, K, N = 300, 64, 32
    xb = torch.zeros(M * K + 8, dtype=torch.bfloat16)
    q = torch.zeros((K, N), dtype=torch.int8)
    sb = torch.zeros(N + 2)
    assert q.data_ptr() % 16 == 0 and xb.data_ptr() % 16 == 0 and sb.data_ptr() % 8 == 0
    for x_off in (0, 1, 8):
        for s_off in (0, 1, 2):
            x, scale = xb[x_off:x_off + M * K].view(M, K), sb[s_off:s_off + N]
            vec = x.data_ptr() % 16 == 0
            assert qm.plan_of(x, q, scale) == ((M, K, N, vec and s_off % 2 == 0), vec)
    x = xb[:M * K].view(M, K)
    assert qm.plan_of(x[:, :36].contiguous(), q[:36], sb[:N])[1] is False  # K % 8 != 0


def test_int8_widening_is_exact():
    # the kernels' int8 -> bf16 step, transcribed: bf16(128 + (b & 0x7f))
    # minus bf16(b < 0 ? 256 : 128), both built from bits, is b for every byte
    b = np.arange(-128, 128, dtype=np.int8)
    u = b.view(np.uint8).astype(np.uint32)

    def bf16_bits(bits):
        return (bits << 16).astype(np.uint32).view(np.float32)

    v = bf16_bits((u & 0x7F) | 0x4300)
    s = bf16_bits((u & 0x80) | 0x4300)
    out = torch.from_numpy(v).bfloat16() - torch.from_numpy(s).bfloat16()
    assert torch.equal(out.float(), torch.from_numpy(b.astype(np.float32)))


# ---------------------------------------------------------------------------
# cost model, planner, conversion
# ---------------------------------------------------------------------------


def test_cost_model_and_plan_for_int8_equal_jax():
    from repro.core.task import HTask as JaxHTask

    jcfg = jax_get_config("llama3.2-3b").with_overrides(backbone_dtype="int8")
    cfg = get_config("llama3.2-3b").with_overrides(backbone_dtype="int8")
    spec = "sst2:lora:8,qa:lora:16,rte:adapter:8,sst2:ia3"
    jt, pt = jax_parse_tasks(spec, 8), parse_tasks(spec, 8)
    jcm = jax_cost_model.CostModel(jcfg, jt, JaxParallelism())
    pcm = CostModel(cfg, pt, ParallelismSpec(), hw=HardwareProfile(**JAX_HW))
    assert pcm.weight_bytes == jcm.weight_bytes == 1
    assert pcm.stage_memory([]) == jcm.stage_memory([]) < \
        CostModel(get_config("llama3.2-3b"), pt, ParallelismSpec()).stage_memory([])
    jh = [JaxHTask((0, 1, 3), 24 * 256, 24, 256, 64), JaxHTask((2,), 8 * 128, 8, 128, 64)]
    ph = [HTask((0, 1, 3), 24 * 256, 24, 256, 64), HTask((2,), 8 * 128, 8, 128, 64)]
    assert pcm.stage_memory(ph) == jcm.stage_memory(jh)
    assert pcm.stage_latency(ph[0]) == pytest.approx(jcm.stage_latency(jh[0]), rel=1e-12)
    assert quantize.quantized_param_count(cfg) == jquant.quantized_param_count(jcfg)

    jplan = JaxPlanner(jcfg, JaxParallelism(num_stages=1)).plan(jt, n_micro=1)
    pplan = ExecutionPlanner(cfg, ParallelismSpec(num_stages=1), hw=HardwareProfile(**JAX_HW),
                             memory_budget=jax_cost_model.HBM_BYTES).plan(pt, n_micro=1)
    js, ps = jplan.summary(), pplan.summary()
    del js["planning_seconds"], ps["planning_seconds"]
    assert ps == js
    fields = ("task_ids", "rows", "row_len", "tokens", "effective_tokens")
    assert [tuple(getattr(h, f) for f in fields) for h in pplan.htasks] == \
        [tuple(getattr(h, f) for f in fields) for h in jplan.htasks]


def test_backbone_from_numpy_carries_the_quantized_tree():
    cfg_j = jax_smoke_config("llama3.2-3b").with_overrides(backbone_dtype="int8")
    tree = _np_tree(JaxGenerator(cfg_j, seed=0).init_backbone())
    cfg = smoke_config("llama3.2-3b").with_overrides(backbone_dtype="int8")
    bb = backbone_from_numpy(tree, cfg, "cpu", torch.bfloat16)
    for name in ("w_q", "w_o"):
        node = bb["layers"]["attn"][name]
        assert node["q"].dtype == torch.int8 and node["scale"].dtype == torch.float32
        np.testing.assert_array_equal(node["q"].numpy(), tree["layers"]["attn"][name]["q"])
    assert bb["layers"]["mlp"]["w_up"]["q"].dtype == torch.int8
    assert bb["embed"]["tok"].dtype == torch.bfloat16
    bad = jax.tree.map(lambda a: a, tree)
    del bad["layers"]["mlp"]["w_up"]["scale"]
    with pytest.raises(KeyError, match="missing"):
        backbone_from_numpy(bad, cfg, "cpu", torch.bfloat16)
    bad = jax.tree.map(lambda a: a, tree)
    bad["layers"]["attn"]["w_k"]["q"] = bad["layers"]["attn"]["w_k"]["q"].astype(np.float32)
    with pytest.raises(TypeError, match="int8"):
        backbone_from_numpy(bad, cfg, "cpu", torch.bfloat16)
    with pytest.raises(TypeError, match="dict"):  # a dense tree for an int8 config
        backbone_from_numpy(_np_tree(JaxGenerator(jax_smoke_config("llama3.2-3b"),
                                                  seed=0).init_backbone()),
                            cfg, "cpu", torch.bfloat16)


# ---------------------------------------------------------------------------
# the slice: serving and training on the int8 backbone, against JAX
# ---------------------------------------------------------------------------

SITES = ("attn_q", "attn_k", "attn_v", "attn_o", "mlp_gate", "mlp_up", "mlp_down")
TENANTS = ((4, 8.0), (8, 4.0), (2, 6.0))
ROWS, MAX_LEN, CAP, LP = 4, 24, 6, 8
BIND_ROWS = np.asarray([0, 1, 3], np.int32)
BIND_TASKS = np.asarray([2, 0, 1], np.int32)
POOL_TASKS = np.asarray([2, 0, -1, 1], np.int32)
LENGTHS = np.asarray([8, 5, 3], np.int32)
MAX_NEW = np.asarray([6, 3, 5], np.int32)


@pytest.fixture(scope="module")
def serve_setup():
    cfg_j = jax_smoke_config("llama3.2-3b").with_overrides(backbone_dtype="int8")
    jgen = JaxGenerator(cfg_j, seed=0)
    bb_np = _np_tree(jgen.init_backbone())
    mta = JaxMultiTaskAdapters(cfg_j, [JaxAdapterConfig("lora", rank=r, alpha=a, targets=SITES)
                                       for r, a in TENANTS])
    ad_np = _np_tree(mta.init(jax.random.PRNGKey(1)))
    rs = np.random.RandomState(0)
    for site in ad_np["lora"].values():
        site["b"] = (rs.randn(*site["b"].shape) * 0.1).astype(np.float32)
    tokens = np.zeros((len(LENGTHS), LP), np.int32)
    for i, n in enumerate(LENGTHS):
        tokens[i, :n] = rs.randint(1, 256, n)
    cfg = smoke_config("llama3.2-3b").with_overrides(backbone_dtype="int8")
    mta_t = MultiTaskAdapters(cfg, [AdapterConfig("lora", rank=r, alpha=a, targets=SITES)
                                    for r, a in TENANTS], device="cpu")
    return {"model": jgen.model, "mta": mta, "bb": jax.tree.map(jnp.asarray, bb_np),
            "ad": jax.tree.map(jnp.asarray, ad_np), "model_t": Model(cfg, device="cpu"),
            "mta_t": mta_t, "bb_t": backbone_from_numpy(bb_np, cfg, "cpu", torch.float32),
            "ad_t": adapters_from_numpy(ad_np, mta_t, "cpu"), "tokens": tokens}


def test_int8_bind_prefill_logits_match_jax(serve_setup):
    s = serve_setup
    mta, mta_t = s["mta"], s["mta_t"]
    st = s["model"].init_decode_state(None, 3, MAX_LEN, cache_dtype=jnp.float32)
    ctxf = mta.ctx_factory_from_slots(
        {k: jnp.asarray(v) for k, v in mta.decode_row_slots(BIND_TASKS).items()})
    with _impl("xla"):
        want, _ = s["model"].prefill(s["bb"], {"tokens": jnp.asarray(s["tokens"])}, st,
                                     adapters=s["ad"], ctx_factory=ctxf,
                                     lengths=jnp.asarray(LENGTHS))
    st_t = s["model_t"].init_decode_state(3, MAX_LEN, cache_dtype=torch.float32)
    ctxf_t = mta_t.ctx_factory_from_slots(
        {k: torch.from_numpy(v) for k, v in mta_t.decode_row_slots(BIND_TASKS).items()})
    got, _ = s["model_t"].prefill(s["bb_t"], {"tokens": torch.from_numpy(s["tokens"])}, st_t,
                                  adapters=s["ad_t"], ctx_factory=ctxf_t,
                                  lengths=torch.from_numpy(LENGTHS))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_int8_pool_generation_matches_jax(serve_setup):
    s = serve_setup
    model, mta = s["model"], s["mta"]
    scales = {k: jnp.asarray(mta.scales(k)) for k in mta.kind_tasks}

    def jslots(tasks):
        return {k: jnp.asarray(v) for k, v in mta.decode_row_slots(tasks).items()}

    with _impl("xla"):
        pool = jsteps.init_decode_pool(model, ROWS, MAX_LEN, CAP, cache_dtype=jnp.float32)
        bind = jsteps.build_decode_batched_bind_step(model, mta, MAX_LEN)
        micro = jsteps.build_decode_micro_step(model, mta)
        pool = bind(s["bb"], s["ad"], pool, jnp.asarray(BIND_ROWS), jnp.asarray(s["tokens"]),
                    jnp.asarray(LENGTHS), jslots(BIND_TASKS), scales, jnp.asarray(MAX_NEW),
                    jsteps.greedy_sampling(len(BIND_ROWS)))
        for _ in range(CAP - 1):
            pool = micro(s["bb"], s["ad"], pool, jslots(POOL_TASKS), scales)
    model_t, mta_t = s["model_t"], s["mta_t"]
    scales_t = {k: torch.from_numpy(mta_t.scales(k)) for k in mta_t.kind_tasks}

    def tslots(tasks):
        return {k: torch.from_numpy(v) for k, v in mta_t.decode_row_slots(tasks).items()}

    tpool = steps.init_decode_pool(model_t, ROWS, MAX_LEN, CAP, cache_dtype=torch.float32)
    tbind = steps.build_decode_batched_bind_step(model_t, mta_t, MAX_LEN)
    tpool = tbind(s["bb_t"], s["ad_t"], tpool, torch.from_numpy(BIND_ROWS),
                  torch.from_numpy(s["tokens"]), torch.from_numpy(LENGTHS), tslots(BIND_TASKS),
                  scales_t, torch.from_numpy(MAX_NEW), steps.greedy_sampling(3, "cpu"), [])
    tmicro = steps.build_decode_micro_step(model_t, mta_t)
    for _ in range(CAP - 1):
        tpool = tmicro(s["bb_t"], s["ad_t"], tpool, tslots(POOL_TASKS), scales_t, [])
    np.testing.assert_array_equal(tpool["out"].numpy(), np.asarray(pool["out"]))
    np.testing.assert_array_equal(tpool["n_out"].numpy(), np.asarray(pool["n_out"]))
    np.testing.assert_array_equal(tpool["state"]["pos"].numpy(),
                                  np.asarray(pool["state"]["pos"]))
    assert list(tpool["n_out"].numpy()) == [6, 3, 0, 5] and not tpool["active"].any()
    np.testing.assert_allclose(tpool["state"]["kv"]["k"].numpy(),
                               np.asarray(pool["state"]["kv"]["k"]), rtol=1e-4, atol=1e-4)


TRAIN_TASKS = "sst2:lora:8,qa:lora:16,rte:adapter:4,sst2:ia3"
FILLED = ("b", "up", "s")  # the adapter leaves that start at zero


def test_int8_run_iteration_matches_jax():
    cfg_j = jax_smoke_config("llama3.2-3b").with_overrides(attn_q_block=128,
                                                          backbone_dtype="int8")
    jt = jax_parse_tasks(TRAIN_TASKS, 2)
    jplan = JaxPlanner(cfg_j, JaxParallelism(num_stages=1)).plan(jt, n_micro=1)
    jgen = JaxGenerator(cfg_j, seed=0)
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
    with _impl("xla"):
        jeng = JaxEngine(jgen, jplan, lr=1e-3)

    cfg = smoke_config("llama3.2-3b").with_overrides(attn_q_block=128, backbone_dtype="int8")
    pt = parse_tasks(TRAIN_TASKS, 2)
    pplan = ExecutionPlanner(cfg, ParallelismSpec(num_stages=1), hw=HardwareProfile(**JAX_HW),
                             memory_budget=jax_cost_model.HBM_BYTES).plan(pt, n_micro=1)
    assert len(pplan.htasks) == 1 and pplan.htasks[0].row_len == 256
    gen = ModelGenerator(cfg, device="cpu")
    reg = gen.register_tasks(pt)
    gen.backbone_params = backbone_from_numpy(bb_np, cfg, "cpu", torch.float32)
    reg.adapter_params = adapters_from_numpy(ad_np, reg.mta, "cpu")
    reg.opt_state = adamw_init(reg.adapter_params)
    peng = PEFTEngine(gen, pplan, lr=1e-3, device="cpu")
    jloaders = {i: JaxLoader(jt, jplan.alignment[i], cfg_j.vocab_size)
                for i in range(len(jplan.htasks))}
    ploaders = {i: HTaskLoader(pt, pplan.alignment[i], cfg.vocab_size)
                for i in range(len(pplan.htasks))}
    for it in range(2):
        with _impl("xla"):
            jm = jeng.run_iteration(jloaders)
        pm = peng.run_iteration(ploaders)
        np.testing.assert_allclose(pm.per_task_loss, jm.per_task_loss, rtol=2e-4,
                                   err_msg=f"iteration {it}")
        for name, jtree, ptree in (
                ("params", jeng.reg.adapter_params, peng.reg.adapter_params),
                ("m", jeng.reg.opt_state.m, peng.reg.opt_state.m),
                ("v", jeng.reg.opt_state.v, peng.reg.opt_state.v)):
            jf, pf = _flat(jtree), _flat(ptree)
            assert sorted(jf) == sorted(pf)
            for path in jf:
                np.testing.assert_allclose(pf[path].detach().numpy(),
                                           np.asarray(jf[path], np.float32),
                                           err_msg=f"iteration {it} {name} {path}", **F32)
