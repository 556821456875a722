"""Logical-axis sharding rules (DP / TP / SP / EP / CP) for a mesh (port of
``repro.distributed.sharding``).

Model tensors carry *logical* axis names ("batch", "seq", "heads", "ff",
"vocab", "experts", ...).  A :class:`ShardingRules` maps each logical name
to a mesh axis, a tuple of mesh axes, or ``None`` (replicated); a few keys
(``FLAG_KEYS``) carry execution flags instead.  ``activate_rules`` installs
rules and mesh for the code inside the context, which reads them through
``active_rules``: the MoE layer picks its expert-parallel branch there,
attention its context-parallel one.

The port runs explicit SPMD: every rank holds local tensors (its block of
each sharded one, a copy of each replicated one), as the body of a JAX
``shard_map`` does.  A placement is a spec, one entry per dim: ``None``,
a mesh axis name or a tuple of axis names (the entries of JAX's
``PartitionSpec``).  :func:`local_block` cuts a global tensor to a rank's
block under a spec, :func:`gather_blocks` puts the blocks back together.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import torch

AxisTarget = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisTarget, ...]


@dataclass(frozen=True)
class ShardingRules:
    """Logical axis name -> mesh axis target.  The defaults are the JAX
    package's baseline layout: batch over ("pod", "data"), the
    sequence-parallel residual and CP attention over "model", Megatron TP
    for the MLP, vocab and experts over "model"."""

    rules: Tuple[Tuple[str, AxisTarget], ...] = (
        ("batch", ("pod", "data")),
        ("seq", "model"),          # sequence-sharded residual stream (SP)
        ("kv_seq", None),          # attention KV after the gather: replicated
        ("heads", "model"),        # head-sharded attention (heads mode)
        ("kv_heads", None),
        ("head_dim", None),
        ("embed", None),
        ("ff", "model"),           # MLP TP
        ("vocab", "model"),        # vocab-sharded embedding and logits
        ("experts", "model"),      # expert parallelism
        ("expert_ff", None),
        ("cache_batch", ("pod", "data")),
        ("cache_seq", None),
        ("ssm_inner", "model"),
        ("ssm_heads", "model"),
        ("ssm_state", None),
        ("layers", None),          # stacked-layer leading dim
        ("stage", None),
        # adapter-stack task dim: optimizer moments shard across DP ranks
        ("adapter_tasks", ("pod", "data")),
    )

    # rule keys whose values are execution flags, not mesh axes
    FLAG_KEYS = ("moe_impl", "moe_wire", "attn_impl")

    def lookup(self, name: Optional[str]) -> AxisTarget:
        if name is None:
            return None
        for k, v in self.rules:
            if k == name:
                return v
        return None

    @classmethod
    def replicated(cls) -> "ShardingRules":
        """Every logical axis replicated: the start of rules that shard only
        what the port's model code runs sharded (the experts under EP;
        ``with_updates(experts="model")``), since it runs no tensor
        parallelism over heads, ff or vocab."""
        return cls(tuple((k, None) for k, _ in cls().rules))

    def with_updates(self, **kw: AxisTarget) -> "ShardingRules":
        d = dict(self.rules)
        d.update(kw)
        return ShardingRules(tuple(d.items()))

    def mesh_axes(self, mesh) -> "ShardingRules":
        """Drop rule targets naming axes that ``mesh`` lacks ("pod" on a
        one-pod mesh); flag-valued keys pass through.  ``mesh`` is anything
        with ``axis_names`` (a :class:`~repro_torch.launch.mesh.Mesh` or a
        ``MeshShape``)."""
        names = set(mesh.axis_names)

        def fix(k: str, t: AxisTarget) -> AxisTarget:
            if k in self.FLAG_KEYS or t is None:
                return t
            if isinstance(t, str):
                return t if t in names else None
            kept = tuple(a for a in t if a in names)
            return kept if kept else None

        return ShardingRules(tuple((k, fix(k, v)) for k, v in self.rules))


class _Env(threading.local):
    def __init__(self) -> None:
        self.mesh = None
        self.rules: Optional[ShardingRules] = None


_ENV = _Env()


@contextlib.contextmanager
def activate_rules(mesh, rules: Optional[ShardingRules]):
    """Install (mesh, rules) for the code inside the context (this thread)."""
    prev = (_ENV.mesh, _ENV.rules)
    _ENV.mesh = mesh
    _ENV.rules = rules.mesh_axes(mesh) if (rules is not None and mesh is not None) else rules
    try:
        yield
    finally:
        _ENV.mesh, _ENV.rules = prev


def active_rules():
    """(mesh, rules) of the innermost ``activate_rules``, or (None, None)."""
    return _ENV.mesh, _ENV.rules


def logical_to_spec(axes: Sequence[Optional[str]], rules: ShardingRules) -> Spec:
    """Logical axes (one per dim) -> spec entries, as JAX's
    ``PartitionSpec``: a mesh axis appears at most once, and a dim whose
    target reuses an axis already taken falls back to replicated."""
    used: set = set()
    out = []
    for name in axes:
        target = rules.lookup(name)
        if target is None:
            out.append(None)
            continue
        tgt = (target,) if isinstance(target, str) else tuple(target)
        free = tuple(a for a in tgt if a not in used)
        if len(free) != len(tgt):
            out.append(None)
            continue
        used.update(free)
        out.append(free[0] if len(free) == 1 else free)
    return tuple(out)


def shard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """The JAX sharding constraint's counterpart: checks ``x``'s rank
    against the logical axes and returns ``x``.  Port code runs on local
    tensors whose placement its collectives set, so a constraint has
    nothing to do; the port's model code does not call it."""
    if x.ndim != len(axes):
        raise ValueError(f"shard(): rank {x.ndim} vs {len(axes)} logical axes")
    return x


def _axes_of(entry: AxisTarget) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def divisible(dim: int, mesh, target: AxisTarget) -> bool:
    """Whether ``dim`` divides evenly over the mesh axes in ``target``."""
    size = 1
    for a in _axes_of(target):
        if a in mesh.axis_names:
            size *= mesh.shape[a]
    return dim % size == 0


def _parts(entry: AxisTarget, mesh) -> Tuple[int, int]:
    """(number of blocks, this rank's block) of a dim under a spec entry:
    row-major over the entry's axes, as JAX lays out a tuple entry."""
    n, idx = 1, 0
    for a in _axes_of(entry):
        size = mesh.shape[a]
        n, idx = n * size, idx * size + mesh.coord(a)
    return n, idx


def local_block(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of the global tensor ``t`` under ``spec`` (one entry
    per dim), contiguous and in a storage of its own, so that the global
    tensor can be freed.  A dim that does not divide raises."""
    if len(spec) != t.ndim:
        raise ValueError(f"local_block: spec {spec} for a tensor of rank {t.ndim}")
    out = t
    for dim, entry in enumerate(spec):
        n, idx = _parts(entry, mesh)
        if n == 1:
            continue
        if t.shape[dim] % n:
            raise ValueError(f"local_block: dim {dim} ({t.shape[dim]}) does not divide "
                             f"into {n} blocks")
        size = t.shape[dim] // n
        out = out.narrow(dim, idx * size, size)
    return out.clone() if out is not t else t


def gather_blocks(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The inverse of :func:`local_block`: every rank's block gathered back
    into the global tensor, on every rank (no gradient)."""
    from repro_torch.distributed import collectives

    out = t
    for dim, entry in enumerate(spec):
        axes = _axes_of(entry)
        if axes:
            out = collectives.all_gather_nograd(out, axes, mesh, dim)
    return out
