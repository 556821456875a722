"""Device meshes over a ``torch.distributed`` world (port of
``repro.launch.mesh``), and a launcher of a world of local processes.

A :class:`MeshShape` is a mesh's shape and axis names, nothing more: the
sharding rules of ``repro_torch.launch.rules`` are worked out on one, so the
production meshes (16, 16) and (2, 16, 16) need no world.  A :class:`Mesh`
lays a shape over the ranks of an initialised world, row-major (rank
``r`` has the coordinates of ``r`` in the shape, as JAX's mesh of the first
``n`` devices), and makes one process group for every line along every
non-empty set of its axes: a collective over ``("data", "model")`` runs
in the group of the ranks that share this rank's other coordinates.

The backend of the groups is an argument of the mesh (``"gloo"`` or
``"nccl"``), never chosen from a failure: the CPU tests and the ranks that
share one card run gloo, ranks that each own a card run NCCL.  The groups
are plain ``new_group`` ones; ``torch.distributed.device_mesh`` is not
used (nothing here needs more than a group per line, and whether it takes
gloo on CUDA tensors was not checked).
"""
from __future__ import annotations

import itertools
import multiprocessing
import os
import queue as queue_mod
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np


class MeshShape:
    """A mesh's shape and axis names: ``shape[name]`` is the axis's size."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} for axes {tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))
        self.size = int(np.prod(list(self.shape.values()), dtype=np.int64))

    def axis_size(self, axes) -> int:
        """The number of ranks along ``axes`` (a name or a tuple of names)."""
        return int(np.prod([self.shape[a] for a in _as_tuple(axes)], dtype=np.int64))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.shape})"


def _as_tuple(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh(MeshShape):
    """A mesh over the first ``prod(shape)`` ranks of the initialised world.

    Every rank of the world builds it (group creation is collective), in
    the same order as its other meshes; a rank past the mesh's size is no
    member (``member`` is False) and runs none of its collectives.
    ``timeout_s`` bounds every collective of the mesh's groups."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *, backend: str,
                 timeout_s: float = 120.0):
        import torch.distributed as dist

        super().__init__(shape, axis_names)
        if backend not in ("gloo", "nccl"):
            raise ValueError(f"mesh backend {backend!r}: gloo or nccl")
        if not dist.is_initialized():
            raise RuntimeError("Mesh: torch.distributed is not initialised")
        world = dist.get_world_size()
        if world < self.size:
            raise RuntimeError(f"need {self.size} ranks for mesh {tuple(self.shape.values())}; "
                               f"the world has {world}")
        self.backend = backend
        self.rank = dist.get_rank()
        self.member = self.rank < self.size
        dims = tuple(self.shape.values())
        self._coords = (dict(zip(self.axis_names, np.unravel_index(self.rank, dims)))
                        if self.member else None)
        self._groups: Dict[Tuple[str, ...], Tuple[Any, Tuple[int, ...]]] = {}
        timeout = timedelta(seconds=timeout_s)
        grid = np.arange(self.size).reshape(dims)
        for n in range(1, len(self.axis_names) + 1):
            for sub in itertools.combinations(range(len(self.axis_names)), n):
                names = tuple(self.axis_names[i] for i in sub)
                if self.axis_size(names) == 1:
                    continue
                rest = [i for i in range(len(dims)) if i not in sub]
                lines = np.transpose(grid, rest + list(sub)).reshape(-1, self.axis_size(names))
                for line in lines:  # every rank makes every group, in one order
                    ranks = tuple(int(r) for r in line)
                    pg = dist.new_group(list(ranks), timeout=timeout, backend=backend)
                    if self.rank in ranks:
                        self._groups[names] = (pg, ranks)

    def _key(self, axes) -> Tuple[str, ...]:
        axes = _as_tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise KeyError(f"mesh {self.axis_names} has no axis {unknown}")
        return tuple(a for a in self.axis_names if a in axes)

    def coord(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        if not self.member:
            raise RuntimeError(f"rank {self.rank} is not in mesh {self.shape}")
        return int(self._coords[axis])

    def axis_index(self, axes) -> int:
        """This rank's index along ``axes``, row-major in the mesh's axis
        order (JAX's ``axis_index`` of a tuple of axes)."""
        idx = 0
        for a in self._key(axes):
            idx = idx * self.shape[a] + self.coord(a)
        return idx

    def group(self, axes):
        """(process group, its global ranks in axis order) of this rank's line
        along ``axes``; (None, (rank,)) when the line has one rank."""
        key = self._key(axes)
        if self.axis_size(key) == 1:
            return None, (self.rank,)
        return self._groups[key]


def make_mesh(shape, axes, *, backend: str = "gloo", timeout_s: float = 120.0) -> Mesh:
    """A mesh of ``shape`` over the first ``prod(shape)`` ranks (tests, the
    card's co-located ranks)."""
    return Mesh(shape, axes, backend=backend, timeout_s=timeout_s)


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    """The production mesh's shape: (16, 16) over ("data", "model"), or
    (2, 16, 16) over ("pod", "data", "model")."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, backend: str = "nccl",
                         timeout_s: float = 600.0) -> Mesh:
    """The production mesh over the world's first 256 (or 512) ranks;
    raises on a world with fewer ranks, as the JAX package's does."""
    import torch.distributed as dist

    shape = production_mesh_shape(multi_pod=multi_pod)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < shape.size:
        raise RuntimeError(f"need {shape.size} ranks for mesh "
                           f"{tuple(shape.shape.values())}; have {have}")
    return Mesh(tuple(shape.shape.values()), shape.axis_names, backend=backend,
                timeout_s=timeout_s)


# ---------------------------------------------------------------------------
# A world of local processes
# ---------------------------------------------------------------------------


def _world_main(rank, world_size, store_path, backend, timeout_s, fn, args, out_q):
    import torch.distributed as dist

    try:
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                                timeout=timedelta(seconds=timeout_s))
        try:
            result = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        out_q.put((rank, True, result))
    except BaseException:  # reported to the parent, which fails the world
        out_q.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def run_world(fn: Callable, world_size: int, store_path: str, *, args: tuple = (),
              backend: str = "gloo", timeout_s: float = 120.0,
              join_timeout_s: Optional[float] = None) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes joined into one ``torch.distributed`` world through a
    ``FileStore`` at ``store_path`` (a path no other world uses), every
    collective bounded by ``timeout_s``.  Returns each rank's result, in
    rank order (results cross a pipe: numpy arrays, not tensors).

    A rank that raises fails the world; a world that does not finish within
    ``join_timeout_s`` (default ``2 * timeout_s``) is killed.  Either way
    every process is stopped before this raises."""
    ctx = multiprocessing.get_context("spawn")
    out_q = ctx.Queue()
    procs = [ctx.Process(target=_world_main, daemon=True,
                         args=(r, world_size, store_path, backend, timeout_s, fn, args, out_q))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + (join_timeout_s or 2 * timeout_s)
    results: Dict[int, Any] = {}
    failures = []
    try:
        while len(results) + len(failures) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"run_world: {world_size - len(results)} of {world_size} "
                                   f"ranks unfinished after {join_timeout_s or 2 * timeout_s} s")
            try:
                rank, ok, payload = out_q.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and out_q.empty():
                    time.sleep(0.5)  # a rank's last message may still be in flight
                    if out_q.empty():
                        raise RuntimeError(f"run_world: rank(s) exited "
                                           f"{[p.exitcode for p in dead]} without a result")
                continue
            if ok:
                results[rank] = payload
            else:
                failures.append((rank, payload))
                break
        if failures:
            rank, tb = failures[0]
            raise RuntimeError(f"run_world: rank {rank} failed:\n{tb}")
    finally:
        for p in procs:
            p.join(timeout=5 if not failures and len(results) == world_size else 0.1)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        out_q.close()
    return [results[r] for r in range(world_size)]
