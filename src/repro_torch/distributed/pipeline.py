"""Pipeline parallelism: the collective-permute pipeline (port of
``repro.distributed.pipeline``).

Stage-stacked parameters (leaves ``[n_stages, ...]``) are cut over a
``stage`` mesh axis, one stage a rank.  One loop over clocks advances every
stage at once: stage 0 takes the next micro-batch, every stage runs
``stage_fn`` on what it holds, and ``ppermute`` moves the outputs one stage
on.  Autograd through the loop is the backward pipeline: each ppermute's
backward sends the cotangents one stage back.  The order in which
micro-batches enter is the planner's template (data, not code).

``pipeline_reference`` runs the same clock loop on one rank, the stages a
loop over the stacked parameters; ``pipeline_ranks`` is the counterpart of
JAX's ``pipeline_shard_map``; ``pipeline_loss`` dispatches as JAX's does.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.distributed import collectives


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _clock_loop(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], stage_params: Any,
                microbatches: torch.Tensor, n_stages: int,
                shift: Callable[[torch.Tensor], torch.Tensor],
                select_stage: Callable[[Any, int], Any],
                my_stage: Optional[int] = None) -> torch.Tensor:
    """``n_micro + n_stages - 1`` clocks.  With ``my_stage`` (one rank a
    stage) the state is this stage's ``[1, ...]``; without it, all stages'
    ``[n_stages, ...]``.  The last stage's output at clock ``t`` is
    micro-batch ``t - (n_stages - 1)``'s result."""
    n_micro = microbatches.shape[0]
    mb_shape = tuple(microbatches.shape[1:])
    rows = 1 if my_stage is not None else n_stages
    state = microbatches.new_zeros((rows,) + mb_shape)
    clocks = n_micro + n_stages - 1
    outputs = []
    for t in range(clocks):
        mb = microbatches[min(t, n_micro - 1)]
        inject = t < n_micro
        if my_stage is not None:
            # every rank's graph reads the micro-batch and keeps its outputs
            # (weighted 0 where JAX selects the other operand), so that each
            # rank's backward runs every collective of the loop, in one order
            take = 1.0 if (my_stage == 0 and inject) else 0.0
            cur = mb[None] * take + state * (1.0 - take)
            y = stage_fn(select_stage(stage_params, 0), cur[0])[None]
            if t >= n_stages - 1:
                outputs.append(y[0] * (1.0 if my_stage == n_stages - 1 else 0.0))
        else:
            cur = torch.cat([mb[None], state[1:]]) if inject else state
            y = torch.stack([stage_fn(select_stage(stage_params, i), cur[i])
                             for i in range(n_stages)])
            if t >= n_stages - 1:
                outputs.append(y[-1])
        if t < clocks - 1:  # the last clock's shift feeds nothing
            state = shift(y)
    return torch.stack(outputs)


def pipeline_reference(stage_fn, stage_params: Any, microbatches: torch.Tensor,
                       n_stages: int) -> torch.Tensor:
    """One rank, the clock loop exact: every stage a slice of the stacked
    params; returns the outputs [n_micro, ...]."""

    def shift(y):
        return torch.cat([torch.zeros_like(y[:1]), y[:-1]])

    return _clock_loop(stage_fn, stage_params, microbatches, n_stages, shift,
                       select_stage=lambda p, i: _tree_map(lambda a: a[i], p))


def pipeline_ranks(stage_fn, stage_params_local: Any, microbatches: torch.Tensor, mesh=None,
                   stage_axis: str = "stage") -> torch.Tensor:
    """The pipeline over ``stage_axis``, one stage a rank: this rank holds
    its stage's params ``[1, ...]`` (``local_block`` of the stacked tree)
    and every rank the micro-batches.  ``ppermute`` moves each clock's
    outputs to the next stage; the last stage's outputs are summed over the
    axis with ``psum`` (the others contribute zeros), so every rank returns
    them.  The micro-batches enter through ``fan_out``: stage 0 alone reads
    them, and their gradient reaches every rank whole.  Each rank's autograd
    graph holds the whole loop (the operands JAX's ``where`` drops are
    weighted 0 here), so every rank's backward runs each ppermute's and the
    fan-out's collective, in reverse clock order.  A ``stage_fn`` output
    that is not finite on a rank where JAX would drop it turns the sum NaN
    (0 * inf); the stages here are finite."""
    mesh = collectives._mesh(mesh)
    n_stages = mesh.shape[stage_axis]
    my_stage = mesh.coord(stage_axis)
    microbatches = collectives.fan_out(microbatches, stage_axis, mesh)
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]

    def shift(y):
        return collectives.ppermute(y, stage_axis, perm, mesh)

    outs = _clock_loop(stage_fn, stage_params_local, microbatches, n_stages, shift,
                       select_stage=lambda p, i: _tree_map(lambda a: a[i], p),
                       my_stage=my_stage)
    return collectives.psum(outs, stage_axis, mesh)  # the last stage's, zeros elsewhere


def pipeline_loss(stage_fn, loss_fn: Callable[[torch.Tensor], torch.Tensor], stage_params: Any,
                  microbatches: torch.Tensor, n_stages: int, mesh=None,
                  stage_axis: str = "stage") -> torch.Tensor:
    """The pipelined loss (autograd through it is the backward pipeline):
    over ranks when ``mesh`` has a ``stage_axis`` longer than 1 (then
    ``stage_params`` is this rank's block), else on one rank."""
    if mesh is not None and stage_axis in mesh.axis_names and mesh.shape[stage_axis] > 1:
        outs = pipeline_ranks(stage_fn, stage_params, microbatches, mesh, stage_axis)
    else:
        outs = pipeline_reference(stage_fn, stage_params, microbatches, n_stages)
    return loss_fn(outs)
