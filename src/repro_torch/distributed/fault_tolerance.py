"""Restart supervision (port of the ``TrainSupervisor`` part of
``repro.distributed.fault_tolerance``).

``TrainSupervisor`` wraps a step loop: periodic asynchronous checkpoints
through :class:`CheckpointStore`, and on a failure a restart from the
latest committed checkpoint (``resume()``), up to ``max_restarts`` times.
Tests inject failures through ``failure_hook``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

from repro_torch.distributed.checkpoint import CheckpointStore, latest_step, restore_checkpoint


@dataclass
class SupervisorConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    max_restarts: int = 3


class TrainSupervisor:
    """Checkpoint/restart harness around a step function.

    ``step_fn(state, step_idx) -> state`` must be pure in ``state``.
    ``failure_hook(step_idx)`` may raise :func:`simulated_failure` to
    simulate a node failure."""

    def __init__(self, cfg: SupervisorConfig,
                 failure_hook: Optional[Callable[[int], None]] = None):
        self.cfg = cfg
        self.ckpt = CheckpointStore(cfg.ckpt_dir, keep=cfg.keep)
        self.failure_hook = failure_hook
        self.restarts = 0

    def resume(self, init_state: Any, shardings: Any = None) -> Tuple[Any, int]:
        step = latest_step(self.cfg.ckpt_dir)
        if step is None:
            return init_state, 0
        state, extra = restore_checkpoint(self.cfg.ckpt_dir, step, init_state, shardings)
        return state, int(extra.get("next_step", step + 1))

    def run(self, init_state: Any, step_fn: Callable[[Any, int], Any], n_steps: int,
            shardings: Any = None) -> Any:
        state, start = self.resume(init_state, shardings)
        i = start
        while i < n_steps:
            try:
                if self.failure_hook is not None:
                    self.failure_hook(i)
                state = step_fn(state, i)
                i += 1
                if i % self.cfg.ckpt_every == 0 or i == n_steps:
                    self.ckpt.save_async(i, state, extra={"next_step": i})
            except _SimulatedFailure:
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise
                self.ckpt.wait()
                state, i = self.resume(init_state, shardings)
        self.ckpt.wait()
        return state


class _SimulatedFailure(RuntimeError):
    pass


def simulated_failure() -> BaseException:
    return _SimulatedFailure("injected node failure")
