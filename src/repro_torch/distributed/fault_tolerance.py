"""Crash-restart training (the ``TrainSupervisor`` of
``repro.distributed.fault_tolerance``; its health tracker and straggler
detector come with M11)."""
from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class TrainSupervisorReport:
    steps_run: int
    restarts: int
    restore_steps: List[int]


class TrainSupervisor:
    """``run_step(step)`` runs one training step and may raise; ``save(step)``
    and ``restore() -> step`` talk to the checkpoint manager.  A failure
    rolls back to the latest checkpoint and replays: the data are seeded per
    step, so a replay is bit for bit the run it replaces."""

    def __init__(self, run_step, save, restore, checkpoint_every=50, max_restarts=10):
        self.run_step, self.save, self.restore = run_step, save, restore
        self.checkpoint_every = checkpoint_every
        self.max_restarts = max_restarts

    def run(self, total_steps):
        restarts, restore_steps, steps_run = 0, [], 0
        step = self.restore()
        while step < total_steps:
            try:
                self.run_step(step)
                steps_run += 1
                step += 1
                if step % self.checkpoint_every == 0:
                    self.save(step)
            except Exception:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                step = self.restore()
                restore_steps.append(step)
        self.save(step)
        return TrainSupervisorReport(steps_run, restarts, restore_steps)
