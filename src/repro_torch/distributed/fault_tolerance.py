"""Fault tolerance and straggler detection (a port of
``repro.distributed.fault_tolerance``).

* :class:`HealthTracker`: heartbeats per worker; one silent for more than
  ``dead_after`` seconds is declared dead, and one heard from again rejoins
  with a new incarnation (which fences its stale writes).
* :class:`StragglerDetector`: each worker's step time as an EWMA against the
  fleet's median; a worker slower than ``threshold`` x the median is flagged.
* :class:`TrainSupervisor`: crash-restart training from the latest
  checkpoint, under a mesh too.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import List


@dataclasses.dataclass
class HeartbeatState:
    last_seen: float = 0.0
    alive: bool = True
    incarnation: int = 0  # bumps on every recovery


class HealthTracker:
    def __init__(self, n_workers, dead_after=2.0):
        self.dead_after = dead_after
        self.state = {i: HeartbeatState() for i in range(n_workers)}

    def heartbeat(self, wid, now):
        st = self.state[wid]
        if not st.alive:
            st.alive = True
            st.incarnation += 1
        st.last_seen = now

    def sweep(self, now):
        """The workers newly declared dead."""
        died = [w for w, st in self.state.items()
                if st.alive and now - st.last_seen > self.dead_after]
        for w in died:
            self.state[w].alive = False
        return died

    def alive(self):
        return [w for w, st in self.state.items() if st.alive]


class StragglerDetector:
    """Flags workers whose step time drifts above threshold x fleet median."""

    def __init__(self, n_workers, threshold=1.5, ema=0.8):
        self.threshold, self.ema = threshold, ema
        self.step_time = {i: 0.0 for i in range(n_workers)}

    def observe(self, wid, step_s):
        prev = self.step_time.get(wid, 0.0)
        self.step_time[wid] = step_s if prev == 0.0 else self.ema * prev + (1 - self.ema) * step_s

    def stragglers(self):
        vals = [v for v in self.step_time.values() if v > 0]
        if len(vals) < 2:
            return []
        med = statistics.median(vals)
        return [w for w, v in self.step_time.items() if v > 0 and v > self.threshold * med]


@dataclasses.dataclass
class TrainSupervisorReport:
    steps_run: int
    restarts: int
    restore_steps: List[int]


class TrainSupervisor:
    """``run_step(step)`` runs one training step and may raise; ``save(step)``
    and ``restore() -> step`` talk to the checkpoint manager.  A failure
    rolls back to the latest checkpoint and replays: the data are seeded per
    step, so a replay is bit for bit the run it replaces.  Under a mesh
    every rank runs the loop: ``save`` and ``restore`` are collective
    (``CheckpointManager`` with the train step's ``places``), a failure is
    raised on every rank at the same step, and the checkpoint restores onto
    any mesh (the reference's elastic restart onto a smaller pool)."""

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
