"""Fault tolerance for 1000+-node runs: heartbeats, checkpoint/restart,
straggler detection & mitigation.

Design (matching the scale posture in DESIGN.md §6):

* ``HeartbeatMonitor`` — per-worker liveness with a deadline; a missed
  heartbeat marks the worker dead and triggers the supervisor's restart path.
* ``StragglerDetector`` — per-step worker durations; a worker consistently
  slower than ``threshold`` x median over a window is *relegated* (the same
  relegation philosophy the paper's scheduler applies to SLO-expired
  requests: capacity is protected for the healthy majority).
* ``TrainingSupervisor`` — drives a step function with periodic async
  checkpoints; on failure, restores the latest checkpoint and replays. The
  harness is deliberately transport-agnostic (in this repo workers are
  simulated; on a real cluster the callbacks map to jax.distributed +
  coordinator liveness).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Optional

from repro_torch.train import checkpoint


@dataclasses.dataclass
class WorkerState:
    last_heartbeat: float
    alive: bool = True
    relegated: bool = False


class HeartbeatMonitor:
    def __init__(self, workers: List[str], timeout: float = 60.0):
        self.timeout = timeout
        now = time.monotonic()
        self.workers: Dict[str, WorkerState] = {
            w: WorkerState(last_heartbeat=now) for w in workers}

    def beat(self, worker: str, now: Optional[float] = None) -> None:
        self.workers[worker].last_heartbeat = now or time.monotonic()

    def check(self, now: Optional[float] = None) -> List[str]:
        """Returns newly-dead workers."""
        now = now or time.monotonic()
        dead = []
        for name, st in self.workers.items():
            if st.alive and now - st.last_heartbeat > self.timeout:
                st.alive = False
                dead.append(name)
        return dead

    def alive_count(self) -> int:
        return sum(1 for s in self.workers.values() if s.alive and not s.relegated)


class StragglerDetector:
    def __init__(self, workers: List[str], window: int = 20,
                 threshold: float = 1.5, min_samples: int = 5):
        self.window = window
        self.threshold = threshold
        self.min_samples = min_samples
        self.durations: Dict[str, collections.deque] = {
            w: collections.deque(maxlen=window) for w in workers}

    def record(self, worker: str, duration: float) -> None:
        self.durations[worker].append(duration)

    def stragglers(self) -> List[str]:
        means = {w: sum(d) / len(d) for w, d in self.durations.items()
                 if len(d) >= self.min_samples}
        if len(means) < 2:
            return []
        med = sorted(means.values())[len(means) // 2]
        return [w for w, m in means.items() if m > self.threshold * med]


class TrainingSupervisor:
    """Checkpoint/restart loop around an arbitrary step function."""

    def __init__(self, ckpt_dir: str, save_every: int = 50,
                 async_save: bool = True):
        self.ckpt_dir = ckpt_dir
        self.save_every = save_every
        self.async_save = async_save
        self._pending = None

    def run(self, step_fn: Callable, state, start_step: int, num_steps: int,
            fail_at: Optional[Callable[[int], bool]] = None,
            on_restore=None) -> tuple:
        """Runs steps with periodic checkpoints; simulated failures via
        ``fail_at(step)`` raise and exercise the restore path. Returns
        (state, completed_step, num_restarts)."""
        step = start_step
        restarts = 0
        while step < num_steps:
            try:
                if fail_at is not None and fail_at(step):
                    raise RuntimeError(f"injected failure at step {step}")
                state = step_fn(state, step)
                step += 1
                if step % self.save_every == 0:
                    self.wait()
                    self._pending = checkpoint.save(
                        self.ckpt_dir, step, state, async_save=self.async_save)
            except RuntimeError:
                restarts += 1
                self.wait()
                last = checkpoint.latest_step(self.ckpt_dir)
                if last is None:
                    step = start_step
                    if on_restore is not None:
                        state = on_restore(None, start_step)
                    continue
                state = checkpoint.restore(self.ckpt_dir, last, state)
                if on_restore is not None:
                    state = on_restore(state, last)
                step = last
        self.wait()
        return state, step, restarts

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
