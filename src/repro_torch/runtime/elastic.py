"""Elastic re-mesh planning: map a job onto a different device count.

Port of the reference ``runtime/elastic.py``. When nodes are lost (or
added) the job restarts on N' != N devices. The planner picks a new (data,
model) factorization -- preserving the model-axis width when possible so
tensor-parallel shards stay aligned -- and :func:`build_mesh` makes the
``DeviceMesh`` of the plan over the restarted process group. A sharded
checkpoint (``train/checkpoint.Sharded``) restores onto the new mesh, each
whole leaf cut to the new specs, and reports ``resharding_plan``; the
:class:`MeshSupervisor` runs the reference's checkpoint/restart loop with
it on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.runtime.fault_tolerance import TrainingSupervisor


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    def describe(self) -> str:
        return " x ".join(f"{a}={s}" for a, s in zip(self.axes, self.shape))


def plan_remesh(num_devices: int, prefer_model: int = 16,
                multi_pod_at: int = 512, pod_size: int = 256) -> MeshPlan:
    """Choose a mesh factorization for an elastic restart.

    Keeps the model axis at ``prefer_model`` when it divides the device
    count (TP shards unchanged -> no weight resharding traffic); otherwise
    falls back to the largest power-of-two divisor <= prefer_model.
    """
    if num_devices < 1:
        raise ValueError(f"plan_remesh: {num_devices} devices")
    if num_devices >= multi_pod_at and num_devices % pod_size == 0:
        pods = num_devices // pod_size
        inner = plan_remesh(pod_size, prefer_model, multi_pod_at=1 << 62)
        return MeshPlan((pods,) + inner.shape, ("pod",) + inner.axes)
    model = prefer_model
    while model > 1 and num_devices % model:
        model //= 2
    data = num_devices // model
    return MeshPlan((data, model), ("data", "model"))


def build_mesh(plan: MeshPlan, device_type: str = "cuda"):
    """The plan's ``DeviceMesh`` over the initialised process group (its
    world size must be the plan's size)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, plan.shape, mesh_dim_names=plan.axes)


def resharding_plan(old: MeshPlan, new: MeshPlan) -> dict:
    """Human/log-facing summary of what an elastic transition moves."""
    old_model = old.shape[old.axes.index("model")] if "model" in old.axes else 1
    new_model = new.shape[new.axes.index("model")] if "model" in new.axes else 1
    return {
        "model_axis_preserved": old_model == new_model,
        "tp_reshard_required": old_model != new_model,
        "old": old.describe(),
        "new": new.describe(),
    }


class MeshSupervisor(TrainingSupervisor):
    """``TrainingSupervisor``'s loop (checkpoints every ``save_every``
    steps; on a ``RuntimeError`` the latest checkpoint restored and the
    steps replayed) over a ``train.checkpoint.Sharded`` ``checkpointer``:
    every rank of the mesh runs it, and each save, latest-step lookup and
    restore is a collective (rank 0 writes; every rank restores its
    shards). A failure must reach every rank, as an injected one does.
    The loop is the supervisor's own, repeated here because
    ``runtime/fault_tolerance.py`` is a verbatim copy of the reference's
    (``tests/test_torch_isolation.py`` guards it), whose loop calls the
    checkpoint module by name."""

    def __init__(self, ckpt_dir: str, checkpointer, save_every: int = 50,
                 async_save: bool = True):
        super().__init__(ckpt_dir, save_every, async_save)
        self.ckpt = checkpointer

    def run(self, step_fn, state, start_step: int, num_steps: int,
            fail_at=None, on_restore=None) -> tuple:
        step, restarts = start_step, 0
        while step < num_steps:
            try:
                if fail_at is not None and fail_at(step):
                    raise RuntimeError(f"injected failure at step {step}")
                state = step_fn(state, step)
                step += 1
                if step % self.save_every == 0:
                    self.wait()
                    self._pending = self.ckpt.save(
                        self.ckpt_dir, step, state,
                        async_save=self.async_save)
            except RuntimeError:
                restarts += 1
                self.wait()
                last: Optional[int] = self.ckpt.latest_step(self.ckpt_dir)
                if last is None:
                    step = start_step
                    if on_restore is not None:
                        state = on_restore(None, start_step)
                    continue
                state = self.ckpt.restore(self.ckpt_dir, last, state)
                if on_restore is not None:
                    state = on_restore(state, last)
                step = last
        self.wait()
        return state, step, restarts
