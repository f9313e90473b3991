"""Elastic re-mesh planning: map a job onto a different device count.

Port of the reference ``runtime/elastic.py``. When nodes are lost (or
added) the job restarts on N' != N devices. The planner picks a new (data,
model) factorization -- preserving the model-axis width when possible so
tensor-parallel shards stay aligned -- and :func:`build_mesh` makes the
``DeviceMesh`` of the plan over the restarted process group. Restoring a
checkpoint onto the new mesh comes with sharded training.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


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
