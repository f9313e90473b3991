"""Meshes of the port: process-group start-up, the serving mesh and the
production mesh, on ``torch.distributed``.

Port of the reference ``launch/mesh.py``. The reference is one process
driving every device; PyTorch runs one process a rank, so a mesh here is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of an
initialised process group, and :func:`init_distributed` starts that group
(from ``torchrun``'s variables, or from a ``file://`` store that tests
pass). Functions, not module-level state: importing this module touches no
process group and no device.

* :func:`make_serving_mesh` -- the sharded serving executor's mesh
  (``--mesh`` / ``REPRO_FORCE_MESH``; see ``serving/engine.py``).
* :func:`make_production_mesh` -- the training launch mesh (pod x data x
  model); :func:`make_train_mesh` resolves the training launcher's
  ``--mesh`` / ``REPRO_FORCE_MESH`` / ``--multi-pod`` to it.

Meshes are named right-aligned against ``("pod", "data", "model")``:
``"4"`` is ``("model",)``, ``"2x4"`` is ``("data", "model")``. The rule
functions of ``launch/sharding.py`` also take a :class:`MeshShape`, a mesh
described by its sizes alone (no ranks needed).
"""
from __future__ import annotations

import dataclasses
import math
import os
from datetime import timedelta
from typing import Dict, Optional, Tuple

import torch

_AXIS_NAMES = ("pod", "data", "model")


def parse_mesh_spec(spec: str) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """``"2x4"`` -> ((2, 4), ("data", "model")); 1-3 ``x``-separated dims,
    named right-aligned against (pod, data, model)."""
    try:
        dims = tuple(int(x) for x in spec.split("x"))
    except ValueError:
        raise ValueError(f"bad mesh spec {spec!r} (want e.g. '2x4')")
    if not 1 <= len(dims) <= 3 or any(d < 1 for d in dims):
        raise ValueError(f"bad mesh spec {spec!r} (want 1-3 positive dims)")
    return dims, _AXIS_NAMES[-len(dims):]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh described by its axis sizes alone (``launch/sharding.py``'s
    rules need nothing else), e.g. ``MeshShape((2, 4), ("data", "model"))``.
    Its two fields are the ``DeviceMesh`` attributes of the same names, so
    every reader of a mesh's sizes takes either."""

    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a :class:`MeshShape`."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axes(mesh) -> tuple:
    """The data-parallel axis names of a mesh (('pod','data') or ('data',))."""
    return tuple(a for a in axis_sizes(mesh) if a in ("pod", "data"))


def dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    out = 1
    for a in dp_axes(mesh):
        out *= sizes[a]
    return out


# ---- process group ------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DistInfo:
    """This process's place in the group: its rank, the world size and its
    device (:func:`data_backend` names the backends the group carries)."""

    rank: int
    world_size: int
    device: torch.device


def data_backend_for(device: torch.device, local_world: int) -> str:
    """The data plane's backend: NCCL when every rank of the host has a card
    of its own, gloo on the CPU or when ranks share a card (NCCL refuses two
    ranks on one device). Chosen here from what the host has, never by
    trying one and catching its failure."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def data_backend(device_type: str) -> str:
    """The backend that carries ``device_type``'s tensors ("cpu": the
    serving mesh's control plane; the device's: its data plane) in the
    initialised default group, as :func:`init_distributed` chose it: "gloo"
    or "nccl". The mesh's axis groups inherit it."""
    import torch.distributed as dist
    name = str(dist.get_backend())
    if ":" not in name:
        return name
    return dict(p.split(":") for p in name.split(","))[device_type]


def init_distributed(device=None, *, init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout_s: float = 1800.0) -> DistInfo:
    """Initialise the default process group and return this rank's
    :class:`DistInfo`.

    Without arguments the rank, world size and rendezvous come from
    ``torchrun``'s variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT``); tests pass ``init_method=
    "file://<dir>/store"`` with ``rank`` and ``world_size``. ``device``
    ``None`` or ``"cuda"`` means the card ``cuda:{LOCAL_RANK %
    device_count}`` and raises without one; ``"cpu"`` keeps the rank on the
    CPU. The default group carries gloo for CPU tensors (the control plane)
    and :func:`data_backend_for`'s backend for the device's tensors."""
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError("init_distributed: the process group is already "
                           "initialised")
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                  else int(world_size))
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device is "
                               "available; pass device='cpu' explicitly")
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    data = data_backend_for(device, local_world)
    backend = "gloo" if data == "gloo" else f"cpu:gloo,cuda:{data}"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size,
                            timeout=timedelta(seconds=timeout_s))
    return DistInfo(rank, world_size, device)


# ---- meshes ---------------------------------------------------------------------
def _device_mesh(dims, axes, device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised process group "
                           "(init_distributed)")
    world = dist.get_world_size()
    if math.prod(dims) != world:
        raise ValueError(f"mesh {'x'.join(map(str, dims))} holds "
                         f"{math.prod(dims)} ranks, the world {world}")
    return init_device_mesh(device_type, tuple(dims), mesh_dim_names=axes)


def _device_type() -> str:
    """``"cuda"`` when the data plane is NCCL (a card a rank, so the mesh
    may bind rank ``LOCAL_RANK`` to card ``LOCAL_RANK``), else ``"cpu"``:
    ranks sharing one card over gloo must not be bound to cards of their
    own. The ops take their groups from the mesh either way; its device
    type matters to ``DTensor`` only."""
    return "cuda" if data_backend("cuda") == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks when ``multi_pod``.

    ``REPRO_FORCE_MESH`` (e.g. "4x8" / "2x2x8") overrides the shape, as in
    the reference. The world size must equal the mesh's size."""
    forced = os.environ.get("REPRO_FORCE_MESH")
    if forced:
        dims, axes = parse_mesh_spec(forced)
    else:
        dims = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(dims, axes, device_type or _device_type())


def make_train_mesh(spec: Optional[str] = None, *, multi_pod: bool = False,
                    device_type: Optional[str] = None):
    """The training launcher's mesh, or ``None`` for one device (the
    default): ``spec`` (``--mesh``, else ``REPRO_FORCE_MESH``, resolved as
    serving resolves it) gives its shape, named right-aligned against
    (pod, data, model); ``multi_pod`` without a spec is the production
    mesh of two pods. The world size must equal the mesh's size."""
    spec = serving_mesh_spec(spec)
    if spec:
        dims, axes = parse_mesh_spec(spec)
        return _device_mesh(dims, axes, device_type or _device_type())
    if multi_pod:
        return make_production_mesh(multi_pod=True, device_type=device_type)
    return None


def serving_mesh_spec(cli_value: Optional[str] = None) -> Optional[str]:
    """Uniform mesh-override resolution shared by every serving entrypoint:
    an explicit ``--mesh`` value wins, else ``REPRO_FORCE_MESH``, else None
    (single-device engine)."""
    return cli_value or os.environ.get("REPRO_FORCE_MESH") or None


def make_serving_mesh(spec: Optional[str] = None,
                      device_type: Optional[str] = None):
    """Mesh of the sharded paged serving executor, or ``None`` for the
    single-device engine (the default, and the bit-identity baseline).

    ``spec`` like ``"2x4"`` (data x model): ``model`` is the KV/attention
    shard axis; ``data``/``pod`` axes replicate (each of their rows of the
    mesh runs the same dispatches). The product of the dims must be the
    world size, else this raises. A spec of size 1 still builds a real mesh
    over a world of one: it drives the whole sharded code path on one
    device, bit-identical by construction. ``device_type`` defaults to
    :func:`_device_type`'s."""
    spec = serving_mesh_spec(spec)
    if not spec:
        return None
    dims, axes = parse_mesh_spec(spec)
    return _device_mesh(dims, axes, device_type or _device_type())


def add_mesh_argument(ap) -> None:
    """Attach the shared ``--mesh`` flag (serving entrypoints)."""
    ap.add_argument("--mesh", default=None,
                    help="serving mesh shape, e.g. 2x4 (data x model), over "
                         "the ranks of torchrun; defaults to "
                         "$REPRO_FORCE_MESH, else single-device")
