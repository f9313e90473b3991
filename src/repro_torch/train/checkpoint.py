"""Checkpoints in the JAX package's format (port of the reference
``train/checkpoint.py``): per-leaf .npy files and a MessagePack manifest.

Layout (one directory per step)::

    ckpt_dir/step_000123/
        manifest.msgpack        # leaf paths, shapes, dtypes, step, extra
        leaf_00000.npy ...      # one file per leaf

Leaves are taken in JAX's flattening order and named by JAX's key paths
(``train/tree.py``), and bf16 (and fp8) leaves are stored as a byte view
(``uint16``/``uint8``) with the dtype's name in the manifest, as the
reference stores them, so a checkpoint written by either package restores
in the other. Saves are atomic (written to ``.tmp``, then renamed) and
optionally asynchronous. Every leaf is copied to the host **before** the
writer thread starts: the port's optimizer updates parameters and moments
in place, so a thread that read the tensors later would write a state torn
between two steps (the reference's arrays are immutable, so it can defer
the read). Restore builds fresh tensors with the dtype and device of each
leaf of ``like``.

:class:`Sharded` saves and restores a tree whose leaves are this rank's
shards on a mesh (sharded training): the ranks gather one whole leaf at a
time, rank 0 copies it to the host and writes it in the same format (so
the JAX package, or a run on any other mesh, reads it), and a restore
slices each whole leaf to the specs of the mesh it restores on. It has
the module's ``save``/``restore``/``latest_step``, which
``runtime/elastic.MeshSupervisor`` calls on every rank.
"""
from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Optional

import msgpack
import numpy as np
import torch

from repro_torch.train import tree as T

_NP_UNSUPPORTED = ("bfloat16", "float8_e4m3fn", "float8_e5m2")


def _to_storable(x):
    """A host copy of ``x`` as a numpy array numpy can save, and the name
    of ``x``'s dtype."""
    t = torch.as_tensor(x).detach().to("cpu", copy=True)
    name = str(t.dtype).removeprefix("torch.")
    if name in _NP_UNSUPPORTED:
        wide = t.element_size() == 2
        arr = t.view(torch.int16 if wide else torch.uint8).numpy()
        return (arr.view(np.uint16) if wide else arr), name
    return t.numpy(), name


def _from_stored(x: np.ndarray, name: str) -> torch.Tensor:
    if name in _NP_UNSUPPORTED:
        wide = x.dtype.itemsize == 2
        return torch.from_numpy(x.view(np.int16 if wide else np.uint8)).view(
            getattr(torch, name))
    return torch.from_numpy(x)


def _write(ckpt_dir: str, step: int, paths, storable,
           extra: Optional[dict]) -> None:
    """Writes the leaves of ``storable`` (an iterable of ``_to_storable``'s
    pairs, taken one at a time) and then the manifest."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    shapes, dtypes = [], []
    for i, (x, name) in enumerate(storable):
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), x)
        shapes.append(list(x.shape))
        dtypes.append(name)
    manifest = {"step": step, "paths": paths, "shapes": shapes,
                "dtypes": dtypes, "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
        f.write(msgpack.packb(manifest))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


def _save_storable(ckpt_dir, step, paths, storable, extra, async_save
                   ) -> Optional[threading.Thread]:
    if async_save:
        storable = list(storable)                   # before the thread
        t = threading.Thread(target=_write, daemon=True,
                             args=(ckpt_dir, step, paths, storable, extra))
        t.start()
        return t
    _write(ckpt_dir, step, paths, storable, extra)
    return None


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[dict] = None,
         async_save: bool = False) -> Optional[threading.Thread]:
    """Serialize a tree of tensors. Returns the writer thread when async."""
    flat = list(T.leaves_with_paths(tree))
    return _save_storable(ckpt_dir, step, [p for p, _ in flat],
                          [_to_storable(x) for _, x in flat], extra,
                          async_save)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: Any) -> Any:
    """A tree of ``like``'s structure read from the checkpoint of ``step``:
    each leaf a fresh tensor with the dtype and device of ``like``'s.
    Raises ``ValueError`` where the leaf count or a leaf's shape differs
    from ``like``'s (a checkpoint of another model or configuration)."""
    manifest = manifest_of(ckpt_dir, step)
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    leaves_like = T.leaves(like)
    if len(leaves_like) != len(manifest["paths"]):
        raise ValueError(f"checkpoint has {len(manifest['paths'])} leaves, "
                         f"expected {len(leaves_like)}")
    for path, shape, ref in zip(manifest["paths"], manifest["shapes"],
                                leaves_like):
        if list(shape) != list(ref.shape):
            raise ValueError(f"checkpoint leaf {path} has shape "
                             f"{tuple(shape)}, expected {tuple(ref.shape)}")
    out = []
    for i, ref in enumerate(leaves_like):
        x = _from_stored(np.load(os.path.join(d, f"leaf_{i:05d}.npy")),
                         manifest["dtypes"][i])
        out.append(x.to(device=ref.device, dtype=ref.dtype))
    return T.unflatten(like, out)


def manifest_of(ckpt_dir: str, step: int) -> dict:
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.msgpack"), "rb") as f:
        return msgpack.unpackb(f.read())


class Sharded:
    """Checkpoints of a tree of shards: ``specs`` its specs (the
    ``launch/sharding`` rules' tree, of the same structure) on ``mesh`` (a
    ``DeviceMesh``). Every rank calls each method (they are collectives);
    the manifest's ``extra`` records the mesh, and a restore from another
    mesh leaves ``resharding_plan`` (``runtime/elastic.py``) in
    :attr:`plan`."""

    def __init__(self, specs: Any, mesh):
        self.specs, self.mesh = specs, mesh
        self.plan: Optional[dict] = None

    def _rank(self) -> int:
        import torch.distributed as dist
        return dist.get_rank()

    def save(self, ckpt_dir: str, step: int, tree: Any,
             extra: Optional[dict] = None, async_save: bool = False
             ) -> Optional[threading.Thread]:
        """Gathers ``tree`` one leaf at a time; rank 0 copies each whole
        leaf to the host and writes it (all of them before its writer
        thread starts when async, a thread only rank 0 has to join)."""
        from repro_torch.launch.sharding import gather_leaf
        root = self._rank() == 0
        flat = list(T.leaves_with_paths(tree))
        specs = T.flatten_up_to(tree, self.specs)

        def whole_leaves():
            for (_, x), spec in zip(flat, specs):
                full = gather_leaf(x, spec, self.mesh)
                if root:
                    yield _to_storable(full)
                del full            # one whole leaf on the device at once

        if not root:
            for _ in whole_leaves():
                pass
            return None
        mesh = [list(self.mesh.shape), list(self.mesh.mesh_dim_names)]
        return _save_storable(ckpt_dir, step, [p for p, _ in flat],
                              whole_leaves(), dict(extra or {}, mesh=mesh),
                              async_save)

    def latest_step(self, ckpt_dir: str) -> Optional[int]:
        """Rank 0's latest step, on every rank."""
        import torch.distributed as dist
        got = [latest_step(ckpt_dir) if self._rank() == 0 else None]
        dist.broadcast_object_list(got, src=0)
        return got[0]

    def restore(self, ckpt_dir: str, step: int, like: Any) -> Any:
        """``like``'s structure from the whole leaves of ``step``, each cut
        to this rank's shard of the specs. Raises ``ValueError`` where the
        leaf count differs, or a whole leaf's shard is not ``like``'s
        shape."""
        from repro_torch.launch.sharding import local_shape, shard_leaf
        from repro_torch.runtime.elastic import MeshPlan, resharding_plan
        manifest = manifest_of(ckpt_dir, step)
        d = os.path.join(ckpt_dir, f"step_{step:08d}")
        leaves_like = T.leaves(like)
        specs = T.flatten_up_to(like, self.specs)
        if len(leaves_like) != len(manifest["paths"]):
            raise ValueError(f"checkpoint has {len(manifest['paths'])} "
                             f"leaves, expected {len(leaves_like)}")
        for path, shape, ref, spec in zip(manifest["paths"],
                                          manifest["shapes"], leaves_like,
                                          specs):
            if local_shape(shape, spec, self.mesh) != tuple(ref.shape):
                raise ValueError(f"checkpoint leaf {path} of shape "
                                 f"{tuple(shape)} has no shard of shape "
                                 f"{tuple(ref.shape)} here")
        out = []
        for i, (ref, spec) in enumerate(zip(leaves_like, specs)):
            x = _from_stored(np.load(os.path.join(d, f"leaf_{i:05d}.npy")),
                             manifest["dtypes"][i])
            out.append(shard_leaf(x, spec, self.mesh).to(device=ref.device,
                                                         dtype=ref.dtype))
        old = manifest.get("extra", {}).get("mesh") or [[1, 1],
                                                         ["data", "model"]]
        self.plan = resharding_plan(
            MeshPlan(tuple(old[0]), tuple(old[1])),
            MeshPlan(tuple(self.mesh.shape), tuple(self.mesh.mesh_dim_names)))
        return T.unflatten(like, out)
