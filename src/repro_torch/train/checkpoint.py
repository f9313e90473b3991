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


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[dict] = None,
         async_save: bool = False) -> Optional[threading.Thread]:
    """Serialize a tree of tensors. Returns the writer thread when async."""
    flat = list(T.leaves_with_paths(tree))
    paths = [p for p, _ in flat]
    storable = [_to_storable(x) for _, x in flat]     # before any thread

    def _write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        manifest = {
            "step": step,
            "paths": paths,
            "shapes": [list(x.shape) for x, _ in storable],
            "dtypes": [d for _, d in storable],
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
            f.write(msgpack.packb(manifest))
        for i, (x, _) in enumerate(storable):
            np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), x)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if async_save:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


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
