"""The kernels' work counts, and their branch for tensors that hold no data.

Each kernel module has a ``cost(...)`` of the work its TPU kernel does on
given operands, whatever implements it: the floating-point operations
(``flops``, with the dtype whose peak rate bounds them) and the HBM bytes
that the function must move (each input read once, each output written
once). ``chip_smoke.py`` computes its bound rows from these, and the dry
run (``launch/dryrun.py``) adds them to its traced counts. Where the work
depends on the data (lengths, offsets), ``cost`` takes the data; without
it, each row counts its whole key range.

A wrapper given a ``FakeTensor`` (a traced program, such as the dry
run's under a ``FakeTensorMode``: nothing to compute) returns empty
outputs of the kernel's shapes and dtypes and adds its ``cost`` to every
active :func:`counting` block. This is not a fallback: a CUDA tensor
still launches the kernel or raises, a CPU tensor still runs the plain
version, and a tensor on any other device (``meta`` among them) raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List

import torch


@dataclasses.dataclass
class Work:
    """One call's work: ``flops`` at the peak rate of ``dtype`` (its name,
    "bfloat16" or "float32"), and ``bytes`` of HBM traffic."""

    flops: float
    bytes: float
    dtype: str


@dataclasses.dataclass
class Counter:
    """The summed work of the kernel calls of a :func:`counting` block,
    and the calls by kernel name."""

    flops: float = 0.0
    bytes: float = 0.0
    calls: Dict[str, int] = dataclasses.field(default_factory=dict)

    def add(self, kernel: str, work: Work) -> None:
        self.flops += work.flops
        self.bytes += work.bytes
        self.calls[kernel] = self.calls.get(kernel, 0) + 1


_ACTIVE: List[Counter] = []


@contextlib.contextmanager
def counting():
    """A :class:`Counter` of the fake kernel calls made inside the block."""
    c = Counter()
    _ACTIVE.append(c)
    try:
        yield c
    finally:
        _ACTIVE.remove(c)


def is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a ``FakeTensor`` (it holds no data). A tensor on
    the ``meta`` device is not: a wrapper still refuses that device."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def record(kernel: str, work: Work) -> None:
    """Add one call of ``kernel`` to every active counter."""
    for c in _ACTIVE:
        c.add(kernel, work)


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]
