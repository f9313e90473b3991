"""Roofline terms of a traced cell (port of the reference
``analysis/roofline.py``), on the NVIDIA H100 80GB HBM3's published
figures.

Per (arch x shape x mesh) cell, from rank 0's program:

    compute term    = flops / peak_FLOP/s
    memory term     = bytes / HBM_bw
    collective term = collective_bytes / link_bw

The reference reads these from XLA: ``cost_analysis()`` of the compiled
per-device program, and the collectives parsed from its HLO text (loop
bodies multiplied by their trip counts). PyTorch has no compiled program,
so the port counts what rank 0's program does when it is traced
(:func:`trace`: every op dispatched on tensors that hold no data, under
``torch.utils.flop_counter.FlopCounterMode`` and a ``TorchDispatchMode``):

* flops: ``FlopCounterMode``'s count of the matrix products and
  convolutions, plus the kernels' ``cost`` (``kernels/cost.py``: the
  attention kernels and the two scans, which the flop counter cannot see);
* bytes: each operand and result of every op that is not a view, a
  factory or a collective, plus the kernels' ``cost``;
* collective bytes and ops by kind, from the ``c10d`` ops the dispatch
  sees: the bytes of each one's result (all-reduce: the reduced tensors;
  all-gather: the gathered ones; reduce-scatter: the scattered block;
  all-to-all: the received blocks), as the reference counts each HLO
  collective's result shape;
* memory: the peak of the live storages (the inputs, then each op's new
  results until their storage is freed).

The layer loop runs in Python, so every repetition is traced and counted:
the reference's ``unroll_layers`` and its HLO parsers (``_split_computations``,
``_trip_count`` and the text form of ``collective_bytes``) have no
counterpart. The constants are the H100 SXM5's spec-sheet figures, not
measurements: 989e12 bf16 dense FLOP/s, 3.35e12 B/s of HBM3 and 450e9 B/s
of NVLink a direction (the reference's are TPU v5e's 197e12, 819e9 and
50e9).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# NVIDIA H100 80GB HBM3 (SXM5) spec-sheet figures, per card.
PEAK_FLOPS = 989e12      # bf16 dense
HBM_BW = 3.35e12         # bytes/s
LINK_BW = 450e9          # bytes/s, NVLink 4, one direction

_COLLECTIVES = {         # c10d op -> the reference's HLO kind
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "collective-permute",
}


# ops that read and write no element: allocations and aliases (and the
# "prim" namespace's metadata queries, such as a tensor's device)
_MOVES_NOTHING = {"empty", "empty_strided", "empty_like", "new_empty",
                  "new_empty_strided", "detach", "alias", "lift_fresh",
                  "_local_scalar_dense"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if torch.is_tensor(t) else 0


@dataclasses.dataclass
class CollectiveStats:
    total_bytes: float
    by_kind: Dict[str, float]
    num_ops: int


@dataclasses.dataclass
class TraceCounts:
    """What one traced call did on this rank (:func:`trace`)."""

    flops: float
    bytes: float
    collectives: CollectiveStats
    peak_bytes: float              # live storages at their most
    kernel_calls: Dict[str, int]


class _Counting(TorchDispatchMode):
    """Bytes of every non-view op, the collectives, and the live storages
    (each new result's storage until it is freed)."""

    def __init__(self, live: int):
        super().__init__()
        self.bytes = 0
        self.coll: Dict[str, float] = {}
        self.n_coll = 0
        self.live = self.peak = live
        self._seen = set()

    def _track(self, out):
        for t in tree_leaves(out):
            if not torch.is_tensor(t):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            self._seen.add(key)
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)

    def _free(self, key, n):
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns == "c10d":
            if not name.startswith(("barrier", "monitored_barrier")):
                kind = _COLLECTIVES.get(name, name)
                b = sum(_nbytes(t) for t in tree_leaves(args[0]))
                self.coll[kind] = self.coll.get(kind, 0.0) + b
                self.n_coll += 1
            return out
        if func.is_view or ns == "prim" or name in _MOVES_NOTHING:
            self._track(out)
            return out
        self.bytes += sum(_nbytes(t) for t in tree_leaves((args, kwargs)))
        self.bytes += sum(_nbytes(t) for t in tree_leaves(out))
        self._track(out)
        return out


def trace(fn, *inputs) -> TraceCounts:
    """``fn(*inputs)`` once, on fake tensors (they hold no data),
    counted: flops, bytes, collectives and the peak of live storage on
    this rank (the inputs' storages count from the start)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import cost as C
    storages = {}
    for t in tree_leaves(inputs):
        if torch.is_tensor(t):
            st = t.untyped_storage()
            storages[st._cdata] = st.nbytes()
    mode = _Counting(sum(storages.values()))
    mode._seen.update(storages)
    with C.counting() as kernels, FlopCounterMode(display=False) as fc, \
            mode:
        out = fn(*inputs)
    del out
    return TraceCounts(
        flops=float(fc.get_total_flops()) + kernels.flops,
        bytes=float(mode.bytes) + kernels.bytes,
        collectives=CollectiveStats(float(sum(mode.coll.values())),
                                    dict(mode.coll), mode.n_coll),
        peak_bytes=float(mode.peak), kernel_calls=dict(kernels.calls))


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float            # 6*N*D (or 6*N_active*D) global
    useful_ratio: float           # MODEL_FLOPS / (traced flops * devices)
    peak_fraction: float          # model-flops utilization at the bound
    memory_per_device_gb: float
    notes: str = ""

    def row(self) -> str:
        return (f"{self.arch},{self.shape},{self.mesh},"
                f"{self.flops_per_device:.3e},{self.bytes_per_device:.3e},"
                f"{self.collective_bytes_per_device:.3e},"
                f"{self.t_compute * 1e3:.3f},{self.t_memory * 1e3:.3f},"
                f"{self.t_collective * 1e3:.3f},{self.bottleneck},"
                f"{self.useful_ratio:.3f},{self.peak_fraction:.3f},"
                f"{self.memory_per_device_gb:.2f}")


def analyze(arch: str, shape_name: str, mesh_name: str, *,
            counts: TraceCounts, num_devices: int, model_flops: float,
            memory_bytes_per_device: float,
            notes: str = "") -> RooflineReport:
    """The reference's ``analyze`` over a traced cell's per-device counts
    (rank 0's program is the per-device program)."""
    flops, byts = counts.flops, counts.bytes
    coll = counts.collectives.total_bytes
    t_comp = flops / PEAK_FLOPS
    t_mem = byts / HBM_BW
    t_coll = coll / LINK_BW
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    bottleneck = max(terms, key=terms.get)
    total_flops = flops * num_devices
    useful = model_flops / total_flops if total_flops else 0.0
    t_bound = max(terms.values())
    ideal = model_flops / (num_devices * PEAK_FLOPS)
    peak_fraction = ideal / t_bound if t_bound > 0 else 0.0
    return RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_name,
        flops_per_device=flops, bytes_per_device=byts,
        collective_bytes_per_device=coll,
        t_compute=t_comp, t_memory=t_mem, t_collective=t_coll,
        bottleneck=bottleneck, model_flops=model_flops,
        useful_ratio=useful, peak_fraction=peak_fraction,
        memory_per_device_gb=memory_bytes_per_device / 1e9, notes=notes)


def analytic_memory_bytes(cell_inputs, cfg, shape, n_dp: int,
                          accum: int = 1) -> dict:
    """Exact per-device bytes of every input (parameters, optimizer state,
    cache, batch: the cell's inputs are this rank's shards already, each
    leaf at ``launch/sharding.local_shape``; a Python integer, such as a
    decode step's position, counts as the reference's int32 scalar) + the
    reference's activation/workspace estimate: saved layer inputs
    (remat-full) for one microbatch + a working set of ~6 layer tensors."""
    args = 0
    for leaf in tree_leaves(cell_inputs):
        if torch.is_tensor(leaf):
            args += max(leaf.numel(), 1) * leaf.element_size()
        elif isinstance(leaf, int):
            args += 4

    d = cfg.d_model
    layers = cfg.num_layers + (cfg.num_encoder_layers if cfg.enc_dec else 0)
    b_loc = max(shape.global_batch // n_dp, 1)
    if shape.kind == "train":
        b_micro = max(b_loc // accum, 1)
        saved = layers * b_micro * shape.seq_len * d * 2          # bf16 carries
        work = 8 * b_micro * shape.seq_len * d * 4                # bwd tensors
        ce = 2 * b_micro * (shape.seq_len // 16) * cfg.vocab_size * 4
        act = saved + work + ce
    elif shape.kind == "prefill":
        act = 6 * b_loc * shape.seq_len * d * 4
    else:
        act = 6 * b_loc * 1 * d * 4 + 2 * b_loc * cfg.vocab_size * 4
    return {"args_bytes": args, "activation_bytes": act,
            "total_bytes": args + act}


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N*D for training, 2*N*D forward-only; MoE uses active
    params. D = tokens processed by the step."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch * 1
    return 2.0 * n_active * tokens
