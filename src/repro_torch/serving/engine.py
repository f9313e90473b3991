"""Serving engine: SlidingServe driving the PyTorch model on the GPU.

Port of the reference ``serving/engine.py``, in two cache modes.

* **paged** (pure-attention decoders; the default). KV lives in
physical pages handed out by :class:`BlockAllocator`, the single admission
and preemption authority (admit on free blocks, grow per emitted token,
evict-and-recompute the lowest-priority owner when growth fails). A
scheduler ``Decision`` runs as at most two fused dispatches of the row
ladder (more only when a round exceeds ``ROW_BUCKETS[-1]`` rows or the top
chunk bucket, or when speculative verify rows join decode and prefill rows):
one ragged chunked-prefill batch through the paged-prefill kernel and one
ragged decode batch through the paged-attention kernel.

The hot path syncs with the device once per round. Both steps sample on the
device and return int32 token ids; the engine runs one round ahead of the
GPU (PyTorch launches are asynchronous), uploads its host-built operands
from pinned buffers with ``non_blocking=True``, and reads round N's ids back
with a single ``torch.cat(...).cpu()`` after round N+1's admission,
scheduling and numpy assembly are done. Block-table uploads are cached by
content. ``overlap=False`` syncs every round at once with one transfer per
row, for A/B profiling.

* **slot** (``cache_mode="slot"``; the reference's mode for the archs whose
  state the paged cache cannot hold, and what ``"auto"`` picks for them).
  Each admitted request owns one row of a contiguous ``max_slots x
  max_len`` KV cache (MLA's latent rows ``ckv``/``kr`` for deepseek-v3)
  and of the recurrent state of the Mamba and xLSTM mixers (a hybrid such
  as jamba holds both in one tree). Every prompt chunk is one dispatch at
  its slot's offset on views of the slot's row, updated in place:
  attention and MLA through the chunked-prefill attention kernel, Mamba
  through the selective-scan kernel, the mLSTM through the mLSTM chunkwise
  kernel. Chunk lengths are bucketed by ``CHUNK_BUCKETS`` and padded by
  repeating the last real token (MLA keeps no recurrent state, so it is
  padded too), except for recurrent archs, whose chunks have their exact
  lengths (padding tokens would advance the state). One decode dispatch runs every slot and writes K/V only for the
  rows that are really decoding; recurrent blocks run and update only
  those rows. Greedy argmax is taken on the device and read back once per
  dispatch that emits; rounds are synchronous. ``spec_k`` and the prefix
  cache are off in this mode, as in the reference. As in the reference, a
  slot's recurrent state is not reset when a new request takes the slot:
  the request starts from the previous owner's final state.

* **sharded paged** (``mesh=``, a ``DeviceMesh`` from
  ``launch/mesh.make_serving_mesh``; paged mode only, slot mode ignores it
  as the reference does). Every rank of the process group builds the same
  ``EngineCore`` on the same parameters; the KV pools shard their heads on
  the mesh's ``model`` axis when the head count divides it, else they stay
  replicated and attention is sequence-sharded (``launch/sharding.py``,
  ``kernels/shard_utils.py``). The scheduler is mesh-oblivious and runs
  once: rank 0 is the driver and owns all host state (scheduler,
  allocator, block tables, prefix cache, predictor); before each fused
  dispatch it broadcasts the dispatch (kind, shapes, sampling nonce and
  int operands) over the control plane, the process group's gloo backend
  on CPU tensors, and every rank then runs the same ``paged_*_step`` on
  its shard, the attention ops' collectives going over the ``model`` axis's
  group (the data plane). The other ranks run :meth:`EngineCore.serve_as_worker`
  until the driver's :meth:`EngineCore.close`. Parameters and all math but
  attention are replicated (checked at start-up), so every rank draws the
  same tokens; only the driver reads them back.

An encoder-decoder (seamless-m4t) is refused before anything is
allocated (``check_servable``): the model computes it (``prefill`` and
``decode_step`` of ``models/model.py``), but the reference engine cannot
serve it, so there is nothing to port.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
import heapq
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.scheduler import KVPressure, SchedulerBase
from repro_torch.kernels import shard_utils as su
from repro_torch.kernels.paged_attention.kernel import paged_attention_fused
from repro_torch.kernels.paged_prefill_attention.kernel import (
    paged_prefill_attention_fused)
from repro_torch.launch.mesh import data_backend
from repro_torch.launch.sharding import local_shape, paged_cache_specs
from repro_torch.models.model import (PAGED_KV_LAYOUT, RECURRENT, RunCtx,
                                      Sampling, check_supported,
                                      chunk_prefill_step, decode_step,
                                      init_cache, init_paged_cache,
                                      paged_chunk_step, paged_decode_step,
                                      paged_spec_step, supports_paged_cache)
from repro_torch.params import init_params
from repro_torch.serving.block_allocator import BlockAllocator
from repro_torch.serving.drafter import DrafterBase, NGramDrafter
from repro_torch.serving.request import ReqState, Request
from repro_torch.train.tree import leaves, leaves_with_paths, unflatten

# chunk-length ladder for shape bucketing; allocations above the top rung
# are split across dispatches instead of being silently truncated.
CHUNK_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)

# fused-batch *row* ladder; row counts above the top rung split across
# dispatches, so the set of dispatch shapes stays bounded.
ROW_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


def _bucket(n: int, buckets=CHUNK_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _row_bucket(n: int) -> int:
    return _bucket(n, ROW_BUCKETS)


def _pow2(n: int, lo: int = 1) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


# ---- the driver's control plane ----------------------------------------------
# A message is a fixed header of int64s, [op, kind, nonce, group, Rb, Lb,
# nb, 0], broadcast from rank 0, then for a dispatch one int64 payload: the
# assembly's int operands in _WIRE order, each raveled.
_OP_DISPATCH, _OP_COUNTERS, _OP_STOP = 1, 2, 3
_HEADER = 8
_KINDS = ("decode", "chunk", "spec")


def _wire(kind: str, Rb: int, Lb: int, nb: int):
    """(name, shape, dtype) of a dispatch's operands on the wire."""
    i32 = np.int32
    if kind == "decode":
        return (("tokens", (Rb, 1), i32), ("lengths", (Rb,), i32),
                ("tables", (Rb, nb), i32), ("slots", (Rb,), np.int64))
    rows = (("tokens", (Rb, Lb), i32), ("row_pos", (Rb,), i32),
            ("row_lens", (Rb,), i32))
    if kind == "chunk":
        rows += (("logits_at", (Rb,), i32),)
    return rows + (("tables", (Rb, nb), i32), ("slots", (Rb, Lb), np.int64))


# what a rank reports to the driver's ``mesh_counters``
_COUNTERS = ("decode_calls", "prefill_calls", "spec_calls",
             "paged_attention_fused", "paged_prefill_attention_fused")


def resolve_device(device) -> torch.device:
    """``None`` means the GPU. A CUDA device without a card raises: the
    engine never falls back to the CPU on its own."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("EngineCore: no CUDA device is available; pass "
                           "device='cpu' explicitly to run on the CPU")
    return device


def check_servable(cfg: ModelConfig) -> None:
    """Raise for a config the engine cannot serve: one the model does not
    compute, or an encoder-decoder. The reference engine's slot mode builds
    its cache with ``init_cache(cfg, max_slots, max_len)``, whose cross
    cache then holds no encoder position (``enc_len`` 0), and its first
    chunk fails in the cross attention over zero keys; no request carries
    encoder frames either."""
    check_supported(cfg)
    if cfg.enc_dec:
        raise NotImplementedError(
            f"{cfg.name}: the engine does not serve an encoder-decoder "
            f"(enc_dec; the reference engine cannot: its slot cache holds "
            f"no encoder output, and requests carry no encoder frames); "
            f"repro_torch.models.model.prefill and decode_step compute it")


class EventKind(enum.Enum):
    QUEUED = "queued"            # request handed to the engine (arrival)
    ADMITTED = "admitted"        # KV reserved; request is executable
    FIRST_TOKEN = "first_token"  # first output token (token id attached)
    TOKEN = "token"              # subsequent output token (token id attached)
    FINISHED = "finished"        # reason: "length" (max_output) | "stop" (EOS)
    EVICTED = "evicted"          # relegated by KV pressure; will re-prefill
    ABORTED = "aborted"          # cancelled via EngineCore.abort()


@dataclasses.dataclass
class EngineEvent:
    """One request-lifecycle transition, as observed by ``step()``. ``t`` is
    seconds on the engine clock; for FIRST_TOKEN/TOKEN it is the readback
    time, one round after dispatch."""

    kind: EventKind
    rid: int
    t: float
    token: Optional[int] = None
    reason: str = ""


@dataclasses.dataclass
class EngineStats:
    iterations: int = 0
    prefill_calls: int = 0        # fused chunk dispatches (paged) / per-req (slot)
    decode_calls: int = 0
    compiled_shapes: int = 0      # distinct dispatch shapes seen
    evictions: int = 0
    aborted: int = 0              # requests cancelled via abort()
    max_concurrency: int = 0      # peak simultaneously-admitted requests
    max_round_calls: int = 0      # peak model dispatches in one scheduler round
    # ---- prefix-cache accounting --------------------------------------------
    cache_hit_tokens: int = 0     # prompt tokens served from frozen pages
    prompt_tokens: int = 0        # prompt tokens admitted (hit-rate denominator)
    prefill_tokens: int = 0       # prompt tokens actually computed
    decode_tokens: int = 0        # output tokens computed (decode-step rows)
    deferred_admissions: int = 0  # admission rounds a follower waited for an
                                  # in-flight leader to commit a shared prefix
    # ---- zero-sync hot-path accounting ---------------------------------------
    token_readbacks: int = 0      # device->host token-id transfers
    sync_s: float = 0.0           # wall time blocked waiting on the device
    dispatch_s: float = 0.0       # wall time issuing (async) model dispatches
    device_busy_s: float = 0.0    # wall covered by an in-flight round
    host_s: float = 0.0           # wall with NO round in flight
    reused_uploads: int = 0       # block-table uploads served from device cache
    control_s: float = 0.0        # driver wall time broadcasting dispatches
                                  # to the mesh's workers (control plane)
    # ---- speculative decoding (spec_k > 0) -----------------------------------
    spec_calls: int = 0           # fused verify dispatches
    spec_rounds: int = 0          # rounds that dispatched >=1 verify row
    spec_rows: int = 0            # verify rows read back
    spec_drafts: int = 0          # draft tokens proposed (verify width - 1)
    spec_accepted: int = 0        # draft tokens the model accepted
    spec_emitted: int = 0         # tokens emitted by verify rows
    # ---- per-SLO-class breakdown ---------------------------------------------
    finished_by_class: Dict[str, int] = dataclasses.field(default_factory=dict)
    evicted_by_class: Dict[str, int] = dataclasses.field(default_factory=dict)
    aborted_by_class: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _InflightRound:
    """One dispatched-but-not-read-back scheduler round."""

    toks: List                    # device int32 vectors, one per dispatch
    emits: List[Tuple[int, int]]  # (rid, row in the concatenated tok vector)
    t_dispatch: float             # perf_counter at dispatch
    executed_batch: List = dataclasses.field(default_factory=list)
    # (req, token index, was_first, was_finish): timestamps provisionally
    # stamped at dispatch, corrected to readback time at flush.
    stamped: List = dataclasses.field(default_factory=list)
    # speculative verify rows: (rid, base offset of the row's [accepted,
    # out_0..out_{Lb-1}] span in the concatenated vector, Lb, n_real, start).
    spec_emits: List[Tuple[int, int, int, int, int]] = \
        dataclasses.field(default_factory=list)


class EngineCore:
    """Continuous-batching engine core, driven one scheduler round at a
    time: ``add_request(req, prompt)`` → ``step()`` (repeat while
    ``has_work()``) → per-round ``EngineEvent`` lists; ``abort(rid)``
    cancels a request and releases its pages or slot at once;
    ``serve(requests)`` is the offline wrapper over the same loop.

    ``params``: the model's parameters (``repro_torch.params``); drawn from
    ``seed`` on ``device`` when omitted. ``device``: the GPU by default;
    raises when there is none. ``cache_mode``: ``"paged"``, ``"slot"`` or
    ``"auto"`` (paged where the arch allows it); slot mode holds
    ``max_slots`` rows of ``max_len`` tokens. ``prefix_cache`` reuses frozen
    full pages across requests sharing a prefix; greedy tokens are the same
    with it on or off. ``spec_k > 0`` turns decode rows into speculative
    verify rows (n-gram drafter). Both are paged-mode only. ``mesh``: the
    serving mesh (paged mode only; see the module docstring): every rank
    of the process group constructs the engine alike, rank 0 drives it
    through the step API, the others call :meth:`serve_as_worker`.
    """

    def __init__(self, cfg: ModelConfig, scheduler: SchedulerBase, *,
                 cache_mode: str = "auto",
                 max_slots: int = 8, max_len: int = 512,
                 kv_capacity_tokens: Optional[int] = None,
                 page_size: int = 16, decode_reserve_tokens: int = 64,
                 overlap: bool = True, prefix_cache: bool = True,
                 defer_shared: bool = True,
                 spec_k: int = 0, drafter: Optional[DrafterBase] = None,
                 spec_class_caps: Optional[Dict[int, int]] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 sample_seed: int = 0, seed: int = 0,
                 params=None, device=None, mesh=None):
        check_servable(cfg)      # before any weight or cache is allocated
        if cache_mode == "auto":
            cache_mode = "paged" if supports_paged_cache(cfg) else "slot"
        if cache_mode not in ("paged", "slot"):
            raise ValueError(f"unknown cache_mode {cache_mode!r}")
        if cache_mode == "paged" and not supports_paged_cache(cfg):
            raise ValueError(
                f"{cfg.name}: paged KV requires pure-attention mixers; "
                f"use cache_mode='slot'")
        self.cache_mode = cache_mode
        # the mesh applies to the paged executor only; slot mode (recurrent
        # / MLA archs) stays single-device, as in the reference.
        self.mesh = mesh if cache_mode == "paged" else None
        self.rctx = RunCtx(mesh=self.mesh)
        self.rank, self.world_size = 0, 1
        self.data_plane: Optional[str] = None   # the mesh's attention backend
        self._closed = False
        self.cfg = cfg
        self.sched = scheduler
        self.max_slots = max_slots
        self.max_len = max_len
        self.overlap = overlap
        self.device = resolve_device(device)
        self.params = (init_params(cfg, seed, self.device) if params is None
                       else params)
        self.stats = EngineStats()
        self._tokens_out: Dict[int, List[int]] = {}
        self._seen_shapes = set()
        self._resumed: set = set()    # evicted mid-decode; re-prefill, no emit
        self._round_calls = 0
        self._last_round_evictions = 0
        self._t0 = time.perf_counter()

        # ---- step-API state --------------------------------------------------
        self._pending: List[Tuple[float, int, Request]] = []  # future arrivals
        self._seq = 0                                  # heap tie-break counter
        self._queued: collections.deque = collections.deque()  # arrived, no KV
        self._active: List[Request] = []                        # KV-resident
        self._done: List[Request] = []                          # FINISHED
        self._aborted: List[Request] = []                       # ABORTED
        self._prompts: Dict[int, np.ndarray] = {}
        self._reqs: Dict[int, Request] = {}     # rid -> live (unretired) req
        self._events: List[EngineEvent] = []
        self._progress = "idle"   # "executed" | "empty" | "no-decision" | "idle"
        self._inflight: Optional[_InflightRound] = None

        # ---- speculative decoding + sampling policy --------------------------
        # (paged mode only; slot mode ignores spec_k, as the reference does)
        self.spec_k = int(spec_k) if cache_mode == "paged" else 0
        self.drafter = drafter or (NGramDrafter() if self.spec_k else None)
        self.spec_class_caps = dict(spec_class_caps or {})
        self.sampling = (Sampling(temperature=temperature, top_k=top_k,
                                  seed=sample_seed)
                         if temperature > 0 else None)
        self._sample_nonce = 0          # monotonic per-dispatch RNG fold
        self._round_spec_rids: set = set()
        self._spec_acc_mean = 0.0       # EMA of accepted length per verify row
        self._spec_acc_m2 = 0.0         # EMA of its square (for the std)
        self._spec_draft_ema = 0.0      # EMA of drafts per decode-eligible row

        self.prefix_cache = bool(prefix_cache) and cache_mode == "paged"
        # dependency-aware admission defer (in-flight burst sharing): when K
        # concurrent requests share an uncommitted prefix, followers wait for
        # the leader to commit the shared pages instead of prefilling it K
        # times. Only meaningful with the prefix cache on.
        self.defer_shared = bool(defer_shared) and self.prefix_cache
        self._defer_rounds: Dict[int, int] = {}   # rid -> rounds deferred
        self._defer_cap = 512                     # livelock safety valve

        self._length: Dict[int, int] = {}     # tokens resident per rid
        self._folded: Dict[int, int] = {}     # gen tokens folded on evict
        if cache_mode == "slot":
            self._init_slot_mode(max_slots, max_len)
            return
        capacity = kv_capacity_tokens or max_slots * max_len
        self.alloc = BlockAllocator(capacity, page_size)
        self.page_size = page_size
        self.decode_reserve = decode_reserve_tokens
        # one extra physical page (the last) is the trash page: padding
        # tokens' KV writes land there and are never read back.
        if self.mesh is None:
            self.cache = init_paged_cache(cfg, self.alloc.num_blocks + 1,
                                          page_size, device=self.device)
        else:
            self._init_mesh_state()
        self._trash_slot = self.alloc.num_blocks * page_size
        self._dev_cache: Dict[Tuple, Tuple[np.ndarray, torch.Tensor]] = {}

    # =========================================================================
    # sharded paged executor: one driver, workers on the mesh
    # =========================================================================
    def _init_mesh_state(self) -> None:
        """Join the mesh: check that every rank holds the same parameters,
        then allocate this rank's shard of the KV pools at the shape
        ``paged_cache_specs`` gives it (a head slice ``[reps, Hkv/M, P, 2,
        ps, D]`` when the heads divide the ``model`` axis, the whole pool
        otherwise). The control plane is the process group's gloo backend
        on CPU tensors."""
        import torch.distributed as dist
        if data_backend("cpu") != "gloo":
            raise RuntimeError("the serving mesh's control plane needs gloo "
                               "for CPU tensors in the default process "
                               "group (launch.mesh.init_distributed)")
        self.rank = dist.get_rank()
        self.world_size = dist.get_world_size()
        self.data_plane = data_backend(self.device.type)
        self._check_replicas()
        shapes = init_paged_cache(self.cfg, self.alloc.num_blocks + 1,
                                  self.page_size, device="meta")
        specs = paged_cache_specs(self.cfg, shapes, self.mesh,
                                  axis=self.rctx.shard_axis)
        self.cache = unflatten(shapes, [
            torch.zeros(local_shape(leaf.shape, spec, self.mesh),
                        dtype=leaf.dtype, device=self.device)
            for leaf, spec in zip(leaves(shapes), leaves(specs))])

    def _check_replicas(self) -> None:
        """Raise on every rank unless all ranks hold the same parameters:
        one all-reduce (MAX) of the per-leaf checksums (each leaf's sum,
        accumulated in fp32 without a converted copy, as fp64) and their
        negations gives each leaf's largest and smallest over the ranks."""
        import torch.distributed as dist
        paths, sums = [], []
        for path, leaf in leaves_with_paths(self.params):
            paths.append(path)
            sums.append(leaf.sum(dtype=torch.float32).double())
        s = torch.stack(sums).cpu()
        both = torch.cat([s, -s])
        dist.all_reduce(both, op=dist.ReduceOp.MAX)
        n = len(paths)
        bad = [p for p, hi, lo in zip(paths, both[:n], -both[n:])
               if hi != lo]
        if bad:
            raise RuntimeError(f"the mesh's ranks hold different parameters "
                               f"({len(bad)} leaves differ, first "
                               f"{bad[0]}): give every rank the same seed "
                               f"or params")

    @property
    def is_driver(self) -> bool:
        """Rank 0 of the mesh (or the engine without one) runs the
        scheduler and the step API."""
        return self.rank == 0

    def _require_driver(self) -> None:
        if not self.is_driver:
            raise RuntimeError(f"rank {self.rank} is a worker of the serving "
                               f"mesh: only rank 0 runs the scheduler "
                               f"(call serve_as_worker())")

    def _broadcast_dispatch(self, asm: dict, nonce: int) -> None:
        """The driver's message for one dispatch: header, then operands."""
        import torch.distributed as dist
        t0 = time.perf_counter()
        kind = asm["kind"]
        head = torch.tensor([_OP_DISPATCH, _KINDS.index(kind), nonce,
                             asm.get("group", 0), asm["Rb"], asm.get("Lb", 1),
                             asm["nb"], 0], dtype=torch.int64)
        dist.broadcast(head, 0)
        payload = np.concatenate([
            np.asarray(asm[name], np.int64).reshape(-1)
            for name, _, _ in _wire(kind, asm["Rb"], asm.get("Lb", 1),
                                    asm["nb"])])
        dist.broadcast(torch.from_numpy(payload), 0)
        self.stats.control_s += time.perf_counter() - t0

    def _receive(self) -> Tuple[int, Optional[dict], int]:
        """A worker's next message: (op, the dispatch's assembly or None,
        its nonce)."""
        import torch.distributed as dist
        head = torch.empty(_HEADER, dtype=torch.int64)
        dist.broadcast(head, 0)
        op, k, nonce, group, Rb, Lb, nb, _ = (int(x) for x in head)
        if op != _OP_DISPATCH:
            return op, None, 0
        kind = _KINDS[k]
        wire = _wire(kind, Rb, Lb, nb)
        payload = torch.empty(sum(int(np.prod(shape)) for _, shape, _ in wire),
                              dtype=torch.int64)
        dist.broadcast(payload, 0)
        flat = payload.numpy()
        asm = {"kind": kind, "group": group, "Rb": Rb, "Lb": Lb, "nb": nb}
        at = 0
        for name, shape, dtype in wire:
            size = int(np.prod(shape))
            asm[name] = flat[at:at + size].reshape(shape).astype(dtype)
            at += size
        return op, asm, nonce

    def serve_as_worker(self) -> None:
        """A worker rank's loop: run every dispatch the driver broadcasts on
        this rank's shard (the same ``paged_*_step`` with the driver's
        nonce), answer ``mesh_counters``, and return at the driver's
        ``close()``. Never schedules and never reads tokens back."""
        if self.mesh is None or self.is_driver:
            raise RuntimeError("serve_as_worker() is for the mesh's ranks "
                               "other than 0")
        while True:
            op, asm, nonce = self._receive()
            if op == _OP_STOP:
                return
            if op == _OP_COUNTERS:
                self._gather_counters()
                continue
            self._sample_nonce = nonce
            self._dispatch(asm)

    def _gather_counters(self) -> List[Dict[str, int]]:
        """Every rank's :data:`_COUNTERS`, gathered on every rank."""
        import torch.distributed as dist
        st = self.stats
        mine = torch.tensor([st.decode_calls, st.prefill_calls,
                             st.spec_calls, paged_attention_fused.launches,
                             paged_prefill_attention_fused.launches],
                            dtype=torch.int64)
        parts = [torch.empty_like(mine) for _ in range(self.world_size)]
        dist.all_gather(parts, mine)
        return [dict(zip(_COUNTERS, (int(x) for x in p))) for p in parts]

    def mesh_counters(self) -> List[Dict[str, int]]:
        """The driver's view of every rank's dispatches and #1/#2 launches
        (rank order), fetched through the control plane."""
        import torch.distributed as dist
        self._require_driver()
        if self.mesh is None:
            raise RuntimeError("mesh_counters() needs a mesh")
        dist.broadcast(torch.tensor([_OP_COUNTERS] + [0] * (_HEADER - 1),
                                    dtype=torch.int64), 0)
        return self._gather_counters()

    def close(self) -> None:
        """The driver ends the workers' loops (idempotent; without a mesh
        and on a worker, nothing to do)."""
        import torch.distributed as dist
        if self.mesh is None or not self.is_driver or self._closed:
            return
        self._closed = True
        dist.broadcast(torch.tensor([_OP_STOP] + [0] * (_HEADER - 1),
                                    dtype=torch.int64), 0)

    def kv_shards(self) -> int:
        """How many ways the KV page pools are partitioned (1 = replicated
        or single-device); the shared ``head_shards`` rule, so this always
        agrees with cache placement and ops dispatch."""
        if self.cache_mode != "paged" or self.mesh is None:
            return 1
        return su.head_shards(self.cfg.num_kv_heads, self.mesh,
                              self.rctx.shard_axis)

    def shard_info(self) -> Dict:
        """Mesh + per-shard KV-pool accounting, in the reference's record
        shape."""
        if self.cache_mode != "paged":
            return {"mesh": None, "kv_partition": "none", "kv_shards": 1}
        mesh = self.mesh
        shards = self.kv_shards()
        m = su.axis_size(mesh, self.rctx.shard_axis)
        # a 1-wide (or absent) shard axis runs the exact single-device
        # dispatch: report it as unpartitioned, not as a trivial head shard.
        if shards > 1:
            partition = "heads"
        elif m > 1:
            partition = "sequence"
        else:
            partition = "none"
        info = {
            "mesh": None if mesh is None else "x".join(
                str(d) for d in mesh.shape),
            "axes": None if mesh is None else dict(
                zip(mesh.mesh_dim_names, mesh.shape)),
            "kv_partition": partition,
            "kv_shards": shards,
            "kv_heads_per_shard": self.cfg.num_kv_heads // shards,
        }
        info.update(self.alloc.shard_stats(shards))
        return info

    def shard_banner(self) -> str:
        """One-line human-readable form of :meth:`shard_info`, with the
        data plane's backend (the serving entrypoints print it)."""
        info = self.shard_info()
        return (f"sharded paged executor: mesh={info['mesh']} "
                f"kv_partition={info['kv_partition']} "
                f"shards={info['kv_shards']}"
                + (f" data_plane={self.data_plane} world={self.world_size}"
                   if self.data_plane else ""))

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def now(self) -> float:
        """Seconds on the engine clock (what event timestamps and request
        arrivals are measured against)."""
        return self._now()

    # =========================================================================
    # step API: add_request / abort / step / has_work
    # =========================================================================
    @staticmethod
    def _bump(d: Dict[str, int], cls: str) -> None:
        d[cls] = d.get(cls, 0) + 1

    def _event(self, kind: EventKind, rid: int, t: float,
               token: Optional[int] = None, reason: str = "") -> None:
        self._events.append(EngineEvent(kind, rid, t, token, reason))

    def _drain_events(self) -> List[EngineEvent]:
        evts, self._events = self._events, []
        return evts

    def add_request(self, req: Request, prompt: Sequence[int]) -> None:
        """Hand a request to the engine. ``req.arrival`` is on the engine
        clock: a future arrival is held back, a past/now arrival joins the
        admission queue immediately."""
        self._require_driver()
        if req.rid in self._reqs:
            raise ValueError(f"duplicate rid {req.rid}")
        # transcripts outlive retirement (serve() exposes them), so recycling
        # a finished request's rid would splice two streams together.
        if req.rid in self._tokens_out:
            raise ValueError(
                f"rid {req.rid} reuses a finished request's id on this engine")
        self._reqs[req.rid] = req
        self._prompts[req.rid] = np.asarray(prompt, np.int32)
        if req.arrival > self._now():
            heapq.heappush(self._pending, (req.arrival, self._seq, req))
            self._seq += 1
        else:
            self._queued.append(req)
            self._event(EventKind.QUEUED, req.rid, self._now())

    def abort(self, rid: int) -> List[EngineEvent]:
        """Cancel a request at any stage and free its KV pages. Returns the
        events this produced (the in-flight round is flushed first when it
        emits for the request, so its final TOKEN events surface here)."""
        r = self._reqs.get(rid)
        if r is None or r.state in (ReqState.FINISHED, ReqState.ABORTED):
            return []
        if any(e[2].rid == rid for e in self._pending):
            self._pending = [e for e in self._pending if e[2].rid != rid]
            heapq.heapify(self._pending)
        try:
            self._queued.remove(r)
        except ValueError:
            pass
        if r in self._active:
            # settle the in-flight round first when it will *emit* for this
            # request (that round's one readback happening early). A
            # non-emitting row needs no flush: its page writes are ordered
            # on the stream before any later owner of the pages writes them.
            fr = self._inflight
            if fr is not None and (any(x == rid for x, _ in fr.emits)
                                   or any(s[0] == rid for s in fr.spec_emits)):
                self._flush_round()
                if r.state == ReqState.FINISHED:  # the flush finished it (stop)
                    return self._drain_events()
        r.state = ReqState.ABORTED
        r.finish_time = self._now()
        self._retire(r)
        self._aborted.append(r)
        self.stats.aborted += 1
        self._bump(self.stats.aborted_by_class, r.slo_class)
        self._event(EventKind.ABORTED, rid, self._now())
        return self._drain_events()

    def has_work(self) -> bool:
        """True while any request is pending/queued/active or a dispatched
        round still awaits its readback."""
        return bool(self._pending or self._queued or self._active
                    or self._inflight is not None)

    @property
    def progress(self) -> str:
        """What the last ``step()`` accomplished: ``"executed"``, ``"empty"``
        (decision evicted away), ``"no-decision"`` or ``"idle"``."""
        return self._progress

    def next_arrival(self) -> Optional[float]:
        """Engine-clock time of the earliest not-yet-due request, or None."""
        return self._pending[0][0] if self._pending else None

    @property
    def queue_depth(self) -> int:
        """Requests that have arrived but hold no KV yet."""
        return len(self._queued)

    def outstanding_tokens(self) -> int:
        """Token work still owed across every live request: uncomputed
        prompt tokens plus remaining output budget."""
        tot = 0
        for r in self._reqs.values():
            if r.state in (ReqState.FINISHED, ReqState.ABORTED):
                continue
            tot += r.remaining_prefill() + max(r.max_output - r.generated, 0)
        return tot

    def class_queue_depth(self, max_rank: int) -> int:
        """Live requests at SLO-class rank ``max_rank`` or more critical."""
        return sum(1 for r in self._reqs.values()
                   if r.state not in (ReqState.FINISHED, ReqState.ABORTED)
                   and r.class_rank() <= max_rank)

    @property
    def last_round_evictions(self) -> int:
        """Evictions the most recent executed round caused."""
        return self._last_round_evictions

    def stalled(self) -> bool:
        """Wedge predicate shared by every driver: the last ``step()`` made
        no progress and nothing external will change that."""
        if self._progress == "empty" and self._last_round_evictions == 0:
            return True
        return (self._progress == "idle" and not self._pending
                and bool(self._queued))

    def flush(self) -> List[EngineEvent]:
        """Settle any in-flight round now (its one readback happens early)
        and return the events that surfaced."""
        self._flush_round()
        return self._drain_events()

    def _retire(self, r: Request) -> None:
        """Release a request's execution resources (idempotent)."""
        if self.cache_mode == "paged":
            if r.rid in self.alloc.owners:
                self.alloc.free(r.rid)
            self._length.pop(r.rid, None)
            self._folded.pop(r.rid, None)
        else:
            self._release_slot(r)
        self._resumed.discard(r.rid)
        self._defer_rounds.pop(r.rid, None)
        if r in self._active:
            self._active.remove(r)
        self._reqs.pop(r.rid, None)
        # the prompt array is the dominant per-request memory; transcripts
        # and the _done list stay (serve() returns them).
        self._prompts.pop(r.rid, None)

    # ---- in-flight burst sharing (dependency-aware admission defer) ----------
    def _shared_whole_pages(self, a: np.ndarray, b: np.ndarray) -> int:
        """Whole pages of common prefix between two token arrays."""
        ps = self.page_size
        n = min(len(a), len(b)) // ps * ps
        if n == 0:
            return 0
        eq = a[:n] == b[:n]
        if eq.all():
            return n // ps
        return int(np.argmin(eq)) // ps

    def _defer_for_leader(self, r: Request) -> bool:
        """True when admitting ``r`` now would recompute a prefix that an
        in-flight leader is about to commit (bounded by ``_defer_cap``)."""
        if not self.defer_shared:
            return False
        prompt = self._prompts[r.rid]
        cap = (r.prompt_len - 1) // self.page_size * self.page_size
        if cap == 0:
            return False
        matched_now = self.alloc.match_prefix(prompt,
                                              max_tokens=r.prompt_len - 1)[1]
        gain = 0
        for lead in self._active:
            if lead.state == ReqState.DECODING:
                continue    # prompt pages already committed (or stalled)
            if (lead.rid not in self.alloc.owners
                    or self.alloc.commit_stalled(lead.rid)):
                continue
            lp = self._prompts.get(lead.rid)
            if lp is None:
                continue
            shared = min(self._shared_whole_pages(prompt, lp)
                         * self.page_size, cap)
            if (shared > matched_now
                    and self.alloc.committed_count(lead.rid)
                    * self.page_size < shared):
                gain = max(gain, shared - matched_now)
        if gain >= self.page_size \
                and self._defer_rounds.get(r.rid, 0) < self._defer_cap:
            self._defer_rounds[r.rid] = self._defer_rounds.get(r.rid, 0) + 1
            self.stats.deferred_admissions += 1
            return True
        return False

    def _admit(self) -> None:
        """Move due arrivals into the admission queue, then admit while the
        free pool (or a free slot) lasts, latency-critical SLO classes
        first, FIFO within a class. Paged admission reserves the full prompt
        + decode reserve."""
        paged = self.cache_mode == "paged"
        while self._pending and self._pending[0][0] <= self._now():
            _, _, r = heapq.heappop(self._pending)
            self._queued.append(r)
            self._event(EventKind.QUEUED, r.rid, r.arrival)
        exhausted = (self.alloc.free_blocks == 0 if paged
                     else not self.free_slots)
        if self._queued and not exhausted:
            if len(self._queued) > 1:
                self._queued = collections.deque(
                    sorted(self._queued, key=lambda r: r.class_rank()))
            failures = 0
            for _ in range(len(self._queued)):
                r = self._queued.popleft()
                if paged and self._defer_for_leader(r):
                    self._queued.append(r)
                    failures += 1
                    continue
                if paged:
                    # admission reserves the full prompt + decode headroom;
                    # with the prefix cache, frozen pages matching the
                    # prompt are reused (capped at prompt_len - 1 so one
                    # prompt token is always computed for the first token).
                    ok = self.alloc.admit(
                        r.rid, r.remaining_prefill() + self.decode_reserve,
                        token_ids=(self._prompts[r.rid]
                                   if self.prefix_cache else None),
                        match_limit=r.prompt_len - 1)
                else:
                    ok = self._assign_slot(r) is not None
                if ok:
                    self._active.append(r)
                    self._defer_rounds.pop(r.rid, None)
                    if paged:
                        matched = self.alloc.cached_tokens(r.rid)
                        self._length[r.rid] = matched
                        if matched:
                            # prefill resumes after the frozen prefix
                            r.prefilled = matched
                            r.cached_prefix = matched
                        self.stats.cache_hit_tokens += matched
                        self.stats.prompt_tokens += r.prompt_len
                    self._event(EventKind.ADMITTED, r.rid, self._now())
                else:
                    self._queued.append(r)
                    failures += 1
                if paged and self.alloc.free_blocks == 0:
                    # pool just drained: rotate the failures back to the
                    # front so FIFO order survives the early exit.
                    self._queued.rotate(failures)
                    break
        self.stats.max_concurrency = max(self.stats.max_concurrency,
                                         len(self._active))

    def step(self) -> List[EngineEvent]:
        """Run one scheduler round: admit, schedule, dispatch, and flush the
        *previous* round's deferred readback. Returns the events that
        settled during this call; an idle step flushes any in-flight round
        so the final tokens always surface."""
        self._require_driver()
        paged = self.cache_mode == "paged"
        self._admit()
        if not self._active:
            self._flush_round()         # device is idle anyway
            self._progress = "idle"
            return self._drain_events()

        waiting = [r for r in self._active if r.state == ReqState.WAITING]
        prefilling = [r for r in self._active
                      if r.state == ReqState.PREFILLING]
        decoding = [r for r in self._active if r.state == ReqState.DECODING]
        decision = self.sched.schedule(
            self._now(), waiting, prefilling, decoding,
            kv=self._kv_pressure() if paged else None)
        if decision is None:
            self._flush_round()
            self._progress = "no-decision"
            return self._drain_events()

        self._round_calls = 0
        it0 = time.perf_counter()
        executed = (self._execute_paged(decision) if paged
                    else self._execute_slot(decision))
        if not executed:
            # every entry was evicted away: the driver should yield so
            # re-admission can make progress.
            self._flush_round()
            self._progress = "empty"
            return self._drain_events()
        self._progress = "executed"
        latency = time.perf_counter() - it0
        t_now = self._now()
        self.stats.iterations += 1
        self.stats.max_round_calls = max(self.stats.max_round_calls,
                                         self._round_calls)

        executed_batch = []
        stamped = []
        for entry in executed:
            r, n, ctx = entry[0], entry[1], entry[2]
            drafts = entry[3] if len(entry) > 3 else 0
            if r.state in (ReqState.FINISHED, ReqState.ABORTED):
                continue    # finished by the flush inside execute: dead row
            executed_batch.append((n, ctx, drafts) if drafts else (n, ctx))
            emitted = False
            was_first = r.first_token_time is None
            if r.state == ReqState.DECODING:
                if r.rid in self._round_spec_rids:
                    continue    # verify row: emission is decided at the flush
                r.emit_token(t_now)
                self.stats.decode_tokens += 1
                emitted = True
            else:
                r.advance_prefill(n)
                if r.remaining_prefill() == 0:
                    if r.rid in self._resumed:
                        # re-prefill after eviction: the pending token was
                        # already emitted; resume decoding silently.
                        self._resumed.discard(r.rid)
                        r.state = ReqState.DECODING
                    else:
                        r.emit_token(t_now)
                        emitted = True
            if emitted and paged:
                # the token value is on the device; events settle at flush.
                stamped.append((r, len(r.token_times) - 1, was_first,
                                r.state == ReqState.FINISHED))
            elif emitted:
                # slot mode reads back per dispatch: the id is known now.
                tok = self._tokens_out[r.rid][-1]
                reason = "length"
                if r.state != ReqState.FINISHED and r.hits_stop(tok):
                    r.state = ReqState.FINISHED
                    r.finish_time = t_now
                    reason = "stop"
                self._event(EventKind.FIRST_TOKEN if was_first
                            else EventKind.TOKEN, r.rid, t_now, token=tok)
                if r.state == ReqState.FINISHED:
                    self._event(EventKind.FINISHED, r.rid, t_now,
                                reason=reason)
            if r.state == ReqState.FINISHED:
                self._retire(r)
                self._done.append(r)
                self._bump(self.stats.finished_by_class, r.slo_class)
        if not paged:
            # close the loop on what actually ran (post split/clamp)
            self.sched.observe(executed_batch, latency, kv=None)
            return self._drain_events()
        # readback + observe happen at the next round's flush; the executed
        # batch is recorded on the in-flight round.
        if self._inflight is not None:
            self._inflight.executed_batch = executed_batch
            self._inflight.stamped = stamped
        self.alloc.check_invariants()
        if not self.overlap:
            self._flush_round()
        return self._drain_events()

    # =========================================================================
    # slot mode: one contiguous KV row per request
    # =========================================================================
    def _init_slot_mode(self, max_slots: int, max_len: int) -> None:
        self.cache = init_cache(self.cfg, max_slots, max_len,
                                device=self.device)
        self.lengths = np.zeros((max_slots,), np.int32)   # cached tokens/slot
        self.slot_of: Dict[int, int] = {}
        self.free_slots = list(range(max_slots))

    def _assign_slot(self, req: Request) -> Optional[int]:
        if req.rid in self.slot_of:
            return self.slot_of[req.rid]
        if not self.free_slots:
            return None
        s = self.free_slots.pop()
        self.slot_of[req.rid] = s
        self.lengths[s] = 0
        return s

    def _release_slot(self, req: Request) -> None:
        s = self.slot_of.pop(req.rid, None)
        if s is not None:
            self.free_slots.append(s)

    def _slot_row(self, slot: int) -> list:
        """The cache tree cut to one slot's row (KV rows and recurrent
        state leaves): views, so the chunk step writes the row in place and
        nothing is copied."""
        def row(tree):
            if isinstance(tree, dict):
                return {n: row(v) for n, v in tree.items()}
            return tree[:, slot:slot + 1]
        return [[row(c) for c in stack] for stack in self.cache]

    def _run_prefill_chunk(self, req: Request, n: int,
                           prompt_tokens: np.ndarray) -> int:
        """Execute up to ``n`` prompt tokens, one dispatch per chunk at the
        slot's offset; returns tokens actually run. Allocations above the
        top bucket are split across dispatches (never silently truncated —
        the caller advances by the returned count)."""
        slot = self.slot_of[req.rid]
        total = min(n, req.prompt_len - int(self.lengths[slot]))
        row = self._slot_row(slot)
        recurrent = any(k in RECURRENT for k in self.cfg.layer_pattern)
        done = 0
        ids = None
        while done < total:
            start = int(self.lengths[slot])
            step = min(total - done, CHUNK_BUCKETS[-1])
            # recurrent state advances per token, so padding tokens would
            # pollute it: recurrent archs run exact-length chunks
            blen = step if recurrent else _bucket(step)
            chunk = np.zeros((1, blen), np.int32)
            real = prompt_tokens[start:start + step]
            chunk[0, :step] = real
            # bucket padding repeats the last real token; attention is
            # causal, so the real tokens never see it.
            if step < blen and step > 0:
                chunk[0, step:] = real[-1]
            self._note_shape(("slot_chunk", blen))
            logits, _ = chunk_prefill_step(self.cfg, self.params,
                                           self._to_dev(chunk), row, start,
                                           logits_at=step - 1)
            ids = torch.argmax(logits, dim=-1)
            self.lengths[slot] = start + step
            self.stats.prefill_calls += 1
            self._round_calls += 1
            done += step
        if int(self.lengths[slot]) >= req.prompt_len and done > 0:
            # slot mode reads each token back outside the paged hot path's
            # counted transfer point, as the reference's slot path does
            tok = int(ids[0])
            self._tokens_out.setdefault(req.rid, []).append(tok)
        return done

    def _run_decode_slot(self, reqs: Sequence[Request]) -> None:
        """One decode dispatch over every slot; only the rows of ``reqs``
        write K/V, advance their recurrent state and emit (the reference
        runs every row too and keeps the decoding rows' cache)."""
        tokens = np.zeros((self.max_slots, 1), np.int32)
        slots = np.asarray([self.slot_of[r.rid] for r in reqs], np.int64)
        for r, slot in zip(reqs, slots):
            prev = self._tokens_out.get(r.rid, [0])
            tokens[slot, 0] = prev[-1] if prev else 0
        rows = self._to_dev(slots)
        lengths_p1 = self.lengths + 1   # every row writes to its empty spot
        logits, _ = decode_step(self.cfg, self.params, self._to_dev(tokens),
                                self.cache, 0,
                                lengths=self._to_dev(lengths_p1),
                                write_rows=rows)
        ids = torch.argmax(logits[rows], dim=-1).cpu().numpy()
        for r, slot, tok in zip(reqs, slots, ids):
            self.lengths[slot] += 1
            self._tokens_out.setdefault(r.rid, []).append(int(tok))
        self.stats.decode_calls += 1
        self._round_calls += 1

    def _execute_slot(self, decision) -> List[Tuple[Request, int, int]]:
        executed = []
        decode_reqs = [r for r, n in decision.alloc
                       if r.state == ReqState.DECODING]
        if decode_reqs:
            self._run_decode_slot(decode_reqs)
            executed += [(r, 1, r.context_len()) for r in decode_reqs]
        for r, n in decision.alloc:
            if r.state != ReqState.DECODING:
                ctx = r.context_len()
                n_exec = self._run_prefill_chunk(r, n, self._prompts[r.rid])
                if n_exec > 0:
                    executed.append((r, n_exec, ctx))
        return executed

    # =========================================================================
    # allocator-backed growth / eviction
    # =========================================================================
    def _kv_pressure(self) -> KVPressure:
        """Snapshot for the scheduler, against tokens actually *written*;
        shared pages count once, refcount-0 cached pages are reclaimable.
        ``evictions`` reports the previous round's churn."""
        capacity = self.alloc.num_blocks * self.page_size
        ps = self.page_size
        computed = ps * self.alloc.referenced_committed_blocks() + sum(
            max(self._length.get(rid, 0) - ps * self.alloc.committed_count(rid),
                0)
            for rid in self.alloc.owners)
        return KVPressure(utilization=computed / capacity,
                          free_tokens=capacity - computed,
                          reclaimable_tokens=self.alloc.cached_blocks * ps,
                          evictions=self._last_round_evictions)

    # ---- prefix-cache plumbing ----------------------------------------------
    def _content_upto(self, rid: int, upto: int) -> np.ndarray:
        """Token content of ``rid``'s first ``upto`` cache positions."""
        prompt = self._prompts[rid]
        if upto <= len(prompt):
            return prompt[:upto]
        gen = self._tokens_out.get(rid, [])
        folded = self._folded.get(rid, 0)
        tail = np.asarray(gen[folded:folded + upto - len(prompt)], np.int32)
        return np.concatenate([prompt, tail])

    def _commit(self, rid: int, upto: Optional[int] = None) -> None:
        """Freeze ``rid``'s fully-written pages into the content index, only
        after the covering writes were dispatched (a later reader is a later
        launch on the same stream). ``upto`` caps the freeze below the
        resident length: unconfirmed draft positions must never freeze."""
        if not self.prefix_cache or rid not in self.alloc.owners:
            return
        if upto is None:
            upto = self._length.get(rid, 0)
        if (upto // self.page_size > self.alloc.committed_count(rid)
                and not self.alloc.commit_stalled(rid)):
            self.alloc.commit(rid, self._content_upto(rid, upto), upto)

    def cache_info(self) -> Dict:
        """Prefix-cache hit/commit accounting."""
        st = self.stats
        info = {"prefix_cache": self.prefix_cache,
                "hit_tokens": st.cache_hit_tokens,
                "prompt_tokens": st.prompt_tokens,
                "hit_rate": st.cache_hit_tokens / max(st.prompt_tokens, 1),
                "prefill_tokens_computed": st.prefill_tokens}
        if self.cache_mode == "paged":
            info.update(self.alloc.cache_stats())
        return info

    # ---- speculative decoding plumbing --------------------------------------
    def _transcript(self, rid: int) -> np.ndarray:
        """Full visible token history (the drafter's lookup corpus)."""
        gen = self._tokens_out.get(rid, [])
        tail = gen[self._folded.get(rid, 0):]
        if not tail:
            return self._prompts[rid]
        return np.concatenate([self._prompts[rid],
                               np.asarray(tail, np.int32)])

    def _spec_pressure(self) -> bool:
        """Should latency-critical classes stop speculating?"""
        if self._last_round_evictions > 0:
            return True
        backoff = getattr(self.sched, "kv_backoff_util", 0.92)
        return self._kv_pressure().utilization > backoff

    def _propose_drafts(self, r: Request,
                        pressure: bool) -> Optional[np.ndarray]:
        """Draft tokens for one decode-eligible row after the per-class cap,
        the remaining output budget and the interactive-under-pressure
        opt-out. None -> plain decode row."""
        k = self.spec_class_caps.get(r.class_rank(), self.spec_k)
        k = min(k, self.spec_k, r.max_output - r.generated - 1)
        if k <= 0 or (pressure and r.class_rank() == 0):
            return None
        drafts = self.drafter.propose(self._transcript(r.rid), k)
        if drafts is None or len(drafts) == 0:
            return None
        return np.asarray(drafts[:k], np.int32)

    def _note_spec_accept(self, a: int) -> None:
        """EMA mean/second moment of per-row accepted length."""
        beta = 0.9
        if self.stats.spec_rows <= 1:
            self._spec_acc_mean, self._spec_acc_m2 = float(a), float(a * a)
        else:
            self._spec_acc_mean = (beta * self._spec_acc_mean
                                   + (1 - beta) * a)
            self._spec_acc_m2 = beta * self._spec_acc_m2 + (1 - beta) * a * a

    def _feed_spec_signals(self, round_drafts: int, round_rows: int) -> None:
        """Publish speculation price signals to the scheduler's forwarder."""
        if round_rows <= 0:
            return
        beta = 0.8
        per_row = round_drafts / round_rows
        self._spec_draft_ema = (per_row if self.stats.spec_rounds <= 1
                                else beta * self._spec_draft_ema
                                + (1 - beta) * per_row)
        F = getattr(self.sched, "F", None)
        if F is not None and hasattr(F, "spec_draft_tokens"):
            F.spec_draft_tokens = self._spec_draft_ema
            var = max(self._spec_acc_m2 - self._spec_acc_mean ** 2, 0.0)
            F.spec_len_std = var ** 0.5

    def spec_info(self) -> Dict:
        """Speculation accounting."""
        st = self.stats
        return {
            "spec_k": self.spec_k,
            "spec_rounds": st.spec_rounds,
            "verify_rows": st.spec_rows,
            "draft_tokens": st.spec_drafts,
            "accepted_tokens": st.spec_accepted,
            "acceptance_rate": st.spec_accepted / max(st.spec_drafts, 1),
            "emitted_tokens": st.spec_emitted,
            "tokens_per_verify_row": st.spec_emitted / max(st.spec_rows, 1),
            "decode_tokens_per_round": st.decode_tokens / max(st.iterations, 1),
        }

    def _evict(self, victim: Request) -> None:
        """Relegate ``victim`` (recompute on resume): drop its pages and fold
        already-emitted tokens into its prompt so re-prefill rebuilds the
        exact cache state."""
        # folding reads the victim's emitted token *values*: settle the
        # in-flight round first (its one readback, early).
        self._flush_round()
        if victim.rid not in self.alloc.owners:
            return      # the flush just finished it (stop token)
        prompts = self._prompts
        self.alloc.evict(victim.rid)
        self.stats.evictions += 1
        self._bump(self.stats.evicted_by_class, victim.slo_class)
        self._event(EventKind.EVICTED, victim.rid, self._now())
        gen = self._tokens_out.get(victim.rid, [])
        if victim.generated > 0:
            # the cache held prompt + gen[:-1]; the newest token stays
            # pending as the next decode input, so finishing the re-prefill
            # must NOT emit. _folded guards repeat evictions.
            folded = self._folded.get(victim.rid, 0)
            rebuild = np.asarray(gen[folded:victim.generated - 1], np.int32)
            if len(rebuild):
                prompts[victim.rid] = np.concatenate(
                    [prompts[victim.rid], rebuild])
                victim.prompt_len += len(rebuild)
            self._folded[victim.rid] = victim.generated - 1
            victim.recomputed = victim.generated - 1
            self._resumed.add(victim.rid)
        victim.prefilled = 0
        victim.cached_prefix = 0      # re-matched (if at all) at re-admission
        victim.state = ReqState.WAITING
        self._length.pop(victim.rid, None)
        if victim in self._active:
            self._active.remove(victim)
        self._queued.append(victim)

    def _grow_or_evict(self, req: Request, new_tokens: int,
                       protected: set) -> bool:
        """Grow ``req``'s allocation, evicting lowest-priority owners until
        it fits (outside the decision first, then the least critical class,
        then the newest arrival; never a more critical class than ``req``).
        Returns False if capacity is exhausted even so."""
        by_rid = {r.rid: r for r in self._active}
        needy_rank = req.class_rank()

        def rank_of(rid: int) -> int:
            r = by_rid.get(rid)
            return r.class_rank() if r is not None else needy_rank

        while not self.alloc.grow(req.rid, new_tokens):
            vid = self.alloc.pick_victim(
                req.rid,
                priority=lambda rid: (rid not in protected, rank_of(rid),
                                      by_rid[rid].arrival if rid in by_rid else 0.0),
                eligible=lambda rid: rank_of(rid) >= needy_rank)
            if vid is None or vid not in by_rid:
                return False
            self._evict(by_rid.pop(vid))
        return True

    # ---- zero-sync plumbing --------------------------------------------------
    def _readback(self, arr: torch.Tensor) -> np.ndarray:
        """The single device→host transfer point of the paged hot path."""
        self.stats.token_readbacks += 1
        return arr.cpu().numpy()

    def _to_dev(self, arr: np.ndarray) -> torch.Tensor:
        """Host→device upload. On the GPU it goes through a pinned buffer
        with ``non_blocking=True``; PyTorch's caching host allocator records
        the copy's stream event and does not hand the pinned block out
        again before the copy has completed."""
        t = torch.from_numpy(np.array(arr, copy=True))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _flush_round(self) -> None:
        """Materialize the in-flight round: one token-id readback, then
        append emitted ids, correct provisional timestamps, emit token
        events, decide stop-token termination and feed observe()."""
        fr = self._inflight
        if fr is None:
            return
        self._inflight = None
        t0 = time.perf_counter()
        joined = fr.toks[0] if len(fr.toks) == 1 else torch.cat(fr.toks)
        if self.overlap:
            vals = self._readback(joined)
            toks = {idx: int(vals[idx]) for _, idx in fr.emits}
        else:
            # legacy profile: one transfer per emitting row (and the whole
            # payload once more when verify rows ran).
            toks = {idx: int(self._readback(joined[idx]))
                    for _, idx in fr.emits}
            if fr.spec_emits:
                vals = self._readback(joined)
        self.stats.sync_s += time.perf_counter() - t0
        t_done = self._now()
        by_rid = {r.rid: (r, k, wf, fin) for r, k, wf, fin in fr.stamped}
        for rid, idx in fr.emits:
            tok = toks[idx]
            self._tokens_out.setdefault(rid, []).append(tok)
            entry = by_rid.get(rid)
            if entry is None:
                continue
            r, k, was_first, was_finish = entry
            r.token_times[k] = t_done
            if was_first:
                r.first_token_time = t_done
            self._event(EventKind.FIRST_TOKEN if was_first
                        else EventKind.TOKEN, rid, t_done, token=tok)
            if was_finish:
                r.finish_time = t_done
                self._event(EventKind.FINISHED, rid, t_done, reason="length")
            elif r.state == ReqState.DECODING and r.hits_stop(tok):
                # stop-token termination from the deferred readback; a row
                # already assembled for the next round executes dead.
                r.state = ReqState.FINISHED
                r.finish_time = t_done
                self._retire(r)
                self._done.append(r)
                self._bump(self.stats.finished_by_class, r.slo_class)
                self._event(EventKind.FINISHED, rid, t_done, reason="stop")
        for rid, base, Lb, n_real, start in fr.spec_emits:
            # payload span [accepted, out_0 .. out_{Lb-1}]: emit out_0..out_a
            # (a accepted drafts + the bonus token); rolling the resident
            # length back makes the next round overwrite the rejected tail.
            a = min(int(vals[base]), n_real - 1)
            outs = [int(v) for v in vals[base + 1:base + 2 + a]]
            r = self._reqs.get(rid)
            self.stats.spec_rows += 1
            self.stats.spec_drafts += n_real - 1
            self._note_spec_accept(a)
            if r is None or r.state in (ReqState.FINISHED, ReqState.ABORTED):
                continue        # aborted between dispatch and flush
            m = 0
            finished_reason = ""
            for tok in outs:
                self._tokens_out.setdefault(rid, []).append(tok)
                m += 1
                r.emit_token(t_done)
                self.stats.decode_tokens += 1
                self._event(EventKind.TOKEN, rid, t_done, token=tok)
                if r.state == ReqState.FINISHED:        # max_output reached
                    finished_reason = "length"
                    break
                if r.hits_stop(tok):
                    r.state = ReqState.FINISHED
                    finished_reason = "stop"
                    break
            self.stats.spec_accepted += a
            self.stats.spec_emitted += m
            if rid in self._length:
                self._length[rid] = start + m
            if finished_reason:
                r.finish_time = t_done
                self._retire(r)
                self._done.append(r)
                self._bump(self.stats.finished_by_class, r.slo_class)
                self._event(EventKind.FINISHED, rid, t_done,
                            reason=finished_reason)
        latency = time.perf_counter() - fr.t_dispatch
        # dispatch->flush intervals are disjoint, so their sum is the wall
        # time covered by an in-flight round.
        self.stats.device_busy_s += latency
        self.sched.observe(fr.executed_batch, latency, kv=self._kv_pressure())

    def _upload_cached(self, kind, arr: np.ndarray) -> torch.Tensor:
        """Host→device upload with content reuse: block tables are stable
        across steady decode rounds, so the previous round's device buffer
        is reused. Keyed per consumer ``kind`` and row group, and by the
        pool layout tag."""
        key = (kind, arr.shape, PAGED_KV_LAYOUT)
        prev = self._dev_cache.get(key)
        if prev is not None and np.array_equal(prev[0], arr):
            self.stats.reused_uploads += 1
            return prev[1]
        dev = self._to_dev(arr)
        self._dev_cache[key] = (arr, dev)
        return dev

    # ---- fused dispatch assembly ---------------------------------------------
    def _page_slots(self, rid: int, positions: np.ndarray) -> np.ndarray:
        pt = np.asarray(self.alloc.page_table(rid), np.int64)
        return pt[positions // self.page_size] * self.page_size \
            + positions % self.page_size

    def lengths_of(self, req: Request) -> int:
        return self._length.get(req.rid, 0)

    def _assemble_chunk(self, batch: List[Tuple[Request, int, int]],
                        prompts: Dict[int, np.ndarray]) -> dict:
        """Numpy assembly of one fused ragged-prefill dispatch (host work
        that runs while the previous round executes on the device)."""
        R = len(batch)
        Rb = _row_bucket(R)
        Lb = _bucket(max(n for _, _, n in batch))
        nb = _pow2(max(self.alloc.blocks_for(s + n) for _, s, n in batch))
        tokens = np.zeros((Rb, Lb), np.int32)
        row_pos = np.zeros((Rb,), np.int32)
        row_lens = np.zeros((Rb,), np.int32)
        logits_at = np.zeros((Rb,), np.int32)
        tables = np.zeros((Rb, nb), np.int32)
        slots = np.full((Rb, Lb), self._trash_slot, np.int64)
        emit_rows: List[Tuple[int, int]] = []
        for i, (r, start, n) in enumerate(batch):
            tokens[i, :n] = prompts[r.rid][start:start + n]
            row_pos[i] = start
            row_lens[i] = start + n
            logits_at[i] = n - 1
            # only the page-table prefix covering start+n tokens belongs in
            # the table (a split chunk grows the whole allocation up front).
            need = self.alloc.blocks_for(start + n)
            tables[i, :need] = self.alloc.page_table(r.rid)[:need]
            slots[i, :n] = self._page_slots(r.rid, np.arange(start, start + n))
            self._length[r.rid] = start + n
            if start + n >= r.prompt_len and r.rid not in self._resumed:
                emit_rows.append((r.rid, i))
        return {"kind": "chunk", "tokens": tokens, "row_pos": row_pos,
                "row_lens": row_lens, "logits_at": logits_at,
                "tables": tables, "slots": slots, "emit_rows": emit_rows,
                "Rb": Rb, "Lb": Lb, "nb": nb}

    def _assemble_prefill(self, entries: List[Tuple[Request, int]],
                          prompts: Dict[int, np.ndarray]) -> List[dict]:
        """Split the decision's prefill rows over the chunk-length and row
        ladders."""
        asms: List[dict] = []
        work = [[r, self.lengths_of(r), n] for r, n in entries]
        while work:
            step_batch = [(r, s, min(n, CHUNK_BUCKETS[-1])) for r, s, n in work]
            for i in range(0, len(step_batch), ROW_BUCKETS[-1]):
                asm = self._assemble_chunk(
                    step_batch[i:i + ROW_BUCKETS[-1]], prompts)
                asm["group"] = len(asms)
                asms.append(asm)
            nxt = []
            for (r, s, n), (_, _, step) in zip(work, step_batch):
                if n - step > 0:
                    nxt.append([r, s + step, n - step])
            work = nxt
        return asms

    def _assemble_decode(self, reqs: Sequence[Request]) -> dict:
        """Numpy assembly of one fused decode dispatch; the input token ids
        are filled in after the previous round's flush."""
        R = len(reqs)
        Rb = _row_bucket(R)
        new_lens = [self._length[r.rid] + 1 for r in reqs]
        pts = [self.alloc.page_table(r.rid) for r in reqs]
        # full reserved page tables: stable bytes round over round, so the
        # upload cache hits; pages past ceil(len/ps) are never read.
        nb = _pow2(max(len(pt) for pt in pts))
        tokens = np.zeros((Rb, 1), np.int32)
        lengths = np.zeros((Rb,), np.int32)
        tables = np.zeros((Rb, nb), np.int32)
        slots = np.full((Rb,), self._trash_slot, np.int64)
        for i, (r, pt) in enumerate(zip(reqs, pts)):
            lengths[i] = new_lens[i]
            tables[i, :len(pt)] = pt
            slots[i] = self._page_slots(
                r.rid, np.asarray([new_lens[i] - 1]))[0]
            self._length[r.rid] += 1
        return {"kind": "decode", "rids": [r.rid for r in reqs],
                "tokens": tokens, "lengths": lengths, "tables": tables,
                "slots": slots, "Rb": Rb, "nb": nb}

    def _assemble_spec(self, batch: List[Tuple[Request, np.ndarray]]) -> dict:
        """Numpy assembly of one fused speculative-verify dispatch: each row
        is [pending token, draft_1..draft_k] at the request's resident
        offset. Runs after the flush; the resident length advances over the
        whole row and rolls back to ``start + emitted`` at the next flush."""
        R = len(batch)
        Rb = _row_bucket(R)
        max_n = max(1 + len(d) for _, d in batch)
        Lb = _pow2(max_n, lo=2)     # verify rows get their own narrow ladder
        pts = [self.alloc.page_table(r.rid) for r, _ in batch]
        nb = _pow2(max(len(pt) for pt in pts))
        tokens = np.zeros((Rb, Lb), np.int32)
        row_pos = np.zeros((Rb,), np.int32)
        row_lens = np.zeros((Rb,), np.int32)
        tables = np.zeros((Rb, nb), np.int32)
        slots = np.full((Rb, Lb), self._trash_slot, np.int64)
        rows: List[Tuple[int, int, int]] = []   # (rid, n_real, start)
        for i, ((r, drafts), pt) in enumerate(zip(batch, pts)):
            rid = r.rid
            start = self._length[rid]
            n = 1 + len(drafts)
            tokens[i, 0] = self._tokens_out[rid][-1]
            tokens[i, 1:n] = drafts
            if n < Lb:
                tokens[i, n:] = tokens[i, n - 1]   # pad; writes hit trash
            row_pos[i] = start
            row_lens[i] = start + n
            tables[i, :len(pt)] = pt
            slots[i, :n] = self._page_slots(rid, np.arange(start, start + n))
            self._length[rid] = start + n
            rows.append((rid, n, start))
        return {"kind": "spec", "tokens": tokens, "row_pos": row_pos,
                "row_lens": row_lens, "tables": tables, "slots": slots,
                "rows": rows, "Rb": Rb, "Lb": Lb, "nb": nb}

    def _dispatch(self, asm: dict) -> torch.Tensor:
        """Issue one fused dispatch (asynchronous on the GPU); returns the
        device token-id vector: [Rb] for decode/chunk, [Rb*(Lb+1)] payload
        for spec. The sampling nonce advances per dispatch."""
        nonce = self._sample_nonce
        self._sample_nonce += 1
        if self.mesh is not None and self.is_driver:
            self._broadcast_dispatch(asm, nonce)
        cfg, dev = self.cfg, self._to_dev
        slots = dev(asm["slots"].reshape(-1).astype(np.int32))
        if asm["kind"] == "decode":
            self._note_shape(("decode", asm["Rb"], asm["nb"]))
            toks, self.cache = paged_decode_step(
                cfg, self.params, dev(asm["tokens"]), self.cache,
                lengths=dev(asm["lengths"]),
                block_tables=self._upload_cached(
                    ("decode", asm.get("group", 0)), asm["tables"]),
                write_slots=slots, sampling=self.sampling, nonce=nonce,
                rctx=self.rctx)
            self.stats.decode_calls += 1
        elif asm["kind"] == "spec":
            self._note_shape(("spec", asm["Rb"], asm["Lb"], asm["nb"]))
            toks, self.cache = paged_spec_step(
                cfg, self.params, dev(asm["tokens"]), self.cache,
                dev(asm["row_pos"]), row_lens=dev(asm["row_lens"]),
                block_tables=self._upload_cached(
                    ("spec", asm.get("group", 0)), asm["tables"]),
                write_slots=slots, sampling=self.sampling, nonce=nonce,
                rctx=self.rctx)
            self.stats.spec_calls += 1
        else:
            self._note_shape(("chunk", asm["Rb"], asm["Lb"], asm["nb"]))
            toks, self.cache = paged_chunk_step(
                cfg, self.params, dev(asm["tokens"]), self.cache,
                dev(asm["row_pos"]), row_lens=dev(asm["row_lens"]),
                block_tables=self._upload_cached(
                    ("chunk", asm.get("group", 0)), asm["tables"]),
                write_slots=slots, logits_at=dev(asm["logits_at"]),
                sampling=self.sampling, nonce=nonce, rctx=self.rctx)
            self.stats.prefill_calls += 1
        self._round_calls += 1
        return toks

    def _note_shape(self, key) -> None:
        if key not in self._seen_shapes:
            self._seen_shapes.add(key)
            self.stats.compiled_shapes += 1

    # =========================================================================
    # offline compatibility wrapper
    # =========================================================================
    def serve(self, requests: Sequence[Request],
              prompts: Optional[Dict[int, np.ndarray]] = None,
              max_wall_s: float = 300.0) -> Dict:
        """Serve a complete request list (arrival times are wall-clock
        offsets from this call) and block until everything finishes: resets
        the engine clock, feeds every request through ``add_request`` and
        drives ``step()``. The engine must be drained."""
        if self.has_work():
            raise RuntimeError(
                "serve() on an engine with live requests (drain or use step())")
        rng = np.random.default_rng(0)
        prompts = prompts or {
            r.rid: rng.integers(0, self.cfg.vocab_size, r.prompt_len).astype(np.int32)
            for r in requests
        }
        self._t0 = time.perf_counter()
        busy0 = self.stats.device_busy_s    # stats accumulate across serve()s
        done0 = len(self._done)
        for r in sorted(requests, key=lambda r: r.arrival):
            self.add_request(r, prompts[r.rid])

        empty_rounds = 0
        while self.has_work() and self._now() < max_wall_s:
            self.step()
            if self._progress == "executed":
                empty_rounds = 0
            elif self._progress == "empty":
                # every entry was evicted away: yield so re-admission can
                # progress, but bail if nothing changed state either.
                empty_rounds += 1
                if self._last_round_evictions == 0 and empty_rounds >= 8:
                    break
                time.sleep(1e-3)
            elif self._progress == "no-decision":
                time.sleep(1e-3)
            else:   # idle: nothing admitted/admissible (in-flight is flushed)
                if self._pending:
                    time.sleep(max(self._pending[0][0] - self._now(), 0.0)
                               + 1e-4)
                elif self._queued:   # arrived but nothing fits: wedged
                    break

        # the final flush's events have no step() caller to collect them.
        self.flush()
        wall = self._now()
        self.stats.host_s = max(
            wall - (self.stats.device_busy_s - busy0), 0.0)
        return {
            "finished": self._done[done0:],
            "unfinished": [r for r in requests if r.state != ReqState.FINISHED],
            "stats": self.stats,
            "outputs": dict(self._tokens_out),
            "wall": wall,
        }

    # ---- decision execution ----------------------------------------------------
    def _execute_paged(self, decision) -> List[Tuple]:
        """Grow allocations (evicting under pressure), assemble the round on
        the host while the previous round still runs on the device, sync
        once on the previous round's token ids, then dispatch the decision
        as fused decode + speculative-verify + ragged prefill batches.

        With ``spec_k > 0`` the round's one readback moves *before*
        assembly: round N's accepted counts decide round N+1's write
        positions, and drafting needs the newest token host-visible."""
        prompts = self._prompts
        protected = {r.rid for r, _ in decision.alloc}
        ev0 = self.alloc.evictions
        spec_on = self.spec_k > 0 and self.drafter is not None
        if spec_on:
            self._flush_round()
        self._round_spec_rids = set()

        def is_live(r):  # an earlier grow may have evicted a later entry
            return r.rid in self.alloc.owners and r.state not in (
                ReqState.FINISHED, ReqState.ABORTED)

        pressure = self._spec_pressure() if spec_on else False
        decode_rows: List[Request] = []
        spec_rows: List[Tuple[Request, np.ndarray]] = []
        prefill_rows: List[Tuple[Request, int]] = []
        for r, n in decision.alloc:
            if not is_live(r):
                continue
            if r.state == ReqState.DECODING:
                drafts = self._propose_drafts(r, pressure) if spec_on else None
                if drafts is not None and self._grow_or_evict(
                        r, self._length[r.rid] + 1 + len(drafts), protected):
                    spec_rows.append((r, drafts))
                elif self._grow_or_evict(r, self._length[r.rid] + 1,
                                         protected):
                    decode_rows.append(r)
            else:
                n_exec = min(n, r.remaining_prefill())
                if n_exec <= 0:
                    continue
                start = self._length.get(r.rid, 0)
                if not self._grow_or_evict(r, start + n_exec, protected):
                    continue
                prefill_rows.append((r, n_exec))
        decode_rows = [r for r in decode_rows if is_live(r)]
        spec_rows = [(r, d) for r, d in spec_rows if is_live(r)]
        prefill_rows = [(r, n) for r, n in prefill_rows if is_live(r)]
        self._last_round_evictions = self.alloc.evictions - ev0
        if not decode_rows and not spec_rows and not prefill_rows:
            return []

        # ---- host-side numpy assembly (device still busy with round N) ------
        executed: List[Tuple] = []
        decode_asms: List[dict] = []
        if decode_rows:
            ctxs = {r.rid: r.context_len() for r in decode_rows}
            for i in range(0, len(decode_rows), ROW_BUCKETS[-1]):
                asm = self._assemble_decode(decode_rows[i:i + ROW_BUCKETS[-1]])
                asm["group"] = i // ROW_BUCKETS[-1]
                decode_asms.append(asm)
            executed += [(r, 1, ctxs[r.rid]) for r in decode_rows]
        spec_asms: List[dict] = []
        if spec_rows:
            self.stats.spec_rounds += 1
            for i in range(0, len(spec_rows), ROW_BUCKETS[-1]):
                asm = self._assemble_spec(spec_rows[i:i + ROW_BUCKETS[-1]])
                asm["group"] = i // ROW_BUCKETS[-1]
                spec_asms.append(asm)
            for r, drafts in spec_rows:
                self._round_spec_rids.add(r.rid)
                executed.append((r, 1 + len(drafts), r.context_len(),
                                 len(drafts)))
        if spec_on:
            self._feed_spec_signals(
                sum(len(d) for _, d in spec_rows),
                len(decode_rows) + len(spec_rows))
        chunk_asms: List[dict] = []
        if prefill_rows:
            ctxs = {r.rid: r.context_len() for r, _ in prefill_rows}
            chunk_asms = self._assemble_prefill(prefill_rows, prompts)
            executed += [(r, n, ctxs[r.rid]) for r, n in prefill_rows]
            for r, n in prefill_rows:
                self.stats.prefill_tokens += n
                self._commit(r.rid)   # freeze pages this round fills

        # ---- the round's single sync: round N's token ids -------------------
        # (a no-op when spec_on already flushed above)
        self._flush_round()

        # ---- dispatch round N+1 (async) -------------------------------------
        t_disp = time.perf_counter()
        toks, emits, spec_emits, off = [], [], [], 0
        for asm in decode_asms:
            # decode inputs are round N's outputs, host-visible only now
            for i, rid in enumerate(asm["rids"]):
                r = self._reqs.get(rid)
                if r is None or r.state in (ReqState.FINISHED,
                                            ReqState.ABORTED):
                    # finished by the flush above (stop token): the row runs
                    # dead (KV write to the trash page, no emit).
                    asm["slots"][i] = self._trash_slot
                    continue
                prev = self._tokens_out.get(rid)
                asm["tokens"][i, 0] = prev[-1] if prev else 0
                emits.append((rid, off + i))
                # the write this row makes may complete a page whose content
                # is host-known now: decode pages freeze too.
                self._commit(rid)
            toks.append(self._dispatch(asm))
            off += asm["Rb"]
        for asm in spec_asms:
            toks.append(self._dispatch(asm))
            W = asm["Lb"] + 1
            for i, (rid, n_real, start) in enumerate(asm["rows"]):
                spec_emits.append((rid, off + i * W, asm["Lb"], n_real,
                                   start))
                # only the pending token's position is confirmed content
                self._commit(rid, upto=start + 1)
            off += asm["Rb"] * W
        for asm in chunk_asms:
            toks.append(self._dispatch(asm))
            emits += [(rid, off + row) for rid, row in asm["emit_rows"]
                      if rid in self._reqs]
            off += asm["Rb"]
        self.stats.dispatch_s += time.perf_counter() - t_disp
        self._inflight = _InflightRound(toks=toks, emits=emits,
                                        t_dispatch=t_disp,
                                        spec_emits=spec_emits)
        return executed


# Back-compat name, as in the reference.
ServingEngine = EngineCore
