#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases (each raises on failure, and the script then exits non-zero; each
prints its seconds):

1. device: CUDA must be available on a compute-capability 9.0 card; prints
   ``nvidia-smi --query-gpu=name,power.limit``.
2. build: compiles ``src/repro_torch/csrc/*.cu`` with nvcc for sm_90a, one
   library per source (five), all nvcc processes at once, and prints each
   kernel's registers and spills (ptxas), and the registers, spills,
   dynamic shared memory and resident blocks per SM of the bf16
   tensor-core prefill kernels at head_dim 64, 128 and 256, and of #5 at
   deepseek-v3's MLA pair (keys 192, values 128) (the runtime's report)
   with their rows and key tile (the library's); the wrappers' bf16 check
   must refuse more query heads per kv head than rows, and a head_dim or a
   (head_dim, value width) pair without a kernel.
3. kernel parity: the seven CUDA kernels against their plain PyTorch
   versions on the same inputs. The attention kernels at llama3.2-3b
   shapes (bf16, 24 query heads, 8 kv heads, head_dim 128; page size 16 for
   the paged kernels; a 4096-token slot row, read in place as the slot
   engine passes it, for the chunked-prefill kernel) and a few others
   (window + softcap, fp32, partial mode with negative shard-local
   positions, a chunk that ends past the slot row, ``causal=False`` with
   per-row lengths); the chunked-prefill kernel also at jamba's attention
   shapes (64 query heads over 8 kv heads), the paged prefill kernel at
   G 8, and both at gemma2-2b's (8 query heads over 4 kv heads, head_dim
   256, window 4096, softcap 50, contexts past the window); the
   chunked-prefill kernel also at deepseek-v3's MLA shapes (128 heads, G
   1, keys 192 and values 128 read in place from the expanded rows: Sq 512
   at offset 3584 of a 4096 row, also split three ways, and Sq 100 at
   offset 2000; in fp32 the smoke config's keys 24 and values 16), and at
   seamless-m4t-large-v2's (16 heads of 64 over 16 kv heads, B 4: the
   encoder's 1024 frames not causal, the decoder's 128-token prefill,
   cross attention over 1024 encoder positions at prefill and at a
   decode step, Sq 1). The
   decode kernels split each row's
   pages (split-K, merged in the same launch): each decode case prints its
   split count and its time from CUDA events and from a profiler trace, a
   case whose plan splits is also checked and timed at one split and
   checked again after the timing loops; decode also at G 8, G 12 (two
   head groups), head_dim 48 and gemma2-2b's heads (G 2, head_dim 256,
   window 4096, softcap 50). bf16 decode at head_dim 64, 128 or 256 over
   16-key pages runs the tensor-core block; the scalar block's bf16 cases
   (head_dim 48, head_dim 32 in two head groups, and llama3.2-3b's heads
   over 128-key pages) must record that they ran it. bf16 prefill runs on the tensor cores
   (wgmma fed by TMA); each paged and chunked prefill case prints its split
   count and its time from CUDA events and from a profiler trace, and
   records its kernel's registers, spills, shared memory and blocks an SM;
   a case whose plan splits the keys (split-K) is also checked and timed
   with one split (a paged case is checked again after its timing loops,
   which would catch a split-merge ticket left set), and three more short
   deep chunks are split-K cases. The split-pool decode and
   prefill kernels at llama3.2-3b shapes, each also against the fused
   kernel on the same keys (whether the two are bit-identical is printed;
   the split prefill must be, in bf16 and fp32: the bf16 pair shares its
   tensor-core tile loop).
   The mLSTM chunkwise kernels at xlstm-125m shapes (4 heads, head_dim 384,
   bf16): fresh state at S 2048 and S 1000 (a ragged last chunk) and a
   batch of 4 at S 300, carried states at S 37, S 200, S 512 and S 512 at
   head_dim 96, the decode of 8 of 10 and 4 of 6 state rows, fp32, and the
   smoke config's head_dim 32; each with its device time, a bf16 chunk's
   also pass by pass (gates, states, outputs) from the trace; before them
   the registers, spills, shared memory and blocks an SM of the three bf16
   passes at both chunk lengths (128 tokens at S 2048, 64 at S 200), none
   of which may spill.
   The Mamba selective scan at jamba's shapes (d_inner 16384, d_state 16,
   bf16): fresh chunks of 2048 and 1000 steps, a carried chunk of 37, the
   decode of 8 of 10 state rows, fp32, the smoke config's d_inner 128,
   and d_state 6 with B and C rows that no tensor map takes; each with its
   device time, also with the L2 flushed, and whether its new state equals
   the plain version's bit for bit (which a decode step must: its kernel
   keeps expf; the chunk kernel's ex2 does not); and the registers,
   spills, shared memory and blocks an SM of the library's four kernels,
   none of which may spill.
   Tolerance, at valid query positions, elementwise: fp32
   ``|got - want| <= 2e-5 + 2e-5 * |want|``; bf16
   ``|got - want| <= 2**-7 * |want| + 0.05 * rms(want)``, one bf16 rounding
   step of the element plus a twentieth of the RMS of its head's D-vector
   (the token's d_inner vector for the scan), so the limit follows bf16
   rounding, not the size of the output (a kernel that skips one 64-key
   tile at a 4K context is off by about a tenth of the RMS). The partial
   state's m and l are held to ``1e-3 + 1e-5 * |m|`` and ``1e-4 * l``; the
   mLSTM's new C and n and the scan's new h to ``1e-5 + 1e-4 * |ref|`` and
   the mLSTM's m to ``1e-3 + 1e-5 * |m|``. Each case is timed with CUDA
   events beside the plain version and, for attention, one PyTorch library
   call used only as a yardstick (``scaled_dot_product_attention`` on the
   gathered pages or the slot row, with an explicit mask; no single
   PyTorch call computes the mLSTM or the selective scan), and its bound
   (bytes at 3.35 TB/s, flops at 989 TFLOP/s bf16 or 67 TFLOP/s fp32; the
   scan's fp32 arithmetic at 67) is computed from the case's own inputs
   (the keys each query attends; the mLSTM's chunks).
4. end to end on a small input: the smoke llama3.2-3b engine (fp32) on the
   GPU gives the same greedy tokens as on the CPU (plain versions), in
   paged and in slot mode, and slot mode gives the paged tokens; so do the
   smoke xlstm-125m and jamba slot engines, the smoke qwen2-moe-a2.7b
   engine (MoE FFN) in both modes, gemma2-2b (paged and slot) and
   gemma2-27b (paged) with the window cut to 16 tokens so that it masks
   keys, qwen3-1.7b (paged) and deepseek-v3-671b (MLA, slot). Then
   ``prefill`` and 8 greedy ``decode_step``s of every arch's smoke config
   (fp32; internvl2 with patch embeddings, seamless-m4t with 16 encoder
   frames): the same greedy tokens on the GPU and on the CPU.
5. full-width paged serving: llama3.2-3b (28 layers, d_model 3072, random
   weights from a seed, bf16) through ``InferenceServer(EngineCore(...))``
   with a 65536-token KV pool, 8 requests, once with ``spec_k=0`` and once
   with ``spec_k=4``. Every kernel's launch counter is set to 0 just before
   and read just after, and the paged kernels' counts must equal 28 x the
   dispatches that use them. A third run repeats the first under
   ``torch.profiler`` and prints the device busy time, idle share and
   largest device and host entries.
6. full-width slot serving: the same model and requests through
   ``EngineCore(cache_mode="slot")`` with 8 slots of 4096 tokens. The
   counters are set to 0 just before and read just after; the
   chunked-prefill kernel must have launched 28 x the chunk dispatches;
   the launches of its split-K combine kernel (one for each wrapper call
   whose plan splits the keys) are printed. A second run repeats
   ``cut_workload``'s part of it (4 requests, a quarter of their output
   tokens) under ``torch.profiler``.
7. full-width xlstm-125m slot serving: 12 layers (6 mLSTM, 6 sLSTM),
   d_model 768, 4 heads, random weights from a seed, bf16, the same
   requests over 8 slots; the mLSTM chunkwise wrapper must have been
   called 6 x (chunk + decode dispatches); its calls, the CUDA kernels
   they launched (one for a decode step, three passes for a bf16 chunk)
   and its decode and chunk calls are printed apart. A second run repeats
   ``cut_workload``'s part of it under ``torch.profiler`` and prints
   #7's kernels in the trace, the chunk passes and the decode kernel
   apart.
8. full-width jamba-1.5-large-398b slot serving, cut in depth to one
   8-layer period (``jamba_cut``: every published width, 7 Mamba layers
   and one attention layer, the last FFN MoE; 18.06 B parameters), random
   weights from a seed, bf16, the same requests over 8 slots; the selective
   scan must have launched 7 x (chunk + decode dispatches) and the
   chunked-prefill kernel 1 x the chunk dispatches. A second run repeats
   it under ``torch.profiler`` and prints #6's chunk and decode kernels'
   device time in the trace apart.
9. full-width gemma2-2b paged serving (26 layers, d_model 2304, every
   published width, bf16), 8 requests of which 4 have prompts of 4097-6144
   tokens, past the local layers' 4096-key window, at spec_k 0 and 4 and
   a traced repeat of ``cut_workload``'s part, checked as phase 5.
10. full-width qwen3-1.7b paged serving (28 layers, per-head q/k norm,
   nothing cut), phase 5's requests at spec_k 0 and a traced repeat of
   ``cut_workload``'s part.
11. full-width deepseek-v3-671b slot serving, cut in depth to 4 layers
   (``deepseek_cut``: the 3 first_k_dense layers and 1 MoE layer of 256
   experts, every published width, and the MTP module, which serving does
   not read; 15.8 B parameters), the same requests
   over 8 slots of 4096; #5 must have launched 4 x the chunk dispatches
   (one per MLA layer), its split-K combine launches are printed, and a
   second run repeats it under ``torch.profiler``.
12. the front door: full-width llama3.2-3b (bf16, paged, phase 5's KV
   pool) behind ``HttpFrontend`` on 127.0.0.1 (port 0, its asyncio loop
   in a thread of its own), phase 5's 8 requests as concurrent SSE streams
   through ``EngineHttpClient``, the one with the longest output
   cancelled by DELETE after its fourth token: every other stream
   finishes with all its tokens, the cancelled request holds no page when
   the DELETE is answered, ``/v1/stats`` reports one readback per round,
   #1 and #2 launch 28 x their dispatches, and the pool is whole after
   ``request_stop``'s drain. Prints each request's client-side TTFT and
   tokens per second beside an in-process run of the same requests, and
   how many streams equal the in-process ones (bf16 streams depend on the
   batch); the smoke config in fp32 must give the in-process streams.
13. the router: two full-width llama3.2-3b replicas (one parameter tree)
   behind the prefix-affine ``EngineRouter`` and HTTP, two groups of four
   conversations from ``make_shared_prefix_workload`` and a
   ``multiturn_followup`` turn of each: every stream completes, each
   follow-up lands on its conversation's replica unless spilled, the
   directory and that replica's prefix cache hit, both pools are whole
   after the drain; the same traffic under round-robin, with its hits.
14. seamless-m4t-large-v2 at full width (bf16, 24 encoder and 24 decoder
   layers, every published width, random weights from a seed): B 4, 1024
   encoder frames, 128-token prompts, ``prefill`` and 32 greedy
   ``decode_step``s; #5 launches 24 + 48 at prefill and 24 a decode step;
   a traced repeat gives #5's device time, prefill and decode apart, and
   the run its peak memory.
15. training. (a) Every arch's smoke config (fp32, TF32 off; patch
   embeddings and encoder frames from a seed) under remat "full": the
   loss and every gradient leaf on the card against the same port code on
   the CPU (the loss to ``2e-5 + 2e-5 * |ref|``, each leaf to ``1e-4 *
   max|g_ref|``), every gradient finite, the global norm above 0; the
   forward launches #5/#6/#7 once per attention (self, cross, encoder,
   MLA, MTP), Mamba and mLSTM call and runs no plain version, the
   backward launches each once more (the recompute) and runs each plain
   version once (its gradient, through the kernel's
   ``autograd.Function``). (b) The smoke llama3.2-3b under
   ``TrainingSupervisor`` with a failure injected at step 5: one restart,
   every loss equal to an uninterrupted run's, and a checkpoint written on
   the card restores on the CPU bit for bit. Then each kernel's forward
   and its plain backward timed alone (#5 at llama3.2-3b's training layer,
   #6 and #7 at B1 S2048), and the bf16 gradient witness: llama3.2-3b at
   full width cut to 4 layers, its bf16 loss and gradients against the
   same weights in fp32 (the loss to 1e-2 relative, each leaf to 0.05 of
   its fp32 norm). (c) Full-width llama3.2-3b (bf16, nothing cut),
   B 2 x S 2048 from ``PackedSyntheticData``, remat "full", six AdamW
   steps on one batch: finite losses, the first within ln(V) + 3, the last
   below the first, #5 56 launches a step; the step time, tokens a second,
   6 N tokens / step time as a share of 989 TFLOP/s, the peak memory, and
   a traced step.
16. sharded paged serving on the one card (``tools/sharded_phase.py``):
   worlds of 1-4 spawned ranks over the serving mesh ``"W"`` (world 1's
   data plane NCCL; worlds 2-4 share the card, which NCCL refuses, so
   gloo). (a) Smoke llama3.2-3b (fp32, Hkv 2) and an 8-KV-head variant at
   worlds 1-4: the driver's greedy tokens equal the mesh-less engine's on
   the card, one readback per round, the pool whole, every rank's
   dispatches the driver's; spec_k 4 at world 3. (b) #1 and #2 at
   llama3.2-3b's heads (bf16) on phase 3's cases at world 2 (heads) and 3
   (sequence, ``partial=True``) against the plain version at phase 3's
   limit, an empty shard's state (0, -1e30, 0), the kernel's time alone,
   the collectives' alone and the whole op's. (c) Full-width llama3.2-3b
   with ``cut_workload``'s part of phase 5's requests and its pool at
   worlds 2 and 3: every request
   finishes, #1/#2 launch 28 x each rank's dispatches (counters read
   through the control plane), the backend, tokens/s, round time and the
   control plane's cost a dispatch.
17. sharded training on the one card (``tools/train_sharded_phase.py``;
   gloo between ranks that share it). (a) Every slice arch's smoke config
   (fp32) at world 4, mesh ``2x2``: one AdamW step's loss, gradient norm
   and first moment against the card's world-1 step (the dense archs) or
   the CPU's world-4 step (the expert-parallel qwen2-moe and jamba), at
   phase 15's limits; #5/#6/#7 twice a layer on every rank, no plain
   version forward. (b) Full-width llama3.2-3b (bf16), phase 15's weights
   and batch, tensor-parallel at mesh ``2``: one step, its loss
   within 1e-2 of phase 15's, #5 56 launches a step on each rank; step
   time, tokens/s, each rank's peak memory, collectives a step. (c)
   qwen2-moe-a2.7b at published widths cut to 4 layers, expert-parallel
   at mesh ``2``: two steps, finite losses, the last below the first;
   the tokens dropped by capacity and the ``all_to_all`` time a step.
18. every arch on a mesh, and the dry run (``tools/mesh_all_phase.py``;
   gloo between ranks that share the card). (a) World 4: one AdamW step of
   deepseek-v3 (MLA, MTP, EP), seamless-m4t and internvl2 at ``2x2`` and
   smoke llama with half a query head a rank at ``4``, against the card's
   world-1 step at phase 15's limits, #5/#6/#7 twice a layer a rank; every
   arch's prefill + 4 greedy decode steps at ``2x2`` with the world-1
   card's tokens. (b) Mesh ``2``: full-width seamless-m4t, one training
   step (step time, tokens/s, each rank's peak); the 4-layer deepseek-v3
   cut, prefill 2 x 512 and 32 decode steps (each rank's peak, ms a step,
   #5 launches, the ``combine_partials`` time). (c) ``launch/dryrun.py``'s
   cells on this torch, and the roofline's memory and model flops for
   phase 15 (c)'s step beside its measured peak.
19. ZeRO-3 parameters (``fsdp``) and the wide data-parallel batch
   (``wide_dp``) (``tools/fsdp_phase.py``; gloo between ranks that share
   the card). (a) World 4, mesh ``2x2``, fp32 smoke configs, one AdamW
   step each: llama3.2-3b, jamba and deepseek-v3 with the parameters and
   AdamW's state at ``param_specs(..., fsdp=True)``'s slices, against the
   card's world-1 step (llama) or the CPU's world-4 step (the
   expert-parallel archs) at phase 15's limits, every leaf still at its
   local shape after the step, #5/#6/#7 twice a layer a rank; xlstm-125m
   with a row a rank on ``("data", "model")`` against world 1; llama and
   jamba under ``fsdp``: prefill + 4 greedy decode steps with the world-1
   card's tokens. (b) Full-width llama3.2-3b (bf16) at mesh ``2x1`` under
   ``fsdp``, phase 15's weights and batch, a row a rank, each rank capped
   at half the card: one step, its loss within 1e-2 of phase
   15's, #5 56 launches a step a rank; step time, tokens/s, each rank's
   peak beside a ZeRO-1 step's (or its out-of-memory error), the
   all-gather and reduce-scatter time a step. (c) The dry run with
   ``--fsdp`` for deepseek-v3 ``train_4k`` at 16x16: the traced peak and
   ``analytic_memory_bytes`` beside the figures without it. The dry runs
   of phases 18 (c) and 19 (c) need only the host: each runs in a process
   of its own from phase 16 on, beside the phases that use the card.
20. the port's serving examples (``tools/examples_phase.py``): (a) in
   process at their smoke sizes (fp32), each under its example's checks
   (the reference's assertions): ``examples/serve_streaming_torch.py``'s
   streaming demo paged and slot, ``--shared-prefix``, ``--spec-k 4``
   greedy and sampled, and ``examples/serve_slo_engine_torch.py``; the
   demo, shared-prefix and greedy speculation streams equal the CPU's;
   #1/#2 (#5 in slot mode) launch once a layer a dispatch. (b) The demo,
   ``--shared-prefix`` and ``--spec-k 4`` at mesh ``2`` over two ranks
   sharing the card (gloo): (a)'s streams, every check, each rank's
   launches. (c) ``examples/router_smoke_torch.py`` as a subprocess,
   beside (a) and (b): its five checks and exit code 0. (d) Full-width
   llama3.2-3b (bf16, phase 5's seed-0 weights): the demo and the
   shared-prefix scenario, with what bf16 leaves intact (one readback a
   round, no leaked page, the cancelled stream aborted, prefix hits and
   fewer prefill tokens computed) and the cache-on/off stream agreement
   printed as a count.

The traces are summarised in one pass over the profiler's raw events;
each also lists the device time and count of every port kernel in it (the
combine included).

The last lines are a ``{"kernels": [...]}`` JSON object, the card's name
and power limit, and ``{"ok": true, "device": {...}}``. Per-case numbers go
to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import asyncio
import atexit
import contextlib
import gc
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PAGE = 16
DEVICE = "cuda"


def device_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int) -> float:
    """Device time per call of ``fn``: the durations of the device events
    (kernels, copies) that ``iters`` calls leave in a ``torch.profiler``
    trace, summed and divided by ``iters``. Unlike ``cuda_ms`` it leaves out
    the host's path and the device's idle time between the calls, so a
    kernel under about 0.1 ms is seen apart from its wrapper."""
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    with profiler(torch) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ns = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA)
    return ns / iters / 1e6


def cold_device_ms(torch, fn, iters, match):
    """Device time per call of the kernels of ``fn`` whose names hold
    ``match``, with the 50 MB L2 flushed before each call (a 128 MB buffer
    written), as a caller finds its operands that the layers in between
    have evicted; ``device_ms``'s repeated calls find them in the L2."""
    from torch.autograd import DeviceType
    buf = torch.empty(32 << 20, dtype=torch.float32, device=DEVICE)
    fn()
    torch.cuda.synchronize()
    with profiler(torch) as prof:
        for _ in range(iters):
            buf.zero_()
            fn()
        torch.cuda.synchronize()
    ns = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA and match in e.name())
    return ns / iters / 1e6


def kernel_device_ms(torch, fn, iters, match):
    """Device time per call of each kernel of ``fn`` whose name holds
    ``match`` (a profiler trace of ``iters`` calls), by the kernel's name
    without its namespace, template arguments and parameters: the time of
    each pass of a launch that runs several kernels."""
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    with profiler(torch) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and match in e.name():
            name = e.name().replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].split()[-1]
            out[name] = out.get(name, 0.0) + e.duration_ns() / iters / 1e6
    return out


def vec_limit(want, dtype_name):
    """Elementwise limit of an output or accumulator whose last axis is the
    head dim, for a case whose inputs are in ``dtype_name``: 2e-5 +
    2e-5*|want| in fp32; in bf16 one rounding step of the element
    (2**-7*|want|) plus 0.05 x the RMS of its D-vector."""
    w = want.float()
    if dtype_name == "float32":
        return 2e-5 + 2e-5 * w.abs()
    rms = w.square().mean(dim=-1, keepdim=True).sqrt()
    return 2.0 ** -7 * w.abs() + 0.05 * rms


def check(what, got, want, limit, mask=None):
    """Raise unless |got - want| <= limit at every (masked) element;
    return max |got - want| and max |got - want| / limit there."""
    import torch
    diff = (got.float() - want.float()).abs()
    limit = torch.broadcast_to(torch.as_tensor(limit, device=diff.device),
                               diff.shape)
    if mask is not None:
        diff, limit = diff[mask], limit[mask]
    diff, limit = diff.reshape(-1), limit.reshape(-1)
    if diff.numel() and not bool(torch.isfinite(diff).all()):
        raise AssertionError(f"{what}: non-finite values")
    bad = diff > limit
    if bool(bad.any()):
        i = int(bad.nonzero()[0, 0])
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {diff.numel()} elements past the "
            f"limit; first |got - want| {float(diff[i]):.3e} > "
            f"{float(limit[i]):.3e}; max {float(diff.max()):.3e}")
    if not diff.numel():
        return 0.0, 0.0
    return float(diff.max()), float((diff / limit).max())


def ml_limits(want_m, want_l):
    """Limits of the partial state's row max m and row sum l (fp32)."""
    return 1e-3 + 1e-5 * want_m.abs(), 1e-4 * want_l.abs()


class Cases:
    """Kernel parity cases: runs, checks, times and records each one."""

    def __init__(self, torch):
        self.torch = torch
        self.rows = []
        self.gen = torch.Generator(device=DEVICE).manual_seed(1234)

    def randn(self, shape, dtype):
        return self.torch.randn(shape, generator=self.gen, device=DEVICE,
                                dtype=self.torch.float32).to(dtype)

    def pool_and_tables(self, lens, n, Hkv, D, dtype, ps=PAGE):
        """A pool of ps-key pages holding every row's pages at random
        places, and tables zero-padded past each row's last page, as the
        engine builds them."""
        torch = self.torch
        need = [max(math.ceil(int(x) / ps), 0) for x in lens]
        P = max(sum(need), 1) + 1
        perm = torch.randperm(P, generator=self.gen, device=DEVICE)
        bt = torch.zeros((len(lens), n), dtype=torch.int32, device=DEVICE)
        off = 0
        for i, k in enumerate(need):
            bt[i, :k] = perm[off:off + k].to(torch.int32)
            off += k
        kv = self.randn((Hkv, P, 2, ps, D), dtype)
        return kv, bt, need

    def record(self, row):
        self.rows.append(row)
        print(f"  {row['kernel']:<24} {row['case']:<44} err {row['max_abs_err']:.3e} "
              f"({row['limit_share']:.3f} of limit) ms {row['ms']:.4f} plain {row['plain_ms']:.3f} "
              f"lib {row['library_ms']} bound {row['bound_ms']:.4f} "
              f"({row['bound_by']})", flush=True)


def gathered(torch, kv, bt, G):
    """K, V of each row's pages, heads expanded for GQA: [B, H, n*ps, D]."""
    from repro_torch.kernels import ref_common as rc
    k_pages, v_pages = rc.split_fused(kv)
    k = rc.gather_seq(k_pages, bt).repeat_interleave(G, dim=1)
    v = rc.gather_seq(v_pages, bt).repeat_interleave(G, dim=1)
    return k, v


def bound(nbytes, flops, dtype_name):
    t_b = nbytes / HBM_BYTES_PER_S
    t_f = flops / PEAK_FLOPS[dtype_name]
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def work_bound(work):
    """``bound`` of a kernel's ``cost(...)`` (``kernels/cost.py``)."""
    return bound(work.bytes, work.flops, work.dtype)


def decode_yardsticks(cs, q, kv, bt, lens_t, need, G, D, window, softcap,
                      iters):
    """A decode case's library time (``scaled_dot_product_attention`` on
    the gathered pages, without window or softcap; else None) and its
    bound: q and out once, each row's live pages once per kv head."""
    torch = cs.torch
    lib = None
    if window == 0 and softcap == 0.0:
        k, v = gathered(torch, kv, bt, G)
        mask = (torch.arange(k.shape[2], device=DEVICE)[None, :]
                < lens_t[:, None])[:, None, None, :]
        qs = q[:, :, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = round(cuda_ms(torch, lambda: sdpa(qs, k, v, attn_mask=mask,
                                                scale=D ** -0.5), iters), 5)
        del k, v
    from repro_torch.kernels.paged_attention.kernel import cost
    B, H, _ = q.shape
    return (lib, *work_bound(cost(B, H, H // G, D, kv.shape[3], bt.shape[1],
                                  q.dtype, lens_t.tolist())))


@contextlib.contextmanager
def fixed_splits(module, plan, n):
    """The wrappers of kernel module ``module`` launch n key splits inside
    this block: their plan, the function ``module.<plan>``, is replaced
    for the duration (the chunked launcher still cuts n to the chunk's key
    tiles // 2)."""
    saved = getattr(module, plan)
    setattr(module, plan, lambda *args: n)
    try:
        yield
    finally:
        setattr(module, plan, saved)


def split_timings(cs, name, run, want, dn, splits, iters, module,
                  mask=None):
    """A split-K case's time a call with CUDA events around the wrapper
    calls (``ms``) and from a profiler trace (``device_ms``), the same at
    one split when the plan splits the keys (checked first; the plan is
    ``module.planned_splits``), and a check after the timing loops (a
    split merge's tickets must be left zero); ``mask`` picks the checked
    outputs."""
    torch = cs.torch
    t = {"splits": splits, "ms": cuda_ms(torch, run, iters),
         "device_ms": device_ms(torch, run, iters)}
    if splits > 1:
        with fixed_splits(module, "planned_splits", 1):
            check(f"{name}: 1 split", run(), want, vec_limit(want, dn), mask)
            t.update(ms_other=cuda_ms(torch, run, iters),
                     device_ms_other=device_ms(torch, run, iters),
                     splits_other=1)
    check(f"{name}: after timing", run(), want, vec_limit(want, dn), mask)
    other = (f"; 1 split: {t['ms_other']:.4f} ms, device "
             f"{t['device_ms_other']:.4f} ms" if splits > 1 else "")
    print(f"    {splits} key splits: {t['ms']:.4f} ms, device "
          f"{t['device_ms']:.4f} ms{other}")
    return t


def decode_case(cs, name, B, lens, dtype, window=0, softcap=0.0, G=3, Hkv=8,
                D=128, iters=20, ps=PAGE):
    torch = cs.torch
    from repro_torch.kernels.paged_attention import kernel as PK
    from repro_torch.kernels.paged_attention.kernel import (
        paged_attention_fused, planned_splits)
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_fused_ref, paged_attention_partial_ref)
    from repro_torch.kernels import ref_common as rc
    dn = str(dtype).split(".")[-1]
    lens_t = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
    n = 1 << max(math.ceil(max(lens) / ps) - 1, 0).bit_length()
    kv, bt, need = cs.pool_and_tables(lens, n, Hkv, D, dtype, ps)
    q = cs.randn((B, Hkv * G, D), dtype)
    kw = dict(scale=D ** -0.5, window=window, softcap=softcap)
    got = paged_attention_fused(q, kv, bt, lens_t, **kw)
    want = paged_attention_fused_ref(q, kv, bt, lens_t, **kw)
    torch.cuda.synchronize()
    err, share = check(f"decode {name}", got, want, vec_limit(want, dn))
    # partial mode: finalize == full, the state (acc, m, l) == the plain
    # version's, and two key halves at shard-local (partly negative)
    # lengths combine to the whole
    acc, m, l = paged_attention_fused(q, kv, bt, lens_t, partial=True, **kw)
    check(f"decode {name}: finalize(partial)",
          rc.finalize_partials(acc, l, q.dtype), want, vec_limit(want, dn))
    racc, rm, rl = paged_attention_partial_ref(q, kv, bt, lens_t, **kw)
    m_lim, l_lim = ml_limits(rm, rl)
    check(f"decode {name}: partial m", m, rm, m_lim)
    check(f"decode {name}: partial l", l, rl, l_lim)
    check(f"decode {name}: partial acc", acc, racc, vec_limit(racc, dn))
    h = n // 2
    if h and window == 0:
        p1 = paged_attention_fused(q, kv, bt[:, :h].contiguous(), lens_t,
                                   partial=True, **kw)
        p2 = paged_attention_fused(q, kv, bt[:, h:].contiguous(),
                                   lens_t - h * ps, partial=True, **kw)
        check(f"decode {name}: partial combine",
              rc.combine_partials([p1, p2], q.dtype), want,
              vec_limit(want, dn))
    t = split_timings(cs, f"decode {name}",
                      lambda: paged_attention_fused(q, kv, bt, lens_t, **kw),
                      want, dn, planned_splits(q, bt, Hkv, ps), iters, PK)
    plain = cuda_ms(torch, lambda: paged_attention_fused_ref(
        q, kv, bt, lens_t, **kw), 3, warmup=1)
    lib, b_ms, b_by = decode_yardsticks(cs, q, kv, bt, lens_t, need, G, D,
                                        window, softcap, iters)
    cs.record({"kernel": "paged_attention_fused", "case": name, "dtype": dn,
               "max_abs_err": err, "limit_share": share, **t,
               "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
               "bound_by": b_by, "page_size": ps,
               **decode_block(dtype, D, ps)})


def expect_block(cs, block):
    """Raise unless the last recorded decode case ran ``block``."""
    row = cs.rows[-1]
    if row["block"] != block:
        raise AssertionError(f"decode {row['case']}: ran the {row['block']} "
                             f"block, not the {block} one")


def decode_block(dtype, D, ps):
    """Which block of the decode library a case ran ("wgmma": the
    tensor-core block, with its attributes; "scalar" otherwise), as the
    launcher chooses it from the shapes."""
    from repro_torch.kernels.paged_attention import kernel as PK
    attr = PK.wgmma_attributes(dtype, D, ps)
    if attr is None:
        return {"block": "scalar"}
    return {"block": "wgmma", **{k: attr[k] for k in (
        "registers", "spill_bytes", "smem_bytes", "blocks_per_sm")}}


def mma_info(kernel, dtype, D, Dv=None):
    """A bf16 case's kernel attributes (``build.mma_attributes``: registers,
    spill bytes, shared memory, resident blocks an SM); none for fp32."""
    import torch
    if dtype != torch.bfloat16:
        return {}
    from repro_torch.kernels import build
    a = build.mma_attributes(kernel, D, Dv)
    return {k: a[k] for k in ("registers", "spill_bytes", "smem_bytes",
                              "blocks_per_sm")}


def prefill_yardsticks(cs, q, kv, bt, pos, lens, G, D, window, softcap,
                       iters):
    """A prefill case's library time (``scaled_dot_product_attention`` on
    the gathered pages with an explicit mask, without window or softcap;
    else None) and its bound: q and out once, each row's live pages once
    per kv head; flops of the (query, key) pairs the masks leave."""
    torch = cs.torch
    R, Sq, Hkv = q.shape[:3]
    n = bt.shape[1]
    pos_t = torch.tensor(pos, dtype=torch.int32, device=DEVICE)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
    lib = None
    if window == 0 and softcap == 0.0:
        k, v = gathered(torch, kv, bt, G)
        kpos = torch.arange(k.shape[2], device=DEVICE)
        qpos = pos_t[:, None] + torch.arange(Sq, device=DEVICE)[None]
        mask = ((kpos[None, None] <= qpos[:, :, None])
                & (kpos[None, None] < lens_t[:, None, None]))[:, None]
        qs = q.reshape(R, Sq, Hkv * G, D).transpose(1, 2)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = round(cuda_ms(torch, lambda: sdpa(qs, k, v, attn_mask=mask,
                                                scale=D ** -0.5), iters), 5)
        del k, v
    from repro_torch.kernels.paged_prefill_attention.kernel import cost
    return (lib, *work_bound(cost(R, Sq, Hkv, G, D, PAGE, n, q.dtype, pos,
                                  lens, window)))


def prefill_case(cs, name, pos, lens, Sq, dtype, window=0, softcap=0.0, G=3,
                 Hkv=8, D=128, iters=10, partial_split=False):
    torch = cs.torch
    from repro_torch.kernels.paged_prefill_attention import kernel as PPK
    from repro_torch.kernels.paged_prefill_attention.kernel import (
        paged_prefill_attention_fused)
    from repro_torch.kernels.paged_prefill_attention.ref import (
        paged_prefill_attention_fused_ref, paged_prefill_attention_partial_ref)
    from repro_torch.kernels import ref_common as rc
    dn = str(dtype).split(".")[-1]
    R = len(pos)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=DEVICE)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
    n = 1 << max(math.ceil(max(lens) / PAGE) - 1, 0).bit_length()
    kv, bt, _ = cs.pool_and_tables(lens, n, Hkv, D, dtype)
    q = cs.randn((R, Sq, Hkv, G, D), dtype)
    valid = ((pos_t[:, None] + torch.arange(Sq, device=DEVICE)[None])
             < lens_t[:, None])
    kw = dict(scale=D ** -0.5, window=window, softcap=softcap)
    got = paged_prefill_attention_fused(q, kv, bt, pos_t, lens_t, **kw)
    want = paged_prefill_attention_fused_ref(q, kv, bt, pos_t, lens_t, **kw)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"prefill {name}: non-finite output")
    err, share = check(f"prefill {name}", got, want, vec_limit(want, dn),
                       valid)
    acc, m, l = paged_prefill_attention_fused(q, kv, bt, pos_t, lens_t,
                                              partial=True, **kw)
    check(f"prefill {name}: finalize(partial)",
          rc.finalize_partials(acc, l, q.dtype), want, vec_limit(want, dn),
          valid)
    if partial_split:
        # the second half of each table at shard-local (negative) positions
        h = n // 2
        off = h * PAGE
        a2 = (q, kv, bt[:, h:].contiguous(), pos_t - off, lens_t - off)
        k_acc, k_m, k_l = paged_prefill_attention_fused(*a2, partial=True, **kw)
        r_acc, r_m, r_l = paged_prefill_attention_partial_ref(*a2, **kw)
        live = r_m > rc.NEG_INF / 2
        if not bool(live.any()) or int(pos_t.min()) - off >= 0:
            raise AssertionError(f"prefill {name}: split has no negative rows")
        m_lim, l_lim = ml_limits(r_m, r_l)
        check(f"prefill {name}: partial m", k_m, r_m, m_lim, live)
        check(f"prefill {name}: partial l", k_l, r_l, l_lim, live)
        check(f"prefill {name}: partial acc", k_acc, r_acc,
              vec_limit(r_acc, dn), live)
        p1 = paged_prefill_attention_fused(q, kv, bt[:, :h].contiguous(),
                                           pos_t, lens_t, partial=True, **kw)
        check(f"prefill {name}: combine",
              rc.combine_partials([p1, (k_acc, k_m, k_l)], q.dtype), want,
              vec_limit(want, dn), valid)
    t = split_timings(cs, f"prefill {name}", lambda:
                      paged_prefill_attention_fused(q, kv, bt, pos_t, lens_t,
                                                    **kw),
                      want, dn, PPK.planned_splits(q, bt, PAGE), iters, PPK,
                      valid)
    plain = cuda_ms(torch, lambda: paged_prefill_attention_fused_ref(
        q, kv, bt, pos_t, lens_t, **kw), 2, warmup=1)
    lib, b_ms, b_by = prefill_yardsticks(cs, q, kv, bt, pos, lens, G, D,
                                         window, softcap, iters)
    cs.record({"kernel": "paged_prefill_attention_fused", "case": name,
               "dtype": dn, "max_abs_err": err, "limit_share": share, **t,
               "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
               "bound_by": b_by,
               **mma_info("paged_prefill_attention", dtype, D)})


def split_pools(kv):
    """The fused pool's K and V planes as two contiguous [Hkv, P, ps, D]
    pools, holding the same keys."""
    from repro_torch.kernels import ref_common as rc
    k, v = rc.split_fused(kv)
    return k.contiguous(), v.contiguous()


def split_decode_case(cs, name, B, lens, dtype, window=0, softcap=0.0, G=3,
                      Hkv=8, D=128, iters=20, ps=PAGE):
    """#3: decode over split K and V pools, against its plain version and
    against the fused kernel on the same keys (the pool split in two)."""
    torch = cs.torch
    from repro_torch.kernels.paged_attention import kernel as PK
    from repro_torch.kernels.paged_attention.kernel import (
        paged_attention, paged_attention_fused, planned_splits)
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    dn = str(dtype).split(".")[-1]
    lens_t = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
    n = 1 << max(math.ceil(max(lens) / ps) - 1, 0).bit_length()
    kv, bt, need = cs.pool_and_tables(lens, n, Hkv, D, dtype, ps)
    kp, vp = split_pools(kv)
    q = cs.randn((B, Hkv * G, D), dtype)
    kw = dict(scale=D ** -0.5, window=window, softcap=softcap)
    got = paged_attention(q, kp, vp, bt, lens_t, **kw)
    want = paged_attention_ref(q, kp, vp, bt, lens_t, **kw)
    fused = paged_attention_fused(q, kv, bt, lens_t, **kw)
    torch.cuda.synchronize()
    err, share = check(f"split decode {name}", got, want, vec_limit(want, dn))
    t = split_timings(cs, f"split decode {name}",
                      lambda: paged_attention(q, kp, vp, bt, lens_t, **kw),
                      want, dn, planned_splits(q, bt, Hkv, ps), iters, PK)
    plain = cuda_ms(torch, lambda: paged_attention_ref(
        q, kp, vp, bt, lens_t, **kw), 3, warmup=1)
    lib, b_ms, b_by = decode_yardsticks(cs, q, kv, bt, lens_t, need, G, D,
                                        window, softcap, iters)
    cs.record({"kernel": "paged_attention", "case": name, "dtype": dn,
               "max_abs_err": err, "limit_share": share, **t,
               "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
               "bound_by": b_by, "same_as_fused": bool(torch.equal(got, fused)),
               "page_size": ps, **decode_block(dtype, D, ps)})
    print(f"    bit-identical to the fused kernel: {cs.rows[-1]['same_as_fused']}")
    if not cs.rows[-1]["same_as_fused"]:
        raise AssertionError(f"split decode {name}: not bit-identical to the "
                             f"fused kernel on the same keys")


def split_prefill_case(cs, name, pos, lens, Sq, dtype, window=0, softcap=0.0,
                       G=3, Hkv=8, D=128, iters=10):
    """#4: prefill over split K and V pools (any Sq), against its plain
    version and against the fused kernel on the same keys."""
    torch = cs.torch
    from repro_torch.kernels.paged_prefill_attention import kernel as PPK
    from repro_torch.kernels.paged_prefill_attention.kernel import (
        paged_prefill_attention, paged_prefill_attention_fused)
    from repro_torch.kernels.paged_prefill_attention.ref import (
        paged_prefill_attention_ref)
    dn = str(dtype).split(".")[-1]
    R = len(pos)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=DEVICE)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
    n = 1 << max(math.ceil(max(lens) / PAGE) - 1, 0).bit_length()
    kv, bt, _ = cs.pool_and_tables(lens, n, Hkv, D, dtype)
    kp, vp = split_pools(kv)
    q = cs.randn((R, Sq, Hkv, G, D), dtype)
    valid = ((pos_t[:, None] + torch.arange(Sq, device=DEVICE)[None])
             < lens_t[:, None])
    kw = dict(scale=D ** -0.5, window=window, softcap=softcap)
    args = (q, kp, vp, bt, pos_t, lens_t)
    got = paged_prefill_attention(*args, **kw)
    want = paged_prefill_attention_ref(*args, **kw)
    fused = paged_prefill_attention_fused(q, kv, bt, pos_t, lens_t, **kw)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"split prefill {name}: non-finite output")
    err, share = check(f"split prefill {name}", got, want, vec_limit(want, dn),
                       valid)
    if not torch.equal(got, fused):
        raise AssertionError(f"split prefill {name}: not bit-identical to the "
                             f"fused kernel on the same keys")
    t = split_timings(cs, f"split prefill {name}",
                      lambda: paged_prefill_attention(*args, **kw), want, dn,
                      PPK.planned_splits(q, bt, PAGE), iters, PPK, valid)
    plain = cuda_ms(torch, lambda: paged_prefill_attention_ref(*args, **kw), 2,
                    warmup=1)
    lib, b_ms, b_by = prefill_yardsticks(cs, q, kv, bt, pos, lens, G, D,
                                         window, softcap, iters)
    cs.record({"kernel": "paged_prefill_attention", "case": name, "dtype": dn,
               "max_abs_err": err, "limit_share": share, **t,
               "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
               "bound_by": b_by, "same_as_fused": bool(torch.equal(got, fused)),
               **mma_info("paged_prefill_attention", dtype, D)})
    print(f"    bit-identical to the fused kernel: {cs.rows[-1]['same_as_fused']}")


def split_cases(cs, main_lens):
    """#3/#4 at the llama3.2-3b shapes: the serving-like decode batch and the
    R4 Sq512 prefill in bf16, window + softcap in fp32, decode on the scalar
    block in bf16 (head_dim 48), and a chunk length the TPU kernel's q
    tiling would refuse (Sq 100)."""
    torch = cs.torch
    bf, f32 = torch.bfloat16, torch.float32
    split_decode_case(cs, "B8 serving-like ctx bf16", 8, main_lens, bf)
    split_decode_case(cs, "B8 window1000 softcap30 fp32", 8,
                      [4096, PAGE, PAGE - 3, 4096 - PAGE // 2, 2500, 900,
                       1700, 3333], f32, window=1000, softcap=30.0)
    split_decode_case(cs, "B3 D48 bf16", 3, [500, 16, 33], bf, G=2, Hkv=4,
                      D=48)
    expect_block(cs, "scalar")
    split_prefill_case(cs, "R4 Sq512 bf16", [0, 1000, 1029, 0],
                       [512, 1509, 1541, 0], 512, bf)
    split_prefill_case(cs, "R4 Sq128 window300 softcap30 fp32",
                       [0, 500, 900, 0], [128, 620, 1028, 0], 128, f32,
                       window=300, softcap=30.0)
    split_prefill_case(cs, "R2 Sq100 bf16", [37, 700], [137, 790], 100, bf)


SLOT_LEN = 4096      # the slot row of the full-width slot phase (max_len)


def chunked_case(cs, name, Sq, q_offset, lengths, dtype, causal=True,
                 window=0, softcap=0.0, H=24, Hkv=8, D=128, Sk=SLOT_LEN,
                 iters=10, other_splits=None, Dv=None, scale=None):
    """q as the model passes it (a [B, H, Sq, D] view of the kv-major
    [B, Sq, H, D] projections) over k/v as the slot engine passes them
    (views of a [B, Sk, Hkv, D] slot cache). With ``Dv`` (MLA) the values
    are Dv wide and, as ``mla_block`` passes them, the second half of each
    head's [B, Sk, H, 2 * Dv] expanded row, read in place; ``scale``
    defaults to D**-0.5. A bf16 case whose plan splits
    the keys is also checked and timed with one split, and one that the
    plan keeps whole with ``other_splits`` splits when given
    (``fixed_splits``); each timing with CUDA events around the wrapper
    calls (``ms``) and as device time (``device_ms``)."""
    torch = cs.torch
    from repro_torch.kernels.chunked_prefill_attention import kernel as CK
    from repro_torch.kernels.chunked_prefill_attention.kernel import (
        chunked_prefill_attention, planned_splits)
    from repro_torch.kernels.chunked_prefill_attention.ref import (
        chunked_prefill_attention_ref)
    dn = str(dtype).split(".")[-1]
    B, G = len(lengths), H // Hkv
    q = cs.randn((B, Sq, H, D), dtype).permute(0, 2, 1, 3)
    if Dv is None:
        Dv = D
        cache = cs.randn((2, B, Sk, Hkv, D), dtype)
        k, v = cache[0].permute(0, 2, 1, 3), cache[1].permute(0, 2, 1, 3)
    else:
        k = cs.randn((B, Sk, Hkv, D), dtype).permute(0, 2, 1, 3)
        v = cs.randn((B, Sk, Hkv, 2 * Dv), dtype)[..., Dv:].permute(
            0, 2, 1, 3)
    lens_t = torch.tensor(lengths, dtype=torch.int32, device=DEVICE)
    scale = D ** -0.5 if scale is None else scale
    kw = dict(scale=scale, q_offset=q_offset, causal=causal,
              window=window, softcap=softcap)
    splits = planned_splits(q, k, v, q_offset=q_offset, causal=causal,
                            window=window)
    got = chunked_prefill_attention(q, k, v, lens_t, **kw)
    want = chunked_prefill_attention_ref(q, k, v, lens_t, **kw)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"chunked {name}: non-finite output")
    # the keys each query sees, [B, Sq, Sk]
    qp = q_offset + torch.arange(Sq, device=DEVICE)[None, :, None]
    kp = torch.arange(Sk, device=DEVICE)[None, None, :]
    vis = kp < lens_t[:, None, None]
    if causal:
        vis = vis & (kp <= qp)
    if window > 0:
        vis = vis & (qp - kp < window)
    vis = vis.expand(B, Sq, Sk)     # every query row, causal or not
    valid = vis.any(-1)[:, None, :, None].expand(B, H, Sq, Dv)
    err, share = check(f"chunked {name}", got, want, vec_limit(want, dn),
                       valid)
    def run():
        return chunked_prefill_attention(q, k, v, lens_t, **kw)
    ms = cuda_ms(torch, run, iters)
    dev = device_ms(torch, run, iters)
    other = {}
    n_other = 1 if splits > 1 else other_splits
    if n_other:
        with fixed_splits(CK, "split_plan", n_other):
            check(f"chunked {name}: {n_other} splits", run(), want,
                  vec_limit(want, dn), valid)
            other = {"splits_other": n_other,
                     "ms_other": cuda_ms(torch, run, iters),
                     "device_ms_other": device_ms(torch, run, iters)}
    plain = cuda_ms(torch, lambda: chunked_prefill_attention_ref(
        q, k, v, lens_t, **kw), 2, warmup=1)
    kr = k.repeat_interleave(G, dim=1)
    vr = v.repeat_interleave(G, dim=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = vis[:, None]
    try:     # a value width of its own (Ev != E) where the library takes it
        lib = round(cuda_ms(torch, lambda: sdpa(
            q, kr, vr, attn_mask=mask, scale=scale), iters), 5)
    except RuntimeError as e:
        print(f"    scaled_dot_product_attention refused the case: {e}")
        lib = None
    del kr, vr
    work = CK.cost(B, H, Hkv, Sq, Sk, D, Dv, dtype, lengths, q_offset, causal,
                   window)
    b_ms, b_by = work_bound(work)
    cs.record({"kernel": "chunked_prefill_attention", "case": name,
               "dtype": dn, "max_abs_err": err, "limit_share": share,
               "ms": ms, "plain_ms": plain, "library_ms": lib,
               "bound_ms": b_ms, "bound_by": b_by, "flops": work.flops,
               "keys_attended": int(vis.any(1).sum()), "splits": splits,
               "device_ms": dev, **other,
               **mma_info("chunked_prefill_attention", dtype, D, Dv)})
    if other:
        print(f"    {splits} key splits: {ms:.4f} ms, device {dev:.4f} ms; "
              f"{n_other} splits: {other['ms_other']:.4f} ms, device "
              f"{other['device_ms_other']:.4f} ms")


# #5 cases whose plan splits the keys (short chunks at deep offsets, few
# q tiles), beside the parity phase's Sq16 off4080 and Sq128 off3968:
# (name, Sq, q_offset, lengths, H, window, softcap)
SPLIT_K_CASES = [
    ("B1 Sq37 off2500 window1000 bf16", 37, 2500, [2537], 24, 1000, 0.0),
    ("jamba H64 Sq16 off4000 bf16", 16, 4000, [4016], 64, 0, 0.0),
    ("B2 Sq64 off3000 lens 3064/2000 bf16", 64, 3000, [3064, 2000], 24, 0,
     30.0),
]


def split_k_cases(cs):
    for name, Sq, off, lens, H, window, cap in SPLIT_K_CASES:
        chunked_case(cs, name, Sq, off, lens, cs.torch.bfloat16, H=H,
                     window=window, softcap=cap)


MLA_CASE = "deepseek-v3 MLA H128 Sq512 off3584 Dqk192 Dv128 bf16"


def mla_cases(cs):
    """#5 at deepseek-v3's MLA shapes as ``mla_block`` passes them: 128
    heads, G 1, keys [k_nope | k_rope] of 192, values of 128 read in place
    from the expanded [k_nope | v] rows, scale 1/sqrt(192); a 512-token
    chunk at offset 3584 of a 4096 row (its 1024 blocks fill the card, so
    it is also checked and timed split three ways), a 100-token chunk
    carried at offset 2000, and the smoke config's (24, 16) in fp32."""
    torch = cs.torch
    bf = torch.bfloat16
    mla = dict(H=128, Hkv=128, D=192, Dv=128, scale=192 ** -0.5)
    chunked_case(cs, MLA_CASE, 512, 3584, [4096], bf, other_splits=3, **mla)
    chunked_case(cs, "deepseek-v3 MLA H128 Sq100 off2000 carried Dqk192 "
                 "Dv128 bf16", 100, 2000, [2100], bf, **mla)
    chunked_case(cs, "deepseek-v3 smoke MLA H4 Sq37 off50 Dqk24 Dv16 fp32",
                 37, 50, [87], torch.float32, H=4, Hkv=4, D=24, Dv=16,
                 Sk=256, scale=24 ** -0.5)


SEAMLESS_CROSS_DECODE = "seamless B4 cross decode Sq1 Sk1024 G1 D64 bf16"


def seamless_cases(cs):
    """#5 at seamless-m4t-large-v2's shapes (16 heads over 16 kv heads of
    64, B 4) as phase 14 calls it: the encoder over 1024 frames (not
    causal), the decoder's 128-token prefill over its own keys (causal),
    and cross attention over the 1024 encoder positions (not causal) at
    prefill (Sq 128) and at a decode step (Sq 1: one query row of a block,
    G 1)."""
    bf = cs.torch.bfloat16
    sm = dict(H=16, Hkv=16, D=64)
    chunked_case(cs, "seamless B4 encoder Sq1024 Sk1024 non-causal bf16",
                 1024, 0, [1024] * 4, bf, causal=False, Sk=1024, **sm)
    chunked_case(cs, "seamless B4 decoder prefill Sq128 causal bf16", 128, 0,
                 [128] * 4, bf, Sk=128, **sm)
    chunked_case(cs, "seamless B4 cross prefill Sq128 Sk1024 bf16", 128, 0,
                 [1024] * 4, bf, causal=False, Sk=1024, **sm)
    chunked_case(cs, SEAMLESS_CROSS_DECODE, 1, 0, [1024] * 4, bf,
                 causal=False, Sk=1024, **sm)


MLSTM_H, MLSTM_D = 4, 384     # xlstm-125m: 4 heads of 1536 / 4


def state_limits(want_c, want_n, want_m):
    """Limits of the mLSTM state: C and n 1e-5 + 1e-4*|ref|, m 1e-3 +
    1e-5*|m|."""
    return (1e-5 + 1e-4 * want_c.abs(), 1e-5 + 1e-4 * want_n.abs(),
            1e-3 + 1e-5 * want_m.abs())


def mlstm_case(cs, name, B, S, dtype, carried, H=MLSTM_H, D=MLSTM_D,
               rows=None, iters=10):
    """q, k, v as mlstm_mix passes them ([B, S, H, D] views of the
    projections), log_i a strided view of the gate projection, from a
    fresh state (C 0, n 0, m -1e30) or the state a random prefix leaves;
    ``rows`` maps batch rows to the rows of a larger state, as a slot
    decode does. Timed with CUDA events around the wrapper calls (``ms``)
    and as device time (``device_ms``, the passes' kernels summed; each
    kernel's in ``pass_ms``), also with the L2 flushed before each call
    (``device_ms_cold``)."""
    torch = cs.torch
    from repro_torch.kernels.mlstm_chunkwise.kernel import mlstm_chunkwise
    from repro_torch.kernels.mlstm_chunkwise.ref import (
        NEG_INF, mlstm_chunkwise_ref)
    dn = str(dtype).split(".")[-1]
    q = cs.randn((B, S, H * D), dtype).view(B, S, H, D)
    k = (cs.randn((B, S, H * D), dtype) / math.sqrt(D)).view(B, S, H, D)
    v = cs.randn((B, S, H * D), dtype).view(B, S, H, D)
    gates = cs.randn((B, S, 2 * H), torch.float32)
    log_i = gates[..., :H]
    log_f = torch.nn.functional.logsigmoid(gates[..., H:] + 4.0)
    Bs = B if rows is None else max(rows) + 1
    C = torch.zeros((Bs, H, D, D), device=DEVICE)
    n = torch.zeros((Bs, H, D), device=DEVICE)
    m = torch.full((Bs, H), NEG_INF, device=DEVICE)
    if carried:      # the state a 100-token prefix leaves, as in serving
        W = 100
        g = cs.randn((Bs, W, 2 * H), torch.float32)
        _, n, m = mlstm_chunkwise_ref(
            cs.randn((Bs, W, H, D), dtype),
            cs.randn((Bs, W, H, D), dtype) / math.sqrt(D),
            cs.randn((Bs, W, H, D), dtype), g[..., :H],
            torch.nn.functional.logsigmoid(g[..., H:] + 4.0), C, n, m)
    rows_t = None if rows is None else torch.tensor(rows, device=DEVICE)
    args = (q, k, v, log_i, log_f)
    C_got, C_want = C.clone(), C.clone()
    got = mlstm_chunkwise(*args, C_got, n, m, rows=rows_t)
    want = mlstm_chunkwise_ref(*args, C_want, n, m, rows=rows_t)
    torch.cuda.synchronize()
    err, share = check(f"mlstm {name}", got[0], want[0],
                       vec_limit(want[0], dn))
    idx = list(range(B)) if rows is None else rows
    c_lim, n_lim, m_lim = state_limits(C_want[idx], want[1], want[2])
    _, c_share = check(f"mlstm {name}: C", C_got[idx], C_want[idx], c_lim)
    check(f"mlstm {name}: n", got[1], want[1], n_lim)
    check(f"mlstm {name}: m", got[2], want[2], m_lim)
    others = [r for r in range(Bs) if r not in idx]
    if not torch.equal(C_got[others], C[others]):
        raise AssertionError(f"mlstm {name}: state rows outside the batch "
                             f"changed")
    def run():
        return mlstm_chunkwise(*args, C_got, n, m, rows=rows_t)
    ms = cuda_ms(torch, run, iters)
    dev = device_ms(torch, run, iters)
    cold = cold_device_ms(torch, run, iters, "mlstm_")
    passes = kernel_device_ms(torch, run, iters, "mlstm_")
    plain = cuda_ms(torch, lambda: mlstm_chunkwise_ref(
        *args, C_want, n, m, rows=rows_t), 2, warmup=1)
    from repro_torch.kernels.mlstm_chunkwise.kernel import cost, plan
    from repro_torch.kernels.mlstm_chunkwise.ref import chunk_length
    b_ms, b_by = work_bound(cost(B, S, H, D, dtype))
    cs.record({"kernel": "mlstm_chunkwise", "case": name, "dtype": dn,
               "max_abs_err": err, "limit_share": share,
               "C_limit_share": c_share, "ms": ms, "device_ms": dev,
               "device_ms_cold": cold, "pass_ms": passes,
               "kernels_a_call": plan(S, D, dtype == torch.bfloat16)[0],
               "chunk": chunk_length(dtype, S) if S > 1 else None,
               "plain_ms": plain, "library_ms": None,
               "bound_ms": b_ms, "bound_by": b_by})
    print(f"    device {dev:.4f} ms, with the L2 flushed {cold:.4f} ms; C at "
          f"{c_share:.3f} of its limit; "
          + ", ".join(f"{k} {v:.4f}" for k, v in passes.items()))


def mlstm_cases(cs):
    """#7 at the xlstm-125m shapes (H 4, D 384): the engine's fresh first
    chunks (S 2048 and S 1000 in 128-token chunks, the last of S 1000
    ragged), a batch of 4 fresh rows as the training forward passes them
    (S 300, in 64-token chunks as every S up to 512), chunks from a carried
    state (S 37, S 200 and S 512; S 200 and S 37 end inside a chunk; S 512
    also at D 96, a column box cut inside a swizzle atom), the decode of 8 of 10 slots and of 4 of 6 (S
    1, state rows permuted; the others must not change), fp32, and the
    smoke config's D 32."""
    torch = cs.torch
    from repro_torch.kernels.mlstm_chunkwise.kernel import pass_attributes
    bf, f32 = torch.bfloat16, torch.float32
    # the bf16 passes at both chunk lengths (S 2048: 128 tokens, S 200:
    # 64) at xlstm-125m's head dim: no spill
    for S in (2048, 200):
        for name, attrs in pass_attributes(S, MLSTM_D).items():
            print(f"  mlstm_chunkwise {name} pass, S {S} D {MLSTM_D}: "
                  f"{attrs}", flush=True)
            if attrs["spill_bytes"]:
                raise AssertionError(f"mlstm_chunkwise {name} pass (S {S}): "
                                     f"ptxas spilled {attrs['spill_bytes']} "
                                     f"bytes")
    mlstm_case(cs, "B1 S2048 fresh bf16", 1, 2048, bf, False, iters=5)
    mlstm_case(cs, "B1 S1000 fresh bf16", 1, 1000, bf, False, iters=5)
    mlstm_case(cs, "B1 S37 carried bf16", 1, 37, bf, True)
    mlstm_case(cs, "B1 S512 carried bf16", 1, 512, bf, True)
    mlstm_case(cs, "B4 S300 fresh bf16", 4, 300, bf, False, iters=5)
    mlstm_case(cs, "B1 S200 carried bf16", 1, 200, bf, True, iters=5)
    mlstm_case(cs, "B1 S512 carried bf16 D96", 1, 512, bf, True, D=96,
               iters=5)
    mlstm_case(cs, "B8 S1 decode carried bf16", 8, 1, bf, True,
               rows=[3, 0, 7, 1, 6, 2, 9, 4], iters=20)
    mlstm_case(cs, "B4 S1 decode carried bf16", 4, 1, bf, True,
               rows=[5, 2, 0, 3], iters=20)
    mlstm_case(cs, "B1 S512 carried fp32", 1, 512, f32, True)
    mlstm_case(cs, "B4 S100 carried fp32 D32", 4, 100, f32, True, D=32)


MAMBA_D, MAMBA_N = 16384, 16   # jamba: d_inner 2 x 8192, d_state 16


def mamba_case(cs, name, B, S, dtype, carried, d=MAMBA_D, n=MAMBA_N,
               rows=None, iters=10, lead=32):
    """x a column view of the in_proj output, as mamba_mix passes it; dt
    (softplus'd) fp32 in init_mamba's range [0.001, 0.1]; Bc and Cc column
    views of a fp32 x_proj output (``lead`` columns of dt's rank before
    them); A the S4D-real -(1..n) and D 1, as
    init_mamba draws them. From a zero state, or from the state a
    100-token prefix leaves (as in serving); ``rows`` maps batch rows to
    the rows of a larger state, as a slot decode does (the other rows must
    not change). Timed with CUDA events around the wrapper calls (``ms``)
    and as device time (``device_ms``), also with the L2 flushed before
    each call (``device_ms_cold``). Whether the new h equals the plain
    version's bit for bit is recorded (``h_bits_equal``); it must for a
    decode step (S 1), whose kernel keeps the reference's rounding (expf,
    no contraction). The chunk kernel takes ex2.approx of dt * (A log2 e)
    and updates h by one multiply-add, so its h is held to the limit
    alone."""
    torch = cs.torch
    from repro_torch.kernels.mamba_scan.kernel import mamba_scan
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
    dn = str(dtype).split(".")[-1]
    Bs = B if rows is None else max(rows) + 1

    def inputs(Bn, Sn):
        x = cs.randn((Bn, Sn, 2 * d), dtype)[..., :d]
        u = torch.rand((Bn, Sn, d), generator=cs.gen, device=DEVICE)
        dt = torch.exp(u * (math.log(0.1) - math.log(0.001))
                       + math.log(0.001))
        dbc = cs.randn((Bn, Sn, lead + 2 * n), torch.float32)
        return x, dt, dbc[..., lead:lead + n], dbc[..., lead + n:]

    A = -torch.arange(1, n + 1, dtype=torch.float32,
                      device=DEVICE).expand(d, n).contiguous()
    Dp = torch.ones((d,), device=DEVICE)
    h = torch.zeros((Bs, d, n), device=DEVICE)
    if carried:
        mamba_scan_ref(*inputs(Bs, 100), A, Dp, h)
    rows_t = None if rows is None else torch.tensor(rows, device=DEVICE)
    args = inputs(B, S)
    h_got, h_want = h.clone(), h.clone()
    got = mamba_scan(*args, A, Dp, h_got, rows=rows_t)
    want = mamba_scan_ref(*args, A, Dp, h_want, rows=rows_t)
    torch.cuda.synchronize()
    err, share = check(f"mamba {name}", got, want, vec_limit(want, dn))
    idx = list(range(B)) if rows is None else rows
    _, h_share = check(f"mamba {name}: h", h_got[idx], h_want[idx],
                       1e-5 + 1e-4 * h_want[idx].abs())
    h_bits = bool(torch.equal(h_got[idx], h_want[idx]))
    if S == 1 and not h_bits:
        diff = float((h_got[idx] - h_want[idx]).abs().max())
        raise AssertionError(f"mamba {name}: h is not bit-identical to the "
                             f"plain version's (max |diff| {diff:.3e})")
    others = [r for r in range(Bs) if r not in idx]
    if not torch.equal(h_got[others], h[others]):
        raise AssertionError(f"mamba {name}: state rows outside the batch "
                             f"changed")
    def run():
        return mamba_scan(*args, A, Dp, h_got, rows=rows_t)
    ms = cuda_ms(torch, run, iters)
    dev = device_ms(torch, run, iters)
    cold = cold_device_ms(torch, run, iters, "mamba_scan")
    plain = cuda_ms(torch, lambda: mamba_scan_ref(*args, A, Dp, h_want,
                                                  rows=rows_t), 2, warmup=1)
    from repro_torch.kernels.mamba_scan.kernel import cost
    b_ms, b_by = work_bound(cost(B, S, d, n, got.dtype))
    cs.record({"kernel": "mamba_scan", "case": name, "dtype": dn,
               "max_abs_err": err, "limit_share": share,
               "h_limit_share": h_share, "h_bits_equal": h_bits, "ms": ms,
               "device_ms": dev, "device_ms_cold": cold, "plain_ms": plain,
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by})
    print(f"    device {dev:.4f} ms, with the L2 flushed {cold:.4f} ms; h "
          f"bit-identical: {h_bits}")


def mamba_cases(cs):
    """#6 at jamba's shapes (d_inner 16384, d_state 16): the engine's fresh
    first chunks (S 2048; S 1000, whose last 32-step tile is ragged), a
    chunk from a carried state (S 37), the decode of 8 of 10 state rows
    (S 1, rows permuted; the other two must not change), fp32, the smoke
    config's d_inner 128, and d_state 6 with B and C column views whose
    rows (17 floats) are no multiple of 16 bytes: the operands the chunk
    kernel's tensor maps refuse, which its service warp copies. Every
    kernel of the library is built without a spill."""
    torch = cs.torch
    from repro_torch.kernels.mamba_scan.kernel import attributes
    for name, attrs in attributes().items():
        print(f"  mamba_scan {name} kernel: {attrs}", flush=True)
        if attrs["spill_bytes"]:
            raise AssertionError(f"mamba_scan {name}: ptxas spilled "
                                 f"{attrs['spill_bytes']} bytes")
    bf, f32 = torch.bfloat16, torch.float32
    mamba_case(cs, "B1 S2048 fresh bf16", 1, 2048, bf, False, iters=5)
    mamba_case(cs, "B1 S1000 fresh bf16", 1, 1000, bf, False, iters=5)
    mamba_case(cs, "B1 S37 carried bf16", 1, 37, bf, True)
    mamba_case(cs, "B8 S1 decode carried bf16", 8, 1, bf, True,
               rows=[3, 0, 7, 1, 6, 2, 9, 4], iters=20)
    mamba_case(cs, "B1 S512 carried fp32", 1, 512, f32, True)
    mamba_case(cs, "B4 S100 carried fp32 d128", 4, 100, f32, True, d=128)
    mamba_case(cs, "B2 S100 carried bf16 n6 B/C rows of 68 bytes", 2, 100,
               bf, True, n=6, lead=5)


def kernel_phase(torch):
    import numpy as np
    cs = Cases(torch)
    rng = np.random.default_rng(7)
    bf, f32 = torch.bfloat16, torch.float32
    edges = [4096, PAGE, PAGE - 3, 4096 - PAGE // 2]
    for B in (1, 8, 64):
        lens = [4093] if B == 1 else (
            edges + [int(x) for x in rng.integers(1, 4097, B - 4)])
        decode_case(cs, f"B{B} ctx<=4096 bf16", B, lens, bf)
    main = [int(x) + 40 for x in rng.integers(128, 2049, 8)]
    decode_case(cs, "B8 serving-like ctx bf16", 8, main, bf)
    decode_case(cs, "B8 window1000 softcap30 bf16", 8,
                edges + [int(x) for x in rng.integers(1, 4097, 4)], bf,
                window=1000, softcap=30.0)
    decode_case(cs, "B8 ctx<=4096 fp32", 8,
                edges + [int(x) for x in rng.integers(1, 4097, 4)], f32)
    decode_case(cs, "B4 G4 D256 fp32", 4, [300, 17, 1024, 5], f32, G=4,
                Hkv=2, D=256)
    # the decode block's other shapes: G 8 (jamba's heads), two head groups
    # (G 12), a head dim of 6 vectors a row, and gemma2-2b's heads (G 2,
    # D 256, window 4096, softcap 50) past the window
    decode_case(cs, "B4 G8 bf16", 4, [2000, 1, 700, 4096], bf, G=8)
    decode_case(cs, "B2 G12 D64 window300 bf16", 2, [1000, 77], bf, G=12,
                Hkv=2, D=64, window=300)
    decode_case(cs, "B3 D48 fp32", 3, [500, 16, 33], f32, G=2, Hkv=4, D=48)
    # the scalar block in bf16: head dims without a tensor-core
    # instantiation (48; 32 in two head groups), and pages of 128 keys,
    # which do not divide the tensor-core block's 64-key tile
    decode_case(cs, "B3 D48 bf16", 3, [500, 16, 33], bf, G=2, Hkv=4, D=48)
    expect_block(cs, "scalar")
    decode_case(cs, "B2 G12 D32 bf16", 2, [1000, 77], bf, G=12, Hkv=2, D=32)
    expect_block(cs, "scalar")
    decode_case(cs, "B8 serving-like ps128 bf16", 8, main, bf, ps=128)
    expect_block(cs, "scalar")
    decode_case(cs, "gemma2-2b B2 D256 window4096 softcap50 bf16", 2,
                [6000, 300], bf, G=2, Hkv=4, D=256, window=4096,
                softcap=50.0)
    # gemma2-2b's serving batch: half the rows past the 4096-key window
    decode_case(cs, "gemma2-2b B8 ctx 4097-6144 D256 window4096 softcap50 "
                "bf16", 8, [int(x) for x in rng.integers(4097, 6145, 4)]
                + [int(x) for x in rng.integers(128, 2049, 4)], bf, G=2,
                Hkv=4, D=256, window=4096, softcap=50.0)
    for R in (1, 4):
        for Sq in (16, 128, 512, 2048):
            if R == 1:
                pos, lens = [37], [37 + Sq]
            else:
                pos = [0, 1000, 2 * Sq + 5, 0]
                lens = [Sq, 1000 + Sq - 3, 3 * Sq + 5, 0]   # last: padding
            prefill_case(cs, f"R{R} Sq{Sq} bf16", pos, lens, Sq, bf,
                         iters=5 if Sq == 2048 else 10,
                         partial_split=(R == 4 and Sq == 128))
    prefill_case(cs, "R4 Sq128 window300 softcap30 bf16", [0, 500, 900, 0],
                 [128, 620, 1028, 0], 128, bf, window=300, softcap=30.0)
    prefill_case(cs, "R4 Sq128 fp32 partial", [0, 1000, 261, 0],
                 [128, 1125, 389, 0], 128, f32, partial_split=True)
    prefill_case(cs, "R2 Sq4 verify-rows bf16", [1500, 700], [1504, 702], 4,
                 bf)
    # G 8 (jamba's heads) and gemma2-2b's (8 heads over 4 kv heads, D 256,
    # window 4096, softcap 50) on the bf16 tensor-core path
    prefill_case(cs, "R4 Sq512 G8 bf16", [0, 1000, 1029, 0],
                 [512, 1509, 1541, 0], 512, bf, G=8)
    prefill_case(cs, "gemma2-2b R2 Sq512 D256 window4096 softcap50 bf16",
                 [4000, 100], [4512, 612], 512, bf, window=4096,
                 softcap=50.0, G=2, Hkv=4, D=256, partial_split=True)
    prefill_case(cs, "gemma2-2b R4 Sq256 ctx<=6144 D256 window4096 "
                 "softcap50 bf16", [5888, 4200, 0, 1000],
                 [6144, 4456, 256, 1200], 256, bf, window=4096, softcap=50.0,
                 G=2, Hkv=4, D=256)
    # chunked prefill over one 4096-token slot row: the engine passes
    # lengths = q_offset + Sq
    for Sq in (16, 128, 512, 2048):
        for off in (0, SLOT_LEN - Sq):
            chunked_case(cs, f"Sq{Sq} off{off} bf16", Sq, off, [off + Sq], bf,
                         iters=5 if Sq == 2048 else 10,
                         other_splits=3 if (Sq, off) == (512, 0) else None)
    # llama's 512-token chunks around split_plan's SPLIT_FROM_TILES (16,
    # 24 and 32 key tiles of 32 keys, 104 blocks), each also at the other
    # choice: the data that the threshold rests on
    for off in (256, 512):
        chunked_case(cs, f"Sq512 off{off} bf16", 512, off, [off + 512], bf,
                     other_splits=3)
    chunked_case(cs, "Sq512 off3800 past row end bf16", 512, 3800,
                 [3800 + 512], bf)
    chunked_case(cs, "Sq512 off2000 window1000 softcap30 bf16", 512, 2000,
                 [2512], bf, window=1000, softcap=30.0)
    chunked_case(cs, "Sq512 off1000 fp32", 512, 1000, [1512], f32)
    chunked_case(cs, "B2 Sq128 non-causal lens 3000/1234 bf16", 128, 0,
                 [3000, 1234], bf, causal=False)
    # jamba's attention layer: 64 query heads over 8 kv heads (G 8), no RoPE
    # (the kernel does not see it); exact-length chunks
    for Sq, off in ((512, 0), (512, 3584), (37, 100)):
        chunked_case(cs, f"jamba H64 Sq{Sq} off{off} bf16", Sq, off,
                     [off + Sq], bf, H=64)
    chunked_case(cs, "gemma2-2b H8 Sq512 off4000 window4096 softcap50 bf16",
                 512, 4000, [4512], bf, window=4096, softcap=50.0, H=8,
                 Hkv=4, D=256, Sk=8192)
    mla_cases(cs)
    seamless_cases(cs)
    split_k_cases(cs)
    mlstm_cases(cs)
    split_cases(cs, main)
    mamba_cases(cs)
    return cs.rows


def to_device(tree, dev):
    """A parameter tree (nested dicts and lists of tensors) on ``dev``."""
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev)


def smoke_engine_phase(torch, arch="llama3.2-3b", modes=("paged", "slot"),
                       window=None):
    """The smoke engine of ``arch`` on the GPU (CUDA kernels, fp32) and on
    the CPU (plain versions) on the same weights: same greedy tokens, in
    each cache mode of ``modes``; with both, slot gives paged's tokens.
    ``window`` replaces the config's sliding window (the smoke config keeps
    gemma2's 4096, which its prompts never reach)."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import SlidingServeScheduler
    from repro_torch.params import init_params
    from repro_torch.serving.engine import EngineCore
    from repro_torch.serving.request import Request
    cfg = get_config(arch).smoke()
    if window is not None:
        cfg = dataclasses.replace(cfg, sliding_window=window)
    cpu_params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    spec = [(40, 6), (77, 5), (19, 8), (130, 4)]
    prompts = {i: rng.integers(1, cfg.vocab_size, p).astype(np.int32)
               for i, (p, _) in enumerate(spec)}
    outs = {}
    for mode in modes:
        for dev in (DEVICE, "cpu"):
            eng = EngineCore(cfg, SlidingServeScheduler(max_budget=64,
                                                        max_iter_time=5.0),
                             cache_mode=mode, kv_capacity_tokens=2048,
                             max_slots=4, max_len=256, device=dev,
                             params=to_device(cpu_params, dev))
            reqs = [Request(rid=i, arrival=0.0, prompt_len=p, max_output=o,
                            ttft_slo=900.0, tbt_slo=900.0)
                    for i, (p, o) in enumerate(spec)]
            out = eng.serve(reqs, {k: v.copy() for k, v in prompts.items()},
                            max_wall_s=300.0)
            if out["unfinished"]:
                raise AssertionError(f"smoke {mode} engine on {dev}: "
                                     f"unfinished requests")
            outs[mode, dev] = out["outputs"]
        if outs[mode, DEVICE] != outs[mode, "cpu"]:
            raise AssertionError(f"smoke {mode} engine GPU vs CPU tokens "
                                 f"differ: {outs[mode, DEVICE]} vs "
                                 f"{outs[mode, 'cpu']}")
        print(f"  smoke {arch} {mode} engine"
              f"{f' (window {window})' if window is not None else ''}: GPU "
              f"tokens == CPU tokens for {len(spec)} requests "
              f"({sum(len(v) for v in outs[mode, DEVICE].values())} tokens)")
    if len(modes) > 1 and outs["slot", DEVICE] != outs["paged", DEVICE]:
        raise AssertionError(f"smoke engine slot vs paged tokens differ: "
                             f"{outs['slot', DEVICE]} vs "
                             f"{outs['paged', DEVICE]}")
    if len(modes) > 1:
        print("  smoke engine: slot tokens == paged tokens")


COUNTERS = ("launches", "combine_launches",    # #5's split-K combine
            "kernel_launches", "decode_launches")  # #7's kernels, S = 1


def reset_counts(kernels):
    for fn in kernels.values():
        for name in COUNTERS:
            if hasattr(fn, name):
                setattr(fn, name, 0)


def mlstm_counts(kernels):
    """#7's wrapper calls, the CUDA kernels they launched, and its decode
    (S = 1) and chunk calls, since the last reset."""
    fn = kernels["mlstm_chunkwise"]
    return {"calls": fn.launches, "kernel_launches": fn.kernel_launches,
            "decode_calls": fn.decode_launches,
            "chunk_calls": fn.launches - fn.decode_launches}


def mamba_counts(kernels):
    """#6's wrapper calls since the last reset: decode (S = 1, the decode
    kernel) and chunk calls (the chunk kernel)."""
    fn = kernels["mamba_scan"]
    return {"calls": fn.launches, "decode_calls": fn.decode_launches,
            "chunk_calls": fn.launches - fn.decode_launches}


def combine_count(kernels):
    """Launches of #5's split-K combine kernel since the last reset."""
    return kernels["chunked_prefill_attention"].combine_launches


def release(torch):
    """Free what an earlier run left: a handle and its server reference
    each other, so the engine (and its KV cache) goes only with the cyclic
    garbage collector. Then start a fresh peak-memory window."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def first_divergence(a, b):
    """Index of the first token where two streams differ (None if equal)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def serving_workload(cfg):
    """The full-width phases' 8 requests: prompts of 128-2048 tokens and
    16-64 output tokens, all submitted at once."""
    import numpy as np
    rng = np.random.default_rng(0)
    prompt_lens = [int(x) for x in rng.integers(128, 2049, 8)]
    outputs = [int(x) for x in rng.integers(16, 65, 8)]
    prompts = [rng.integers(0, cfg.vocab_size, p).astype(np.int32)
               for p in prompt_lens]
    return prompts, outputs


def long_workload(cfg):
    """gemma2-2b's full-width requests: 8 prompts, 4 of 4097-6144 tokens
    (past the local layers' 4096-key window, in prefill and decode) and 4
    of 128-2048, with 16-64 output tokens, all submitted at once."""
    import numpy as np
    rng = np.random.default_rng(0)
    prompt_lens = ([int(x) for x in rng.integers(4097, 6145, 4)]
                   + [int(x) for x in rng.integers(128, 2049, 4)])
    outputs = [int(x) for x in rng.integers(16, 65, 8)]
    prompts = [rng.integers(0, cfg.vocab_size, p).astype(np.int32)
               for p in prompt_lens]
    return prompts, outputs


# The traced repeats of phases 6, 7, 9 and 10 (not phase 5's, whose trace
# holds the paged path's kernels over the whole workload) and phase 16's
# sharded worlds serve the first CUT_REQUESTS requests with a quarter of
# their output tokens: the traces held 1.1-3.5 million events over the
# whole workload, whose summary took longer than the runs, and a round
# takes 2.3x (world 2) and 5.9x (world 3) phase 5's in the sharded worlds.
# A round's events and time hardly depend on its batch, so the output
# tokens (the decode rounds) are what is cut most.
CUT_REQUESTS = 4
CUT_OUTPUT_SHARE = 4


def cut_workload(prompts, outputs):
    """The part of a workload that a cut repeat serves."""
    return (prompts[:CUT_REQUESTS],
            [max(1, o // CUT_OUTPUT_SHARE) for o in outputs[:CUT_REQUESTS]])

# (spec_k, traced) of the paged serving runs; a traced run repeats an
# untraced one under torch.profiler, for the host/device breakdown (its
# wall time includes the tracing cost)
PAGED_RUNS = ((0, False), (4, False), (0, True))


def serving_phase(torch, params, kernels, cfg=None, workload=None,
                  runs=PAGED_RUNS, cut_trace=False):
    """Full-width ``cfg`` (llama3.2-3b by default) through the streaming
    server over the paged cache, one run per (spec_k, traced) of ``runs``,
    on ``workload``'s requests (``serving_workload``'s by default; with
    ``cut_trace``, a traced run serves ``cut_workload``'s part). The
    counters are set to 0 just before the first run and read just after
    the last. Returns the path's launch counts, the records and the first
    spec_k 0 token streams."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import SlidingServeScheduler
    from repro_torch.serving.engine import EngineCore
    from repro_torch.serving.server import InferenceServer
    cfg = cfg or get_config("llama3.2-3b")
    all_prompts, all_outputs = (workload or serving_workload)(cfg)
    layers = cfg.num_layers
    pa_fn = kernels["paged_attention_fused"]
    ppa_fn = kernels["paged_prefill_attention_fused"]
    reset_counts(kernels)
    results = []
    streams = None
    for spec_k, traced in runs:
        prompts, outputs = (cut_workload(all_prompts, all_outputs)
                            if traced and cut_trace
                            else (all_prompts, all_outputs))
        prompt_lens = [len(p) for p in prompts]
        pa0 = pa_fn.launches
        ppa0 = ppa_fn.launches
        core = EngineCore(cfg, SlidingServeScheduler(max_budget=512,
                                                     max_iter_time=2.0),
                          kv_capacity_tokens=65536, spec_k=spec_k,
                          params=params, device=DEVICE)
        server = InferenceServer(core)
        torch.cuda.synchronize()
        release(torch)
        prof = profiler(torch) if traced else contextlib.nullcontext()
        with prof:
            t_start = time.perf_counter()
            handles = [server.submit(p, max_output=o)
                       for p, o in zip(prompts, outputs)]
            server.run(max_wall_s=600.0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_start
        st = core.stats
        toks = [h.collected for h in handles]
        if not all(h.finished and not h.aborted for h in handles):
            raise AssertionError(f"spec_k={spec_k}: unfinished requests")
        if [len(t) for t in toks] != outputs:
            raise AssertionError(f"spec_k={spec_k}: output lengths "
                                 f"{[len(t) for t in toks]} != {outputs}")
        if not all(0 <= x < cfg.vocab_size for t in toks for x in t):
            raise AssertionError(f"spec_k={spec_k}: token id out of range")
        if st.token_readbacks != st.iterations:
            raise AssertionError(f"spec_k={spec_k}: {st.token_readbacks} "
                                 f"readbacks for {st.iterations} rounds")
        # decode + prefill without speculation; verify rows add a third kind
        max_calls = 2 if spec_k == 0 else 3
        if st.max_round_calls > max_calls:
            raise AssertionError(f"spec_k={spec_k}: max_round_calls "
                                 f"{st.max_round_calls} > {max_calls}")
        pa = pa_fn.launches - pa0
        ppa = ppa_fn.launches - ppa0
        if pa != layers * st.decode_calls or \
                ppa != layers * (st.prefill_calls + st.spec_calls):
            raise AssertionError(
                f"spec_k={spec_k}: launches decode {pa} / prefill {ppa} vs "
                f"dispatches decode {st.decode_calls}, chunk "
                f"{st.prefill_calls}, spec {st.spec_calls}")
        if spec_k and st.spec_calls == 0:
            raise AssertionError("spec_k=4: no verify dispatch ran")
        if core.alloc.free_blocks != core.alloc.num_blocks:
            raise AssertionError(f"spec_k={spec_k}: KV pages leaked")
        if spec_k == 0 and streams is None:
            streams = toks
        n_out = sum(outputs)
        n_in = sum(prompt_lens)
        ttft = [h.first_token_t - h.request.arrival for h in handles]
        rec = {"arch": cfg.name, "cache_mode": "paged", "spec_k": spec_k,
               "requests": len(handles),
               "prompt_tokens": n_in, "output_tokens": n_out,
               "wall_s": wall, "output_tok_per_s": n_out / wall,
               "total_tok_per_s": (n_in + n_out) / wall,
               "iterations": st.iterations,
               "round_ms": 1e3 * wall / st.iterations,
               "ttft_s_mean": float(np.mean(ttft)),
               "ttft_s_max": float(np.max(ttft)),
               "decode_calls": st.decode_calls,
               "prefill_calls": st.prefill_calls,
               "spec_calls": st.spec_calls,
               "prompt_lens": prompt_lens,
               "max_round_calls": st.max_round_calls,
               "token_readbacks": st.token_readbacks,
               "sync_s": st.sync_s, "dispatch_s": st.dispatch_s,
               "decode_kernel_launches": pa,
               "prefill_kernel_launches": ppa,
               "acceptance": core.spec_info()["acceptance_rate"],
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "traced": traced}
        if traced:
            rec["trace"] = trace_summary(torch, prof, wall, names=kernels)
        results.append(rec)
        print(f"  serve {cfg.name} spec_k={spec_k}"
              f"{' traced' if traced else ''}: {len(handles)} requests, "
              f"{n_in} prompt + {n_out} output tokens in {wall:.3f}s: "
              f"{rec['output_tok_per_s']:.1f} output tok/s, "
              f"{rec['total_tok_per_s']:.1f} total tok/s, "
              f"{st.iterations} rounds of {rec['round_ms']:.2f} ms, "
              f"ttft mean {rec['ttft_s_mean']:.3f}s; dispatches decode "
              f"{st.decode_calls} chunk {st.prefill_calls} spec "
              f"{st.spec_calls}; kernel launches decode {pa} prefill {ppa}; "
              f"peak memory {rec['peak_mem_gb']:.2f} GB",
              flush=True)
        if traced:
            print_trace(rec["trace"], wall)
        del server, core, handles
    release(torch)
    launches = {name: fn.launches for name, fn in kernels.items()}
    return launches, results, streams


def slot_serving_phase(torch, cfg, params, kernels, expected,
                       paged_streams=None, cut_trace=False):
    """Full-width ``cfg`` through the streaming server over the slot cache
    (8 slots of 4096 tokens); a second run repeats it under torch.profiler
    (``cut_workload``'s part of it with ``cut_trace``).
    ``expected`` maps a kernel's name to its launches as a function of the
    engine's stats (a per-layer kernel: layers x the dispatches it serves);
    the counters are set to 0 just before a run and read just after. With
    ``paged_streams``, counts the requests whose tokens equal the paged
    run's. Returns the first run's launch counts, and the records."""
    import numpy as np
    from repro_torch.core import SlidingServeScheduler
    from repro_torch.serving.engine import EngineCore
    from repro_torch.serving.server import InferenceServer
    arch = cfg.name
    all_prompts, all_outputs = serving_workload(cfg)
    results, first_launches = [], None
    for traced in (False, True):
        prompts, outputs = (cut_workload(all_prompts, all_outputs)
                            if traced and cut_trace
                            else (all_prompts, all_outputs))
        core = EngineCore(cfg, SlidingServeScheduler(max_budget=512,
                                                     max_iter_time=2.0),
                          cache_mode="slot", max_slots=8, max_len=SLOT_LEN,
                          params=params, device=DEVICE)
        server = InferenceServer(core)
        torch.cuda.synchronize()
        release(torch)
        reset_counts(kernels)
        prof = profiler(torch) if traced else contextlib.nullcontext()
        with prof:
            t_start = time.perf_counter()
            handles = [server.submit(p, max_output=o)
                       for p, o in zip(prompts, outputs)]
            server.run(max_wall_s=600.0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_start
        launches = {name: fn.launches for name, fn in kernels.items()}
        launches["chunked_prefill_attention_combine"] = combine_count(kernels)
        first_launches = first_launches or launches
        st = core.stats
        toks = [h.collected for h in handles]
        if not all(h.finished and not h.aborted for h in handles):
            raise AssertionError(f"{arch} slot serving: unfinished requests")
        if [len(t) for t in toks] != outputs:
            raise AssertionError(f"{arch} slot serving: output lengths "
                                 f"{[len(t) for t in toks]} != {outputs}")
        if not all(0 <= x < cfg.vocab_size for t in toks for x in t):
            raise AssertionError(f"{arch} slot serving: token id out of "
                                 f"range")
        for name, want in expected.items():
            if launches[name] <= 0 or launches[name] != want(st):
                raise AssertionError(
                    f"{arch} slot serving: {launches[name]} {name} "
                    f"launches, expected {want(st)} (dispatches: chunk "
                    f"{st.prefill_calls}, decode {st.decode_calls})")
        if sorted(core.free_slots) != list(range(core.max_slots)):
            raise AssertionError(f"{arch} slot serving: slots leaked")
        n_out, n_in = sum(outputs), sum(len(p) for p in prompts)
        ttft = [h.first_token_t - h.request.arrival for h in handles]
        rec = {"arch": arch, "cache_mode": "slot", "spec_k": 0,
               "requests": len(handles),
               "prompt_tokens": n_in, "output_tokens": n_out, "wall_s": wall,
               "output_tok_per_s": n_out / wall,
               "total_tok_per_s": (n_in + n_out) / wall,
               "iterations": st.iterations,
               "round_ms": 1e3 * wall / st.iterations,
               "ttft_s_mean": float(np.mean(ttft)),
               "ttft_s_max": float(np.max(ttft)),
               "decode_calls": st.decode_calls,
               "prefill_calls": st.prefill_calls,
               "max_round_calls": st.max_round_calls,
               "token_readbacks": st.token_readbacks,
               "kernel_launches": {n: launches[n] for n in expected},
               "combine_launches":
                   launches["chunked_prefill_attention_combine"],
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "traced": traced}
        if "mlstm_chunkwise" in expected:
            rec["mlstm"] = mlstm_counts(kernels)
        if "mamba_scan" in expected:
            rec["mamba"] = mamba_counts(kernels)
        same = ""
        if paged_streams is not None:
            n_same = sum(a == b for a, b in zip(toks, paged_streams))
            diverge = [first_divergence(a, b)
                       for a, b in zip(toks, paged_streams)]
            rec.update(same_tokens_as_paged=n_same,
                       first_divergence_from_paged=diverge)
            same = (f"; {n_same}/{len(handles)} requests with the paged "
                    f"run's tokens (first differing token: {diverge})")
        print(f"  serve {arch} slot{' traced' if traced else ''}: "
              f"{len(handles)} requests, {n_in} prompt + {n_out} output "
              f"tokens in {wall:.3f}s: {rec['output_tok_per_s']:.1f} output "
              f"tok/s, {rec['total_tok_per_s']:.1f} total tok/s, "
              f"{st.iterations} rounds of {rec['round_ms']:.2f} ms, ttft "
              f"mean {rec['ttft_s_mean']:.3f}s max {rec['ttft_s_max']:.3f}s; "
              f"dispatches decode {st.decode_calls} chunk "
              f"{st.prefill_calls}; launches {rec['kernel_launches']} (#5's "
              f"split-K combine {rec['combine_launches']}); peak "
              f"memory {rec['peak_mem_gb']:.2f} GB{same}", flush=True)
        if "mlstm" in rec:
            print(f"  #7: {rec['mlstm']}")
        if "mamba" in rec:
            print(f"  #6: {rec['mamba']}")
        if traced:
            rec["trace"] = trace_summary(torch, prof, wall,
                                         names=(*kernels, "mlstm_"))
            print_trace(rec["trace"], wall)
            if "mlstm" in rec:
                mk = [k for k in rec["trace"]["port_kernels"]
                      if "mlstm_" in k["name"]]
                rec["mlstm"]["traced_kernels"] = sum(k["count"] for k in mk)
                rec["mlstm"]["traced_ms"] = sum(k["ms"] for k in mk)
                # the chunk passes and the decode kernel apart
                for part, key in (("chunk", ("mlstm_gate", "mlstm_state",
                                             "mlstm_output")),
                                  ("decode", ("mlstm_decode",))):
                    pk = [k for k in mk if any(x in k["name"] for x in key)]
                    rec["mlstm"][f"traced_{part}_kernels"] = sum(
                        k["count"] for k in pk)
                    rec["mlstm"][f"traced_{part}_ms"] = sum(
                        k["ms"] for k in pk)
                ml = rec["mlstm"]
                print(f"  #7 in the trace: {ml['traced_kernels']} kernels, "
                      f"{ml['traced_ms']:.2f} ms (the wrapper counted "
                      f"{ml['kernel_launches']}): chunk passes "
                      f"{ml['traced_chunk_ms']:.2f} ms over "
                      f"{ml['traced_chunk_kernels']}, decode kernel "
                      f"{ml['traced_decode_ms']:.2f} ms over "
                      f"{ml['traced_decode_kernels']}")
            if "mamba" in rec:
                # #6's device time in the trace, by kernel: prompt chunks
                # and decode steps
                for part in ("chunk", "decode"):
                    mk = [k for k in rec["trace"]["port_kernels"]
                          if f"mamba_scan_{part}_kernel" in k["name"]]
                    rec["mamba"][f"traced_{part}_kernels"] = sum(
                        k["count"] for k in mk)
                    rec["mamba"][f"traced_{part}_ms"] = sum(
                        k["ms"] for k in mk)
                m = rec["mamba"]
                print(f"  #6 in the trace: chunk kernel "
                      f"{m['traced_chunk_ms']:.2f} ms over "
                      f"{m['traced_chunk_kernels']}, decode kernel "
                      f"{m['traced_decode_ms']:.2f} ms over "
                      f"{m['traced_decode_kernels']} (the wrapper counted "
                      f"{m['chunk_calls']} chunk and {m['decode_calls']} "
                      f"decode calls)")
        results.append(rec)
        del server, core, handles
        release(torch)
    return first_launches, results


def print_trace(tr, wall):
    print(f"  trace: device busy {tr['device_busy_ms']:.1f} ms of "
          f"{1e3 * wall:.1f} ms wall (idle share "
          f"{tr['device_idle_share']:.3f}); {tr['events']} events summarised "
          f"in {tr['summary_s']:.2f}s")
    for k in tr["top_device"]:
        print(f"    device {k['ms']:9.2f} ms {k['count']:6d}x  {k['name']}")
    for k in tr["top_host"]:
        print(f"    host   {k['ms']:9.2f} ms {k['count']:6d}x  {k['name']}")
    for k in tr.get("port_kernels", []):
        print(f"    port   {k['ms']:9.2f} ms {k['count']:6d}x  {k['name']}")


def profiler(torch):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if DEVICE == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def trace_summary(torch, prof, wall_s, top=8, names=()):
    """Device busy time (the sum of the kernels' and copies' time on the
    one stream), the idle share of the wall time, the largest device
    entries and host entries by self time (an op's time less that of the
    ops it called on its thread), and every device entry whose name holds
    one of ``names`` (the port's kernels, #5's split-K combine included,
    whether or not they are among the largest). One pass over the
    profiler's raw events:
    ``key_averages()`` first builds an event object and a call tree for
    every event, which took most of the script's time when it summarised
    two traces that way."""
    from torch.autograd import DeviceType
    t0 = time.perf_counter()
    events = prof.profiler.kineto_results.events()
    dev = {}                         # name -> [count, ns]
    threads = {}                     # host thread -> [(start, end, name)]
    for e in events:
        kind = e.device_type()
        if kind == DeviceType.CUDA:
            acc = dev.setdefault(e.name(), [0, 0])
            acc[0] += 1
            acc[1] += e.duration_ns()
        elif kind == DeviceType.CPU:
            threads.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), e.end_ns(), e.name()))
    host = {}

    def close(frame):
        acc = host.setdefault(frame[1], [0, 0])
        acc[0] += 1
        acc[1] += frame[3] - frame[2]
    for evs in threads.values():
        evs.sort(key=lambda x: (x[0], -x[1]))
        stack = []                   # [end, name, children's ns, own ns]
        for start, end, name in evs:
            while stack and stack[-1][0] <= start:
                close(stack.pop())
            if stack:
                stack[-1][2] += end - start
            stack.append([end, name, 0, end - start])
        while stack:
            close(stack.pop())
    busy_ms = sum(ns for _, ns in dev.values()) / 1e6

    def entries(table):
        rows = sorted(table.items(), key=lambda kv: -kv[1][1])[:top]
        return [{"name": name[:90], "count": n, "ms": ns / 1e6}
                for name, (n, ns) in rows]
    port = {n: v for n, v in dev.items() if any(k in n for k in names)}
    return {"device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / (1e3 * wall_s)),
            "top_device": entries(dev), "top_host": entries(host),
            "port_kernels": entries(port),
            "events": len(events), "summary_s": time.perf_counter() - t0}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


PREFILL_STEPS = 8     # greedy decode steps after each smoke prefill


def prefill_decode_phase(torch, kernels, B=2, S=32, enc_len=16):
    """``prefill`` then ``PREFILL_STEPS`` greedy ``decode_step``s for every
    arch at its smoke size in fp32 (internvl2 with patch embeddings in
    place of its first prompt positions, seamless-m4t with encoder frames
    and its cross cache), on the GPU (CUDA kernels) and on the CPU (plain
    versions) from the same weights and inputs: the same greedy tokens.
    Returns #5's launches on the GPU runs (the CPU runs launch none)."""
    import numpy as np
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.models import model as TM
    from repro_torch.params import init_params
    cpa = kernels["chunked_prefill_attention"]
    n0 = cpa.launches
    for arch in ARCHS:
        cfg = get_config(arch).smoke()
        cpu_params = init_params(cfg, seed=0, device="cpu")
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                                .astype(np.int32))
        extra = {}
        if cfg.num_patch_tokens:
            extra["extra_embeds"] = torch.from_numpy((rng.normal(size=(
                B, cfg.num_patch_tokens, cfg.d_model)) * 0.02).astype(
                np.float32))
        n_enc = enc_len if cfg.enc_dec else 0
        if n_enc:
            extra["enc_embeds"] = torch.from_numpy((rng.normal(size=(
                B, n_enc, cfg.d_model)) * 0.02).astype(np.float32))
        seqs = {}
        for dev in (DEVICE, "cpu"):
            params = to_device(cpu_params, dev)
            cache = TM.init_cache(cfg, B, S + PREFILL_STEPS, device=dev,
                                  enc_len=n_enc)
            logits, cache = TM.prefill(
                cfg, params, toks.to(dev), cache,
                **{k: v.to(dev) for k, v in extra.items()})
            seq = []
            for t in range(PREFILL_STEPS):
                tok = logits.argmax(-1).to(torch.int32)
                seq.append(tok.cpu().tolist())
                logits, cache = TM.decode_step(cfg, params, tok[:, None],
                                               cache, S + t)
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{arch} prefill/decode on {dev}: "
                                     f"non-finite logits")
            seqs[dev] = seq
        if seqs[DEVICE] != seqs["cpu"]:
            raise AssertionError(f"{arch} prefill/decode: GPU tokens "
                                 f"{seqs[DEVICE]} != CPU tokens "
                                 f"{seqs['cpu']}")
        print(f"  smoke {arch} prefill({S}) + {PREFILL_STEPS} decode steps"
              f"{' with patch embeddings' if 'extra_embeds' in extra else ''}"
              f"{f' with {n_enc} encoder frames' if n_enc else ''}: GPU "
              f"tokens == CPU tokens", flush=True)
    return cpa.launches - n0


@contextlib.contextmanager
def front_door(backend):
    """``HttpFrontend`` over ``backend`` on 127.0.0.1, port 0 (loopback
    only), its asyncio loop in a thread of its own, which alone steps the
    engines; yields a client and a dict that receives the drain report.
    On exit: ``request_stop``, the graceful drain (``backend.close()``
    asserts the pools refill) and the thread joined."""
    from repro_torch.frontend.client import EngineHttpClient
    from repro_torch.frontend.http_server import HttpFrontend
    fe = HttpFrontend(backend, host="127.0.0.1", port=0, drain_s=120.0)
    box = {}

    def serve():
        box["report"] = asyncio.run(fe.serve_forever())
    th = threading.Thread(target=serve, daemon=True)
    th.start()
    t_end = time.perf_counter() + 60.0
    while fe.port == 0 and time.perf_counter() < t_end:
        time.sleep(0.01)
    cli = EngineHttpClient(host="127.0.0.1", port=fe.port, timeout=600.0)
    cli.wait_ready(60.0)
    try:
        yield cli, box
    finally:
        fe.request_stop()
        th.join(timeout=300.0)
        if th.is_alive() or "report" not in box:
            raise AssertionError("the front door did not drain on stop")
        if not box["report"]["drained"]:
            raise AssertionError(f"drain report: {box['report']}")


def http_stream(cli, prompt, max_output, cancel_after=None, on_cancel=None):
    """One SSE stream through the client; with ``cancel_after``, a DELETE
    after that many tokens, then ``on_cancel(rid)`` as soon as the cancel
    is acknowledged. Returns the stream's record (client-side TTFT)."""
    t0 = time.perf_counter()
    h = cli.generate([int(x) for x in prompt], max_output=max_output)
    ttft, seen, cancelled = None, 0, None
    for _ in h.tokens():
        ttft = time.perf_counter() - t0 if ttft is None else ttft
        seen += 1
        if cancel_after and seen == cancel_after and cancelled is None:
            cancelled = h.cancel()
            if on_cancel:
                on_cancel(h.rid)
    return {"rid": h.rid, "tokens": list(h.collected), "ttft_s": ttft,
            "wall_s": time.perf_counter() - t0, "aborted": h.aborted,
            "finished": any(n == "finished" for n, _ in h.events),
            "cancelled": cancelled}


def http_jobs(cli, jobs, **kw):
    """``jobs`` [(prompt, max_output, cancel_after)] concurrently, one
    client thread each; returns their records in order."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(jobs)) as ex:
        return list(ex.map(lambda j: http_stream(cli, *j, **kw), jobs))


def settle(backend):
    """Wait until the front door's pump has no work left."""
    t_end = time.perf_counter() + 120.0
    while backend.has_work() and time.perf_counter() < t_end:
        time.sleep(0.01)
    if backend.has_work():
        raise AssertionError("the engine still has work after its streams")


def paged_launch_check(what, layers, stats_list, pa, ppa):
    """#1 and #2 launch ``layers`` times per decode and per chunk or verify
    dispatch, summed over the replicas' stats."""
    dec = sum(st["decode_calls"] for st in stats_list)
    chunk = sum(st["prefill_calls"] + st["spec_calls"] for st in stats_list)
    if pa != layers * dec or ppa != layers * chunk or pa <= 0 or ppa <= 0:
        raise AssertionError(f"{what}: launches decode {pa} / prefill {ppa} "
                             f"vs {layers} x dispatches decode {dec}, chunk "
                             f"{chunk}")
    for st in stats_list:
        if st["token_readbacks"] != st["iterations"]:
            raise AssertionError(f"{what}: {st['token_readbacks']} readbacks "
                                 f"for {st['iterations']} rounds")


def http_phase(torch, params, kernels):
    """Full-width llama3.2-3b (bf16, paged, the KV pool of phase 5) behind
    ``HttpFrontend``: ``serving_workload``'s 8 requests as concurrent SSE
    streams, the one with the longest output cancelled by DELETE after its
    fourth token; beside it, the same requests in process on a backend
    built the same way. Then the smoke config in fp32, where the streams
    must equal the in-process ones. Returns the HTTP run's launch counts
    of #1 and #2 and the record."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.frontend.http_server import build_backend
    cfg = get_config("llama3.2-3b")
    prompts, outputs = serving_workload(cfg)
    kw = dict(arch=cfg.name, smoke=False, replicas=1, kv_tokens=65536,
              max_budget=512, params=params, device=DEVICE)
    server = build_backend(**kw)
    release(torch)
    t0 = time.perf_counter()
    handles = [server.submit(p, max_output=o)
               for p, o in zip(prompts, outputs)]
    server.run(max_wall_s=600.0)
    torch.cuda.synchronize()
    wall_in = time.perf_counter() - t0
    inproc = [list(h.collected) for h in handles]
    ttft_in = [h.first_token_t - h.request.arrival for h in handles]
    rounds_in = server.core.stats.iterations
    server.close()
    del server, handles
    release(torch)

    backend = build_backend(**kw)
    core = backend.core
    cut = int(np.argmax(outputs))
    freed = {}

    def on_cancel(rid):    # the DELETE is answered after abort() ran
        freed[rid] = rid not in core.alloc.owners
    reset_counts(kernels)
    with front_door(backend) as (cli, box):
        t0 = time.perf_counter()
        res = http_jobs(cli, [(p, o, 4 if i == cut else None) for i, (p, o)
                              in enumerate(zip(prompts, outputs))],
                        on_cancel=on_cancel)
        wall = time.perf_counter() - t0
        settle(backend)
        stats = cli.stats()
    pa = kernels["paged_attention_fused"].launches
    ppa = kernels["paged_prefill_attention_fused"].launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    for i, (r, o) in enumerate(zip(res, outputs)):
        if i == cut:
            if not (r["cancelled"] and r["aborted"] and len(r["tokens"]) < o
                    and freed.get(r["rid"])):
                raise AssertionError(f"cancelled stream: {r}, pages freed "
                                     f"at the DELETE: {freed}")
        elif not (r["finished"] and not r["aborted"]
                  and len(r["tokens"]) == o):
            raise AssertionError(f"stream {i}: {len(r['tokens'])}/{o} "
                                 f"tokens, finished {r['finished']}")
        if not all(0 <= x < cfg.vocab_size for x in r["tokens"]):
            raise AssertionError(f"stream {i}: token id out of range")
    paged_launch_check("http", cfg.num_layers, [stats["engine"]], pa, ppa)
    if core.alloc.free_blocks != core.alloc.num_blocks:
        raise AssertionError("http: KV pages still held after the drain")
    n_same = sum(r["tokens"] == t for i, (r, t) in enumerate(zip(res, inproc))
                 if i != cut)
    n_out = sum(len(r["tokens"]) for r in res)
    rec = {"arch": cfg.name, "cache_mode": "paged", "front_door": "http",
           "requests": len(res), "cancelled": cut,
           "ttft_s_http": [r["ttft_s"] for r in res],
           "ttft_s_inprocess": ttft_in,
           "wall_s_http": wall, "wall_s_inprocess": wall_in,
           "output_tokens_http": n_out,
           "output_tok_per_s_http": n_out / wall,
           "output_tok_per_s_inprocess": sum(outputs) / wall_in,
           "same_tokens_as_inprocess": n_same,
           "first_divergence": [first_divergence(r["tokens"], t)
                                for r, t in zip(res, inproc)],
           "iterations": stats["engine"]["iterations"],
           "iterations_inprocess": rounds_in,
           "token_readbacks": stats["engine"]["token_readbacks"],
           "decode_kernel_launches": pa, "prefill_kernel_launches": ppa,
           "peak_mem_gb": peak}
    print(f"  http: {len(res)} SSE streams (request {cut} cancelled after 4 "
          f"of {outputs[cut]} tokens, its pages free when the DELETE was "
          f"answered), {n_out} output tokens in {wall:.3f}s "
          f"({rec['output_tok_per_s_http']:.1f} tok/s; in process "
          f"{wall_in:.3f}s, {rec['output_tok_per_s_inprocess']:.1f} tok/s); "
          f"{stats['engine']['iterations']} rounds, as many readbacks "
          f"({rounds_in} in process); "
          f"launches decode {pa} prefill {ppa}; peak memory {peak:.2f} GB; "
          f"{n_same}/{len(res) - 1} uncancelled streams equal the in-process "
          f"run's (bf16; first differing token {rec['first_divergence']})",
          flush=True)
    print("  ttft s, client side over HTTP: "
          + " ".join(f"{x:.3f}" for x in rec["ttft_s_http"])
          + "; in process: " + " ".join(f"{x:.3f}" for x in ttft_in))
    rec["smoke_fp32_equal"] = http_smoke_parity(torch)
    return {"paged_attention_fused": pa,
            "paged_prefill_attention_fused": ppa}, rec


def http_smoke_parity(torch):
    """The llama3.2-3b smoke config (fp32) on the card: concurrent SSE
    streams give the in-process streams of the same prompts token for
    token."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.frontend.http_server import build_backend
    cfg = get_config("llama3.2-3b").smoke()
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (24, 40, 33, 77, 130)]
    kw = dict(arch=cfg.name, smoke=True, replicas=1, kv_tokens=4096,
              device=DEVICE)
    server = build_backend(**kw)
    want = [server.submit(p, max_output=6).result(600.0) for p in prompts]
    server.close()
    backend = build_backend(**kw)
    with front_door(backend) as (cli, box):
        got = [r["tokens"] for r in http_jobs(cli, [(p, 6, None)
                                                    for p in prompts])]
    if got != want:
        raise AssertionError(f"smoke fp32 SSE streams {got} != in-process "
                             f"{want}")
    print(f"  http, smoke config fp32: {len(prompts)} concurrent SSE streams "
          f"== in-process streams", flush=True)
    return True


def router_phase(torch, params, kernels):
    """Two full-width llama3.2-3b replicas (bf16, paged, one shared
    parameter tree) behind ``EngineRouter`` and HTTP: two groups of four
    conversations from ``make_shared_prefix_workload`` (a 1024-token
    system prompt each, 128-token user parts) and one unrelated 512-token
    request (so that round-robin's second turn starts on the other
    replica), then a ``multiturn_followup`` turn of each conversation, all
    streams of a turn concurrent; under the
    prefix-affine policy, then the same traffic under round-robin. Each
    follow-up must land on the replica that served its conversation unless
    the router spilled it (the first turn's spills, which depend on when
    the pages of the turn's earlier prompts commit, are not counted), the
    prefix-affine run must hit the directory and
    the replicas' prefix caches, and every pool must be whole after the
    drain. Returns the launches of #1 and #2 by policy and the records."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.frontend.http_server import build_backend
    from repro_torch.serving.workloads import (make_shared_prefix_workload,
                                              multiturn_followup)
    cfg = get_config("llama3.2-3b")
    out_len = 16
    convs = []
    for g in range(2):
        _, pr = make_shared_prefix_workload(
            4, cfg.vocab_size, system_len=1024, unique_len=128,
            max_output=out_len, seed=g, rid0=4 * g)
        convs += [pr[r] for r in sorted(pr)]
    cold = np.random.default_rng(9).integers(1, cfg.vocab_size, 512).astype(
        np.int32)
    launches, recs = {}, []
    for policy in ("prefix-affine", "round-robin"):
        backend = build_backend(arch=cfg.name, smoke=False, replicas=2,
                                policy=policy, kv_tokens=32768,
                                max_budget=512, params=params, device=DEVICE)
        release(torch)
        reset_counts(kernels)
        rng = np.random.default_rng(5)
        with front_door(backend) as (cli, box):
            t0 = time.perf_counter()
            first = http_jobs(cli, [(p, out_len, None)
                                    for p in convs + [cold]])
            spills_first = backend.spills      # the first turn's own
            follow = [multiturn_followup(p, r["tokens"], rng,
                                         cfg.vocab_size, turn_len=64)
                      for p, r in zip(convs, first)]
            second = http_jobs(cli, [(p, out_len, None) for p in follow])
            wall = time.perf_counter() - t0
            settle(backend)
            stats = cli.stats()
        pa = kernels["paged_attention_fused"].launches
        ppa = kernels["paged_prefill_attention_fused"].launches
        for r in first + second:
            if not (r["finished"] and len(r["tokens"]) == out_len):
                raise AssertionError(f"router {policy}: stream {r['rid']} "
                                     f"{len(r['tokens'])}/{out_len} tokens")
        paged_launch_check(f"router {policy}", cfg.num_layers,
                           [rep["engine"] for rep in stats["replicas"]],
                           pa, ppa)
        for i, rep in enumerate(backend.replicas):
            alloc = rep.server.core.alloc
            if alloc.free_blocks != alloc.num_blocks:
                raise AssertionError(f"router {policy}: replica {i} holds "
                                     f"pages after the drain")
        rr = stats["routing"]
        owners = [backend.owner_of(r["rid"]) for r in first]
        owners2 = [backend.owner_of(r["rid"]) for r in second]
        on_holder = sum(a == b for a, b in zip(owners, owners2))
        hits = [rep["engine"]["cache_hit_tokens"]
                for rep in stats["replicas"]]
        if policy == "prefix-affine":
            spilled = rr["spills"] - spills_first
            if on_holder + spilled != len(second) or on_holder == 0:
                raise AssertionError(
                    f"router: {on_holder} follow-ups on their conversation's "
                    f"replica, {spilled} spilled, of {len(second)}")
            if rr["directory"]["hit_lookups"] <= 0 or rr["affine_hits"] <= 0:
                raise AssertionError(f"router: no directory hit: {rr}")
            for i in set(b for a, b in zip(owners, owners2) if a == b):
                if hits[i] <= 0:
                    raise AssertionError(f"router: replica {i} took "
                                         f"follow-ups without a cache hit")
        rec = {"arch": cfg.name, "policy": policy, "replicas": 2,
               "conversations": len(convs), "wall_s": wall,
               "owners_turn1": owners, "owners_turn2": owners2,
               "followups_on_holder": on_holder, "routed": rr["routed"],
               "spills": rr["spills"], "affine_hits": rr["affine_hits"],
               "directory": rr["directory"], "cache_hit_tokens": hits,
               "prefill_tokens": [rep["engine"]["prefill_tokens"]
                                  for rep in stats["replicas"]],
               "ttft_s_turn2": [r["ttft_s"] for r in second],
               "decode_kernel_launches": pa, "prefill_kernel_launches": ppa,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        recs.append(rec)
        launches[policy] = {"paged_attention_fused": pa,
                            "paged_prefill_attention_fused": ppa}
        print(f"  router {policy}: {len(first) + len(second)} SSE streams "
              f"in {wall:.3f}s; routed {rr['routed']}, follow-ups on their "
              f"conversation's replica {on_holder}/{len(second)}, spills "
              f"{rr['spills']}, affine hits {rr['affine_hits']}, directory "
              f"hit lookups {rr['directory']['hit_lookups']}/"
              f"{rr['directory']['lookups']}; cache-hit tokens {hits}, "
              f"prefill tokens {rec['prefill_tokens']}; turn-2 ttft mean "
              f"{np.mean(rec['ttft_s_turn2']):.3f}s; launches decode {pa} "
              f"prefill {ppa}; peak memory {rec['peak_mem_gb']:.2f} GB",
              flush=True)
        del backend
    release(torch)
    return launches, recs


SEAMLESS_B, SEAMLESS_ENC, SEAMLESS_S, SEAMLESS_STEPS = 4, 1024, 128, 32


def seamless_phase(torch, kernels):
    """seamless-m4t-large-v2 at full width (bf16, every published width:
    24 encoder and 24 decoder layers, d_model 1024, 16 heads of 64, d_ff
    8192, vocab 256206; random weights from a seed): B 4, 1024 encoder
    frames drawn from a seed, 128-token decoder prompts, ``prefill`` and
    32 greedy ``decode_step``s. #5 must launch once per encoder layer,
    twice per decoder layer at prefill (self and cross attention) and once
    per decoder layer and decode step (cross attention); a second run
    repeats it under torch.profiler for #5's device time, prefill and
    decode apart. Returns #5's launches and the record."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as TM
    cfg = get_config("seamless-m4t-large-v2")
    params = load_params(torch, cfg)
    n_params = sum(p.numel() for p in _leaves(params))
    B, E, S, T = SEAMLESS_B, SEAMLESS_ENC, SEAMLESS_S, SEAMLESS_STEPS
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    enc = (torch.randn((B, E, cfg.d_model), generator=gen, device=DEVICE)
           * 0.02).to(cfg.dtype)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device=DEVICE, dtype=torch.int32)
    L = cfg.num_layers
    want = cfg.num_encoder_layers + 2 * L + T * L
    cpa = kernels["chunked_prefill_attention"]
    rec = {"arch": cfg.name, "params_b": n_params / 1e9, "batch": B,
           "encoder_frames": E, "prompt_tokens": S, "decode_steps": T,
           "expected_launches": want}
    for traced in (False, True):
        release(torch)
        cache = TM.init_cache(cfg, B, S + T, device=DEVICE, enc_len=E)
        torch.cuda.synchronize()
        reset_counts(kernels)
        profs = [profiler(torch) if traced else contextlib.nullcontext()
                 for _ in range(2)]
        t0 = time.perf_counter()
        with profs[0]:
            logits, cache = TM.prefill(cfg, params, toks, cache,
                                       enc_embeds=enc)
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        n_prefill = cpa.launches
        out = []
        with profs[1]:
            for t in range(T):
                tok = logits.argmax(-1).to(torch.int32)
                out.append(tok)
                logits, cache = TM.decode_step(cfg, params, tok[:, None],
                                               cache, S + t)
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        n5 = cpa.launches
        if n5 != want or n_prefill != cfg.num_encoder_layers + 2 * L:
            raise AssertionError(f"seamless: #5 launched {n_prefill} at "
                                 f"prefill and {n5} in all, expected "
                                 f"{cfg.num_encoder_layers + 2 * L} and "
                                 f"{want}")
        toks_out = torch.stack(out, 1)
        if not bool(torch.isfinite(logits.float()).all()) or \
                int(toks_out.min()) < 0 or \
                int(toks_out.max()) >= cfg.vocab_size:
            raise AssertionError("seamless: non-finite logits or token ids "
                                 "out of range")
        if not traced:
            rec.update(launches=n5, launches_prefill=n_prefill,
                       combine_launches=combine_count(kernels),
                       prefill_s=t1 - t0, decode_ms_per_step=1e3 * (t2 - t1)
                       / T,
                       peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
            print(f"  seamless-m4t-large-v2: {n_params / 1e9:.3f}B "
                  f"parameters; B{B}, {E} encoder frames, {S}-token prompts: "
                  f"prefill {rec['prefill_s']:.3f}s, {T} decode steps of "
                  f"{rec['decode_ms_per_step']:.2f} ms; #5 launches "
                  f"{n_prefill} at prefill ({cfg.num_encoder_layers} encoder "
                  f"+ {L} self + {L} cross) and {n5 - n_prefill} in decode "
                  f"({L} cross a step; split-K combines "
                  f"{rec['combine_launches']}); peak memory "
                  f"{rec['peak_mem_gb']:.2f} GB", flush=True)
            continue
        for part, prof, wall in (("prefill", profs[0], t1 - t0),
                                 ("decode", profs[1], t2 - t1)):
            tr = trace_summary(torch, prof, wall, names=kernels)
            k5 = [k for k in tr["port_kernels"]
                  if "chunked_prefill_attention" in k["name"]]
            rec[f"traced_{part}"] = {**tr, "wall_s": wall,
                                     "cpa_device_ms": sum(k["ms"]
                                                          for k in k5)}
            print(f"  seamless traced {part}: device busy "
                  f"{tr['device_busy_ms']:.1f} ms of {1e3 * wall:.1f} ms "
                  f"(idle share {tr['device_idle_share']:.3f}); #5 "
                  f"{rec[f'traced_{part}']['cpa_device_ms']:.3f} ms device: "
                  + "; ".join(f"{k['count']}x {k['ms']:.3f} ms {k['name']}"
                              for k in k5), flush=True)
            print_trace(tr, wall)
    del params, cache
    release(torch)
    return rec["launches"], rec


# ---------------------------------------------------------------------------
# phase 15: training
# ---------------------------------------------------------------------------
TRAIN_B, TRAIN_S, TRAIN_ENC = 2, 32, 16       # (a): every arch's smoke batch
FULL_B, FULL_S, FULL_STEPS = 2, 2048, 6        # (c): full-width llama3.2-3b
FULL_LR = 3e-6       # larger rates move the random model's loss up first
PLAIN = (("chunked_prefill_attention", "chunked_prefill_attention_ref"),
         ("mamba_scan", "mamba_scan_ref"),
         ("mlstm_chunkwise", "mlstm_chunkwise_ref"))


@contextlib.contextmanager
def plain_calls():
    """Count the calls of #5/#6/#7's plain versions (``ref.py``) by caller,
    for the time of the block: "<kernel> forward" from the wrappers (which
    run it for a CPU tensor only) and "<kernel> backward" from the
    ``autograd.Function``'s backward (``ops.py``). Restores the names on
    exit."""
    import importlib
    counts = {}
    saved = []
    for kernel, name in PLAIN:
        for part, where in (("forward", "kernel"), ("backward", "ops")):
            mod = importlib.import_module(
                f"repro_torch.kernels.{kernel}.{where}")
            fn = getattr(mod, name)
            key = f"{kernel} {part}"

            def counted(*a, _fn=fn, _key=key, **k):
                counts[_key] = counts.get(_key, 0) + 1
                return _fn(*a, **k)
            saved.append((mod, name, fn))
            setattr(mod, name, counted)
    try:
        yield counts
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def train_kernel_calls(cfg, enc):
    """Calls of #5/#6/#7 in one training forward: every attention or MLA
    layer, each decoder layer's cross attention and each encoder layer
    (with encoder frames), the MTP block's mixer; every Mamba and mLSTM
    layer."""
    from repro_torch.configs.base import ATTN, LOCAL_ATTN, MAMBA, MLSTM
    attn = sum(count_mixers(cfg, k) for k in (ATTN, LOCAL_ATTN, "mla"))
    if cfg.enc_dec and enc:
        attn += cfg.num_layers + cfg.num_encoder_layers
    if cfg.mtp_depth and cfg.layer_pattern[0] in (ATTN, LOCAL_ATTN, "mla"):
        attn += 1
    return {"chunked_prefill_attention": attn,
            "mamba_scan": count_mixers(cfg, MAMBA),
            "mlstm_chunkwise": count_mixers(cfg, MLSTM)}


def smoke_train_batch(torch, cfg, seed):
    """tokens [TRAIN_B, TRAIN_S] and the arch's frontend inputs (patch
    embeddings, encoder frames) from a numpy seed, on the CPU."""
    import numpy as np
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_B, TRAIN_S)).astype(np.int32))}
    if cfg.num_patch_tokens:
        batch["extra_embeds"] = torch.from_numpy((rng.normal(size=(
            TRAIN_B, cfg.num_patch_tokens, cfg.d_model)) * 0.02).astype(
                np.float32))
    if cfg.enc_dec:
        batch["enc_embeds"] = torch.from_numpy((rng.normal(size=(
            TRAIN_B, TRAIN_ENC, cfg.d_model)) * 0.02).astype(np.float32))
    return batch


def train_loss(cfg, params, batch, rctx):
    """``loss_fn`` with every parameter leaf requiring grad; returns (loss,
    the leaves in flattening order)."""
    from repro_torch.models import model as TM
    from repro_torch.train import tree as T
    leaves = [p.requires_grad_() for p in T.leaves(params)]
    return TM.loss_fn(cfg, params, batch, rctx), leaves


def train_smoke_phase(torch, kernels):
    """(a) Every arch's smoke config (fp32, TF32 off) on the card: loss_fn
    and every gradient leaf against the same port code on the CPU with the
    same parameters (the loss to 2e-5 + 2e-5 |ref|, each leaf to 1e-4 x
    max |g_ref|), every leaf's gradient finite, the global norm above 0.
    Under remat "full" the forward launches #5/#6/#7 once per call and
    makes no plain-version call; the backward launches each once more (the
    recompute) and runs each plain version once (its gradient). Returns
    the launches of the phase by kernel."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.models import model as TM
    from repro_torch.params import init_params
    rctx = TM.RunCtx(remat="full")
    totals = {}
    for arch in ARCHS:
        cfg = get_config(arch).smoke()
        cpu_params = init_params(cfg, seed=0, device="cpu")
        batch = smoke_train_batch(torch, cfg, seed=len(arch))
        want = train_kernel_calls(cfg, "enc_embeds" in batch)
        ref_loss, leaves = train_loss(cfg, cpu_params, batch, rctx)
        ref_grads = torch.autograd.grad(ref_loss, leaves, allow_unused=True)
        params = to_device(cpu_params, DEVICE)
        dbatch = {k: v.to(DEVICE) for k, v in batch.items()}
        reset_counts(kernels)
        with plain_calls() as plain:
            loss, leaves = train_loss(cfg, params, dbatch, rctx)
            torch.cuda.synchronize()
            fwd = {k: kernels[k].launches for k in want}
            fwd_plain = dict(plain)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            torch.cuda.synchronize()
            both = {k: kernels[k].launches for k in want}
            all_plain = dict(plain)
        for k, n in want.items():
            totals[k] = totals.get(k, 0) + both[k]
            if fwd[k] != n or both[k] != 2 * n or \
                    all_plain.get(f"{k} backward", 0) != n:
                raise AssertionError(
                    f"train {arch}: {k} launched {fwd[k]} in the forward and "
                    f"{both[k]} in all, its plain backward ran "
                    f"{all_plain.get(f'{k} backward', 0)} times; expected "
                    f"{n}, {2 * n} and {n}")
        if fwd_plain or any("forward" in k for k in all_plain):
            raise AssertionError(f"train {arch}: plain versions ran in the "
                                 f"forward: {fwd_plain}, {all_plain}")
        rl, gl = float(ref_loss.detach()), float(loss.detach())
        check(f"train {arch} loss", torch.tensor([gl]), torch.tensor([rl]),
              2e-5 + 2e-5 * abs(rl))
        norm2, worst = 0.0, 0.0
        for i, (g, r) in enumerate(zip(grads, ref_grads)):
            if (g is None) != (r is None):
                raise AssertionError(f"train {arch}: leaf {i} has a gradient "
                                     f"on one device only")
            if g is None:
                continue
            g = g.cpu()
            lim = 1e-4 * float(r.abs().max())
            _, share = check(f"train {arch} grad leaf {i}", g, r, lim)
            worst = max(worst, share)
            norm2 += float(g.double().square().sum())
        if not (math.isfinite(norm2) and norm2 > 0.0):
            raise AssertionError(f"train {arch}: global norm^2 {norm2}")
        print(f"  train {arch} (smoke, fp32, remat full): loss "
              f"{gl:.6f} (CPU {rl:.6f}); {len(grads)} leaves, "
              f"worst {worst:.3f} of the limit, global norm "
              f"{math.sqrt(norm2):.4f}; launches forward/all "
              + ", ".join(f"{k.split('_')[0]} {fwd[k]}/{both[k]}"
                          for k in want if want[k])
              + f"; plain {all_plain}", flush=True)
    return totals


def train_supervisor_phase(torch):
    """(b) The smoke llama3.2-3b (fp32) on the card under
    ``TrainingSupervisor`` (asynchronous checkpoints every 3 steps, the
    launcher's out-of-memory guard) for 8 steps with a failure injected at
    step 5: exactly one restart, and every loss, replayed ones included,
    equals an uninterrupted run's; a checkpoint written on the card
    restores on the CPU bit for bit."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.launch.train import oom_as_memory_error
    from repro_torch.models import model as TM
    from repro_torch.params import init_params
    from repro_torch.runtime.fault_tolerance import TrainingSupervisor
    from repro_torch.train import checkpoint
    from repro_torch.train import tree as T
    from repro_torch.train.data import DataConfig, PackedSyntheticData
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                              make_train_step)
    cfg = get_config("llama3.2-3b").smoke()
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-2, warmup_steps=0,
                                             total_steps=50))
    step_fn = make_train_step(cfg, TM.RunCtx(remat="full"), tcfg)
    data = PackedSyntheticData(DataConfig(cfg.vocab_size, 64, 4, seed=0))
    batches = [torch.from_numpy(data.batch(i)).to(DEVICE) for i in range(8)]
    root = ROOT / "build" / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)

    def run(name, fail_step):
        params = init_params(cfg, seed=0, device=DEVICE)
        state = {"params": params,
                 "train": init_train_state(cfg, params, tcfg)}
        losses = {}

        def one_step(st, i):
            p, t, m = step_fn(st["params"], st["train"],
                              {"tokens": batches[i]})
            losses.setdefault(i, []).append(float(m["loss"]))
            return {"params": p, "train": t}
        fired = []

        def fail_at(i):
            if i == fail_step and not fired:
                fired.append(i)
                return True
            return False
        sup = TrainingSupervisor(str(root / name), save_every=3)
        state, end, restarts = sup.run(oom_as_memory_error(one_step), state,
                                       0, len(batches), fail_at=fail_at)
        return state, end, restarts, losses

    _, end0, restarts0, clean = run("clean", None)
    state, end, restarts, losses = run("failed", 5)
    if (end0, restarts0, end, restarts) != (8, 0, 8, 1):
        raise AssertionError(f"supervisor: ended at {end0}/{end} with "
                             f"{restarts0}/{restarts} restarts")
    replayed = {i: v for i, v in losses.items() if len(v) > 1}
    if sorted(replayed) != [3, 4] or any(
            x != clean[i][0] for i, v in losses.items() for x in v):
        raise AssertionError(f"supervisor: losses {losses} against an "
                             f"uninterrupted run's {clean}")
    checkpoint.save(str(root / "final"), end, state)
    like = T.tree_map(lambda t: torch.empty_like(t, device="cpu"), state)
    back = checkpoint.restore(str(root / "final"), end, like)
    n = 0
    for a, b in zip(T.leaves(state), T.leaves(back)):
        if a.dtype != b.dtype or not torch.equal(a.detach().cpu(), b):
            raise AssertionError("supervisor: the card's checkpoint did not "
                                 "restore bit for bit on the CPU")
        n += 1
    shutil.rmtree(root, ignore_errors=True)
    print(f"  supervised smoke llama3.2-3b: 8 steps, 1 restart (failure at "
          f"step 5, restored from step 3), losses of steps 3-4 replayed "
          f"and every loss equal to an uninterrupted run's "
          f"({', '.join(f'{clean[i][0]:.4f}' for i in range(8))}); the "
          f"final state ({n} leaves) restored on the CPU bit for bit",
          flush=True)
    return {"restarts": restarts, "losses": clean, "replayed": replayed}


def backward_timings(torch):
    """Each kernel's forward (the kernel) and its Function's backward (the
    plain version recomputed under autograd) timed alone with CUDA events:
    #5 at llama3.2-3b's training layer (bf16, B2, 24 heads over 8, S 2048,
    causal; its bound from the keys each query attends), #6 and #7 at the
    parity phase's B1 S2048 (jamba's d_inner 16384, d_state 16;
    xlstm-125m's 4 heads of 384), bf16."""
    from repro_torch.kernels.chunked_prefill_attention.ops import (
        chunked_prefill_attention_op)
    from repro_torch.kernels.mamba_scan.ops import mamba_scan_fresh_op
    from repro_torch.kernels.mlstm_chunkwise.ops import (
        mlstm_chunkwise_fresh_op)
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    bf = torch.bfloat16

    def rand(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=gen, device=DEVICE) * scale).to(
            dtype).requires_grad_()
    B, S = FULL_B, FULL_S
    lengths = torch.full((B,), S, dtype=torch.int32, device=DEVICE)
    cases = {
        "chunked_prefill_attention": (
            f"llama3.2-3b train layer B{B} S{S} H24 Hkv8 D128 causal bf16",
            lambda q, k, v: chunked_prefill_attention_op(
                q, k, v, lengths, scale=128 ** -0.5),
            (rand(B, 24, S, 128), rand(B, 8, S, 128), rand(B, 8, S, 128))),
        "mamba_scan": (
            f"B1 S2048 d{MAMBA_D} n{MAMBA_N} bf16",
            lambda *a: mamba_scan_fresh_op(*a)[0],
            (rand(1, 2048, MAMBA_D),
             (torch.rand((1, 2048, MAMBA_D), generator=gen, device=DEVICE)
              * 0.1).requires_grad_(),
             rand(1, 2048, MAMBA_N, dtype=torch.float32),
             rand(1, 2048, MAMBA_N, dtype=torch.float32),
             (-torch.arange(1, MAMBA_N + 1, dtype=torch.float32,
                            device=DEVICE).expand(MAMBA_D, MAMBA_N)
              ).contiguous().requires_grad_(),
             torch.ones((MAMBA_D,), device=DEVICE).requires_grad_())),
        "mlstm_chunkwise": (
            f"B1 S2048 H{MLSTM_H} D{MLSTM_D} bf16",
            lambda *a: mlstm_chunkwise_fresh_op(*a)[0],
            (rand(1, 2048, MLSTM_H, MLSTM_D),
             rand(1, 2048, MLSTM_H, MLSTM_D, scale=MLSTM_D ** -0.5),
             rand(1, 2048, MLSTM_H, MLSTM_D),
             rand(1, 2048, MLSTM_H, dtype=torch.float32),
             torch.nn.functional.logsigmoid(
                 torch.randn((1, 2048, MLSTM_H), generator=gen,
                             device=DEVICE) + 4.0).requires_grad_())),
    }
    out = {}
    for name, (shape, fn, ins) in cases.items():
        fwd_ms = cuda_ms(torch, lambda: fn(*ins), iters=5)
        y = fn(*ins)
        w = torch.randn(y.shape, generator=gen, device=DEVICE).to(y.dtype)
        need = [t for t in ins if t.requires_grad]

        def backward():
            torch.autograd.grad(y, need, w, retain_graph=True)
        bwd_ms = cuda_ms(torch, backward, iters=2, warmup=1)
        out[name] = {"shape": shape, "forward_ms": fwd_ms,
                     "backward_ms": bwd_ms,
                     "backward": "plain version through autograd"}
        if name == "chunked_prefill_attention":
            # forward: QK^T and PV over the S(S+1)/2 causal pairs a head
            from repro_torch.kernels.chunked_prefill_attention.kernel \
                import cost
            out[name]["forward_bound_ms"], out[name]["forward_bound_by"] = \
                work_bound(cost(B, 24, 8, S, S, 128, 128, torch.bfloat16))
        print(f"  {name} {shape}: forward (kernel) {fwd_ms:.3f} ms"
              + (f" (bound {out[name]['forward_bound_ms']:.4f} ms, "
                 f"{out[name]['forward_bound_by']})"
                 if "forward_bound_ms" in out[name] else "")
              + f", backward (plain version through autograd) {bwd_ms:.3f} "
              f"ms", flush=True)
        del y, ins
    release(torch)
    return out


WITNESS_LAYERS = 4     # the bf16 gradient witness: llama3.2-3b cut in depth


def witness_cfg():
    """llama3.2-3b at full width (d_model 3072, 24 heads over 8, d_ff
    8192, vocab 128256) cut to ``WITNESS_LAYERS`` layers."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("llama3.2-3b"),
                               num_layers=WITNESS_LAYERS)


def train_bf16_witness(torch):
    """The full-width bf16 gradient held against fp32: the depth-cut
    llama3.2-3b (``witness_cfg``) with random bf16 weights, and the same
    weights cast to fp32 (TF32 off), on the batch of (c) (B 2 x S 2048),
    remat "full". Both go through #5 (bf16: the tensor-core kernel; fp32:
    the scalar loop) and its plain backward. The bf16 loss is held to 1e-2
    x the fp32 loss, and each leaf's bf16 gradient to 0.05 x the fp32
    gradient's L2 norm in L2 norm: bf16 rounding (2^-9 relative a value)
    through four layers stays far inside that, while a wrong or missing
    gradient path is off by its own size."""
    from repro_torch.models import model as TM
    from repro_torch.params import init_params
    from repro_torch.train import tree as T
    from repro_torch.train.data import DataConfig, PackedSyntheticData
    cfg = witness_cfg()
    release(torch)
    rctx = TM.RunCtx(remat="full", loss_vocab_blocks=16)
    data = PackedSyntheticData(DataConfig(cfg.vocab_size, FULL_S, FULL_B,
                                          seed=0))
    batch = {"tokens": torch.from_numpy(data.batch(0)).to(DEVICE)}
    bf = init_params(cfg, seed=0, device=DEVICE)
    runs = {}
    for name, params in (("bf16", bf),
                         ("fp32", T.tree_map(lambda t: t.float(), bf))):
        t0 = time.perf_counter()
        loss, leaves = train_loss(cfg, params, batch, rctx)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        runs[name] = (float(loss.detach()), [g.float() for g in grads],
                      time.perf_counter() - t0)
        del loss, leaves, params
    (l16, g16, s16), (l32, g32, s32) = runs["bf16"], runs["fp32"]
    if not (math.isfinite(l16) and abs(l16 - l32) <= 1e-2 * abs(l32)):
        raise AssertionError(f"bf16 witness: loss {l16} against fp32 {l32}")
    worst, worst_path, min_cos = 0.0, None, 1.0
    paths = [p for p, _ in T.leaves_with_paths(bf)]
    for path, a, b in zip(paths, g16, g32):
        ref = float(torch.linalg.vector_norm(b))
        rel = float(torch.linalg.vector_norm(a - b)) / max(ref, 1e-30)
        cos = float(torch.nn.functional.cosine_similarity(
            a.reshape(1, -1), b.reshape(1, -1)))
        if not (math.isfinite(rel) and ref > 0.0 and rel <= 0.05):
            raise AssertionError(f"bf16 witness: gradient {path} off by "
                                 f"{rel:.4f} of its fp32 norm {ref:.3e}")
        if rel > worst:
            worst, worst_path = rel, path
        min_cos = min(min_cos, cos)
    n2 = [sum(float(g.double().square().sum()) for g in gs)
          for gs in (g16, g32)]
    rec = {"layers": cfg.num_layers, "loss_bf16": l16, "loss_fp32": l32,
           "loss_rel": abs(l16 - l32) / abs(l32), "worst_leaf_rel_l2": worst,
           "worst_leaf": worst_path, "min_cosine": min_cos,
           "grad_norm_bf16": math.sqrt(n2[0]),
           "grad_norm_fp32": math.sqrt(n2[1]), "seconds_bf16": s16,
           "seconds_fp32": s32}
    print(f"  bf16 witness (llama3.2-3b, {cfg.num_layers} of 28 layers, full "
          f"width, B{FULL_B} x S{FULL_S}): loss bf16 {l16:.5f} / fp32 "
          f"{l32:.5f} (rel {rec['loss_rel']:.2e}); {len(paths)} leaves, "
          f"worst |g16 - g32| / |g32| {worst:.4f} ({worst_path}; limit "
          f"0.05), min cosine {min_cos:.5f}; global norm bf16 "
          f"{rec['grad_norm_bf16']:.4f} / fp32 {rec['grad_norm_fp32']:.4f}",
          flush=True)
    del bf, g16, g32, runs, batch
    release(torch)
    return rec


def train_full_phase(torch, kernels):
    """(c) Full-width llama3.2-3b (28 layers, d_model 3072, vocab 128256,
    bf16, nothing cut; random weights from a seed): B 2 x S 2048 from
    ``PackedSyntheticData``, remat "full", grad_accum 1, AdamW (lr
    ``FULL_LR``, no warmup), six steps on one fixed batch: every loss
    finite, the first within ln(V) + 3, the last below the first, #5
    launched 56 times a step (28 forward, 28 recomputed). Prints each
    step's time (CUDA events), tokens a second and 6 N tokens / step time
    as a share of 989 TFLOP/s from the median of the last 4, the peak
    memory, and a traced repeat of one step (#5's device time, the largest
    device entries, the idle share)."""
    import statistics
    from repro_torch.configs import get_config
    from repro_torch.models import model as TM
    from repro_torch.train.data import DataConfig, PackedSyntheticData
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                              make_train_step)
    cfg = get_config("llama3.2-3b")
    release(torch)
    params = load_params(torch, cfg)
    n_params = sum(p.numel() for p in _leaves(params))
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=FULL_LR, warmup_steps=0,
                                             total_steps=1000))
    state = init_train_state(cfg, params, tcfg)
    step_fn = make_train_step(cfg, TM.RunCtx(remat="full",
                                             loss_vocab_blocks=16), tcfg)
    t0 = time.perf_counter()
    data = PackedSyntheticData(DataConfig(cfg.vocab_size, FULL_S, FULL_B,
                                          seed=0))
    batch = {"tokens": torch.from_numpy(data.batch(0)).to(DEVICE)}
    data_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    state_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    cpa = kernels["chunked_prefill_attention"]
    layers = cfg.num_layers
    losses, times, launches = [], [], []
    for i in range(FULL_STEPS):
        reset_counts(kernels)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, state, m = step_fn(params, state, batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
        launches.append(cpa.launches)
        print(f"  step {i}: loss {losses[-1]:.4f}, {times[-1]:.1f} ms, #5 "
              f"launches {launches[-1]}, grad norm "
              f"{float(m['grad_norm']):.3f}", flush=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in losses) or \
            losses[0] > math.log(cfg.vocab_size) + 3.0 or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"full-width training losses {losses}")
    if any(n != 2 * layers for n in launches):
        raise AssertionError(f"#5 launched {launches} a step, expected "
                             f"{2 * layers} ({layers} forward + {layers} "
                             f"recomputed)")
    step_ms = statistics.median(times[-4:])
    tokens = FULL_B * FULL_S
    flops = 6.0 * n_params * tokens
    rec = {"arch": cfg.name, "params_b": n_params / 1e9, "batch": FULL_B,
           "seq": FULL_S, "steps": FULL_STEPS, "losses": losses,
           "step_ms": times, "step_ms_median_last4": step_ms,
           "tokens_per_s": tokens / (step_ms / 1e3),
           "model_flops_share_989": flops / (step_ms / 1e3) / 989e12,
           "cpa_launches_per_step": launches, "state_gb": state_gb,
           "peak_mem_gb": peak_gb, "data_s": data_s}
    print(f"  llama3.2-3b training ({n_params / 1e9:.3f}B parameters, B"
          f"{FULL_B} x S{FULL_S}, remat full): step {step_ms:.1f} ms "
          f"(median of the last 4), {rec['tokens_per_s']:.0f} tokens/s, "
          f"6 N tokens / step time {rec['model_flops_share_989']:.3f} of 989 "
          f"TFLOP/s; parameters + AdamW state {state_gb:.2f} GB, peak "
          f"{peak_gb:.2f} GB; {device_line()}", flush=True)
    torch.cuda.synchronize()
    with profiler(torch) as prof:
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    tr = trace_summary(torch, prof, wall, top=12, names=kernels)
    k5 = [k for k in tr["port_kernels"]
          if "chunked_prefill_attention" in k["name"]]
    rec["traced"] = {**tr, "wall_s": wall,
                     "cpa_device_ms": sum(k["ms"] for k in k5),
                     "cpa_count": sum(k["count"] for k in k5)}
    print(f"  traced step: #5 {rec['traced']['cpa_device_ms']:.3f} ms device "
          f"over {rec['traced']['cpa_count']} launches", flush=True)
    print_trace(tr, wall)
    del params, state, m, batch
    release(torch)
    return rec


class Phases:
    """Prints each phase's start and, when the next one starts, its
    seconds."""

    def __init__(self, count):
        self.count = count
        self.t_all = time.perf_counter()
        self.seconds = {}
        self._open = None

    def start(self, label):
        self.stop()
        n = len(self.seconds) + 1
        print(f"[{n}/{self.count}] {label} (at "
              f"{time.perf_counter() - self.t_all:.1f}s)", flush=True)
        self._open = (label, time.perf_counter())

    def stop(self):
        if self._open:
            label, t0 = self._open
            self.seconds[label] = time.perf_counter() - t0
            print(f"  phase took {self.seconds[label]:.1f}s", flush=True)
            self._open = None


def load_params(torch, cfg):
    from repro_torch.params import init_params
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    print(f"  init_params {cfg.name}: {time.perf_counter() - t0:.2f}s "
          f"({sum(p.numel() for p in _leaves(params)) / 1e9:.3f}B params, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated)")
    return params


def jamba_cut():
    """jamba-1.5-large-398b at every published width (d_model 8192, 64 q /
    8 kv heads of 128, d_ff 24576, Mamba d_inner 16384 / d_state 16 / d_conv
    4 / dt_rank 512, 16 experts top-2 of width 24576, vocab 65536, untied
    head, no RoPE), cut in depth to one 8-layer period: the mixer pattern
    unchanged (7 Mamba, attention at position 3), the FFN dense in layers
    0-6 and MoE in layer 7. One period as published holds four MoE layers
    of 19.3 GB each in bf16, which with the rest (90.5 GB) exceeds one
    80 GB card; the cut holds 18.06 B parameters (36.1 GB)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import DENSE, MOE
    return dataclasses.replace(get_config("jamba-1.5-large-398b"),
                               num_layers=8,
                               ffn_pattern=(DENSE,) * 7 + (MOE,))


JAMBA_REDUCED = [
    "num_layers 72 -> 8 (one period of the pattern, mixers unchanged)",
    "MoE layers 36 -> 1 (layer 7; layers 0-6 dense, which jamba's even "
    "layers are)",
]


def deepseek_cut():
    """deepseek-v3-671b at every published width (d_model 7168, 128 heads,
    MLA q_lora 1536 / kv_lora 512 / qk_nope 128 / qk_rope 64 / v 128, dense
    d_ff 18432, 256 routed experts top-8 of width 2048 plus one shared,
    vocab 129280, untied head), cut in depth to 4 layers: the three
    first_k_dense layers and one MoE layer, with the MTP module (0.69 B,
    which serving does not read). One MoE layer holds 11.3 B parameters
    (256 x 3 x 7168 x 2048); the cut holds 15.8 B (31.6 GB in bf16), the
    published 61 layers 671 B."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("deepseek-v3-671b"), num_layers=4)


DEEPSEEK_REDUCED = [
    "num_layers 61 -> 4 (the 3 first_k_dense layers and 1 MoE layer; every "
    "published width kept)",
    "MoE layers 58 -> 1",
]


def count_mixers(cfg, kind):
    from repro_torch.models.model import build_stacks
    return sum(reps * [m for m, _ in period].count(kind)
               for period, reps in build_stacks(cfg))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        print(f"chip_smoke: needs a compute-capability 9.0 card, got {cap}",
              file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ATTN, MAMBA, MLA, MLSTM
    from repro_torch.kernels import build
    from repro_torch.kernels.chunked_prefill_attention import kernel as cpa_kernel
    from repro_torch.kernels.mamba_scan import kernel as ms_kernel
    from repro_torch.kernels.mlstm_chunkwise import kernel as ml_kernel
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    from repro_torch.kernels.paged_prefill_attention import kernel as ppa_kernel
    kernels = {"paged_attention_fused": pa_kernel.paged_attention_fused,
               "paged_prefill_attention_fused":
                   ppa_kernel.paged_prefill_attention_fused,
               "paged_attention": pa_kernel.paged_attention,
               "paged_prefill_attention": ppa_kernel.paged_prefill_attention,
               "chunked_prefill_attention":
                   cpa_kernel.chunked_prefill_attention,
               "mlstm_chunkwise": ml_kernel.mlstm_chunkwise,
               "mamba_scan": ms_kernel.mamba_scan}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ph = Phases(20)

    ph.start("device")
    dev = device_line()
    print(f"  {dev}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    ph.start("build")
    t0 = time.perf_counter()
    report = build.build()
    print(f"  {len(report)} libraries in {time.perf_counter() - t0:.2f}s",
          flush=True)
    for name, (_, log) in report.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "Function",
                                       "warning")):
                print(f"  {name}: {line.strip()}")
    # the decode library's tensor-core block (bf16 at these head dims; the
    # scalar block takes every other launch): no spill
    for D in (64, 128, 256):
        attrs = build.mma_attributes("paged_attention", D)
        print(f"  paged_attention bf16 tensor-core kernel, D {D}: {attrs}",
              flush=True)
        if attrs["spill_bytes"]:
            raise AssertionError(f"paged_attention D {D}: ptxas spilled "
                                 f"{attrs['spill_bytes']} bytes")
    for name in ("paged_prefill_attention", "chunked_prefill_attention"):
        for D in (64, 128, 256):
            attrs = build.mma_attributes(name, D)
            print(f"  {name} bf16 tensor-core kernel, D {D}: {attrs}",
                  flush=True)
            # the wrappers' checks read the block's rows from the library
            build.check_mma_geometry(name, attrs["rows"], D)
            for G, Dx in ((attrs["rows"] + 1, D), (1, D + 32)):
                try:
                    build.check_mma_geometry(name, G, Dx)
                except ValueError:
                    continue
                raise AssertionError(f"{name}: G {G} at head_dim {Dx} was "
                                     f"taken by the bf16 check")
    # #5's value width of its own: deepseek-v3's MLA pair, and pairs
    # without a kernel refused by both prefill libraries' checks
    cpa = "chunked_prefill_attention"
    attrs = build.mma_attributes(cpa, 192, 128)
    print(f"  {cpa} bf16 tensor-core kernel, (D, Dv) (192, 128): {attrs}",
          flush=True)
    build.check_mma_geometry(cpa, attrs["rows"], 192, 128)
    for name, G, D, Dv in ((cpa, attrs["rows"] + 1, 192, 128),
                           (cpa, 1, 192, 192), (cpa, 1, 128, 64),
                           (cpa, 1, 256, 128),
                           ("paged_prefill_attention", 1, 192, 128),
                           ("paged_prefill_attention", 1, 128, 64)):
        try:
            build.check_mma_geometry(name, G, D, Dv)
        except ValueError:
            continue
        raise AssertionError(f"{name}: G {G} at (D, Dv) ({D}, {Dv}) was "
                             f"taken by the bf16 check")

    ph.start("kernel parity and timing")
    reset_counts(kernels)
    rows = kernel_phase(torch)
    parity_launches = {name: fn.launches for name, fn in kernels.items()}
    parity_combines = combine_count(kernels)

    ph.start("smoke engines, GPU against CPU")
    smoke_engine_phase(torch)
    smoke_engine_phase(torch, "xlstm-125m", modes=("slot",))
    smoke_engine_phase(torch, "jamba-1.5-large-398b", modes=("slot",))
    smoke_engine_phase(torch, "qwen2-moe-a2.7b")
    # window 16: the smoke prompts (19-130 tokens) pass it, so #1, #2 and
    # #5 mask keys by the window on the card
    smoke_engine_phase(torch, "gemma2-2b", window=16)
    smoke_engine_phase(torch, "qwen3-1.7b", modes=("paged",))
    smoke_engine_phase(torch, "gemma2-27b", modes=("paged",), window=16)
    smoke_engine_phase(torch, "deepseek-v3-671b", modes=("slot",))
    reset_counts(kernels)
    smoke_prefill_launches = prefill_decode_phase(torch, kernels)

    ph.start("full-width llama3.2-3b serving, paged cache")
    cfg = get_config("llama3.2-3b")
    params = load_params(torch, cfg)
    launches, serving, streams = serving_phase(torch, params, kernels)
    for name in ("paged_attention_fused", "paged_prefill_attention_fused"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the paged path")
    by_path = {name: {"llama3.2-3b paged": launches[name]}
               for name in ("paged_attention_fused",
                            "paged_prefill_attention_fused")}

    ph.start("full-width llama3.2-3b serving, slot cache")
    layers = cfg.num_layers
    slot_launches, slot_recs = slot_serving_phase(
        torch, cfg, params, kernels,
        {"chunked_prefill_attention": lambda st: layers * st.prefill_calls},
        paged_streams=streams, cut_trace=True)
    serving += slot_recs
    launches["chunked_prefill_attention"] = \
        slot_launches["chunked_prefill_attention"]
    by_path["chunked_prefill_attention"] = {
        "llama3.2-3b slot": slot_launches["chunked_prefill_attention"]}
    combines = {"llama3.2-3b slot":
                slot_launches["chunked_prefill_attention_combine"]}
    del params
    release(torch)

    ph.start("full-width xlstm-125m serving, slot cache")
    xcfg = get_config("xlstm-125m")
    xparams = load_params(torch, xcfg)
    mlstm_layers = count_mixers(xcfg, MLSTM)
    x_launches, x_recs = slot_serving_phase(
        torch, xcfg, xparams, kernels,
        {"mlstm_chunkwise":
             lambda st: mlstm_layers * (st.prefill_calls + st.decode_calls)},
        cut_trace=True)
    serving += x_recs
    launches["mlstm_chunkwise"] = x_launches["mlstm_chunkwise"]
    by_path["mlstm_chunkwise"] = {"xlstm-125m slot":
                                  x_launches["mlstm_chunkwise"]}
    x_mlstm = x_recs[0]["mlstm"]
    x_traced = next((r["mlstm"] for r in x_recs if r.get("traced")), {})
    del xparams
    release(torch)

    ph.start("full-width jamba-1.5-large-398b (8-layer cut) serving, slot "
             "cache")
    jcfg = jamba_cut()
    jparams = load_params(torch, jcfg)
    mamba_layers = count_mixers(jcfg, MAMBA)
    attn_layers = count_mixers(jcfg, ATTN)
    j_launches, j_recs = slot_serving_phase(
        torch, jcfg, jparams, kernels,
        {"mamba_scan":
             lambda st: mamba_layers * (st.prefill_calls + st.decode_calls),
         "chunked_prefill_attention":
             lambda st: attn_layers * st.prefill_calls})
    for rec in j_recs:
        rec["reduced"] = JAMBA_REDUCED
    serving += j_recs
    launches["mamba_scan"] = j_launches["mamba_scan"]
    j_mamba = {**j_recs[0]["mamba"],
               **{k: v for k, v in j_recs[1]["mamba"].items()
                  if k.startswith("traced")}}
    by_path["mamba_scan"] = {"jamba slot": j_launches["mamba_scan"]}
    by_path["chunked_prefill_attention"]["jamba slot"] = \
        j_launches["chunked_prefill_attention"]
    combines["jamba slot"] = j_launches["chunked_prefill_attention_combine"]
    del jparams
    release(torch)

    for arch, workload, runs in (
            ("gemma2-2b", long_workload, PAGED_RUNS),
            ("qwen3-1.7b", serving_workload, ((0, False), (0, True)))):
        ph.start(f"full-width {arch} serving, paged cache")
        acfg = get_config(arch)
        aparams = load_params(torch, acfg)
        a_launches, a_recs, _ = serving_phase(torch, aparams, kernels,
                                              cfg=acfg, workload=workload,
                                              runs=runs, cut_trace=True)
        serving += a_recs
        for name in ("paged_attention_fused",
                     "paged_prefill_attention_fused"):
            if a_launches[name] <= 0:
                raise AssertionError(f"{name} never launched on the "
                                     f"{arch} paged path")
            by_path[name][f"{arch} paged"] = a_launches[name]
        del aparams
        release(torch)

    ph.start("full-width deepseek-v3-671b (4-layer cut) serving, slot cache")
    dcfg = deepseek_cut()
    print(f"  reduced: {DEEPSEEK_REDUCED}")
    dparams = load_params(torch, dcfg)
    mla_layers = count_mixers(dcfg, MLA)
    d_launches, d_recs = slot_serving_phase(
        torch, dcfg, dparams, kernels,
        {"chunked_prefill_attention":
             lambda st: mla_layers * st.prefill_calls})
    for rec in d_recs:
        rec["reduced"] = DEEPSEEK_REDUCED
    serving += d_recs
    by_path["chunked_prefill_attention"]["deepseek-v3 slot"] = \
        d_launches["chunked_prefill_attention"]
    combines["deepseek-v3 slot"] = \
        d_launches["chunked_prefill_attention_combine"]
    del dparams
    release(torch)

    ph.start("full-width llama3.2-3b behind the HTTP/SSE front door")
    params = load_params(torch, cfg)
    h_launches, h_rec = http_phase(torch, params, kernels)
    serving.append(h_rec)
    for name, n in h_launches.items():
        by_path[name]["llama3.2-3b http"] = n

    ph.start("two full-width llama3.2-3b replicas behind the router and HTTP")
    r_launches, r_recs = router_phase(torch, params, kernels)
    serving += r_recs
    for policy, counts in r_launches.items():
        for name, n in counts.items():
            by_path[name][f"llama3.2-3b router {policy}"] = n
    del params
    release(torch)

    ph.start("full-width seamless-m4t-large-v2 prefill and decode")
    s_launches, s_rec = seamless_phase(torch, kernels)
    serving.append(s_rec)
    by_path["chunked_prefill_attention"]["seamless-m4t prefill+decode"] = \
        s_launches
    by_path["chunked_prefill_attention"]["smoke prefill+decode, all archs"] \
        = smoke_prefill_launches
    combines["seamless-m4t prefill+decode"] = s_rec["combine_launches"]

    ph.start("training: every arch's smoke config, the supervisor, "
             "full-width llama3.2-3b")
    smoke_train = train_smoke_phase(torch, kernels)
    supervised = train_supervisor_phase(torch)
    backward = backward_timings(torch)
    witness = train_bf16_witness(torch)
    full_train = train_full_phase(torch, kernels)
    serving.append({"training_full": full_train,
                    "training_supervised": supervised,
                    "training_bf16_witness": witness})
    by_path["chunked_prefill_attention"][
        "smoke training, all archs (forward + recompute)"] = \
        smoke_train["chunked_prefill_attention"]
    by_path["chunked_prefill_attention"][
        f"llama3.2-3b training, {FULL_STEPS} steps"] = \
        sum(full_train["cpa_launches_per_step"])
    for name in ("mamba_scan", "mlstm_chunkwise"):
        by_path[name]["smoke training (forward + recompute)"] = \
            smoke_train[name]

    # the dry runs of phases 18 (c) and 19 (c) need only the host: each
    # runs in a process of its own from here on, beside the card's phases
    sys.path.insert(0, str(ROOT / "tools"))
    import fsdp_phase
    import mesh_all_phase
    phase15 = {"peak_mem_gb": full_train["peak_mem_gb"],
               "flops": 6.0 * full_train["params_b"] * 1e9 * FULL_B * FULL_S}
    dry18 = mesh_all_phase.start_dryrun(dev, phase15)
    dry19 = fsdp_phase.start_dryrun(dev)
    for proc, _ in (dry18, dry19):
        atexit.register(lambda p=proc: p.poll() is None and (p.kill(),
                                                             p.wait()))

    ph.start("sharded paged serving over 1-4 ranks on the card")
    import sharded_phase
    sharded, sharded_launches = sharded_phase.sharded_phase(
        torch, device_line=dev)
    serving.append({"sharded_serving": sharded})
    for name, counts in sharded_launches.items():
        by_path[name].update(counts)

    ph.start("sharded training over 2-4 ranks on the card")
    import train_sharded_phase
    tsharded, ts_launches = train_sharded_phase.train_sharded_phase(
        torch, phase15_loss=full_train["losses"][0], device_line=dev)
    serving.append({"sharded_training": tsharded})
    for name, counts in ts_launches.items():
        by_path[name].update(counts)

    ph.start("every arch on a mesh, and the dry run")
    mesh_all, ma_launches = mesh_all_phase.mesh_all_phase(
        torch, phase15=phase15, device_line=dev, dryrun=dry18)
    serving.append({"mesh_all": mesh_all})
    for name, counts in ma_launches.items():
        by_path[name].update(counts)

    ph.start("ZeRO-3 parameters and the wide batch, and the dry run with "
             "them")
    fsdp, fs_launches = fsdp_phase.fsdp_phase(
        torch, phase15_loss=full_train["losses"][0],
        phase18=mesh_all["dryrun"], device_line=dev, dryrun=dry19)
    serving.append({"fsdp": fsdp})
    for name, counts in fs_launches.items():
        by_path[name].update(counts)

    ph.start("the serving examples: streaming, shared prefix, speculation, "
             "a mesh, the router, the SLO engine driver")
    import examples_phase
    examples, ex_launches = examples_phase.examples_phase(torch,
                                                          device_line=dev)
    serving.append({"examples": examples})
    for name, counts in ex_launches.items():
        by_path[name].update(counts)
    ph.stop()

    rep = {"paged_attention_fused": ("B8 serving-like ctx bf16",
                                     "src/repro_torch/csrc/paged_attention.cu",
                                     "src/repro/kernels/paged_attention/kernel.py:231"),
           "paged_prefill_attention_fused": (
               "R4 Sq512 bf16", "src/repro_torch/csrc/paged_prefill_attention.cu",
               "src/repro/kernels/paged_prefill_attention/kernel.py:271"),
           "paged_attention": ("B8 serving-like ctx bf16",
                               "src/repro_torch/csrc/paged_attention.cu",
                               "src/repro/kernels/paged_attention/kernel.py:95"),
           "paged_prefill_attention": (
               "R4 Sq512 bf16", "src/repro_torch/csrc/paged_prefill_attention.cu",
               "src/repro/kernels/paged_prefill_attention/kernel.py:113"),
           "chunked_prefill_attention": (
               "Sq512 off3584 bf16",
               "src/repro_torch/csrc/chunked_prefill_attention.cu",
               "src/repro/kernels/chunked_prefill_attention/kernel.py:83"),
           "mlstm_chunkwise": (
               "B1 S2048 fresh bf16", "src/repro_torch/csrc/mlstm_chunkwise.cu",
               "src/repro/kernels/mlstm_chunkwise/kernel.py:88"),
           "mamba_scan": (
               "B1 S2048 fresh bf16", "src/repro_torch/csrc/mamba_scan.cu",
               "src/repro/kernels/mamba_scan/kernel.py:56")}
    kernels = []
    for name, (case, source, replaces) in rep.items():
        row = next(r for r in rows if r["kernel"] == name and r["case"] == case)
        err = max(r["max_abs_err"] for r in rows
                  if r["kernel"] == name and r["dtype"] == "bfloat16")
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches.get(name, 0),
                 "max_abs_err": err, "ms": row["ms"],
                 "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                 "bound_by": row["bound_by"],
                 "library_ms": row["library_ms"], "shape": case,
                 "launches_by_path": by_path.get(name, {}),
                 "parity_launches": parity_launches[name],
                 **{k: row[k] for k in ("device_ms", "splits", "registers",
                                        "spill_bytes", "smem_bytes",
                                        "blocks_per_sm") if k in row}}
        if name in backward:
            entry["train_backward"] = backward[name]
        if name == "chunked_prefill_attention":
            # the split-K combine kernel of the same source, launched by the
            # same wrapper call when the plan splits the keys; and the MLA
            # shape (its own value width)
            mla = next(r for r in rows if r["kernel"] == name
                       and r["case"] == MLA_CASE)
            xd = next(r for r in rows if r["kernel"] == name
                      and r["case"] == SEAMLESS_CROSS_DECODE)
            entry["seamless_cross_decode"] = {k: xd.get(k) for k in (
                "case", "ms", "device_ms", "plain_ms", "library_ms",
                "bound_ms", "bound_by", "max_abs_err", "splits")}
            entry.update(combine_launches=sum(combines.values()),
                         combine_launches_by_path=combines,
                         combine_parity_launches=parity_combines,
                         mla={k: mla[k] for k in (
                             "case", "ms", "device_ms", "plain_ms",
                             "library_ms", "bound_ms", "bound_by", "flops",
                             "max_abs_err", "ms_other", "device_ms_other",
                             "splits_other")})
        if name in ("paged_attention_fused", "paged_attention"):
            # which block of the decode library each case ran (the
            # launcher's choice from the shapes), with its device time
            entry["cases"] = [{k: r.get(k) for k in (
                "case", "block", "page_size", "device_ms", "ms", "bound_ms",
                "splits", "max_abs_err")} for r in rows if r["kernel"] == name]
        if name in ("paged_attention", "paged_prefill_attention"):
            entry["note"] = ("serves no path, here or in the reference: "
                             "launched only by the parity phase")
        if name == "mlstm_chunkwise":
            # one call launches one decode kernel (S 1) or three passes
            # (bf16 chunks); decode is most of the path's calls
            dec = next(r for r in rows if r["kernel"] == name and
                       r["case"] == "B8 S1 decode carried bf16")
            entry.update(
                device_ms=row["device_ms"],
                device_ms_cold=row["device_ms_cold"],
                pass_ms=row["pass_ms"], chunk=row["chunk"],
                pass_attributes=ml_kernel.pass_attributes(2048, MLSTM_D),
                cases=[{k: r.get(k) for k in (
                    "case", "chunk", "device_ms", "pass_ms", "ms",
                    "bound_ms", "max_abs_err", "C_limit_share")}
                    for r in rows if r["kernel"] == name],
                kernel_launches=x_mlstm["kernel_launches"],
                decode_calls=x_mlstm["decode_calls"],
                chunk_calls=x_mlstm["chunk_calls"],
                traced={k: v for k, v in x_traced.items()
                        if k.startswith("traced_")},
                decode={"shape": dec["case"], "ms": dec["ms"],
                        "device_ms": dec["device_ms"],
                        "device_ms_cold": dec["device_ms_cold"],
                        "plain_ms": dec["plain_ms"],
                        "bound_ms": dec["bound_ms"],
                        "bound_by": dec["bound_by"]})
        if name == "mamba_scan":
            # S 1 calls launch the decode kernel, chunks the chunk kernel
            dec = next(r for r in rows if r["kernel"] == name and
                       r["case"] == "B8 S1 decode carried bf16")
            entry.update(
                device_ms=row["device_ms"],
                device_ms_cold=row["device_ms_cold"], **j_mamba,
                attributes=ms_kernel.attributes(),
                decode={k: dec[k] for k in (
                    "case", "ms", "device_ms", "device_ms_cold", "plain_ms",
                    "bound_ms", "bound_by", "h_bits_equal")})
        kernels.append(entry)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    total = time.perf_counter() - ph.t_all
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"device": dev, "torch": torch.__version__, "cases": rows,
         "serving": serving, "kernels": kernels,
         "phase_seconds": ph.seconds, "seconds": total}, indent=1))
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in ph.seconds.items()))
    print(f"done in {total:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(device_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
