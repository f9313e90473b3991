#!/usr/bin/env python3
"""Phase 20 of ``chip_smoke.py``: the port's serving examples on the card
(``examples/serve_streaming_torch.py``, ``serve_slo_engine_torch.py``,
``router_smoke_torch.py``). Alone (it builds the kernels first):

    python3 tools/examples_phase.py

(a) In process, the example CLIs (``main(argv)``) at their own smoke
    sizes (the smoke llama3.2-3b, fp32, seed 0's weights as the CPU draws
    them), each under its example's checks (the reference's assertions):
    the streaming demo paged and slot, ``--shared-prefix``, ``--spec-k 4``
    greedy and sampled (temperature 0.7, top-k 20, seed 9), and the SLO
    engine driver (every request finishes). The demo, the shared-prefix
    and the greedy speculation runs give the streams of the same CLIs with
    ``--device cpu`` (the kernels' plain versions). The kernels' counters
    are set to 0 just before each run and read just after: #1 and #2
    launch once a layer for each decode and each chunk or verify dispatch,
    with one readback a round, #5 once a layer for each slot chunk.
(b) The mesh: a world of 2 spawned ranks sharing the card over gloo (NCCL
    refuses two ranks on one device), mesh ``"2"`` (one KV head a rank):
    the demo, ``--shared-prefix`` and ``--spec-k 4``; the driver's records
    equal (a)'s mesh-less ones on the card and pass the checks, and each
    rank launched #1/#2 once a layer for each of the driver's dispatches.
(c) The router smoke as a subprocess (its HTTP server a subprocess of its
    own, two replicas on the card): its five checks pass and it exits 0.
    It starts first and runs beside (a) and (b).
(d) Full-width llama3.2-3b (bf16, nothing cut; the caller's weights, or
    seed 0's): the streaming demo and the shared-prefix scenario. Checked
    is what bf16 summation order leaves intact: one readback per round, no
    page leaked, the cancelled stream aborted, a prefix hit rate above 0,
    fewer prefill tokens computed with the cache, #1/#2 once a layer a
    dispatch. Printed: how many cache-on streams equal the cache-off ones
    (near-tied bf16 logits may follow the batch) and whether the stop-token
    request stopped at the chat's second token.
"""
from __future__ import annotations

import importlib.util
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

KV = 4096                     # the examples' default --kv-tokens
PAGED = ("paged_attention_fused", "paged_prefill_attention_fused")
ROUTER_TIMEOUT = 300.0


def load_example(name):
    """``examples/<name>.py`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_fns():
    """The wrappers of the kernels the examples run, by name."""
    from repro_torch.kernels.chunked_prefill_attention import kernel as cpa
    from repro_torch.kernels.paged_attention import kernel as pa
    from repro_torch.kernels.paged_prefill_attention import kernel as ppa
    return {"paged_attention_fused": pa.paged_attention_fused,
            "paged_prefill_attention_fused":
                ppa.paged_prefill_attention_fused,
            "chunked_prefill_attention": cpa.chunked_prefill_attention}


def counted(fns, fn, *args, **kw):
    """(``fn``'s result, each kernel's launches in it): the counters set to
    0 just before and read just after."""
    for k in fns.values():
        k.launches = 0
    out = fn(*args, **kw)
    return out, {name: k.launches for name, k in fns.items()}


def runs_of(name, rec):
    """A scenario's runs (the prefix and speculation smokes have two)."""
    if name == "prefix":
        return list(rec["runs"].values())
    if name in ("spec", "sampled"):
        return rec["runs"]
    return [rec]


def stats_of(name, rec):
    """Each run's counters as ``chip_smoke.paged_launch_check`` reads
    them."""
    return [{**run["calls"], "token_readbacks": run["readbacks"],
             "iterations": run["iterations"]} for run in runs_of(name, rec)]


def check_launches(what, layers, stats, got):
    """#1 once a layer for each decode dispatch, #2 for each chunk or
    verify dispatch, both at least once; one readback a round."""
    cs.paged_launch_check(what, layers, stats, *(got[k] for k in PAGED))


def streams(name, rec):
    """What must equal across devices or meshes: the token streams and
    finish reasons (the demo), each run's streams (the others)."""
    if rec is None:
        return None
    if name in ("demo", "slot"):
        return {k: rec[k] for k in ("chat", "chat_reason", "spam",
                                    "spam_reason", "stop_out",
                                    "stop_reason", "batch")}
    return [run["tokens"] for run in runs_of(name, rec)]


# ---- (a) in process -----------------------------------------------------------
# the example CLIs' runs in (a): name, serve_streaming_torch's flags
CLI_RUNS = (("demo", ["--cache-mode", "paged"]),
            ("slot", ["--cache-mode", "slot"]),
            ("prefix", ["--shared-prefix"]),
            ("spec", ["--spec-k", "4"]),
            ("sampled", ["--spec-k", "4", "--temperature", "0.7", "--top-k",
                         "20", "--sample-seed", "9"]))
COMPARED = ("demo", "slot", "prefix", "spec")   # against the CPU's streams


def in_process(torch, fns):
    """The example CLIs on the card, each under its own checks, then the
    compared ones again on the CPU."""
    from repro_torch.configs import get_config
    ex = load_example("serve_streaming_torch")
    slo = load_example("serve_slo_engine_torch")
    layers = get_config("llama3.2-3b").smoke().num_layers
    dev = ["--device", cs.DEVICE]
    recs, launches, seconds = {}, {}, {}
    for name, argv in CLI_RUNS + (("slo", None),):
        print(f"  (a) {name}:", flush=True)
        t0 = time.perf_counter()
        main = slo.main if name == "slo" else ex.main
        rec, got = counted(fns, main, (argv or []) + dev)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        if name == "slot":
            want = layers * rec["calls"]["prefill_calls"]
            if got["chunked_prefill_attention"] != want or want <= 0:
                raise AssertionError(f"(a) slot demo: #5 launched "
                                     f"{got['chunked_prefill_attention']} "
                                     f"times, {want} chunk layers")
        else:
            check_launches(f"(a) {name}", layers, stats_of(name, rec), got)
        if name == "slo" and sorted(map(len, rec["tokens"].values())) != \
                sorted(rec["max_output"].values()):
            raise AssertionError(f"(a) SLO engine driver: unfinished "
                                 f"requests {rec['tokens']}")
        recs[name], launches[name] = rec, got
    # the CPU's streams (the kernels' plain versions) on the same weights
    for name, argv in CLI_RUNS:
        if name not in COMPARED:
            continue
        cpu = ex.main(argv + ["--device", "cpu"])
        if streams(name, cpu) != streams(name, recs[name]):
            raise AssertionError(f"(a) {name}: the card's streams "
                                 f"{streams(name, recs[name])} != the CPU's "
                                 f"{streams(name, cpu)}")
        print(f"  (a) {name}: the card's streams == the CPU's", flush=True)
    return recs, launches, seconds


# ---- (b) the mesh ---------------------------------------------------------------
def mesh_rank(rank, world, rank_device):
    """The demo, --shared-prefix and --spec-k 4 on mesh ``"world"``; every
    rank returns the records (None on a worker) and its own #1/#2
    launches over the three."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.params import init_params_on_host
    ex = load_example("serve_streaming_torch")
    cfg = get_config("llama3.2-3b").smoke()
    mesh = make_serving_mesh(str(world))
    kw = dict(device=rank_device, kv_capacity_tokens=KV, mesh=mesh,
              params=init_params_on_host(cfg, 0, rank_device))
    fns = {k: v for k, v in kernel_fns().items() if k in PAGED}
    for k in fns.values():
        k.launches = 0
    out = {"demo": ex.streaming_demo(cfg, cache_mode="paged", **kw),
           "prefix": ex.shared_prefix_smoke(cfg, **kw),
           "spec": ex.spec_smoke(cfg, spec_k=4, **kw)}
    out["launches"] = {name: k.launches for name, k in fns.items()}
    return out


def mesh_part(base, world=2):
    """(b): the driver's records against ``base``, (a)'s mesh-less ones."""
    from repro_torch.configs import get_config
    from repro_torch.launch.local_world import spawn_world
    ex = load_example("serve_streaming_torch")
    layers = get_config("llama3.2-3b").smoke().num_layers
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_world(mesh_rank, world, tmp, device=cs.DEVICE,
                            timeout=300.0, group_timeout=240.0,
                            rank_device=cs.DEVICE)
    drv = ranks[0]
    stats = []
    for name, check in (("demo", ex.check_demo),
                        ("prefix", ex.check_shared_prefix),
                        ("spec", ex.check_spec)):
        rec = drv[name]
        if rec is None or any(r[name] is not None for r in ranks[1:]):
            raise AssertionError(f"(b) {name}: the driver's record is None, "
                                 f"or a worker's is not")
        check(rec)
        if streams(name, rec) != streams(name, base[name]):
            raise AssertionError(f"(b) {name} at mesh {world}: streams "
                                 f"{streams(name, rec)} != the mesh-less "
                                 f"card's {streams(name, base[name])}")
        stats += stats_of(name, rec)
    for r, res in enumerate(ranks):
        check_launches(f"(b) rank {r}", layers, stats, res["launches"])
    calls = {k: sum(st[k] for st in stats)
             for k in ("decode_calls", "prefill_calls", "spec_calls")}
    return {"world": world, "calls": calls,
            "launches": [r["launches"] for r in ranks],
            "prefix_hit": drv["prefix"]["runs"][True]["cache_info"][
                "hit_rate"],
            "spec_info": drv["spec"]["runs"][0]["spec_info"]}


# ---- (c) the router smoke ------------------------------------------------------
def start_router():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    args = [] if cs.DEVICE == "cuda" else ["--device", cs.DEVICE]
    return subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / "router_smoke_torch.py"),
         *args], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True), time.perf_counter()


def finish_router(proc, t0):
    try:
        out, _ = proc.communicate(timeout=ROUTER_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"(c) router smoke outlived {ROUTER_TIMEOUT} "
                             f"s:\n{out}")
    lines = [line for line in out.splitlines()
             if line.startswith(("parity OK", "cancel OK", "router OK",
                                 "shutdown OK", "ROUTER SMOKE"))]
    if proc.returncode != 0 or len(lines) != 5:
        raise AssertionError(f"(c) router smoke exited {proc.returncode}:"
                             f"\n{out}")
    return {"seconds": time.perf_counter() - t0, "lines": lines}


# ---- (d) full width -------------------------------------------------------------
def full_width(torch, fns, params=None):
    from repro_torch.configs import get_config
    from repro_torch.params import init_params
    ex = load_example("serve_streaming_torch")
    cfg = get_config("llama3.2-3b")
    if params is None:
        params = init_params(cfg, seed=0, device=cs.DEVICE)
    kw = dict(kv_capacity_tokens=KV, device=cs.DEVICE, params=params)
    out = {}
    t0 = time.perf_counter()
    demo, got = counted(fns, ex.streaming_demo, cfg, cache_mode="paged", **kw)
    torch.cuda.synchronize()
    out["demo_s"] = time.perf_counter() - t0
    if demo["pool"][0] != demo["pool"][1]:
        raise AssertionError(f"(d) demo: KV pages leaked {demo['pool']}")
    if demo["spam_reason"] != "aborted":
        raise AssertionError(f"(d) demo: the cancelled stream ended "
                             f"{demo['spam_reason']!r}")
    check_launches("(d) demo", cfg.num_layers, stats_of("demo", demo), got)
    out["demo"] = {k: demo[k] for k in ("iterations", "readbacks", "aborted",
                                        "calls", "pool", "spam_reason",
                                        "stop_reason")}
    out["demo"]["stop_at_second_token"] = demo["stop_out"] == demo["chat"][:2]
    out["demo"]["launches"] = got

    t0 = time.perf_counter()
    prefix, got = counted(fns, ex.shared_prefix_smoke, cfg, **kw)
    torch.cuda.synchronize()
    out["prefix_s"] = time.perf_counter() - t0
    for pc, run in prefix["runs"].items():
        if run["pool"][0] != run["pool"][1]:
            raise AssertionError(f"(d) prefix_cache={pc}: KV pages leaked")
    on, off = prefix["runs"][True], prefix["runs"][False]
    if on["cache_info"]["hit_rate"] <= 0:
        raise AssertionError("(d) the shared system prompt never hit the "
                             "cache")
    if (on["cache_info"]["prefill_tokens_computed"]
            >= off["cache_info"]["prefill_tokens_computed"]):
        raise AssertionError("(d) cache hits did not reduce prefill work")
    check_launches("(d) prefix", cfg.num_layers, stats_of("prefix", prefix),
                   got)
    agree = sum(a == b for a, b in zip(on["tokens"], off["tokens"]))
    out["prefix"] = {
        "hit_tokens": on["cache_info"]["hit_tokens"],
        "prompt_tokens": on["cache_info"]["prompt_tokens"],
        "hit_rate": on["cache_info"]["hit_rate"],
        "prefill_computed_on": on["cache_info"]["prefill_tokens_computed"],
        "prefill_computed_off": off["cache_info"]["prefill_tokens_computed"],
        "streams_equal_on_off": agree, "streams": len(on["tokens"]),
        "iterations": [on["iterations"], off["iterations"]],
        "launches": got}
    return out


# ---- the phase ------------------------------------------------------------------
def examples_phase(torch, params=None, device_line=None):
    """Phase 20 (see the module docstring). Returns its record and the
    launches of the examples' paths."""
    device_line = device_line or cs.device_line()
    fns = kernel_fns()
    t_all = time.perf_counter()
    router, t_router = start_router()
    try:
        recs, launches, seconds = in_process(torch, fns)
        cs.release(torch)
        t0 = time.perf_counter()
        mesh = mesh_part(recs)
        mesh["seconds"] = time.perf_counter() - t0
        print(f"  (b) mesh 2: every check; streams == the mesh-less card's; "
              f"#1/#2 by rank {[tuple(r.values()) for r in mesh['launches']]}"
              f" = {len(mesh['launches'])} ranks x layers x "
              f"{mesh['calls']} ({mesh['seconds']:.1f}s)", flush=True)
        t0 = time.perf_counter()
        full = full_width(torch, fns, params)
        full["seconds"] = time.perf_counter() - t0
        cs.release(torch)
        rt = finish_router(router, t_router)
    finally:
        if router.poll() is None:
            os.killpg(router.pid, signal.SIGKILL)
            router.wait(10)
    for line in rt["lines"]:
        print(f"  (c) {line}", flush=True)
    d, p = full["demo"], full["prefix"]
    print(f"  (d) full-width llama3.2-3b demo: {d['iterations']} rounds, as "
          f"many readbacks; cancelled stream {d['spam_reason']}; stop at the "
          f"chat's second token: {d['stop_at_second_token']}; #1/#2 "
          f"{tuple(d['launches'][k] for k in PAGED)} ({full['demo_s']:.1f}s)"
          f" [{device_line}]", flush=True)
    print(f"  (d) full-width shared prefix: hit {p['hit_tokens']}/"
          f"{p['prompt_tokens']} prompt tokens ({p['hit_rate']:.0%}), "
          f"computed {p['prefill_computed_off']} -> "
          f"{p['prefill_computed_on']}; cache-on streams equal to cache-off: "
          f"{p['streams_equal_on_off']} of {p['streams']}; #1/#2 "
          f"{tuple(p['launches'][k] for k in PAGED)} ({full['prefix_s']:.1f}s)"
          f" [{device_line}]", flush=True)
    rec = {"device": device_line, "seconds": time.perf_counter() - t_all,
           "in_process_seconds": seconds, "in_process_launches": launches,
           "mesh": mesh, "router": rt, "full_width": full}
    by_path = {}
    for name, got in launches.items():
        for k, n in got.items():
            if n:
                by_path.setdefault(k, {})[f"examples smoke {name}"] = n
    for r, got in enumerate(mesh["launches"]):
        for k, n in got.items():
            by_path.setdefault(k, {})[f"examples smoke mesh 2 rank {r}"] = n
    for part in ("demo", "prefix"):
        for k, n in full[part]["launches"].items():
            if n:
                by_path.setdefault(k, {})[
                    f"examples llama3.2-3b full width {part}"] = n
    return rec, by_path


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("examples_phase: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    dev = cs.device_line()
    print(f"{dev}; torch {torch.__version__}", flush=True)
    t0 = time.perf_counter()
    build.build()
    print(f"build: {time.perf_counter() - t0:.1f}s", flush=True)
    rec, by_path = examples_phase(torch, device_line=dev)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "examples_phase.json").write_text(json.dumps(
        {"record": rec, "launches": by_path}, indent=1, default=str))
    print(f"phase 20: {rec['seconds']:.1f}s [{dev}]")
    print(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
