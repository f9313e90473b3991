#!/usr/bin/env python3
"""Build variants of the mLSTM chunkwise source (``csrc/mlstm_chunkwise.cu``)
of one checkout side by side and time each through that checkout's
wrapper, in one process on one card:

    python3 tools/mlstm_variants.py [ROOT [VARIANTS.json]]

``ROOT`` is a checkout (default: this one), for example the parent commit
unpacked with ``git archive`` into ``build/parent``; its ``chip_smoke.py``
and ``src/`` are imported. The variants are the source as it is and two
diagnostic cuts: no loads (the kernels compute on whatever their tiles
hold) and no compute (the kernels only stream their tiles), which say
whether a kernel is bound by its loads or by its instruction stream. A
source that defines ``MLSTM_CUT`` is cut by building it with
``-DMLSTM_CUT=1`` (loads) or ``2`` (compute); the scalar chunk loop, which
does not, is cut by the text substitutions of ``LOOP_CUTS``. A source that
defines ``MLSTM_CHUNK`` (the bf16 passes' chunk length, chosen by S when
0) also gives the variants "chunk 64" and "chunk 128"
(``-DMLSTM_CHUNK=64``, ``128``: one length at every S; the wrapper sizes
the scratch from the library's plan). A JSON file
of further variants, ``{name: {"sub": {old: new}, "flags": [...]}}``, adds
its own (text substitutions in the source, extra nvcc flags). Each variant
is built with the repository's nvcc flags into
``build/mlstm_variants/<root>/<variant>/`` and timed, twice in turns, at
the xlstm-125m shapes (4 heads, head_dim 384, bf16) of the serving path:
B1 S2048, S1000 and S512 chunks, B1 S37, the decode of 8 rows, a batch of 4 at
S300 (the training forward's shape), B1 S200 and B1 S512 at head_dim 96.
Prints, per variant and case, the device time a call from a profiler trace
(both turns) and the device time of each of its kernels (the bf16 passes
apart), and writes them to ``chiprun_out/mlstm_variants_<root>.json``.
"""
from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

# the scalar chunk loop (csrc/mlstm_chunkwise.cu path 3, and the whole bf16
# path of sources without the passes): its q/k/v reads and its four
# product loops, each guarded by a condition that is false at run time
# (tests/test_torch_ssm.py checks the anchors)
LOOP_CUTS = {
    "no loads": {
        "        if (t < L) {\n": "        if (t < L && D < 0) {\n",
        "t < L ? paged::to_float(k_bh": "t < L && D < 0 ? paged::to_float(k_bh",
        "v_s[i] = s < L ? paged::to_float(v_bh":
            "v_s[i] = s < L && D < 0 ? paged::to_float(v_bh"},
    "no compute": {
        "      if (any_pair) {": "      if (any_pair && D < 0) {",
        "            sum = fmaf(qrow[dd], ccol[dd * DV], sum);":
            "            if (D < 0) sum = fmaf(qrow[dd], ccol[dd * DV], sum);",
        "          pv = fmaf(sc[t * kLoopChunk + s], v_s[s * DV + j], pv);":
            "          if (D < 0) pv = fmaf(sc[t * kLoopChunk + s], v_s[s * DV + j], pv);",
        "          sum = fmaf(k_s[s * kPad + dd] * w_s[s], v_s[s * DV + j], sum);":
            "          if (D < 0) sum = fmaf(k_s[s * kPad + dd] * w_s[s], v_s[s * DV + j], sum);"},
}
VARIANTS = ("source", "no loads", "no compute")
CHUNK_VARIANTS = {"chunk 64": 64, "chunk 128": 128}
# (name, B, S, carried, state rows, head_dim)
CASES = [("B1 S2048 fresh", 1, 2048, False, None, 384),
         ("B1 S1000 fresh", 1, 1000, False, None, 384),
         ("B1 S512 carried", 1, 512, True, None, 384),
         ("B1 S37 carried", 1, 37, True, None, 384),
         ("B8 S1 decode", 8, 1, True, [3, 0, 7, 1, 6, 2, 9, 4], 384),
         ("B4 S300 fresh", 4, 300, False, None, 384),
         ("B1 S200 carried", 1, 200, True, None, 384),
         ("B1 S512 carried D96", 1, 512, True, None, 96)]
H = 4


def variant_names(src: str, extra=None):
    """The variants a source gives: the source, its two cuts, the forced
    chunk lengths where the source defines MLSTM_CHUNK, then ``extra``'s."""
    names = list(VARIANTS)
    if "MLSTM_CHUNK" in src:
        names += list(CHUNK_VARIANTS)
    return (*names, *(extra or {}))


def variant_source(src: str, name: str, extra=None):
    """(source text, extra nvcc flags) of variant ``name``; ``extra`` maps
    the names of further variants to their substitutions and flags."""
    if name == "source":
        return src, []
    if extra and name in extra:
        for old, new in extra[name].get("sub", {}).items():
            if old not in src:
                raise ValueError(f"{name}: {old!r} not in the source")
            src = src.replace(old, new)
        return src, list(extra[name].get("flags", []))
    if name in CHUNK_VARIANTS:
        return src, [f"-DMLSTM_CHUNK={CHUNK_VARIANTS[name]}"]
    if "MLSTM_CUT" in src:
        return src, [f"-DMLSTM_CUT={VARIANTS.index(name)}"]
    for old, new in LOOP_CUTS[name].items():
        if src.count(old) != 1:
            raise ValueError(f"{name}: {old!r} is not once in the source")
        src = src.replace(old, new)
    return src, []


def build_variants(build, tag, names, extra):
    base = (build.CSRC / "mlstm_chunkwise.cu").read_text()
    root = Path(__file__).resolve().parents[1]
    procs = {}
    for name in names:
        src, flags = variant_source(base, name, extra)
        out = root / "build" / "mlstm_variants" / tag / name.replace(" ", "_")
        out.mkdir(parents=True, exist_ok=True)
        (out / "mlstm_chunkwise.cu").write_text(src)
        cmd = [build.nvcc(), *build.NVCC_FLAGS, *flags, "-I",
               str(build.CSRC), "-o", str(out / "lib.so"),
               str(out / "mlstm_chunkwise.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out / "lib.so")
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in build.SIGNATURES["mlstm_chunkwise"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.mlstm_chunkwise_error_string.argtypes = [ctypes.c_int]
        lib.mlstm_chunkwise_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def kernel_times(torch, fn, iters):
    """Device ms a call of each kernel ``fn`` launches (profiler trace)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            name = e.name().replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].split()[-1]
            out[name] = out.get(name, 0.0) + e.duration_ns() / iters / 1e6
    return out


def main(argv) -> int:
    root = Path(argv[1] if len(argv) > 1 else ".").resolve()
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.mlstm_chunkwise import kernel as MK
    from repro_torch.kernels.mlstm_chunkwise.ref import (NEG_INF,
                                                         mlstm_chunkwise_ref)
    if not torch.cuda.is_available():
        print("mlstm_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    tag = "this" if root == Path(__file__).resolve().parents[1] else root.name
    extra = json.loads(Path(argv[2]).read_text()) if len(argv) > 2 else {}
    names = variant_names((build.CSRC / "mlstm_chunkwise.cu").read_text(),
                          extra)
    libs = build_variants(build, tag, names, extra)
    print(cs.device_line(), flush=True)
    cases = cs.Cases(torch)
    bf = torch.bfloat16
    inputs = []
    for cname, B, S, carried, rows, D in CASES:
        q = cases.randn((B, S, H * D), bf).view(B, S, H, D)
        k = (cases.randn((B, S, H * D), bf) / math.sqrt(D)).view(B, S, H, D)
        v = cases.randn((B, S, H * D), bf).view(B, S, H, D)
        gates = cases.randn((B, S, 2 * H), torch.float32)
        li = gates[..., :H]
        lf = torch.nn.functional.logsigmoid(gates[..., H:] + 4.0)
        Bs = B if rows is None else max(rows) + 1
        C = torch.zeros((Bs, H, D, D), device="cuda")
        n = torch.zeros((Bs, H, D), device="cuda")
        m = torch.full((Bs, H), NEG_INF, device="cuda")
        if carried:
            g = cases.randn((Bs, 100, 2 * H), torch.float32)
            _, n, m = mlstm_chunkwise_ref(
                cases.randn((Bs, 100, H, D), bf),
                cases.randn((Bs, 100, H, D), bf) / math.sqrt(D),
                cases.randn((Bs, 100, H, D), bf), g[..., :H],
                torch.nn.functional.logsigmoid(g[..., H:] + 4.0), C, n, m)
        rows_t = None if rows is None else torch.tensor(rows, device="cuda")
        inputs.append((cname, (q, k, v, li, lf, C, n, m), rows_t))
    times = {}
    for _ in range(2):
        for name in names:
            build._loaded["mlstm_chunkwise"] = libs[name]
            if hasattr(MK, "plan"):
                MK.plan.cache_clear()
            for cname, args, rows_t in inputs:
                def run():
                    return MK.mlstm_chunkwise(*args, rows=rows_t)
                t = times.setdefault(f"{name} | {cname}",
                                     {"device_ms": [], "ms": []})
                t["device_ms"].append(cs.device_ms(torch, run, 10))
                t["ms"].append(cs.cuda_ms(torch, run, 10))
                if "kernels" not in t:
                    t["kernels"] = kernel_times(torch, run, 10)
    for name in names:
        print(f"{name}:")
        for cname, *_ in inputs:
            t = times[f"{name} | {cname}"]
            per = "".join(f"  {k} {v:.4f}" for k, v in
                          t.get("kernels", {}).items())
            print(f"  {cname:<16} device ms {t['device_ms'][0]:.4f} "
                  f"{t['device_ms'][1]:.4f}  events ms {t['ms'][0]:.4f}{per}")
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / f"mlstm_variants_{tag}.json").write_text(json.dumps(
        {"root": str(root), "device": cs.device_line(), "times": times},
        indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
