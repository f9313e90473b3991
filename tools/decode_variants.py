#!/usr/bin/env python3
"""Build variants of the paged decode kernel (``csrc/paged_attention.cu``)
side by side and time each through the real wrapper, in one process on one
card:

    python3 tools/decode_variants.py [VARIANTS.json]

A variant is a set of text substitutions in the source (``"sub"``), extra
nvcc flags (``"flags"``) and, optionally, attributes of the wrapper module
``kernels/paged_attention/kernel.py`` to set while it runs (``"plan"``,
e.g. ``{"SPLIT_OVERHEAD_TILES": 1}`` for the tensor-core block's split
plan, ``{"SPLIT_BLOCKS_PER_SM": 3}`` for the scalar block's). Without an
``"splits": n`` launches every case with n key splits instead of the
plan's. Without an
argument the variants are the source as it is and the diagnostic cuts of
``DIAGNOSTIC``, two for each of the library's blocks: no K/V loads (the
block computes on whatever its ring holds) and no compute (the block only
streams its pages), which say whether a block is bound by its loads or by
its instruction stream. The tensor-core block (bf16 at head_dim 64, 128,
256) runs the bf16 cases, the scalar block the fp32 one. Each variant is
built with the repository's nvcc flags into
``build/decode_variants/<name>/`` and timed, twice in turns, at
llama3.2-3b's decode shapes (24 query heads over 8 kv heads, head_dim
128, pages of 16): B1 at 4093 keys, B8 and B64 at up to 4096, the
serving-like B8 and B8 in fp32; jamba's G 8 (B4) and gemma2-2b's serving
batch (8 heads over 4 kv heads, head_dim 256, window 4096, softcap 50). A
variant that is not a diagnostic cut is checked against the plain version
first. Prints, per variant and case, the splits, the device time a call
from a profiler trace (both turns) and the time a call with CUDA events,
and writes them to ``chiprun_out/decode_variants.json``.
"""
from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# anchors in csrc/paged_attention.cu (tests/test_torch_decode_split.py
# checks that they are there): the scalar block's cuts
NO_LOADS = {"        mma::cp_async16(k_dst": "        if (a.D < 0) mma::cp_async16(k_dst",
            "        mma::cp_async16(v_dst": "        if (a.D < 0) mma::cp_async16(v_dst"}
NO_COMPUTE = {
    "    // scores of the chunk: fp32 dot products reduced over the L lanes,\n":
        "    if (a.D < 0) {\n",
    "    __syncwarp();                         // the slot may be refilled":
        "    }\n    __syncwarp();"}
# ... and the tensor-core block's: the producer arms each stage's full
# barrier for no bytes and issues no copy; the consumers wait for each tile
# and hand its stage back, and issue no product (their end still runs)
WGMMA_NO_LOADS = {
    "      if (lane == 0) wg::mbar_expect_tx(full + 8 * s, Geo::STAGE);":
        "      if (lane == 0) wg::mbar_expect_tx(full + 8 * s, 0);",
    "          wg::tma_load_2d(ring + s * Geo::STAGE":
        "          if (a.D < 0) wg::tma_load_2d(ring + s * Geo::STAGE"}
WGMMA_NO_COMPUTE = {
    "  if (mine > 0) {\n":
        "  for (int i = 0; i < mine; ++i) {\n"
        "    const int jj = c + kConsumers * i;\n"
        "    wg::mbar_wait(full + 8 * (jj % S), (jj / S) & 1);\n"
        "    if (lane == 0) wg::mbar_arrive(empty + 8 * (jj % S));\n"
        "  }\n"
        "  if (mine > 0 && a.D < 0) {\n"}
DIAGNOSTIC = {"no loads": {"sub": NO_LOADS, "diag": True},
              "no compute": {"sub": NO_COMPUTE, "diag": True},
              "wgmma no loads": {"sub": WGMMA_NO_LOADS, "diag": True},
              "wgmma no compute": {"sub": WGMMA_NO_COMPUTE, "diag": True}}


def build_variants(build, variants):
    base = (build.CSRC / "paged_attention.cu").read_text()
    procs = {}
    for name, spec in variants.items():
        src = base
        for old, new in spec.get("sub", {}).items():
            if old not in src:
                raise ValueError(f"variant {name}: {old!r} not in the source")
            src = src.replace(old, new)
        out = ROOT / "build" / "decode_variants" / name.replace(" ", "_")
        out.mkdir(parents=True, exist_ok=True)
        (out / "paged_attention.cu").write_text(src)
        cmd = [build.nvcc(), *build.NVCC_FLAGS, *spec.get("flags", []),
               "-I", str(build.CSRC), "-o", str(out / "lib.so"),
               str(out / "paged_attention.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out / "lib.so")
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in build.SIGNATURES["paged_attention"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main(argv) -> int:
    import chip_smoke as cs
    import numpy as np
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import kernel as PK
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_fused_ref)
    if not torch.cuda.is_available():
        print("decode_variants: no CUDA device", file=sys.stderr)
        return 1
    variants = ({"source": {}, **DIAGNOSTIC} if len(argv) < 2 else
                json.loads(Path(argv[1]).read_text()))
    libs = build_variants(build, variants)
    print(cs.device_line(), flush=True)
    cases = cs.Cases(torch)
    rng = np.random.default_rng(7)
    bf = torch.bfloat16
    edges = [4096, 16, 13, 4088]
    llama = dict(G=3, Hkv=8, D=128)
    gemma = dict(G=2, Hkv=4, D=256, window=4096, softcap=50.0)
    shapes = [("B1", [4093], bf, llama),
              ("B8", edges + [int(x) for x in rng.integers(1, 4097, 4)], bf,
               llama),
              ("B64", edges + [int(x) for x in rng.integers(1, 4097, 60)],
               bf, llama),
              ("B8 serving-like",
               [int(x) + 40 for x in rng.integers(128, 2049, 8)], bf, llama),
              ("B8 fp32", edges + [int(x) for x in rng.integers(1, 4097, 4)],
               torch.float32, llama),
              ("B4 G8", [2000, 1, 700, 4096], bf, dict(G=8, Hkv=8, D=128)),
              ("gemma2-2b B8",
               [int(x) for x in rng.integers(4097, 6145, 4)]
               + [int(x) for x in rng.integers(128, 2049, 4)], bf, gemma)]
    inputs = []
    for cname, lens, dtype, geo in shapes:
        lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
        n = 1 << max(math.ceil(max(lens) / cs.PAGE) - 1, 0).bit_length()
        kv, bt, _ = cases.pool_and_tables(lens, n, geo["Hkv"], geo["D"],
                                          dtype)
        q = cases.randn((len(lens), geo["Hkv"] * geo["G"], geo["D"]), dtype)
        kw = dict(scale=geo["D"] ** -0.5, window=geo.get("window", 0),
                  softcap=geo.get("softcap", 0.0))
        want = paged_attention_fused_ref(q, kv, bt, lens_t, **kw)
        inputs.append((cname, q, kv, bt, lens_t, kw, geo["Hkv"], want))
    saved = {}
    times = {}
    for _ in range(2):
        for name, spec in variants.items():
            build._loaded["paged_attention"] = libs[name]
            for attr, value in spec.get("plan", {}).items():
                saved.setdefault(attr, getattr(PK, attr))
                setattr(PK, attr, value)
            PK._planned.cache_clear()
            PK.wgmma_attributes.cache_clear()
            build.mma_attributes.cache_clear()
            plan = PK.planned_splits
            if "splits" in spec:
                PK.planned_splits = lambda *args, n=spec["splits"]: n
            for cname, q, kv, bt, lens_t, kw, Hkv, want in inputs:
                print(f"  {name} | {cname}", flush=True)

                def run():
                    return PK.paged_attention_fused(q, kv, bt, lens_t, **kw)
                if not spec.get("diag"):
                    cs.check(f"{name} {cname}", run(), want,
                             cs.vec_limit(want, str(q.dtype).split(".")[-1]))
                t = times.setdefault(f"{name} | {cname}", {
                    "splits": PK.planned_splits(q, bt, Hkv, cs.PAGE),
                    "device_ms": [], "ms": []})
                t["device_ms"].append(cs.device_ms(torch, run, 20))
                t["ms"].append(cs.cuda_ms(torch, run, 20))
            for attr, value in saved.items():
                setattr(PK, attr, value)
            PK.planned_splits = plan
    PK._planned.cache_clear()
    for name in variants:
        print(f"{name}:")
        for cname, *_ in inputs:
            t = times[f"{name} | {cname}"]
            print(f"  {cname:<16} {t['splits']:3d} splits  device ms "
                  f"{t['device_ms'][0]:.4f} {t['device_ms'][1]:.4f}  "
                  f"events ms {t['ms'][0]:.4f}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "decode_variants.json").write_text(json.dumps(
        {"device": cs.device_line(), "variants": variants,
         "times": times}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
