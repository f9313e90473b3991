#!/usr/bin/env python3
"""Build variants of the paged decode kernel (``csrc/paged_attention.cu``)
side by side and time each through the real wrapper, in one process on one
card:

    python3 tools/decode_variants.py [VARIANTS.json]

A variant is a set of text substitutions in the source (``"sub"``) and,
optionally, the split plan's blocks an SM (``"blocks_per_sm"``). Without
an argument the variants are the source as it is and the two diagnostic
cuts of ``DIAGNOSTIC``: no K/V loads (the block computes on whatever the
ring holds) and no compute (the block only streams its pages), which say
whether the block is bound by its loads or by its instruction stream.
Each variant is built with the repository's nvcc flags into
``build/decode_variants/<name>/`` and timed, twice in turns, at
llama3.2-3b's decode shapes (24 query heads over 8 kv heads, head_dim
128, pages of 16): B1 at 4093 keys, B8 and B64 at up to 4096, the
serving-like B8 and B8 in fp32. A variant that is not a diagnostic cut
is checked against the plain version first. Prints, per variant and
case, the device time a call from a profiler trace (both turns) and the
time a call with CUDA events, and writes them to
``chiprun_out/decode_variants.json``.
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
# checks that they are there)
NO_LOADS = {"        mma::cp_async16(k_dst": "        if (a.D < 0) mma::cp_async16(k_dst",
            "        mma::cp_async16(v_dst": "        if (a.D < 0) mma::cp_async16(v_dst"}
NO_COMPUTE = {
    "    // scores of the chunk: fp32 dot products reduced over the L lanes,\n":
        "    if (a.D < 0) {\n",
    "    __syncwarp();                         // the slot may be refilled":
        "    }\n    __syncwarp();"}
DIAGNOSTIC = {"no loads": {"sub": NO_LOADS, "diag": True},
              "no compute": {"sub": NO_COMPUTE, "diag": True}}


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
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
               str(out / "lib.so"), str(out / "paged_attention.cu")]
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
    shapes = [("B1", [4093], bf),
              ("B8", edges + [int(x) for x in rng.integers(1, 4097, 4)], bf),
              ("B64", edges + [int(x) for x in rng.integers(1, 4097, 60)],
               bf),
              ("B8 serving-like",
               [int(x) + 40 for x in rng.integers(128, 2049, 8)], bf),
              ("B8 fp32", edges + [int(x) for x in rng.integers(1, 4097, 4)],
               torch.float32)]
    inputs = []
    for cname, lens, dtype in shapes:
        lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
        n = 1 << max(math.ceil(max(lens) / cs.PAGE) - 1, 0).bit_length()
        kv, bt, _ = cases.pool_and_tables(lens, n, 8, 128, dtype)
        q = cases.randn((len(lens), 24, 128), dtype)
        want = paged_attention_fused_ref(q, kv, bt, lens_t,
                                         scale=128 ** -0.5)
        inputs.append((cname, q, kv, bt, lens_t, want))
    plan = PK.SPLIT_BLOCKS_PER_SM
    times = {}
    for _ in range(2):
        for name, spec in variants.items():
            build._loaded["paged_attention"] = libs[name]
            PK.SPLIT_BLOCKS_PER_SM = spec.get("blocks_per_sm", plan)
            PK._planned.cache_clear()
            for cname, q, kv, bt, lens_t, want in inputs:
                def run():
                    return PK.paged_attention_fused(q, kv, bt, lens_t,
                                                    scale=128 ** -0.5)
                if not spec.get("diag"):
                    cs.check(f"{name} {cname}", run(), want,
                             cs.vec_limit(want, str(q.dtype).split(".")[-1]))
                t = times.setdefault(f"{name} | {cname}", {
                    "splits": PK.planned_splits(q, bt, 8), "device_ms": [],
                    "ms": []})
                t["device_ms"].append(cs.device_ms(torch, run, 20))
                t["ms"].append(cs.cuda_ms(torch, run, 20))
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
