#!/usr/bin/env python3
"""Build variants of the Mamba selective-scan source (``csrc/mamba_scan.cu``)
of one checkout side by side and time each through that checkout's
wrapper, in one process on one card:

    python3 tools/mamba_variants.py [ROOT]

``ROOT`` is a checkout (default: this one), for example the parent commit
unpacked with ``git archive`` into ``build/parent``; its ``chip_smoke.py``
and ``src/`` are imported. The variants are built with the repository's
nvcc flags plus the variant's own into
``build/mamba_variants/<root>/<variant>/``:

- ``source``: the source as it is (2 lanes a channel in the chunk
  kernel, ``ex2.approx`` of dt * (A log2 e));
- ``no loads`` (``-DMAMBA_CUT=1``): none of the loads of x, dt, B, C and
  the state;
- ``exp as multiply`` (``-DMAMBA_CUT=2``): the exponential replaced by a
  multiply;
- ``no state writes`` (``-DMAMBA_CUT=3``): no stores of y and the state;
- ``expf`` (``-DMAMBA_EXP2=0``): the accurate ``expf`` of dt * A, which
  gives the plain version's state bit for bit;
- ``lanes 4`` (``-DMAMBA_LANES=4``): 4 lanes a channel, 4 states a lane;
- ``expf lanes 4``: both.

A source without these switches (one older than the lanes design) gives
only ``source``. The cuts give wrong results and only their times mean
anything; the others are also held to the plain
version with ``chip_smoke.py``'s limits (y and h), and each says whether
its new h equals the plain version's bit for bit. Each variant is timed
twice in turns at jamba's shapes (d_inner 16384, d_state 16): B1 S2048
and S1000 fresh and S37 carried chunks in bf16, the decode of 8 of 10
state rows (also with the L2 flushed before each call), and B1 S512 in
fp32. Prints the device time a call from a profiler trace and writes the
times to ``chiprun_out/mamba_variants_<root>.json``.
"""
from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

# (name, nvcc flags, checked against the plain version)
VARIANTS = [("source", [], True),
            ("no loads", ["-DMAMBA_CUT=1"], False),
            ("exp as multiply", ["-DMAMBA_CUT=2"], False),
            ("no state writes", ["-DMAMBA_CUT=3"], False),
            ("expf", ["-DMAMBA_EXP2=0"], True),
            ("lanes 4", ["-DMAMBA_LANES=4"], True),
            ("expf lanes 4", ["-DMAMBA_EXP2=0", "-DMAMBA_LANES=4"], True)]
SWITCHES = ("MAMBA_CUT", "MAMBA_EXP2", "MAMBA_LANES")
# (name, B, S, dtype, carried, state rows)
CASES = [("B1 S2048 fresh bf16", 1, 2048, "bfloat16", False, None),
         ("B1 S1000 fresh bf16", 1, 1000, "bfloat16", False, None),
         ("B1 S37 carried bf16", 1, 37, "bfloat16", True, None),
         ("B8 S1 decode carried bf16", 8, 1, "bfloat16", True,
          [3, 0, 7, 1, 6, 2, 9, 4]),
         ("B1 S512 carried fp32", 1, 512, "float32", True, None)]
D_INNER, D_STATE = 16384, 16


def variants_of(src: str):
    """The variants a source can build: all of them when it has the
    switches, else only the source as it is."""
    if all(s in src for s in SWITCHES):
        return VARIANTS
    return VARIANTS[:1]


def build_variants(build, tag, variants):
    src = build.CSRC / "mamba_scan.cu"
    root = Path(__file__).resolve().parents[1]
    procs = {}
    for name, flags, _ in variants:
        out = root / "build" / "mamba_variants" / tag / name.replace(" ", "_")
        out.mkdir(parents=True, exist_ok=True)
        cmd = [build.nvcc(), *build.NVCC_FLAGS, *flags, "-I",
               str(build.CSRC), "-o", str(out / "lib.so"), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out / "lib.so")
    libs, logs = {}, {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        logs[name] = [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln]
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in build.SIGNATURES["mamba_scan"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.mamba_scan_error_string.argtypes = [ctypes.c_int]
        lib.mamba_scan_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs, logs


def case_inputs(cases, torch, B, S, dtype, carried, rows):
    """chip_smoke.py's #6 inputs: x a column view of the in_proj output,
    dt in [0.001, 0.1], B and C column views, A = -(1..n), D = 1."""
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
    d, n = D_INNER, D_STATE
    Bs = B if rows is None else max(rows) + 1

    def inputs(Bn, Sn):
        x = cases.randn((Bn, Sn, 2 * d), dtype)[..., :d]
        u = torch.rand((Bn, Sn, d), generator=cases.gen, device="cuda")
        dt = torch.exp(u * (math.log(0.1) - math.log(0.001))
                       + math.log(0.001))
        dbc = cases.randn((Bn, Sn, 32 + 2 * n), torch.float32)
        return x, dt, dbc[..., 32:32 + n], dbc[..., 32 + n:]

    A = -torch.arange(1, n + 1, dtype=torch.float32,
                      device="cuda").expand(d, n).contiguous()
    Dp = torch.ones((d,), device="cuda")
    h = torch.zeros((Bs, d, n), device="cuda")
    if carried:
        mamba_scan_ref(*inputs(Bs, 100), A, Dp, h)
    rows_t = None if rows is None else torch.tensor(rows, device="cuda")
    return inputs(B, S), A, Dp, h, rows_t


def parity(cs, torch, MK, name, args, A, Dp, h, rows_t, dn):
    """Shares of chip_smoke.py's limits of y and h, and whether h is
    bit-identical to the plain version's; raises past a limit."""
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
    h_got, h_want = h.clone(), h.clone()
    got = MK.mamba_scan(*args, A, Dp, h_got, rows=rows_t)
    want = mamba_scan_ref(*args, A, Dp, h_want, rows=rows_t)
    torch.cuda.synchronize()
    idx = list(range(args[0].shape[0])) if rows_t is None else \
        rows_t.tolist()
    _, y_share = cs.check(f"{name} y", got, want, cs.vec_limit(want, dn))
    _, h_share = cs.check(f"{name} h", h_got[idx], h_want[idx],
                          1e-5 + 1e-4 * h_want[idx].abs())
    return {"y_limit_share": y_share, "h_limit_share": h_share,
            "h_bits_equal": bool(torch.equal(h_got[idx], h_want[idx]))}


def main(argv) -> int:
    root = Path(argv[1] if len(argv) > 1 else ".").resolve()
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.mamba_scan import kernel as MK
    if not torch.cuda.is_available():
        print("mamba_variants: no CUDA device", file=sys.stderr)
        return 1
    tag = "this" if root == Path(__file__).resolve().parents[1] else root.name
    variants = variants_of((build.CSRC / "mamba_scan.cu").read_text())
    libs, logs = build_variants(build, tag, variants)
    print(cs.device_line(), flush=True)
    for name, lines in logs.items():
        print(f"  {name}: " + " | ".join(lines))
    cases = cs.Cases(torch)
    inputs = [(cname, dn, case_inputs(cases, torch, B, S, getattr(torch, dn),
                                      carried, rows))
              for cname, B, S, dn, carried, rows in CASES]
    times = {}
    for turn in range(2):
        for name, _, checked in variants:
            build._loaded["mamba_scan"] = libs[name]
            for cname, dn, (args, A, Dp, h, rows_t) in inputs:
                t = times.setdefault(f"{name} | {cname}",
                                     {"device_ms": [], "ms": []})
                if turn == 0 and checked:
                    t.update(parity(cs, torch, MK, f"{name} | {cname}", args,
                                    A, Dp, h, rows_t, dn))
                hw = h.clone()

                def run():
                    return MK.mamba_scan(*args, A, Dp, hw, rows=rows_t)
                t["device_ms"].append(cs.device_ms(torch, run, 10))
                t["ms"].append(cs.cuda_ms(torch, run, 10))
                if rows_t is not None and turn == 0:
                    t["device_ms_cold"] = cs.cold_device_ms(
                        torch, run, 10, "mamba_scan")
    for name, _, _ in variants:
        print(f"{name}:")
        for cname, *_ in inputs:
            t = times[f"{name} | {cname}"]
            extra = "".join(f"  {k} {t[k]}" for k in (
                "device_ms_cold", "y_limit_share", "h_limit_share",
                "h_bits_equal") if k in t)
            print(f"  {cname:<26} device ms {t['device_ms'][0]:.4f} "
                  f"{t['device_ms'][1]:.4f}  events ms {t['ms'][0]:.4f}"
                  f"{extra}")
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / f"mamba_variants_{tag}.json").write_text(json.dumps(
        {"root": str(root), "device": cs.device_line(), "ptxas": logs,
         "times": times}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
