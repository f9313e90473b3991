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

- ``source``: the source as it is (its defaults: 2 lanes a channel in the
  chunk kernel, every exponential on the SFU's ``ex2.approx``);
- ``no loads`` (``-DMAMBA_CUT=1``): none of the loads of x, dt, B, C and
  the state;
- ``exp as multiply`` (``-DMAMBA_CUT=2``): the exponential replaced by a
  multiply;
- ``no state writes`` (``-DMAMBA_CUT=3``): no stores of y and the state;
- ``expf`` (``-DMAMBA_EXP2=0``): the accurate ``expf`` of dt * A;
- ``poly 0``, ``poly 1``, ``poly 2`` (``-DMAMBA_POLY=0/1/2``): that many
  states of every 8 take the polynomial 2^v on the FMA pipe, the others
  the SFU's ``ex2.approx``;
- ``lanes 1``, ``lanes 2``, ``lanes 4`` (``-DMAMBA_LANES=1/2/4``): that
  many lanes a channel, 16 / L states a lane.

A source without these switches (one older than the lanes design) gives
only ``source``; one with the lanes and exponential switches but not
``MAMBA_POLY`` drops the ``poly`` variants. The cuts give wrong results
and only their times mean anything; the others are also held to the plain
version with ``chip_smoke.py``'s limits (y and h), and each says whether
its new h equals the plain version's bit for bit. Each variant is timed
twice in turns at jamba's shapes (d_inner 16384, d_state 16): B1 S2048
and S1000 fresh and S37 carried chunks in bf16, the decode of 8 of 10
state rows (also with the L2 flushed before each call), B1 S512 in fp32,
and d_state 6 with B and C rows of 68 bytes (the operands the chunk
kernel's tensor maps refuse). Prints the device time a call from a
profiler trace, and the opcode counts of each variant's walk loop (the
bf16 chunk kernel's, from ``cuobjdump -sass`` of its library, where the
toolkit has it), and writes both to
``chiprun_out/mamba_variants_<root>.json``.
"""
from __future__ import annotations

import collections
import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

# (name, nvcc flags, checked against the plain version)
VARIANTS = [("source", [], True),
            ("no loads", ["-DMAMBA_CUT=1"], False),
            ("exp as multiply", ["-DMAMBA_CUT=2"], False),
            ("no state writes", ["-DMAMBA_CUT=3"], False),
            ("expf", ["-DMAMBA_EXP2=0"], True),
            ("poly 0", ["-DMAMBA_POLY=0"], True),
            ("poly 1", ["-DMAMBA_POLY=1"], True),
            ("poly 2", ["-DMAMBA_POLY=2"], True),
            ("lanes 1", ["-DMAMBA_LANES=1"], True),
            ("lanes 2", ["-DMAMBA_LANES=2"], True),
            ("lanes 4", ["-DMAMBA_LANES=4"], True)]
SWITCHES = ("MAMBA_CUT", "MAMBA_EXP2", "MAMBA_LANES")
# (name, B, S, dtype, carried, state rows, d_state, columns before B)
CASES = [("B1 S2048 fresh bf16", 1, 2048, "bfloat16", False, None, 16, 32),
         ("B1 S1000 fresh bf16", 1, 1000, "bfloat16", False, None, 16, 32),
         ("B1 S37 carried bf16", 1, 37, "bfloat16", True, None, 16, 32),
         ("B8 S1 decode carried bf16", 8, 1, "bfloat16", True,
          [3, 0, 7, 1, 6, 2, 9, 4], 16, 32),
         ("B1 S512 carried fp32", 1, 512, "float32", True, None, 16, 32),
         ("B2 S100 carried bf16 n6", 2, 100, "bfloat16", True, None, 6, 5)]
D_INNER = 16384


def variants_of(src: str):
    """The variants a source can build: all of them when it has the
    switches (the ``poly`` ones where it has ``MAMBA_POLY``), else only the
    source as it is."""
    if not all(s in src for s in SWITCHES):
        return VARIANTS[:1]
    if "MAMBA_POLY" not in src:
        return [v for v in VARIANTS if not v[0].startswith("poly")]
    return VARIANTS


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
                      if any(w in ln for w in ("registers", "spill",
                                               "entry function"))]
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in build.SIGNATURES["mamba_scan"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.mamba_scan_error_string.argtypes = [ctypes.c_int]
        lib.mamba_scan_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs, logs


def case_inputs(cases, torch, B, S, dtype, carried, rows, n, lead):
    """chip_smoke.py's #6 inputs: x a column view of the in_proj output,
    dt in [0.001, 0.1], B and C column views after ``lead`` columns, A =
    -(1..n), D = 1."""
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
    d = D_INNER
    Bs = B if rows is None else max(rows) + 1

    def inputs(Bn, Sn):
        x = cases.randn((Bn, Sn, 2 * d), dtype)[..., :d]
        u = torch.rand((Bn, Sn, d), generator=cases.gen, device="cuda")
        dt = torch.exp(u * (math.log(0.1) - math.log(0.001))
                       + math.log(0.001))
        dbc = cases.randn((Bn, Sn, lead + 2 * n), torch.float32)
        return x, dt, dbc[..., lead:lead + n], dbc[..., lead + n:]

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


CUOBJDUMP = "/usr/local/cuda/bin/cuobjdump"
# "        /*0f70*/                   LDS.128 R36, [R43+0x4000] ;": the
# address and the opcode, after an optional predicate
SASS_LINE = re.compile(
    r"\s+/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")


def walk_loop(sass: str):
    """Opcode counts of the walk loop of the bf16 chunk kernel in
    ``cuobjdump -sass`` output: of the innermost loops (a backward
    branch's range holding no other), the one with the most FFMA."""
    best = None
    for sec in sass.split("Function : ")[1:]:
        if "chunk_kernel" not in sec.splitlines()[0] or \
                "bfloat16" not in sec.splitlines()[0]:
            continue
        ins, loops = [], []
        for line in sec.splitlines():
            m = SASS_LINE.match(line)
            if not m:
                continue
            at = int(m.group(1), 16)
            ins.append((at, m.group(3)))
            b = re.search(r"BRA (?:`\(\.L_x_\d+\) )?0x([0-9a-f]+)", line)
            if b and int(b.group(1), 16) < at:
                loops.append((int(b.group(1), 16), at))
        for lo, hi in loops:
            if any(lo <= a and b <= hi and (a, b) != (lo, hi)
                   for a, b in loops):
                continue
            ops = collections.Counter(op for a, op in ins if lo <= a <= hi)
            if best is None or ops["FFMA"] > best["FFMA"]:
                best = ops
    return dict(best) if best else {}


def sass_counts(lib: Path):
    """The walk loop's opcode counts of a built library, or None where
    cuobjdump is missing."""
    if not Path(CUOBJDUMP).exists():
        return None
    out = subprocess.run([CUOBJDUMP, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    return walk_loop(out)


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
    sass = {}
    for name, _, _ in variants:
        ops = sass_counts(Path(libs[name]._name))
        if ops:
            sass[name] = ops
            print(f"  {name}: walk loop {sum(ops.values())} instructions, "
                  f"{ops.get('MUFU', 0)} MUFU, {ops.get('FFMA', 0)} FFMA, "
                  f"{ops.get('FMUL', 0)} FMUL, {ops.get('LDS', 0)} LDS",
                  flush=True)
    cases = cs.Cases(torch)
    inputs = [(cname, dn, case_inputs(cases, torch, B, S, getattr(torch, dn),
                                      carried, rows, n, lead))
              for cname, B, S, dn, carried, rows, n, lead in CASES]
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
         "walk_loop_sass": sass,
         "times": times}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
