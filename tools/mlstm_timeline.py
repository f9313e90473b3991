#!/usr/bin/env python3
"""Where one block of the mLSTM kernel's bf16 state and output passes
spends its time, on the SM's clock:

    python3 tools/mlstm_timeline.py

Builds a copy of ``csrc/mlstm_chunkwise.cu`` into ``build/mlstm_timeline/``
with ``clock64()`` stamps added by text substitution (``STATE_STAMPS``,
``OUT_STAMPS``; the source itself has none), launches it through the C interface at
xlstm-125m's shapes (4 heads, head_dim 384, bf16, a fresh state) at B1
S2048 (chunks of 128) and S512 (chunks of 64), and prints, for block (0, 0, 0) of each pass, the cycles
since the block started at each stamp:

- the state pass, per chunk: each consumer warpgroup's thread 0 when the
  chunk's planes are ready, when its product is issued, when its
  chunk-start tile is staged and when its product is done; the producer
  lane when the chunk's stage is free; a transform thread when the
  chunk's loads have landed and when its planes are formed; the storer
  lane when warpgroup 1's tile is staged and when its store has read it;
- the output pass (chunk 0): the prologue, the m chain, m_t and g_t, the
  scores split, each D slice's loads landed and its products done (all
  but the last, which the next slice's wait covers), q.n summed, the V
  tile landed, s.V done.

The stamps go into gate scratch the passes no longer read (the raw scores
of (b, h) 0 for the state pass, the carry exponents of (b, h) 0 for the
output pass), so h of those blocks is wrong; only the times mean anything.
Writes ``chiprun_out/mlstm_timeline.json``.
"""
from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# (text, the text with a stamp) of each pass's section of the source:
# STAMP(k) writes slot k of chunk c (trace[16c + k]), OSTAMP(k) slot k
STATE_STAMPS = [
    ("  const int R = stages * G::STAGE;\n  unsigned char* stg_g = base + R;\n",
     "  const int R = stages * G::STAGE;\n  unsigned char* stg_g = base + R;\n"
     "  const long long t_start = clock64();\n"
     "  float* trace = blockIdx.x == 0 && blockIdx.y == 0 && "
     "blockIdx.z == 0 ? gv.scores : nullptr;\n"
     "#define STAMP(k) if (trace) trace[16 * c + (k)] = "
     "(float)(clock64() - t_start);\n"),
    ("        wg::mbar_wait(empty + 8 * s, ((c / stages) & 1) ^ 1);\n",
     "        wg::mbar_wait(empty + 8 * s, ((c / stages) & 1) ^ 1);\n"
     "        STAMP(8)\n"),
    ("      wg::mbar_wait(full + 8 * s, (c / stages) & 1);\n",
     "      wg::mbar_wait(full + 8 * s, (c / stages) & 1);\n"
     "      if (tt == 0) { STAMP(9) }\n"),
    ("      if (lane == 0) wg::mbar_arrive(ready + 8 * s);\n",
     "      if (lane == 0) wg::mbar_arrive(ready + 8 * s);\n"
     "      if (tt == 0) { STAMP(10) }\n"),
    ("          wg::mbar_wait(staged + 8 * g, c & 1);\n",
     "          wg::mbar_wait(staged + 8 * g, c & 1);\n"
     "          if (g == 1) { STAMP(11) }\n"),
    ("          wg::mbar_arrive(freed + 8 * g);\n",
     "          wg::mbar_arrive(freed + 8 * g);\n"
     "          if (g == 1) { STAMP(12) }\n"),
    ("    wg::mbar_wait(ready + 8 * s, (c / stages) & 1);\n"
     "    if (g == 1) stage_out(c);\n",
     "    wg::mbar_wait(ready + 8 * s, (c / stages) & 1);\n"
     "    if (t % 128 == 0) { STAMP(4 * g) }\n"
     "    if (g == 1) stage_out(c);\n"
     "    if (t % 128 == 0 && g == 1) { STAMP(6) }\n"),
    ("    wg::wgmma_commit();\n    if (g == 0) stage_out(c);\n",
     "    wg::wgmma_commit();\n    if (t % 128 == 0) { STAMP(4 * g + 1) }\n"
     "    if (g == 0) stage_out(c);\n"
     "    if (t % 128 == 0 && g == 0) { STAMP(2) }\n"),
    ("    wg::wgmma_wait<0>();\n    wg::fence_regs(pr);\n",
     "    wg::wgmma_wait<0>();\n    wg::fence_regs(pr);\n"
     "    if (t % 128 == 0) { STAMP(4 * g + 3) }\n"),
]
OUT_STAMPS = [
    ("  const int R = stages * G::STAGE;\n  const uint32_t v_s = ring + R;\n",
     "  const int R = stages * G::STAGE;\n  const uint32_t v_s = ring + R;\n"
     "  const long long t_start = clock64();\n"
     "  float* trace = blockIdx.x == 0 && blockIdx.y == 0 && "
     "blockIdx.z == 0 ? gv.tok + kA * gv.Sp : nullptr;\n"
     "#define OSTAMP(k) if (trace && t == 0) trace[(k)] = "
     "(float)(clock64() - t_start);\n"),
    ("  for (int i = t; i < 2 * c; i += kThreads) last_s[i] = gv.last[i];\n"
     "  __syncthreads();\n",
     "  for (int i = t; i < 2 * c; i += kThreads) last_s[i] = gv.last[i];\n"
     "  __syncthreads();\n  OSTAMP(0)\n"),
    ("    *m0_s = m;\n  }\n  wg::named_sync(1, 128 * kWG);\n",
     "    *m0_s = m;\n  }\n  wg::named_sync(1, 128 * kWG);\n  OSTAMP(1)\n"),
    ("    g_s[t] = t < L ? expf(inter - m_t) : 0.f;\n  }\n"
     "  wg::named_sync(1, 128 * kWG);\n",
     "    g_s[t] = t < L ? expf(inter - m_t) : 0.f;\n  }\n"
     "  wg::named_sync(1, 128 * kWG);\n  OSTAMP(2)\n"),
    ("    rs[x] += __shfl_xor_sync(kFull, rs[x], 2);\n  }\n",
     "    rs[x] += __shfl_xor_sync(kFull, rs[x], 2);\n  }\n  OSTAMP(3)\n"),
    ("    wg::mbar_wait(full + 8 * s, (j / stages) & 1);\n",
     "    wg::mbar_wait(full + 8 * s, (j / stages) & 1);\n"
     "    OSTAMP(4 + 2 * j)\n"),
    ("    wg::wgmma_wait<1>();            // slice j - 1's products are done\n",
     "    wg::wgmma_wait<1>();            // slice j - 1's products are done\n"
     "    OSTAMP(5 + 2 * j)\n"),
    ("  wg::named_sync(2 + wgi, 128);\n",
     "  wg::named_sync(2 + wgi, 128);\n  OSTAMP(40)\n"),
    ("  wg::mbar_wait(vbar, 0);\n", "  wg::mbar_wait(vbar, 0);\n  OSTAMP(41)\n"),
    ("  wg::wgmma_commit();\n  wg::wgmma_wait<0>();\n  wg::fence_regs(acc);\n",
     "  wg::wgmma_commit();\n  wg::wgmma_wait<0>();\n  wg::fence_regs(acc);\n"
     "  OSTAMP(42)\n"),
]
SECTIONS = ("// ---- 2b. the state pass", "// ---- 2c. the output pass",
            "// 3. the fp32 chunk loop")


def stamped_source(src: str) -> str:
    """The source with the state and output passes' stamps (each anchor
    once in its pass's section, or ValueError)."""
    head, rest = src.split(SECTIONS[0], 1)
    state, rest = rest.split(SECTIONS[1], 1)
    out, tail = rest.split(SECTIONS[2], 1)
    parts = []
    for text, stamps in ((state, STATE_STAMPS), (out, OUT_STAMPS)):
        for old, new in stamps:
            if text.count(old) != 1:
                raise ValueError(f"not once in its pass: {old!r}")
            text = text.replace(old, new)
        parts.append(text)
    return (head + SECTIONS[0] + parts[0] + SECTIONS[1] + parts[1] +
            SECTIONS[2] + tail)


def main() -> int:
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.mlstm_chunkwise import kernel as MK
    from repro_torch.kernels.mlstm_chunkwise.ref import NEG_INF, chunk_length
    if not torch.cuda.is_available():
        print("mlstm_timeline: no CUDA device", file=sys.stderr)
        return 1
    src = stamped_source((build.CSRC / "mlstm_chunkwise.cu").read_text())
    out_dir = ROOT / "build" / "mlstm_timeline"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "mlstm_chunkwise.cu").write_text(src)
    res = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I",
                          str(build.CSRC), "-o", str(out_dir / "lib.so"),
                          str(out_dir / "mlstm_chunkwise.cu")],
                         capture_output=True, text=True)
    if res.returncode:
        print(res.stdout + res.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(out_dir / "lib.so"))
    for fn, argtypes in build.SIGNATURES["mlstm_chunkwise"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.mlstm_chunkwise_error_string.argtypes = [ctypes.c_int]
    lib.mlstm_chunkwise_error_string.restype = ctypes.c_char_p
    build._loaded["mlstm_chunkwise"] = lib
    MK.plan.cache_clear()
    dev = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(dev, flush=True)
    report = {"device": dev, "runs": []}
    B, H, D = 1, 4, 384
    bf = torch.bfloat16
    for S in (2048, 512):
        gen = torch.Generator(device="cuda").manual_seed(0)

        def rn(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        q = rn(B, S, H * D).to(bf).view(B, S, H, D)
        k = (rn(B, S, H * D) / math.sqrt(D)).to(bf).view(B, S, H, D)
        v = rn(B, S, H * D).to(bf).view(B, S, H, D)
        gates = rn(B, S, 2 * H)
        li = gates[..., :H]
        lf = torch.nn.functional.logsigmoid(gates[..., H:] + 4.0)
        C = torch.zeros((B, H, D, D), device="cuda")
        n = torch.zeros((B, H, D), device="cuda")
        m = torch.full((B, H), NEG_INF, device="cuda")
        _, g_n, c_n, n_n = MK.plan(S, D, True)
        LC = chunk_length(bf, S)
        nc = -(-S // LC)
        for _ in range(3):      # the last of three calls, warm
            g_scr = torch.zeros(B * H * g_n, device="cuda")
            c_scr = torch.empty(B * H * c_n, device="cuda", dtype=bf)
            n_scr = torch.empty(B * H * n_n, device="cuda")
            h = torch.empty((B, S, H, D), device="cuda", dtype=bf)
            n_out = torch.empty((B, H, D), device="cuda")
            m_out = torch.empty((B, H), device="cuda")
            build.check("mlstm_chunkwise", lib.mlstm_chunkwise_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), li.data_ptr(),
                lf.data_ptr(), *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], *li.stride(), *lf.stride(), C.data_ptr(),
                n.data_ptr(), m.data_ptr(), None, C.stride(0), n.stride(0),
                m.stride(0), h.data_ptr(), n_out.data_ptr(),
                m_out.data_ptr(), g_scr.data_ptr(), c_scr.data_ptr(),
                n_scr.data_ptr(), B, S, H, D, 1,
                torch.cuda.current_stream().cuda_stream))
            torch.cuda.synchronize()
        Sp = nc * LC
        scores = g_scr[4 * Sp + ((2 * nc + 3) & ~3):]
        st = scores[:16 * nc].view(nc, 16).cpu().int().tolist()
        ot = g_scr[3 * Sp:3 * Sp + 44].cpu().int().tolist()
        print(f"S {S}, chunks of {LC}: state pass block (0, 0, 0), cycles "
              f"since it started, per chunk: warpgroup 0 (ready, issued, "
              f"staged, done) | warpgroup 1 (ready, staged, issued, done) | "
              f"producer stage free | transform loads landed, planes "
              f"formed | storer staged, read")
        for c, r in enumerate(st):
            print(f"  {c:2d}  {r[0]:6d} {r[1]:6d} {r[2]:6d} {r[3]:6d} | "
                  f"{r[4]:6d} {r[6]:6d} {r[5]:6d} {r[7]:6d} | {r[8]:6d} | "
                  f"{r[9]:6d} {r[10]:6d} | {r[11]:6d} {r[12]:6d}")
        slices = [(ot[4 + 2 * j], ot[5 + 2 * j]) for j in range((D + 63) // 64)]
        print(f"  output pass block (0, 0, 0): prologue {ot[0]}, m chain "
              f"{ot[1]}, m_t and g_t {ot[2]}, scores split {ot[3]}, slices "
              f"(loaded, products done) {slices}, q.n {ot[40]}, V "
              f"{ot[41]}, s.V done {ot[42]}")
        report["runs"].append({"S": S, "chunk": LC, "state": st,
                               "output": ot})
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "mlstm_timeline.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
