#!/usr/bin/env python3
"""Time the CUDA kernels of one checkout on the card, so that two
checkouts can be compared in one chip call, in turns:

    python3 tools/kernel_ab.py OLD && python3 tools/kernel_ab.py . \
        && python3 tools/kernel_ab.py . && python3 tools/kernel_ab.py OLD

``OLD`` is another checkout (for example ``git archive`` of the parent
commit unpacked into ``build/``). Each run imports that checkout's
``chip_smoke.py`` (which puts its ``src/`` first on the path), builds its
kernels and times a fixed set of its decode and prefill parity cases, its
chunked-prefill cases (llama3.2-3b's and jamba's heads, and the short deep
chunks that split-K cuts; and deepseek-v3's MLA shapes where the chunked
kernel takes a value width of its own), the mLSTM chunkwise cases of
``MLSTM_CASES``
(the xlstm-125m shapes of the parity phase), its decode cases at
llama3.2-3b's heads, jamba's G 8, G 12 at D 64 and gemma2-2b's serving
batch, its split-pool decode and
prefill cases and the Mamba
selective-scan cases of ``MAMBA_CASES`` (jamba's shapes, and the smoke
config's d_inner 128) where it has those kernels (CUDA events; inputs from
fixed seeds, the same in both checkouts). A checkout
whose chunked kernel splits the keys also times each split case with one
split (``splits_other``, ``ms_other``), and gives the chunked cases' device
times (``device_ms``, ``device_ms_other``); so does one whose decode
kernels split the keys for the decode cases, and one whose paged prefill
kernel splits the keys for the prefill cases of ``PREFILL_CASES``
(llama3.2-3b's, jamba's G 8 and gemma2-2b's D 256). Every decode, prefill
and split-pool case and every mLSTM and Mamba case gives its device time
on either checkout (``device_ms``, timed here where the checkout's case
does not time it; the Mamba cases also with the L2 flushed,
``device_ms_cold``); a decode case
that fails its check on a checkout is recorded with its ``error``. Prints
one JSON line ``{"root": ..., "rows": [...]}``.
"""
from __future__ import annotations

import ast
import json
import math
import sys
from pathlib import Path


def own_split_k_cases():
    """``SPLIT_K_CASES`` of the chip_smoke.py beside this tool (the newest
    checkout), read without importing it, so that both checkouts of an A/B
    time the same split-K cases; the run imports the checkout under test."""
    src = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    for node in ast.parse(src).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "SPLIT_K_CASES"
                for t in node.targets):
            return ast.literal_eval(node.value)
    return []


# (name, B, S, dtype, carried, D, state rows): the parity phase's mLSTM
# cases, the same on either checkout
MLSTM_CASES = [
    ("B1 S2048 fresh bf16", 1, 2048, "bfloat16", False, 384, None),
    ("B1 S1000 fresh bf16", 1, 1000, "bfloat16", False, 384, None),
    ("B1 S37 carried bf16", 1, 37, "bfloat16", True, 384, None),
    ("B1 S512 carried bf16", 1, 512, "bfloat16", True, 384, None),
    ("B4 S300 fresh bf16", 4, 300, "bfloat16", False, 384, None),
    ("B1 S200 carried bf16", 1, 200, "bfloat16", True, 384, None),
    ("B1 S512 carried bf16 D96", 1, 512, "bfloat16", True, 96, None),
    ("B8 S1 decode carried bf16", 8, 1, "bfloat16", True, 384,
     [3, 0, 7, 1, 6, 2, 9, 4]),
    ("B4 S1 decode carried bf16", 4, 1, "bfloat16", True, 384, [5, 2, 0, 3]),
    ("B1 S512 carried fp32", 1, 512, "float32", True, 384, None),
    ("B4 S100 carried fp32 D32", 4, 100, "float32", True, 32, None),
]


def mlstm_device_ms(cs, cases, row, B, S, dtype, D, rows, iters=10):
    """Give ``row`` (an mLSTM case just recorded by the checkout under
    test) its device time, where the checkout's case did not: the same
    shapes (inputs drawn anew) through that checkout's wrapper, timed from
    a profiler trace."""
    if "device_ms" in row:
        return
    torch = cases.torch
    from repro_torch.kernels.mlstm_chunkwise.kernel import mlstm_chunkwise
    H = cs.MLSTM_H
    q, k, v = (cases.randn((B, S, H * D), dtype).view(B, S, H, D)
               for _ in range(3))
    gates = cases.randn((B, S, 2 * H), torch.float32)
    Bs = B if rows is None else max(rows) + 1
    C = torch.zeros((Bs, H, D, D), device="cuda")
    n = torch.zeros((Bs, H, D), device="cuda")
    m = torch.zeros((Bs, H), device="cuda")
    rows_t = None if rows is None else torch.tensor(rows, device="cuda")
    row["device_ms"] = cs.device_ms(torch, lambda: mlstm_chunkwise(
        q, k / math.sqrt(D), v, gates[..., :H],
        torch.nn.functional.logsigmoid(gates[..., H:] + 4.0), C, n, m,
        rows=rows_t), iters)


# (name, B, S, dtype, carried, d_inner, state rows): the parity phase's
# Mamba cases, the same on either checkout
MAMBA_CASES = [
    ("B1 S2048 fresh bf16", 1, 2048, "bfloat16", False, 16384, None),
    ("B1 S1000 fresh bf16", 1, 1000, "bfloat16", False, 16384, None),
    ("B1 S37 carried bf16", 1, 37, "bfloat16", True, 16384, None),
    ("B8 S1 decode carried bf16", 8, 1, "bfloat16", True, 16384,
     [3, 0, 7, 1, 6, 2, 9, 4]),
    ("B1 S512 carried fp32", 1, 512, "float32", True, 16384, None),
    ("B4 S100 carried fp32 d128", 4, 100, "float32", True, 128, None),
]


def mamba_device_ms(cs, cases, row, B, S, dtype, d, rows, iters=10):
    """Give ``row`` (a Mamba case just recorded by the checkout under test)
    its device time, and with the L2 flushed before each call, where the
    checkout's case did not: the same shapes (inputs drawn anew, a state
    of ones) through that checkout's wrapper, timed from profiler
    traces."""
    if "device_ms" in row:
        return
    torch = cases.torch
    from repro_torch.kernels.mamba_scan.kernel import mamba_scan
    n = cs.MAMBA_N
    x = cases.randn((B, S, 2 * d), dtype)[..., :d]
    dt = torch.rand((B, S, d), generator=cases.gen, device="cuda") * 0.1
    dbc = cases.randn((B, S, 32 + 2 * n), torch.float32)
    A = -torch.arange(1, n + 1, dtype=torch.float32,
                      device="cuda").expand(d, n).contiguous()
    Dp = torch.ones((d,), device="cuda")
    Bs = B if rows is None else max(rows) + 1
    h = torch.ones((Bs, d, n), device="cuda")
    rows_t = None if rows is None else torch.tensor(rows, device="cuda")

    def run():
        return mamba_scan(x, dt, dbc[..., 32:32 + n], dbc[..., 32 + n:], A,
                          Dp, h, rows=rows_t)
    row["device_ms"] = cs.device_ms(torch, run, iters)
    row["device_ms_cold"] = cs.cold_device_ms(torch, run, iters,
                                              "mamba_scan")


def decode_device_ms(cs, cases, row, B, lens, dtype, split=False, window=0,
                     softcap=0.0, G=3, Hkv=8, D=128, iters=20):
    """Give ``row`` (a decode case just recorded by the checkout under
    test) its device time, where the checkout's case did not: the same
    shapes through that checkout's wrapper, timed from a profiler trace."""
    if "device_ms" in row:
        return
    torch = cases.torch
    from repro_torch.kernels.paged_attention import kernel as PK
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    n = 1 << max(math.ceil(max(lens) / cs.PAGE) - 1, 0).bit_length()
    kv, bt, _ = cases.pool_and_tables(lens, n, Hkv, D, dtype)
    q = cases.randn((B, Hkv * G, D), dtype)
    kw = dict(scale=D ** -0.5, window=window, softcap=softcap)
    if split:
        kp, vp = cs.split_pools(kv)
        row["device_ms"] = cs.device_ms(torch, lambda: PK.paged_attention(
            q, kp, vp, bt, lens_t, **kw), iters)
    else:
        row["device_ms"] = cs.device_ms(torch, lambda: PK.paged_attention_fused(
            q, kv, bt, lens_t, **kw), iters)


def prefill_device_ms(cs, cases, row, pos, lens, Sq, dtype, split=False,
                      window=0, softcap=0.0, G=3, Hkv=8, D=128, iters=10):
    """Give ``row`` (a #2 or #4 case just recorded by the checkout under
    test) its device time, where the checkout's case did not: the same
    shapes through that checkout's wrapper, timed from a profiler trace."""
    if "device_ms" in row:
        return
    torch = cases.torch
    from repro_torch.kernels.paged_prefill_attention import kernel as PPK
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    n = 1 << max(math.ceil(max(lens) / cs.PAGE) - 1, 0).bit_length()
    kv, bt, _ = cases.pool_and_tables(lens, n, Hkv, D, dtype)
    q = cases.randn((len(pos), Sq, Hkv, G, D), dtype)
    kw = dict(scale=D ** -0.5, window=window, softcap=softcap)
    if split:
        kp, vp = cs.split_pools(kv)
        row["device_ms"] = cs.device_ms(
            torch, lambda: PPK.paged_prefill_attention(
                q, kp, vp, bt, pos_t, lens_t, **kw), iters)
    else:
        row["device_ms"] = cs.device_ms(
            torch, lambda: PPK.paged_prefill_attention_fused(
                q, kv, bt, pos_t, lens_t, **kw), iters)


# (name, row_pos, lengths, Sq, keywords) of the #2 cases timed on either
# checkout: llama3.2-3b's shapes (G 3), jamba's G 8 and gemma2-2b's (G 2,
# D 256, window 4096, softcap 50)
PREFILL_CASES = [
    ("R1 Sq512 bf16", [37], [549], 512, {}),
    ("R1 Sq2048 bf16", [37], [2085], 2048, {"iters": 5}),
    ("R4 Sq512 bf16", [0, 1000, 1029, 0], [512, 1509, 1541, 0], 512, {}),
    ("R4 Sq2048 bf16", [0, 1000, 4101, 0], [2048, 3045, 6149, 0], 2048,
     {"iters": 5}),
    ("R2 Sq4 verify-rows bf16", [1500, 700], [1504, 702], 4, {}),
    ("R4 Sq512 G8 bf16", [0, 1000, 1029, 0], [512, 1509, 1541, 0], 512,
     {"G": 8}),
    ("gemma2-2b R2 Sq512 D256 window4096 softcap50 bf16", [4000, 100],
     [4512, 612], 512, dict(window=4096, softcap=50.0, G=2, Hkv=4, D=256)),
    ("gemma2-2b R4 Sq256 ctx<=6144 D256 window4096 softcap50 bf16",
     [5888, 4200, 0, 1000], [6144, 4456, 256, 1200], 256,
     dict(window=4096, softcap=50.0, G=2, Hkv=4, D=256)),
]


def main(root: str) -> int:
    path = str(Path(root).resolve())
    sys.path.insert(0, path)
    import chip_smoke as cs
    import numpy as np
    import torch
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    cases = cs.Cases(torch)
    rng = np.random.default_rng(7)
    g_rng = np.random.default_rng(11)
    bf = torch.bfloat16
    main_lens = [int(x) + 40 for x in rng.integers(128, 2049, 8)]
    edges = [4096, 16, 13, 4088]
    decode = [("B8 serving-like ctx bf16", 8, main_lens, bf, {}),
              ("B8 ctx<=4096 fp32", 8,
               edges + [int(x) for x in rng.integers(1, 4097, 4)],
               torch.float32, {}),
              ("B1 ctx<=4096 bf16", 1, [4093], bf, {}),
              ("B64 ctx<=4096 bf16", 64,
               edges + [int(x) for x in rng.integers(1, 4097, 60)], bf, {}),
              ("B8 window1000 softcap30 bf16", 8,
               edges + [int(x) for x in rng.integers(1, 4097, 4)], bf,
               dict(window=1000, softcap=30.0)),
              # jamba's G 8, two head groups at D 64, and gemma2-2b's
              # serving batch (D 256, window 4096, softcap 50; lengths of
              # their own generator, so the cases above keep theirs)
              ("B4 G8 bf16", 4, [2000, 1, 700, 4096], bf, dict(G=8)),
              ("B2 G12 D64 window300 bf16", 2, [1000, 77], bf,
               dict(G=12, Hkv=2, D=64, window=300)),
              ("gemma2-2b B8 ctx 4097-6144 D256 window4096 softcap50 bf16",
               8, [int(x) for x in g_rng.integers(4097, 6145, 4)]
               + [int(x) for x in g_rng.integers(128, 2049, 4)], bf,
               dict(G=2, Hkv=4, D=256, window=4096, softcap=50.0))]
    for name, B, lens, dtype, kw in decode:
        try:
            cs.decode_case(cases, name, B, lens, dtype, **kw)
        except (AssertionError, ValueError) as err:
            # a case the checkout's kernel fails is recorded, not timed
            print(f"  {name}: {err}", flush=True)
            cases.rows.append({"kernel": "paged_attention_fused",
                               "case": name, "error": str(err)})
            continue
        decode_device_ms(cs, cases, cases.rows[-1], B, lens, dtype, **kw)
    for name, pos, lens, Sq, kw in PREFILL_CASES + [
            ("R4 Sq128 fp32", [0, 1000, 261, 0], [128, 1125, 389, 0], 128,
             {"dtype": torch.float32})]:
        kw = dict(kw)
        dtype = kw.pop("dtype", bf)
        cs.prefill_case(cases, name, pos, lens, Sq, dtype, **kw)
        kw.pop("iters", None)
        prefill_device_ms(cs, cases, cases.rows[-1], pos, lens, Sq, dtype,
                          **kw)
    if hasattr(cs, "chunked_case"):      # checkouts with the slot kernel
        for Sq, off in ((16, 4080), (128, 3968), (512, 0), (512, 3584),
                        (2048, 2048)):
            cs.chunked_case(cases, f"Sq{Sq} off{off} bf16", Sq, off,
                            [off + Sq], bf, iters=5 if Sq == 2048 else 10)
        for Sq, off in ((512, 3584), (37, 100)):
            cs.chunked_case(cases, f"jamba H64 Sq{Sq} off{off} bf16", Sq, off,
                            [off + Sq], bf, H=64)
        cs.chunked_case(cases, "Sq512 off1000 fp32", 512, 1000, [1512],
                        torch.float32)
        # the split-K cases of the parity phase, on either checkout
        for name, Sq, off, lens, H, window, cap in own_split_k_cases():
            cs.chunked_case(cases, name, Sq, off, lens, bf, H=H,
                            window=window, softcap=cap)
    if hasattr(cs, "mla_cases"):         # checkouts with #5's value width
        cs.mla_cases(cases)
    if hasattr(cs, "mlstm_case"):        # checkouts with the mLSTM kernel
        for name, B, S, dn, carried, D, rows in MLSTM_CASES:
            dtype = getattr(torch, dn)
            cs.mlstm_case(cases, name, B, S, dtype, carried, D=D, rows=rows,
                          iters=5 if S >= 1000 else 10)
            mlstm_device_ms(cs, cases, cases.rows[-1], B, S, dtype, D, rows)
    if hasattr(cs, "split_cases"):       # checkouts with the split kernels
        cs.split_cases(cases, main_lens)
        for row in cases.rows:
            if row["kernel"] == "paged_attention" and row["case"] == \
                    "B8 serving-like ctx bf16":
                decode_device_ms(cs, cases, row, 8, main_lens, bf,
                                 split=True)
            if row["kernel"] == "paged_prefill_attention" and \
                    row["case"] == "R4 Sq512 bf16":
                prefill_device_ms(cs, cases, row, [0, 1000, 1029, 0],
                                  [512, 1509, 1541, 0], 512, bf, split=True)
            if row["kernel"] == "paged_prefill_attention" and \
                    row["case"] == "R2 Sq100 bf16":
                prefill_device_ms(cs, cases, row, [37, 700], [137, 790], 100,
                                  bf, split=True)
    if hasattr(cs, "mamba_case"):        # checkouts with the Mamba scan
        for name, B, S, dn, carried, d, rows in MAMBA_CASES:
            dtype = getattr(torch, dn)
            cs.mamba_case(cases, name, B, S, dtype, carried, d=d, rows=rows,
                          iters=5 if S >= 1000 else (20 if S == 1 else 10))
            mamba_device_ms(cs, cases, cases.rows[-1], B, S, dtype, d, rows)
    rows = [{k: r[k] for k in ("kernel", "case", "ms", "limit_share",
                               "error", "splits", "device_ms",
                               "device_ms_cold", "h_bits_equal",
                               "splits_other", "ms_other", "device_ms_other",
                               "registers", "spill_bytes", "smem_bytes",
                               "blocks_per_sm", "block", "bound_ms",
                               "same_as_fused", "pass_ms", "chunk")
             if k in r}
            for r in cases.rows]
    print(json.dumps({"root": root, "device": cs.device_line(),
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "."))
