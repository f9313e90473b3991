#!/usr/bin/env python3
"""Time the CUDA kernels of one checkout on the card, so that two
checkouts can be compared in one chip call, in turns:

    python3 tools/kernel_ab.py OLD && python3 tools/kernel_ab.py . \
        && python3 tools/kernel_ab.py . && python3 tools/kernel_ab.py OLD

``OLD`` is another checkout (for example ``git archive`` of the parent
commit unpacked into ``build/``). Each run imports that checkout's
``chip_smoke.py`` (which puts its ``src/`` first on the path), builds its
kernels and times a fixed set of its decode and prefill parity cases, its
chunked-prefill cases, its mLSTM chunkwise cases (the parity phase's
xlstm-125m shapes), its split-pool decode and prefill cases and its Mamba
selective-scan cases (jamba's shapes) where it has those kernels (CUDA
events; inputs from fixed seeds, the same in both checkouts). Prints one
JSON line ``{"root": ..., "rows": [...]}``.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path


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
    bf = torch.bfloat16
    main_lens = [int(x) + 40 for x in rng.integers(128, 2049, 8)]
    cs.decode_case(cases, "B8 serving-like ctx bf16", 8, main_lens, bf)
    edges = [4096, 16, 13, 4088]
    cs.decode_case(cases, "B8 ctx<=4096 fp32", 8,
                   edges + [int(x) for x in rng.integers(1, 4097, 4)],
                   torch.float32)
    for R, Sq in ((1, 512), (1, 2048), (4, 512), (4, 2048)):
        if R == 1:
            pos, lens = [37], [37 + Sq]
        else:
            pos = [0, 1000, 2 * Sq + 5, 0]
            lens = [Sq, 1000 + Sq - 3, 3 * Sq + 5, 0]
        cs.prefill_case(cases, f"R{R} Sq{Sq} bf16", pos, lens, Sq, bf,
                        iters=5 if Sq == 2048 else 10)
    if hasattr(cs, "chunked_case"):      # checkouts with the slot kernel
        for Sq, off in ((16, 4080), (512, 0), (512, 3584), (2048, 2048)):
            cs.chunked_case(cases, f"Sq{Sq} off{off} bf16", Sq, off,
                            [off + Sq], bf, iters=5 if Sq == 2048 else 10)
    if hasattr(cs, "mlstm_cases"):       # checkouts with the mLSTM kernel
        cs.mlstm_cases(cases)
    if hasattr(cs, "split_cases"):       # checkouts with the split kernels
        cs.split_cases(cases, main_lens)
    if hasattr(cs, "mamba_cases"):       # checkouts with the Mamba scan
        cs.mamba_cases(cases)
    rows = [{k: r[k] for k in ("kernel", "case", "ms", "limit_share")}
            for r in cases.rows]
    print(json.dumps({"root": root, "device": cs.device_line(),
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "."))
