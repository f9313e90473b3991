"""PyTorch port: the kernels' one work count (``kernels/cost.py``) and their
branch for tensors that hold no data.

* Each kernel module's ``cost(...)`` at ``chip_smoke.py``'s shapes gives
  ``PERF.md`` §6's bound column (H100 SXM5 spec figures: 3.35e12 B/s,
  989e12 bf16 and 67e12 fp32 FLOP/s): #1 at B8 serving-like 0.0112 ms,
  #5 at Sq512 off3584 0.0244 and MLA's Sq512 0.163, #6 at B1 S2048 0.0812,
  #7 at B1 S2048 0.0089.
* Every one of the seven wrappers, given fake tensors on device "cuda" (no
  card here) or "cpu", returns empty outputs of the kernel's shapes and
  dtypes and adds its ``cost`` to the active counter; given CPU tensors it
  still runs the plain version (no count); a meta tensor still raises
  (``tests/test_torch_kernels.py``).
"""
import math

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import cost as C  # noqa: E402
from repro_torch.kernels.chunked_prefill_attention import kernel as CK  # noqa: E402
from repro_torch.kernels.mamba_scan import kernel as MK  # noqa: E402
from repro_torch.kernels.mlstm_chunkwise import kernel as LK  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as PK  # noqa: E402
from repro_torch.kernels.paged_prefill_attention import kernel as PP  # noqa: E402

PEAK = {"bfloat16": 989e12, "float32": 67e12}
bf = torch.bfloat16


def bound_ms(w):
    return max(w.bytes / 3.35e12, w.flops / PEAK[w.dtype]) * 1e3


def serving_like_lens():
    """chip_smoke.py's decode batch "B8 serving-like" (rng 7, after the
    B1/B8/B64 cases)."""
    rng = np.random.default_rng(7)
    for B in (8, 64):
        rng.integers(1, 4097, B - 4)
    return [int(x) + 40 for x in rng.integers(128, 2049, 8)]


@pytest.mark.parametrize("name,work,want", [
    ("#1 B8 serving-like", lambda: PK.cost(
        8, 24, 8, 128, 16, 1 << (math.ceil(max(serving_like_lens()) / 16)
                                 - 1).bit_length(), bf,
        serving_like_lens()), 0.0112),
    ("#5 Sq512 off3584", lambda: CK.cost(1, 24, 8, 512, 4096, 128, 128, bf,
                                         [4096], 3584), 0.0244),
    ("#5 MLA Sq512 off3584", lambda: CK.cost(1, 128, 128, 512, 4096, 192,
                                             128, bf, [4096], 3584), 0.163),
    ("#6 B1 S2048", lambda: MK.cost(1, 2048, 16384, 16, bf), 0.0812),
    ("#7 B1 S2048", lambda: LK.cost(1, 2048, 4, 384, bf), 0.0089),
])
def test_cost_gives_the_bound_column(name, work, want):
    digits = len(str(want).split(".")[1])
    assert round(bound_ms(work()), digits) == want, name


def test_cost_counts_the_masks():
    """#5: a causal chunk at offset 0 sees S(S+1)/2 pairs a head; a window
    of w keys w per late query; #2 the same pairs from its pages."""
    w = CK.cost(1, 2, 1, 8, 8, 16, 16, torch.float32)
    assert w.flops == 2 * 32 * 2 * 36
    w = CK.cost(1, 2, 1, 8, 8, 16, 16, torch.float32, window=3)
    assert w.flops == 2 * 32 * 2 * (1 + 2 + 3 * 6)
    w = PP.cost(1, 8, 1, 2, 16, 4, 2, torch.float32, [0], [8])
    assert w.flops == 4 * 16 * 2 * 36


def _fake_cases(mode):
    """(kernel name, call, the shapes and dtypes it must return) for each
    wrapper on tensors made by ``mode``."""
    f32 = torch.float32

    def t(*shape, dtype=bf):
        return mode(lambda: torch.empty(shape, dtype=dtype))

    i32 = dict(dtype=torch.int32)
    B, H, Hkv, D, P, ps, n, Sq = 2, 4, 2, 16, 8, 4, 3, 5
    q, kv, bt, ln = t(B, H, D), t(Hkv, P, 2, ps, D), t(B, n, **i32), t(B, **i32)
    kp = t(Hkv, P, ps, D)
    qp, pos = t(B, Sq, Hkv, H // Hkv, D), t(B, **i32)
    qc, kc, vc = t(B, H, Sq, D), t(B, Hkv, 7, D), t(B, Hkv, 7, 8)
    x, dt, Bc, A = t(B, Sq, 6), t(B, Sq, 6, dtype=f32), t(B, Sq, 3, dtype=f32), \
        t(6, 3, dtype=f32)
    Dm, h = t(6, dtype=f32), t(B, 6, 3, dtype=f32)
    ql, lg = t(B, Sq, H, D), t(B, Sq, H, dtype=f32)
    Cs, ns, ms = t(B, H, D, D, dtype=f32), t(B, H, D, dtype=f32), \
        t(B, H, dtype=f32)
    kw = dict(scale=0.25)
    return [
        ("paged_attention", lambda: PK.paged_attention_fused(
            q, kv, bt, ln, **kw), [((B, H, D), bf)]),
        ("paged_attention", lambda: PK.paged_attention_fused(
            q, kv, bt, ln, partial=True, **kw),
         [((B, H, D), f32), ((B, H), f32), ((B, H), f32)]),
        ("paged_attention", lambda: PK.paged_attention(
            q, kp, kp, bt, ln, **kw), [((B, H, D), bf)]),
        ("paged_prefill_attention", lambda: PP.paged_prefill_attention_fused(
            qp, kv, bt, pos, ln, **kw), [(tuple(qp.shape), bf)]),
        ("paged_prefill_attention", lambda: PP.paged_prefill_attention(
            qp, kp, kp, bt, pos, ln, **kw), [(tuple(qp.shape), bf)]),
        ("chunked_prefill_attention", lambda: CK.chunked_prefill_attention(
            qc, kc, vc, ln, **kw), [((B, H, Sq, 8), bf)]),
        ("mamba_scan", lambda: MK.mamba_scan(x, dt, Bc, Bc, A, Dm, h),
         [((B, Sq, 6), bf)]),
        ("mlstm_chunkwise", lambda: LK.mlstm_chunkwise(
            ql, ql, ql, lg, lg, Cs, ns, ms),
         [((B, Sq, H, D), bf), ((B, H, D), f32), ((B, H), f32)]),
    ]


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_wrappers_on_tensors_that_hold_no_data(device):
    from torch._subclasses.fake_tensor import FakeTensorMode
    ctx = FakeTensorMode(allow_non_fake_inputs=False)

    def mode(make):
        with ctx, torch.device(device):
            return make()
    for name, call, want in _fake_cases(mode):
        with ctx, C.counting() as c:
            out = call()
        outs = out if isinstance(out, tuple) else (out,)
        assert [(tuple(o.shape), o.dtype) for o in outs] == want, name
        assert all(C.is_fake(o) for o in outs), name
        assert c.calls == {name: 1} and c.flops > 0 and c.bytes > 0, name


def test_cpu_tensors_still_run_the_plain_version():
    q = torch.randn(1, 2, 3, 16)
    k = torch.randn(1, 1, 3, 16)
    with C.counting() as c:
        out = CK.chunked_prefill_attention(
            q, k, k, torch.full((1,), 3, dtype=torch.int32), scale=0.25)
    assert c.calls == {} and bool(torch.isfinite(out).all())
