"""PyTorch port: a torch mirror of the bf16 tensor-core block of the two
prefill attention kernels (``csrc/attend_wgmma.cuh``, used by
``csrc/paged_prefill_attention.cu`` and ``csrc/chunked_prefill_attention.cu``)
against the plain versions, and the split-K plans of both kernels.

The mirror keeps the block's geometry (``shape()``, which
``test_mirror_shapes_follow_the_sources`` ties to the sources; on the card
the libraries report the same rows and key tiles through
``build.mma_attributes``): query rows ``t*G + g`` a block (two consumer
warpgroups of 64: 128), padding rows zero and never written, key tiles of
128 keys (64 at value width 256; the paged kernel's tile is 128 / ps
pages), values as wide as the keys or narrower (the chunked kernel's (192,
128) pair, deepseek-v3's MLA), scores in fp32, the fp32 online softmax with
``l`` summed from the unrounded ``p``, ``p`` rounded to the operand dtype
before P.V; for the chunked kernel the key splits of ``split_plan`` written
as partial states and merged as the combine kernel merges them, and for the
paged kernel the splits of each q tile's page range merged as its last
block merges them. The CUDA kernels themselves run only on the GPU
(``chip_smoke.py`` holds them against the same plain versions there).

Tolerances as in ``tests/test_torch_kernels.py``: fp32 2e-5, bf16 2e-2."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ref_common as rc  # noqa: E402
from repro_torch.kernels.chunked_prefill_attention import kernel as CK  # noqa: E402
from repro_torch.kernels.chunked_prefill_attention import ref as TCPA  # noqa: E402
from repro_torch.kernels.paged_prefill_attention import kernel as PK  # noqa: E402
from repro_torch.kernels.paged_prefill_attention import ref as TPPA  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
PAGED, CHUNKED = "paged_prefill_attention", "chunked_prefill_attention"

# The block of csrc/attend_wgmma.cuh: consumer warpgroups of 64 query rows
# (wg::kConsumers), and the (head dim, value width) pairs each kernel
# instantiates (mma_launch in its source).
CONSUMERS = 2
MMA_HEAD_DIMS = (64, 128, 256)
MMA_PAIRS = {PAGED: tuple((d, d) for d in MMA_HEAD_DIMS),
             CHUNKED: tuple((d, d) for d in MMA_HEAD_DIMS) + ((192, 128),)}


def shape(kernel, D, Dv=None):
    """(query rows a block, keys a tile) of ``kernel`` at head dim D and
    value width Dv (D when None), by the rules of attend_wgmma.cuh's
    Geometry (the same for both kernels): 64 rows a consumer warpgroup,
    128-key tiles, 64 at value width 256."""
    Dv = D if Dv is None else Dv
    return 64 * CONSUMERS, 64 if Dv > 128 else 128


def chunk_key_tiles(Sq, Sk, q_offset, causal, window, D):
    """The chunked launcher's plan (``plan`` in the .cu): the key tiles some
    query of the chunk can see, counted from the tile-aligned window
    start; the splits cut this range."""
    KT = shape(CHUNKED, D)[1]
    end = min(Sk, q_offset + Sq) if causal else Sk
    base = (max(q_offset - window + 1, 0) if window > 0 else 0) // KT * KT
    return max(-(-(end - base) // KT), 0)


def q_tiles(Sq, G, D=128):
    """The launchers' q tiles: rows // G tokens a block."""
    return -(-Sq // (shape(CHUNKED, D)[0] // G))


def _cases(cases, d_at, kernel=PAGED):
    """(case, dtype name) pairs: fp32 for every case, bf16 for those at a
    (head dim, value width) pair ``kernel``'s tensor-core kernel is
    instantiated for (the CUDA wrappers raise for the others)."""
    return [(c, n) for c in cases for n in DTYPES
            if n == "float32" or (c[d_at], _dv(c, d_at)) in MMA_PAIRS[kernel]]


def _dv(case, d_at=5):
    """A chunked case's value width: its 11th entry where given, else its
    head dim."""
    return case[10] if len(case) > 10 else case[d_at]

# The cases of tests/test_torch_kernels.py (FUSED_PPA_CASES; CPA_CASES +
# CPA_EXTRA): G 1, 2, 3, 4, 8, windows, softcap, padding rows, causal=False.
FUSED_PPA_CASES = [
    # (R, Sq, Hkv, G, D, page_size, P_total, pages_per_row, window, cap)
    (4, 16, 4, 1, 32, 16, 16, 6, 0, 0.0),
    (4, 32, 2, 4, 64, 16, 32, 8, 0, 0.0),
    (4, 16, 1, 8, 64, 16, 16, 6, 0, 0.0),
    (4, 32, 2, 2, 64, 16, 16, 6, 40, 0.0),
    (4, 16, 2, 2, 128, 16, 8, 4, 0, 30.0),
    (4, 16, 2, 2, 32, 16, 16, 6, 23, 30.0),
    (4, 48, 2, 3, 128, 16, 24, 8, 0, 0.0),   # llama3.2-3b heads, 3 q tiles
]

CPA_CASES = [
    # (B, H, Hkv, Sq, Sk, D, q_offset, causal, window, softcap)
    (1, 2, 2, 64, 64, 32, 0, True, 0, 0.0),
    (2, 4, 2, 128, 256, 64, 64, True, 0, 0.0),
    (2, 8, 2, 64, 512, 64, 448, True, 0, 0.0),   # deep prefix chunk
    (1, 4, 4, 128, 128, 64, 0, True, 96, 0.0),    # sliding window
    (1, 4, 4, 128, 128, 64, 0, True, 0, 50.0),    # softcap (gemma2)
    (2, 2, 1, 64, 128, 128, 0, False, 0, 0.0),    # cross/encoder
    (2, 6, 2, 40, 96, 128, 30, True, 0, 0.0),
    (2, 6, 2, 24, 96, 64, 50, True, 20, 30.0),
    (2, 4, 2, 24, 64, 32, 10, False, 12, 0.0),
    # MLA (G 1, values narrower than keys, + value width): deepseek-v3's
    # (192, 128) and its smoke config's (24, 16), fp32 only
    (1, 2, 2, 40, 128, 192, 60, True, 0, 0.0, 128),
    (2, 4, 4, 24, 96, 24, 30, True, 0, 0.0, 16),
]

# Chunks whose visible keys span four or more tiles, so that split-K cuts
# them: short and deep, a window with softcap, and causal=False; and MLA's
# pair at a deep offset.
SPLIT_CASES = [
    (1, 6, 2, 16, 512, 64, 480, True, 0, 0.0),
    (2, 6, 2, 24, 512, 128, 400, True, 300, 30.0),
    (2, 4, 2, 24, 512, 64, 10, False, 0, 0.0),
    (1, 2, 2, 16, 512, 192, 480, True, 0, 0.0, 128),
]


def _tol(name):
    return dict(atol=2e-5, rtol=2e-5) if name == "float32" else \
        dict(atol=2e-2, rtol=2e-2)


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------
def mma_block(kernel, q_rows, q_pos0, G, key_rows, length, lo, hi, *,
              causal, window, scale, softcap, Dv=None):
    """One block of attend_wgmma.cuh in ``kernel``'s shape: q_rows [BR, D]
    (BR <= the block's rows, row r = t*G + g at position q_pos0 + r // G)
    over keys [lo, hi); ``key_rows(kp)`` gives the K rows [n, D] and V
    rows [n, Dv] (Dv = D when None) of the key positions kp of a whole
    tile, as the kernel's copies load them (past hi: the block's last page
    again, or the operand's next rows, or zeros past its end; all masked).
    Returns the block's partial state (acc [BR, Dv], m [BR], l [BR]) in
    fp32; the padding rows past BR are dropped, as the kernel never writes
    them."""
    BR, D = q_rows.shape
    Dv = D if Dv is None else Dv
    ROWS, KT = shape(kernel, D, Dv)
    assert BR <= ROWS
    q = torch.zeros(ROWS, D, dtype=q_rows.dtype)
    q[:BR] = q_rows
    qp = q_pos0 + torch.arange(ROWS) // G
    m = torch.full((ROWS,), rc.NEG_INF)
    l = torch.zeros(ROWS)
    acc = torch.zeros(ROWS, Dv)
    lim = min(hi, length)
    for k0 in range(lo, hi, KT):
        kp = k0 + torch.arange(KT)
        k, v = key_rows(kp)
        s = (q.float() @ k.float().T) * scale
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        ok = (kp < lim)[None].expand(ROWS, KT)
        if causal:
            ok = ok & (kp[None] <= qp[:, None])
        if window > 0:
            ok = ok & (qp[:, None] - kp[None] < window)
        s = torch.where(ok, s, torch.full_like(s, rc.NEG_INF))
        mx = torch.maximum(m, s.amax(dim=1))
        corr = torch.exp(m - mx)
        p = torch.exp(s - mx[:, None])
        l = l * corr + p.sum(dim=1)
        acc = acc * corr[:, None] + p.to(v.dtype).float() @ v.float()
        m = mx
    return acc[:BR], m[:BR], l[:BR]


def finalize(acc, l):
    return acc / torch.clamp(l, min=1e-30)[..., None]


# ---------------------------------------------------------------------------
# paged_prefill_attention_fused (bf16 on the tensor cores)
# ---------------------------------------------------------------------------
def floordiv(a: int, b: int) -> int:
    """csrc/paged_common.cuh floordiv, written the C way (truncating '/')."""
    q = int(a / b)
    return q - 1 if q * b != a and a < 0 else q


def page_range(p0, length, q0, nt, ps, n, window):
    """QTile of csrc/paged_prefill_attention.cu: the pages [j_lo, j_hi) some
    query of tokens [q0, q0 + nt) of a row at p0 with ``length`` can see."""
    pages_needed = floordiv(length + ps - 1, ps)
    causal_hi = floordiv(p0 + q0 + nt - 1, ps) + 1
    j_hi = min(pages_needed, causal_hi, n)
    j_lo = max(floordiv(p0 + q0 - window + 1, ps), 0) if window > 0 else 0
    return min(j_lo, max(j_hi, 0)), j_hi


def split_pages(j_lo, j_hi, n_split):
    """The table columns [c_lo, c_hi) of each split of a q tile's pages, as
    the kernel cuts them (near-equal runs; a split may be empty)."""
    n = max(j_hi - j_lo, 0)
    return [(j_lo + s * n // n_split, j_lo + (s + 1) * n // n_split)
            for s in range(n_split)]


def merge_splits(parts):
    """The in-launch merge of the paged kernel's last split block: M = max
    m_s, w_s = exp(m_s - M), l = sum l_s w_s, acc = sum acc_s w_s (the
    partial state)."""
    M = torch.stack([p[1] for p in parts]).amax(dim=0)
    w = [torch.exp(mi - M) for _, mi, _ in parts]
    acc = sum(a * wi[..., None] for (a, _, _), wi in zip(parts, w))
    l = sum(li * wi for (_, _, li), wi in zip(parts, w))
    return acc, M, l


def mirror_paged_prefill(q, kv, bt, pos, lens, *, scale, window, softcap,
                         pools=None, n_split=1):
    """The grid of paged_prefill_attention_wgmma_kernel: one block per (tile
    of rows // G tokens x key split, kv head, row) over its split of the q
    tile's pages, keys fetched page by page through the block table (a
    column past the split's last loads that page again). With ``pools`` =
    (k_pages, v_pages) [Hkv, P, ps, D] the keys come from the split pools
    instead (the same kernel over two tensor maps). With n_split > 1 the
    splits' states are merged as the last block merges them. Returns the
    partial state (acc, m, l) of every query row."""
    R, Sq, Hkv, G, D = q.shape
    ps = kv.shape[3] if pools is None else pools[0].shape[2]
    bq = shape(PAGED, D)[0] // G
    acc = torch.zeros(R, Sq, Hkv, G, D)
    m = torch.zeros(R, Sq, Hkv, G)
    l = torch.zeros(R, Sq, Hkv, G)
    for r in range(R):
        p0, length = int(pos[r]), int(lens[r])
        for q0 in range(0, Sq, bq):
            nt = min(bq, Sq - q0)
            j_lo, j_hi = page_range(p0, length, q0, nt, ps, bt.shape[1],
                                    window)
            for h in range(Hkv):
                parts = []
                for c_lo, c_hi in split_pages(j_lo, j_hi, n_split):
                    def key_rows(kp, h=h, r=r, c_hi=c_hi):
                        col = torch.clamp(kp // ps, max=c_hi - 1)
                        page = bt[r, col].long()
                        if pools is not None:
                            return (pools[0][h, page, kp % ps],
                                    pools[1][h, page, kp % ps])
                        return (kv[h, page, 0, kp % ps],
                                kv[h, page, 1, kp % ps])
                    parts.append(mma_block(
                        PAGED, q[r, q0:q0 + nt, h].reshape(nt * G, D),
                        p0 + q0, G, key_rows, length, c_lo * ps, c_hi * ps,
                        causal=True, window=window, scale=scale,
                        softcap=softcap))
                a, mm, ll = parts[0] if n_split == 1 else merge_splits(parts)
                acc[r, q0:q0 + nt, h] = a.reshape(nt, G, D)
                m[r, q0:q0 + nt, h] = mm.reshape(nt, G)
                l[r, q0:q0 + nt, h] = ll.reshape(nt, G)
    return acc, m, l


def _prefill_inputs(case, name, seed):
    rng = np.random.default_rng(seed)
    R, Sq, Hkv, G, D, ps, P, n, window, cap = case
    dt = DTYPES[name]
    q = _t(rng.normal(size=(R, Sq, Hkv, G, D)), dt)
    kv = _t(rng.normal(size=(Hkv, P, 2, ps, D)), dt)
    bt = torch.from_numpy(rng.integers(0, P, (R, n)).astype(np.int32))
    bt[-1] = P - 1                          # padding row: the trash page
    pos = np.zeros((R,), np.int32)
    lens = np.zeros((R,), np.int32)
    pos[0] = ps - Sq % ps if Sq % ps else 0   # a chunk ending on a page edge
    lens[0] = pos[0] + Sq
    pos[1], lens[1] = 0, max(ps - 3, 1)       # shorter than one page
    pos[2], lens[2] = n * ps - Sq, n * ps     # the deepest chunk
    pos[-1], lens[-1] = 0, 0                  # an all-padding row
    valid = (pos[:, None] + np.arange(Sq)[None, :]) < lens[:, None]
    kw = dict(scale=D ** -0.5, window=window, softcap=cap)
    return (q, kv, bt, torch.from_numpy(pos), torch.from_numpy(lens)), kw, \
        valid


@pytest.mark.parametrize("case,name", _cases(FUSED_PPA_CASES, 4, PAGED))
def test_paged_prefill_mma_block_mirror(case, name):
    args, kw, valid = _prefill_inputs(case, name, 11)
    acc, m, l = mirror_paged_prefill(*args, **kw)
    got = finalize(acc, l).to(args[0].dtype)
    want = TPPA.paged_prefill_attention_fused_ref(*args, **kw)
    assert torch.isfinite(got.float()).all()      # padding rows included
    np.testing.assert_allclose(got.float().numpy()[valid],
                               want.float().numpy()[valid], **_tol(name))


@pytest.mark.parametrize("case", [c for c in FUSED_PPA_CASES
                                  if c[4] in MMA_HEAD_DIMS])
def test_split_pool_mma_mirror_gives_the_fused_bits(case):
    """#4 in bf16: the split-pool kernel's block over K and V pools that
    hold the fused pool's keys gives the fused kernel's output bit for bit
    (the same tile loop over the same keys), and that output is the split
    pools' plain version within the bf16 tolerance."""
    args, kw, valid = _prefill_inputs(case, "bfloat16", 13)
    q, kv, bt, pos, lens = args
    k_pages, v_pages = (t.contiguous() for t in rc.split_fused(kv))
    acc, _, l = mirror_paged_prefill(*args, **kw)
    fused = finalize(acc, l).to(q.dtype)
    acc, _, l = mirror_paged_prefill(*args, pools=(k_pages, v_pages), **kw)
    split = finalize(acc, l).to(q.dtype)
    assert torch.equal(split, fused)
    want = TPPA.paged_prefill_attention_ref(q, k_pages, v_pages, bt, pos,
                                            lens, **kw)
    np.testing.assert_allclose(split.float().numpy()[valid],
                               want.float().numpy()[valid],
                               **_tol("bfloat16"))


@pytest.mark.parametrize(
    "case,name", _cases(FUSED_PPA_CASES[:2] + FUSED_PPA_CASES[-1:], 4,
                        PAGED))
def test_paged_prefill_mma_mirror_partial_negative_pos(case, name):
    """The second half of the block table at shard-local (negative)
    positions: the block's partial state (m, l from the unrounded p) equals
    the plain version's wherever a row sees a key, and combined with the
    first half it gives the whole."""
    (q, kv, bt, pos, lens), kw, valid = _prefill_inputs(case, name, 12)
    h = bt.shape[1] // 2
    off = h * kv.shape[3]
    args = (q, kv, bt[:, h:].contiguous(), pos - off, lens - off)
    acc, m, l = mirror_paged_prefill(*args, **kw)
    racc, rm, rl = TPPA.paged_prefill_attention_partial_ref(*args, **kw)
    live = (rm > rc.NEG_INF / 2).numpy()
    assert live.any() and not live.all() and int((pos - off).min()) < 0
    np.testing.assert_allclose(m.numpy()[live], rm.numpy()[live],
                               atol=1e-3, rtol=1e-5)
    np.testing.assert_allclose(l.numpy()[live], rl.numpy()[live], rtol=1e-4)
    tol = _tol(name) if name == "float32" else dict(atol=0.1, rtol=2e-2)
    np.testing.assert_allclose(acc.numpy()[live], racc.numpy()[live], **tol)
    first = mirror_paged_prefill(q, kv, bt[:, :h].contiguous(), pos, lens,
                                 **kw)
    got = rc.combine_partials([first, (acc, m, l)], q.dtype)
    want = TPPA.paged_prefill_attention_fused_ref(q, kv, bt, pos, lens, **kw)
    np.testing.assert_allclose(got.float().numpy()[valid],
                               want.float().numpy()[valid], **_tol(name))


# ---------------------------------------------------------------------------
# chunked_prefill_attention (bf16 on the tensor cores, split-K)
# ---------------------------------------------------------------------------
def split_bounds(Sq, Sk, q_offset, causal, window, D, n_split):
    """Key range [lo_s, hi_s) of each split, as the kernel cuts it: split
    s covers tiles [s*T // n, (s+1)*T // n) from the tile-aligned window
    start, T = chunk_key_tiles."""
    KT = shape(CHUNKED, D)[1]
    base = (max(q_offset - window + 1, 0) if window > 0 else 0) // KT * KT
    T = chunk_key_tiles(Sq, Sk, q_offset, causal, window, D)
    return [(base + s * T // n_split * KT, base + (s + 1) * T // n_split * KT)
            for s in range(n_split)]


def slot_rows(k, v, kp):
    """K and V rows kp of one (batch row, kv head) as the chunked kernel's
    4-D tensor maps load them: the operand's rows, zeros past its end."""
    live = kp < k.shape[0]
    kk = torch.zeros(len(kp), k.shape[1], dtype=k.dtype)
    vv = torch.zeros(len(kp), v.shape[1], dtype=v.dtype)
    kk[live], vv[live] = k[kp[live]], v[kp[live]]
    return kk, vv


def combine_splits(parts):
    """chunked_prefill_attention_combine: m* = max m_i, l = sum l_i
    e^(m_i - m*), out = sum acc_i e^(m_i - m*) / max(l, 1e-30)."""
    m = torch.stack([p[1] for p in parts]).amax(dim=0)
    acc = sum(a * torch.exp(mi - m)[..., None] for a, mi, _ in parts)
    l = sum(li * torch.exp(mi - m) for _, mi, li in parts)
    return finalize(acc, l)


def mirror_chunked(q, k, v, lens, *, scale, q_offset, causal, window,
                   softcap, n_split):
    """The grid of chunked_prefill_attention_mma_kernel: one block per
    (batch row, kv head, tile of rows // G tokens, key split) over its part
    of the tile's keys [lo, hi); with n_split > 1 each block's partial
    state goes to scratch and the splits are combined. Values may be
    narrower than keys: v [B, Hkv, Sk, Dv], out [B, H, Sq, Dv]."""
    B, H, Sq, D = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // Hkv
    bq = shape(CHUNKED, D, Dv)[0] // G
    bounds = split_bounds(Sq, Sk, q_offset, causal, window, D, n_split)
    parts = [(torch.zeros(B, H, Sq, Dv), torch.zeros(B, H, Sq),
              torch.zeros(B, H, Sq)) for _ in bounds]
    for b in range(B):
        length = int(lens[b])
        for q0 in range(0, Sq, bq):
            nt = min(bq, Sq - q0)
            for (s_lo, s_hi), (acc, m, l) in zip(bounds, parts):
                hi = min(length, Sk)
                if causal:
                    hi = min(hi, q_offset + q0 + nt)
                lo = max(q_offset + q0 - window + 1, 0) if window > 0 else 0
                if n_split > 1:
                    lo, hi = max(lo, s_lo), min(hi, s_hi)
                lo = min(lo, max(hi, 0))
                for h in range(Hkv):
                    heads = slice(h * G, (h + 1) * G)
                    rows = q[b, heads, q0:q0 + nt].transpose(0, 1)
                    a, mm, ll = mma_block(
                        CHUNKED, rows.reshape(nt * G, D), q_offset + q0, G,
                        lambda kp, h=h, b=b: slot_rows(k[b, h], v[b, h], kp),
                        length, lo, hi, causal=causal, window=window,
                        scale=scale, softcap=softcap, Dv=Dv)
                    acc[b, heads, q0:q0 + nt] = \
                        a.reshape(nt, G, Dv).transpose(0, 1)
                    m[b, heads, q0:q0 + nt] = mm.reshape(nt, G).T
                    l[b, heads, q0:q0 + nt] = ll.reshape(nt, G).T
    if n_split == 1:
        return finalize(parts[0][0], parts[0][2]).to(q.dtype)
    return combine_splits(parts).to(q.dtype)


def _cpa_inputs(case, name, seed):
    rng = np.random.default_rng(seed)
    B, H, Hkv, Sq, Sk, D, q_off, causal, window, cap = case[:10]
    dt = DTYPES[name]
    q = _t(rng.normal(size=(B, H, Sq, D)), dt)
    k = _t(rng.normal(size=(B, Hkv, Sk, D)), dt)
    v = _t(rng.normal(size=(B, Hkv, Sk, _dv(case))), dt)
    lens = rng.integers(max(q_off + Sq, 1), Sk + 1, (B,)).astype(np.int32)
    lens[-1] = max(int(lens[-1]) - 7, 1)      # ragged valid length
    kw = dict(scale=D ** -0.5, q_offset=q_off, causal=causal, window=window,
              softcap=cap)
    return (q, k, v, torch.from_numpy(lens)), kw


def _cpa_valid(case, lens):
    """Query positions that see at least one key."""
    B, H, Hkv, Sq, Sk, D, q_off, causal, window, cap = case[:10]
    qp = q_off + np.arange(Sq)[None, :, None]
    kp = np.arange(Sk)[None, None, :]
    ok = kp < np.asarray(lens)[:, None, None]
    if causal:
        ok = ok & (kp <= qp)
    if window > 0:
        ok = ok & (qp - kp < window)
    return np.broadcast_to(ok.any(-1)[:, None, :, None],
                           (B, H, Sq, _dv(case)))


def _most_splits(case):
    B, H, Hkv, Sq, Sk, D, q_off, causal, window, cap = case[:10]
    return max(chunk_key_tiles(Sq, Sk, q_off, causal, window, D) // 2, 1)


@pytest.mark.parametrize("splits", ["one", "most"])
@pytest.mark.parametrize("case,name", _cases(CPA_CASES + SPLIT_CASES, 5,
                                             CHUNKED))
def test_chunked_mma_block_mirror(case, name, splits):
    """Without split-K, and with the most splits split_plan may give (two
    key tiles each), on the kernel's block and split geometry."""
    (q, k, v, lens), kw = _cpa_inputs(case, name, 21)
    n_split = 1 if splits == "one" else _most_splits(case)
    assert case not in SPLIT_CASES or splits == "one" or n_split > 1
    got = mirror_chunked(q, k, v, lens, n_split=n_split, **kw)
    want = TCPA.chunked_prefill_attention_ref(q, k, v, lens, **kw)
    valid = _cpa_valid(case, lens.numpy())
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(got.float().numpy()[valid],
                               want.float().numpy()[valid], **_tol(name))


def test_chunked_mma_mirror_empty_rows_and_splits_write_zeros():
    """A row of length 0 sees no key in any split: every split contributes
    (0, -1e30, 0) and the combine writes 0, as an empty block does."""
    case = (2, 6, 2, 40, 512, 128, 400, True, 0, 0.0)
    (q, k, v, _), kw = _cpa_inputs(case, "float32", 22)
    lens = torch.tensor([0, 430], dtype=torch.int32)
    got = mirror_chunked(q, k, v, lens, n_split=_most_splits(case), **kw)
    assert _most_splits(case) > 1
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    want = TCPA.chunked_prefill_attention_ref(q, k, v, lens, **kw)
    valid = _cpa_valid(case, lens.numpy())
    np.testing.assert_allclose(got.numpy()[valid], want.numpy()[valid],
                               atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# split_plan and the key partition
# ---------------------------------------------------------------------------
H100_SMS = 132


@pytest.mark.parametrize("B,Sq,G,off", [
    (4, 512, 3, 0),       # llama3.2-3b R4 (416 blocks)
    (1, 2048, 3, 2048),   # llama3.2-3b B1 (392 blocks)
    (1, 512, 8, 3584),    # jamba G 8 (256 blocks)
    (1, 512, 3, 0),       # llama's first chunk: 104 blocks, 4 key tiles
    (1, 128, 3, 0),       # 32 blocks, 1 key tile
    (1, 37, 8, 100),      # jamba: 24 blocks, 2 key tiles
    (1, 256, 3, 600),     # 56 blocks, 7 key tiles
])
def test_split_plan_one_split_when_the_grid_fills_the_card(B, Sq, G, off):
    """One split when the grid gives every SM a block, or when the chunk
    sees fewer than SPLIT_FROM_TILES key tiles (a chunk at or near offset
    0, whose walk is too short to pay for a split)."""
    tiles = chunk_key_tiles(Sq, 4096, off, True, 0, 128)
    blocks = B * 8 * q_tiles(Sq, G)
    assert blocks >= H100_SMS or tiles < CK.SPLIT_FROM_TILES
    assert CK.split_plan(B, 8, q_tiles(Sq, G), tiles, H100_SMS) == 1


@pytest.mark.parametrize("Sq,G,off,want", [
    # B1 Hkv8 Sq16 off4080: one q tile, 8 blocks, 32 key tiles of 128: 16
    # splits of MIN_SPLIT_TILES tiles fill one wave of 128 blocks
    (16, 3, 4080, 32 // CK.MIN_SPLIT_TILES),
    (128, 3, 3968, 4),    # 4 q tiles of 42 tokens, 32 blocks: one wave
    (16, 8, 4000, 16),    # jamba: one q tile of 16 tokens, 32 key tiles
    (256, 3, 2048, 2),    # 56 blocks, 18 key tiles: 112 blocks, one wave
    (512, 3, 3584, 1),    # 104 blocks, 32 key tiles: any split adds a wave
])
def test_split_plan_splits_short_deep_chunks(Sq, G, off, want):
    """Above SPLIT_FROM_TILES key tiles, the count the wave model prices
    least: on an H100 (NVIDIA H100 80GB HBM3) the 16-token chunk at offset
    4080 ran fastest in one wave of short splits, the 128-token chunk at
    3968 at 4 splits (0.036 ms, against 0.099 whole and 0.050 at 5: a
    second wave), and the 512-token chunk at 3584 whole (0.100 ms, against
    0.114 at 2 splits)."""
    tiles = chunk_key_tiles(Sq, 4096, off, True, 0, 128)
    assert tiles >= CK.SPLIT_FROM_TILES
    assert CK.split_plan(1, 8, q_tiles(Sq, G), tiles, H100_SMS) == want


@pytest.mark.parametrize("D", [64, 128, 256, 192])
def test_split_partition_covers_every_key_in_two_tiles_or_more(D):
    """For every plan: splits are whole tiles, disjoint, in order, cover
    the chunk's visible keys, and none has fewer than MIN_SPLIT_TILES tiles
    (so none is empty by construction)."""
    KT = shape(CHUNKED, D)[1]
    for Sq, Sk, off, causal, window in ((16, 4096, 4080, True, 0),
                                        (37, 4096, 2500, True, 1000),
                                        (64, 4096, 3000, False, 0),
                                        (512, 8192, 4000, True, 4096),
                                        (5, 300, 200, True, 0)):
        T = chunk_key_tiles(Sq, Sk, off, causal, window, D)
        for blocks in (1, 8, 40, 200):
            n = CK.split_plan(1, 1, blocks, T, H100_SMS)
            assert n >= 1 and (n == 1 or T // n >= CK.MIN_SPLIT_TILES)
            b = split_bounds(Sq, Sk, off, causal, window, D, n)
            assert n == 1 or all(
                (hi - lo) % KT == 0 and hi - lo >= CK.MIN_SPLIT_TILES * KT
                for lo, hi in b)
            assert all(b[i][1] == b[i + 1][0] for i in range(n - 1))
            first = max(off - window + 1, 0) if window > 0 else 0
            last = min(Sk, off + Sq) if causal else Sk
            assert b[0][0] <= first and b[-1][1] >= last


def test_planned_splits_fp32_never_splits():
    """fp32 keeps the scalar loop, which has no split-K: one split without
    asking the library (so also here, with no library)."""
    q = torch.zeros((1, 24, 16, 128))
    k = torch.zeros((1, 8, 4096, 128))
    assert CK.planned_splits(q, k, k, q_offset=4080) == 1
    qp = torch.zeros((2, 4, 8, 3, 128))
    assert PK.planned_splits(qp, torch.zeros((2, 256), dtype=torch.int32),
                             16) == 1


# ---------------------------------------------------------------------------
# paged_prefill_attention's split-K
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("R,Sq,Hkv,G,D,n", [
    (4, 512, 8, 3, 128, 128),   # llama3.2-3b R4 Sq512: 416 blocks
    (4, 128, 8, 3, 128, 128),   # 128 blocks: a split adds a wave
    (1, 512, 8, 3, 128, 64),    # 104 blocks, 8 key tiles of 128
    (2, 100, 8, 3, 128, 64),    # 48 blocks, 8 key tiles
    (1, 16, 8, 3, 128, 4),      # a short table
])
def test_paged_split_plan_one_split_when_a_split_costs_a_wave(R, Sq, Hkv, G,
                                                             D, n):
    """One split when the grid fills the card, when the table holds fewer
    than SPLIT_FROM_TILES key tiles, or when splitting adds a wave the
    shorter walks do not pay for (on an H100: R4 Sq128 0.031 ms whole
    against 0.048 in 2 splits; R1 Sq512 0.0195 against 0.0395)."""
    kt = shape(PAGED, D)[1]
    assert PK.split_plan(R, Hkv, q_tiles(Sq, G, D), n, 16, kt,
                         H100_SMS) == 1


@pytest.mark.parametrize("R,Sq,Hkv,G,D,n,want", [
    # verify rows R2 Sq4: 16 blocks over 2048-key tables: 8 splits fill one
    # wave (H100: 0.0136 ms against 0.0301 whole)
    (2, 4, 8, 3, 128, 128, 8),
    # gemma2-2b R2 Sq512 D 256 (64 blocks, 8192-key tables of 64-key
    # tiles): 2 splits fill one wave (H100: 0.229 ms against 0.389 whole)
    (2, 512, 4, 2, 256, 512, 2),
    (4, 256, 4, 2, 256, 512, 2),   # gemma2-2b R4 Sq256: 64 blocks
    (1, 16, 8, 3, 128, 256, 16),   # one q tile a head: 8 blocks
])
def test_paged_split_plan_splits_short_grids_over_deep_tables(R, Sq, Hkv, G,
                                                              D, n, want):
    kt = shape(PAGED, D)[1]
    got = PK.split_plan(R, Hkv, q_tiles(Sq, G, D), n, 16, kt, H100_SMS)
    assert got == want
    assert got <= min(n // PK.MIN_SPLIT_PAGES, PK.MAX_SPLITS)
    assert R * Hkv * q_tiles(Sq, G, D) * got <= H100_SMS


@pytest.mark.parametrize("window", [0, 7, 40])
@pytest.mark.parametrize("shard", [False, True])
def test_paged_split_partition_covers_every_key_once(window, shard):
    """Each q tile's page range [j_lo, j_hi) (floor division, so also at
    shard-local negative positions) is cut into n near-equal runs of table
    columns that are disjoint, in order and cover it exactly, empty runs
    included, for every split count; and the kernel cuts it that way."""
    ps, n = 16, 24
    off = n * ps // 2 if shard else 0
    for p0, length in ((0, 300), (37, 380), (250, 384), (0, 0), (5, 9)):
        for q0, nt in ((0, 42), (42, 42), (126, 16)):
            j_lo, j_hi = page_range(p0 - off, length - off, q0, nt, ps,
                                    n - off // ps, window)
            want = set(range(j_lo, j_hi))
            for n_split in range(1, 10):
                runs = split_pages(j_lo, j_hi, n_split)
                cols = [c for lo, hi in runs for c in range(lo, hi)]
                assert sorted(cols) == sorted(want) and \
                    len(cols) == len(want)
                assert all(runs[i][1] == runs[i + 1][0]
                           for i in range(n_split - 1))
    src = (build.CSRC / f"{PAGED}.cu").read_text()
    assert "const long len = max(t.j_hi - t.j_lo, 0);" in src
    assert "c_lo = t.j_lo + (int)(sp * len / n_split);" in src
    assert "c_hi = t.j_lo + (int)((sp + 1) * len / n_split);" in src


@pytest.mark.parametrize("n_split", [2, 3, 7])
@pytest.mark.parametrize("shard", [False, True])
@pytest.mark.parametrize("case", FUSED_PPA_CASES)
def test_paged_split_k_mirror_merges_to_the_unsplit_state(case, shard,
                                                          n_split):
    """fp32: the splits' partial states merged as the kernel's last block
    merges them equal the unsplit block's state (acc, m, l) within 2e-5
    wherever a row sees a key, also over the second half of the table at
    shard-local (negative) positions; the merged output is the plain
    version's."""
    (q, kv, bt, pos, lens), kw, valid = _prefill_inputs(case, "float32", 14)
    if shard:
        h = bt.shape[1] // 2
        off = h * kv.shape[3]
        bt, pos, lens = bt[:, h:].contiguous(), pos - off, lens - off
    one = mirror_paged_prefill(q, kv, bt, pos, lens, **kw)
    acc, m, l = mirror_paged_prefill(q, kv, bt, pos, lens, n_split=n_split,
                                     **kw)
    live = (one[1] > rc.NEG_INF / 2).numpy()
    assert live.any()
    for got, want in ((m, one[1]), (l, one[2]), (acc, one[0])):
        np.testing.assert_allclose(got.numpy()[live], want.numpy()[live],
                                   atol=2e-5, rtol=2e-5)
    racc, rm, rl = TPPA.paged_prefill_attention_partial_ref(q, kv, bt, pos,
                                                            lens, **kw)
    np.testing.assert_allclose(m.numpy()[live], rm.numpy()[live],
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(finalize(acc, l).numpy()[live],
                               finalize(racc, rl).numpy()[live],
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("kernel,var", [(PAGED, "PagedGeo"),
                                        (CHUNKED, "ChunkGeo")])
def test_mirror_shapes_follow_the_sources(kernel, var):
    """CONSUMERS and MMA_PAIRS are the sources' block and instantiations,
    and shape() follows attend_wgmma.cuh's rules, so a change to either side
    fails here rather than letting the mirror drift. In the paged source the
    fused-pool and split-pool launches run the one kernel (launch_mma over
    one tensor map or two), so the split-pool mirror (``pools=``) has the
    fused one's shape; the chunked source instantiates (head dim, value
    width) pairs."""
    import re
    src = (build.CSRC / f"{kernel}.cu").read_text()
    dims = "<D>" if kernel == PAGED else "<D, Dv>"
    assert f"using {var} = wg::Geometry{dims};" in src
    if kernel == PAGED:
        pairs = tuple((int(d), int(d)) for d in re.findall(
            r"D == (\d+) +\? mma_launch<\1>\(\)", src))
    else:
        pairs = tuple((int(d), int(dv)) for d, dv in re.findall(
            r"D == (\d+) && Dv == (\d+) +\? mma_launch<\1, \2>\(\)", src))
    assert pairs == MMA_PAIRS[kernel]
    if kernel == PAGED:
        assert "return launch_mma(q, kv, kv, 1," in src
        assert "return launch_mma(q, k_pages, v_pages, 0," in src
        assert "m.kernel<<<" in src
    geo = (build.CSRC / "attend_wgmma.cuh").read_text()
    for rule in (f"constexpr int kConsumers = {CONSUMERS};",
                 "constexpr int kRows = 64 * kConsumers;",
                 "static constexpr int KT = DV_ > 128 ? 64 : 128;"):
        assert rule in geo, rule
