"""PyTorch port: a torch mirror of the split-K paged decode blocks
(``csrc/paged_attention.cu``, behind ``paged_attention_fused`` and
``paged_attention``) against the JAX reference
(``repro.kernels.paged_attention.ref``) and the port's plain versions.

The mirror keeps each block's geometry and order of work, and picks the
block as the launcher does: bf16 at head_dim 64, 128 or 256 over pages of
a multiple of 8 keys dividing KEY_TILE takes the tensor-core block,
everything else the scalar one. Both share the
shape-only split plans (``split_plan``, ``wgmma_split_plan``), each row's
live page range cut into ``S`` near-equal parts, and the splits merged in
order, as the last block of a (row, head group) does.
- The tensor-core block walks its split in key tiles of ``KEY_TILE`` keys
  (whole pages; pages past the split's range in its last tile are its last
  page again, masked), consumer warpgroup ``c`` of ``CONSUMERS`` taking
  tiles ``c, c + CONSUMERS, ...``: one fp32 online-softmax step a tile
  (one running max over the tile's keys, ``l`` summed from the unrounded
  ``p``, ``p`` rounded to bf16 against that max before P.V), the
  warpgroups merged at the end. Query heads are padded with zero rows to
  ``HEADS_PER_BLOCK``; the padding changes no value.
- The scalar block's ``WARPS`` warps take chunks ``w, w + WARPS, ...`` of
  the split (a chunk is up to ``KC`` keys of one page), one fp32 online-
  softmax step a chunk, the warps merged at the end.
``test_mirror_geometry_follows_the_source`` ties these constants to the
source. The CUDA kernels themselves run only on the GPU (``chip_smoke.py``
holds them against the same plain versions there).

Tolerances as in ``tests/test_torch_kernels.py``: fp32 2e-5, bf16 2e-2."""
import re

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.paged_attention import ref as JPA  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ref_common as rc  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as PK  # noqa: E402
from repro_torch.kernels.paged_attention import ref as TPA  # noqa: E402

RNG = np.random.default_rng(16)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# The blocks' geometry, as csrc/paged_attention.cu has it: the scalar
# block's
WARPS = 8            # kWarps
STAGES = 3           # kStages: chunks in flight a warp (no effect on values)
STEPS = 4            # kSteps: key steps of 32 / L keys a chunk (bf16)
CHUNK_BYTES = 4096   # what kSteps makes a chunk's K and V, at most
# and the tensor-core block's
WGMMA_HEAD_DIMS = (64, 128, 256)   # bf16 head dims it takes
KEY_TILE = 64        # kKeyTile: keys a tile, the M rows of its products
CONSUMERS = 1        # kConsumers: consumer warpgroups a block


def wgmma_block(dtype, D, ps):
    """Whether the launcher takes the tensor-core block (takes_wgmma)."""
    return (dtype == torch.bfloat16 and D in WGMMA_HEAD_DIMS
            and ps % 8 == 0 and KEY_TILE % ps == 0)


def lanes_per_key(D):
    L = 8
    while L < 32 and L * 8 < D:
        L *= 2
    return L


def vectors_per_lane(D, elt):
    return -(-(D * elt // 16) // lanes_per_key(D))


def geometry(G, D, ps, elt):
    """(head groups, heads a group, keys a chunk) of a launch, by the
    launcher's rules."""
    groups = -(-G // PK.HEADS_PER_BLOCK)
    group = -(-G // groups)
    kc = min(ps, STEPS // vectors_per_lane(D, elt) * (32 // lanes_per_key(D)))
    return groups, group, kc


def floordiv(a, b):
    """paged::floordiv written the C way (truncating '/')."""
    q = int(a / b)
    return q - 1 if q * b != a and a < 0 else q


def live_pages(length, ps, n, window):
    """The kernel's [j_lo, j_hi) of a row, and its page count."""
    j_hi = min(floordiv(length + ps - 1, ps), n)
    j_lo = max(floordiv(length - window, ps), 0) if window > 0 else 0
    j_lo = min(j_lo, max(j_hi, 0))
    return j_lo, j_hi, max(j_hi - j_lo, 0)


def split_pages(length, ps, n, window, sp, S):
    """Split sp's pages [p_lo, p_hi) of S."""
    j_lo, _, np_ = live_pages(length, ps, n, window)
    return j_lo + np_ * sp // S, j_lo + np_ * (sp + 1) // S


def _merge(states):
    """Merge (acc, m, l) states of disjoint key sets, in order."""
    M = states[0][1]
    for _, m, _ in states[1:]:
        M = torch.maximum(M, m)
    A = torch.zeros_like(states[0][0])
    L = torch.zeros_like(states[0][2])
    for a, m, l in states:
        c = torch.exp(m - M)
        A = A + a * c[:, None]
        L = L + l * c
    return A, M, L


def mirror_block(qg, rows, length, window, scale, cap, p_lo, p_hi, ps, kc_max):
    """One block's state (acc [gn, D], m [gn], l [gn]): its warps walk the
    chunks of pages [p_lo, p_hi) round robin, then merge."""
    gn, D = qg.shape
    cpp = -(-ps // kc_max)
    units = (p_hi - p_lo) * cpp
    warps = []
    for w in range(WARPS):
        m = torch.full((gn,), rc.NEG_INF)
        l = torch.zeros(gn)
        acc = torch.zeros(gn, D)
        for u in range(w, units, WARPS):
            page = p_lo + u // cpp
            key0 = (u % cpp) * kc_max
            kc = min(kc_max, ps - key0)
            k, v = rows(page, key0, kc)
            s = (qg.float() @ k.float().T) * scale
            if cap > 0:
                s = cap * torch.tanh(s / cap)
            kp = page * ps + key0 + torch.arange(kc)
            ok = kp < length
            if window > 0:
                ok &= length - 1 - kp < window
            s = torch.where(ok[None], s, torch.full_like(s, rc.NEG_INF))
            mx = torch.maximum(m, s.amax(dim=1))
            corr = torch.exp(m - mx)
            p = torch.exp(s - mx[:, None])
            l = l * corr + p.sum(dim=1)
            acc = acc * corr[:, None] + p.to(v.dtype).float() @ v.float()
            m = mx
        warps.append((acc, m, l))
    return _merge(warps)


def mirror_wgmma_block(qg, rows, length, window, scale, cap, p_lo, p_hi, ps):
    """One tensor-core block's state (acc [gn, D], m [gn], l [gn]): its
    consumer warpgroups walk the key tiles of pages [p_lo, p_hi) round
    robin, one running max a tile, then merge."""
    gn, D = qg.shape
    ppt = KEY_TILE // ps
    n_tiles = -(-(p_hi - p_lo) * ps // KEY_TILE)
    hi = min(p_hi * ps, length)
    states = []
    for c in range(CONSUMERS):
        m = torch.full((gn,), rc.NEG_INF)
        l = torch.zeros(gn)
        acc = torch.zeros(gn, D)
        for j in range(c, n_tiles, CONSUMERS):
            kv = [rows(min(p_lo + j * ppt + pg, p_hi - 1), 0, ps)
                  for pg in range(ppt)]
            k = torch.cat([x[0] for x in kv])
            v = torch.cat([x[1] for x in kv])
            s = (qg.float() @ k.float().T) * scale
            if cap > 0:
                s = cap * torch.tanh(s / cap)
            kp = p_lo * ps + j * KEY_TILE + torch.arange(KEY_TILE)
            ok = kp < hi
            if window > 0:
                ok &= length - 1 - kp < window
            s = torch.where(ok[None], s, torch.full_like(s, rc.NEG_INF))
            mx = torch.maximum(m, s.amax(dim=1))
            corr = torch.exp(m - mx)
            p = torch.exp(s - mx[:, None])
            l = l * corr + p.sum(dim=1)
            acc = acc * corr[:, None] + p.to(v.dtype).float() @ v.float()
            m = mx
        states.append((acc, m, l))
    return _merge(states)


def mirror_decode(q, pools, bt, lens, *, scale, window=0, softcap=0.0,
                  S=1, partial=False):
    """The kernel's output over the fused pool (``pools = (kv,)``) or split
    pools (``(k, v)``): [B, H, D] in q's dtype, or the merged fp32 state
    (acc, m, l) with ``partial``."""
    B, H, D = q.shape
    fused = len(pools) == 1
    Hkv, ps = pools[0].shape[0], pools[0].shape[-2]
    G = H // Hkv
    groups, group, kc_max = geometry(G, D, ps, q.element_size())
    n = bt.shape[1]
    acc = torch.zeros(B, H, D)
    m = torch.zeros(B, H)
    l = torch.zeros(B, H)
    for b in range(B):
        length = int(lens[b])
        for h in range(Hkv):
            def rows(page, key0, kc, h=h, b=b):
                j = int(bt[b, page])
                if fused:
                    pg = pools[0][h, j]
                    return pg[0, key0:key0 + kc], pg[1, key0:key0 + kc]
                return (pools[0][h, j, key0:key0 + kc],
                        pools[1][h, j, key0:key0 + kc])
            for hg in range(groups):
                g0 = hg * group
                heads = slice(h * G + g0, h * G + min(g0 + group, G))
                if wgmma_block(q.dtype, D, ps):
                    parts = [mirror_wgmma_block(
                        q[b, heads], rows, length, window, scale, softcap,
                        *split_pages(length, ps, n, window, sp, S), ps)
                        for sp in range(S)]
                else:
                    parts = [mirror_block(
                        q[b, heads], rows, length, window, scale, softcap,
                        *split_pages(length, ps, n, window, sp, S), ps,
                        kc_max)
                        for sp in range(S)]
                acc[b, heads], m[b, heads], l[b, heads] = (
                    _merge(parts) if S > 1 else parts[0])
    if partial:
        return acc, m, l
    return rc.finalize_partials(acc, l, q.dtype)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------
def _tol(name):
    return dict(atol=2e-5, rtol=2e-5) if name == "float32" else \
        dict(atol=2e-2, rtol=2e-2)


def _pair(a, name):
    jd, td = DTYPES[name]
    return jnp.asarray(a, jd), torch.from_numpy(np.asarray(a, np.float32)).to(td)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


CASES = [
    # (B, Hkv, G, D, ps, P, n, window, softcap, lengths)
    (4, 2, 3, 128, 16, 40, 8, 0, 0.0, [128, 16, 13, 120]),   # llama heads
    (3, 2, 4, 64, 16, 32, 8, 0, 0.0, [100, 1, 77]),
    (3, 1, 8, 64, 16, 24, 8, 0, 0.0, [128, 50, 3]),          # G 8
    (2, 1, 12, 32, 16, 16, 4, 0, 0.0, [64, 33]),             # two head groups
    (3, 2, 2, 64, 32, 16, 4, 48, 0.0, [128, 70, 20]),        # window
    (3, 2, 2, 128, 16, 24, 8, 0, 30.0, [90, 128, 5]),        # softcap
    (3, 2, 3, 64, 16, 24, 8, 37, 30.0, [101, 128, 40]),      # both
    (2, 2, 1, 256, 16, 16, 4, 0, 0.0, [64, 29]),             # D 256, MHA
    (2, 2, 2, 48, 16, 16, 4, 0, 0.0, [60, 17]),              # D 48 (6 vectors)
]


def _inputs(case, name):
    B, Hkv, G, D, ps, P, n, window, cap, lens = case
    jq, tq = _pair(RNG.normal(size=(B, Hkv * G, D)), name)
    jkv, tkv = _pair(RNG.normal(size=(Hkv, P, 2, ps, D)), name)
    bt = RNG.permutation(P)[:B * n].reshape(B, n).astype(np.int32)
    lens = np.asarray(lens, np.int32)
    for b in range(B):          # zero-padded past the last page
        bt[b, -(-int(lens[b]) // ps):] = 0
    kw = dict(scale=D ** -0.5, window=window, softcap=cap)
    return (jq, jkv, jnp.asarray(bt), jnp.asarray(lens)), \
        (tq, tkv, torch.from_numpy(bt), torch.from_numpy(lens)), kw


def _split(kv):
    k, v = rc.split_fused(kv)
    return k.contiguous(), v.contiguous()


# ---------------------------------------------------------------------------
# the split plan and the page ranges
# ---------------------------------------------------------------------------
# (block, B, Hkv, G, n, sms, want): the tensor-core block's plan at its
# blocks an SM (2 at D 128, 1 at D 256, 3 at D 64) over 64-key tiles of
# 16-key pages, and the scalar block's (ids as before the tensor-core block)
def _plan_case(block, B, Hkv, G, n, sms, want):
    ids = [B, Hkv, G, n, sms, want]
    if block != "scalar":
        ids = ["wgmma", block[1]] + ids
    return pytest.param(block, B, Hkv, G, n, sms, want,
                        id="-".join(str(x) for x in ids))


@pytest.mark.parametrize("block,B,Hkv,G,n,sms,want", [
    _plan_case(("wgmma", 128, 2), 8, 8, 3, 256, 132, 4),   # B8 serving-like
    _plan_case(("wgmma", 128, 2), 1, 8, 3, 256, 132, 16),  # B1: capped
    _plan_case(("wgmma", 128, 2), 64, 8, 3, 256, 132, 1),  # 512: no split
    _plan_case(("wgmma", 128, 2), 33, 8, 3, 256, 132, 1),  # the card's slots
    _plan_case(("wgmma", 128, 2), 4, 8, 8, 256, 132, 8),   # B4 G8
    _plan_case(("wgmma", 128, 2), 1, 8, 16, 256, 132, 16),  # two head groups
    _plan_case(("wgmma", 128, 2), 1, 8, 3, 2, 132, 1),     # one key tile
    _plan_case(("wgmma", 128, 2), 0, 8, 3, 256, 132, 1),   # no rows
    _plan_case(("wgmma", 256, 1), 8, 4, 2, 512, 132, 4),   # gemma2-2b B8
    _plan_case(("wgmma", 64, 3), 2, 2, 12, 64, 132, 16),   # the key tiles
    _plan_case("scalar", 1, 8, 3, 256, 132, 32),   # B1 ctx 4093: 8 blocks
    _plan_case("scalar", 8, 8, 3, 256, 132, 5),    # B8 serving-like
    _plan_case("scalar", 64, 8, 3, 256, 132, 1),   # 512 blocks: no split
    _plan_case("scalar", 33, 8, 3, 256, 132, 1),   # 264, two an SM already
    _plan_case("scalar", 32, 8, 3, 256, 132, 2),
    _plan_case("scalar", 1, 8, 3, 16, 132, 2),     # n // MIN_SPLIT_PAGES
    _plan_case("scalar", 1, 8, 3, 2, 132, 1),      # too narrow to split
    _plan_case("scalar", 1, 8, 16, 256, 132, 17),  # G 16: two head groups
    _plan_case("scalar", 2, 2, 1, 32, 132, 4),
    _plan_case("scalar", 0, 8, 3, 256, 132, 1),    # no rows
])
def test_split_plan_from_shapes(block, B, Hkv, G, n, sms, want):
    blocks = B * Hkv * -(-G // PK.HEADS_PER_BLOCK)
    if block == "scalar":
        S = PK.split_plan(B, Hkv, G, n, sms)
        assert S == want
        if S > 1:   # the grid reaches about two blocks an SM, or the cap
            assert blocks * S >= PK.SPLIT_BLOCKS_PER_SM * sms \
                or S == n // PK.MIN_SPLIT_PAGES
            assert blocks * (S - 1) < PK.SPLIT_BLOCKS_PER_SM * sms
        return
    _, D, per_sm = block
    S = PK.wgmma_split_plan(B, Hkv, G, n, 16, KEY_TILE, per_sm, sms)
    assert S == want
    tiles = -(-n * 16 // KEY_TILE)
    assert 1 <= S <= max(1, min(tiles, PK.MAX_SPLITS))
    if S > 1:   # the split grid fits the card's resident blocks at once
        assert blocks * S <= per_sm * sms


def test_planned_splits_reads_only_shapes(monkeypatch):
    """The wrappers' plan takes q's and the table's shapes, the page size,
    q's dtype, the card's SM count and the tensor-core block's occupancy,
    nothing of ``lengths``: the engine's one readback a round stays its
    only one."""
    class Shaped:
        def __init__(self, shape, dtype=torch.int32):
            self.shape = shape
            self.dtype = dtype
            self.device = torch.device("cuda", 0)
    monkeypatch.setattr(build, "sm_count", lambda device: 132)
    monkeypatch.setattr(PK, "wgmma_attributes", lambda dtype, D, ps: {
        "key_tile": KEY_TILE, "blocks_per_sm": 2}
        if wgmma_block(dtype, D, ps) else None)
    PK._planned.cache_clear()
    try:
        bf, f32 = torch.bfloat16, torch.float32
        assert PK.planned_splits(Shaped((8, 24, 128), bf), Shaped((8, 256)),
                                 8, 16) == 4
        assert PK.planned_splits(Shaped((1, 24, 128), bf), Shaped((1, 256)),
                                 8, 16) == 16
        assert PK.planned_splits(Shaped((8, 24, 128), f32),
                                 Shaped((8, 256)), 8, 16) == 5
        assert PK.planned_splits(Shaped((1, 24, 48), bf), Shaped((1, 256)),
                                 8, 16) == 32
        # pages that are not whole boxes of the key tile: the scalar plan
        for ps in (128, 12):
            assert PK.planned_splits(Shaped((8, 24, 128), bf),
                                     Shaped((8, 256)), 8, ps) == 5
    finally:
        PK._planned.cache_clear()


@pytest.mark.parametrize("S", [1, 2, 3, 5, 8, 33])
@pytest.mark.parametrize("window", [0, 1, 20, 48])
def test_splits_cut_the_live_range(S, window):
    """The S splits tile [j_lo, j_hi) in order, near-equal (sizes differ by
    at most one page; empty when the range has fewer pages than S), and
    the range is exactly the pages of the first n that hold a visible key:
    rows of length 0, negative shard-local lengths, lengths past the
    table and windows that start inside a page."""
    ps, n = 16, 8
    for length in (-40, -16, -1, 0, 1, 15, 16, 17, 64, 100, 128, 129, 300):
        j_lo, j_hi, np_ = live_pages(length, ps, n, window)
        cuts = [split_pages(length, ps, n, window, sp, S) for sp in range(S)]
        assert cuts[0][0] == j_lo and cuts[-1][1] == j_lo + np_
        assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
        sizes = [hi - lo for lo, hi in cuts]
        assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 0
        if np_ < S:
            assert sizes.count(0) == S - np_
        visible = [j for j in range(n) if any(
            kp < length and (window <= 0 or length - 1 - kp < window)
            for kp in range(j * ps, (j + 1) * ps))]
        assert list(range(j_lo, j_lo + np_)) == visible


@pytest.mark.parametrize("elt", [2, 4])
@pytest.mark.parametrize("D", [16, 32, 48, 64, 80, 128, 192, 256])
@pytest.mark.parametrize("G", [1, 3, 8, 12])
def test_chunk_geometry(D, elt, G):
    """A chunk's K and V rows fit kChunkBytes and take at most kSteps steps
    of 32 / L keys; L lanes of one 16-byte vector (bf16) or two (fp32)
    cover a row; a block holds at most HEADS_PER_BLOCK heads."""
    for ps in (1, 5, 16, 32):
        groups, group, kc = geometry(G, D, ps, elt)
        L = lanes_per_key(D)
        nv = vectors_per_lane(D, elt)
        assert 1 <= kc <= ps and 2 * kc * D * elt <= CHUNK_BYTES
        assert -(-kc // (32 // L)) <= STEPS // nv
        assert 32 % L == 0 and nv <= (1 if elt == 2 else 2)
        assert L * nv * 16 >= D * elt
        assert group <= PK.HEADS_PER_BLOCK and groups * group >= G
        assert (groups - 1) * group < G


# ---------------------------------------------------------------------------
# the mirror against the JAX reference and the plain versions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S", [1, 3, 8])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", list(DTYPES))
def test_mirror_matches_jax(case, name, S):
    (jq, jkv, jbt, jlens), (q, kv, bt, lens), kw = _inputs(case, name)
    got = mirror_decode(q, (kv,), bt, lens, S=S, **kw)
    want = JPA.paged_attention_fused_ref(jq, jkv, jbt, jlens, **kw)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(name))
    np.testing.assert_allclose(
        _np(got), _np(TPA.paged_attention_fused_ref(q, kv, bt, lens, **kw)),
        **_tol(name))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", list(DTYPES))
def test_mirror_partial_state(case, name):
    """partial=True: the merged un-normalized state is the plain version's
    (m and l to fp32 rounding) and finalizes to the full output."""
    (jq, jkv, jbt, jlens), (q, kv, bt, lens), kw = _inputs(case, name)
    acc, m, l = mirror_decode(q, (kv,), bt, lens, S=3, partial=True, **kw)
    jacc, jm, jl = JPA.paged_attention_partial_ref(jq, jkv, jbt, jlens, **kw)
    np.testing.assert_allclose(m.numpy(), _np(jm), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(l.numpy(), _np(jl), atol=1e-4, rtol=1e-4)
    # in bf16 p is rounded against each chunk's running max, not the row's
    acc_tol = dict(atol=1e-4, rtol=1e-4) if name == "float32" else _tol(name)
    np.testing.assert_allclose(acc.numpy(), _np(jacc), **acc_tol)
    np.testing.assert_allclose(
        _np(rc.finalize_partials(acc, l, q.dtype)),
        _np(JPA.paged_attention_fused_ref(jq, jkv, jbt, jlens, **kw)),
        **_tol(name))


@pytest.mark.parametrize("case", [CASES[i] for i in (0, 3, 6, 8)])
@pytest.mark.parametrize("name", list(DTYPES))
def test_split_pools_give_the_fused_bits(case, name):
    """Both pool layouts run one template with one plan: the split-pool
    output is the fused one bit for bit, and both match the JAX split-pool
    reference; so are the partial states."""
    (jq, jkv, jbt, jlens), (q, kv, bt, lens), kw = _inputs(case, name)
    k, v = _split(kv)
    for S in (1, 4):
        fused = mirror_decode(q, (kv,), bt, lens, S=S, **kw)
        split = mirror_decode(q, (k, v), bt, lens, S=S, **kw)
        assert torch.equal(fused, split)
        want = JPA.paged_attention_ref(jq, jkv[:, :, 0], jkv[:, :, 1], jbt,
                                       jlens, **kw)
        np.testing.assert_allclose(_np(split), _np(want), **_tol(name))
        pf = mirror_decode(q, (kv,), bt, lens, S=S, partial=True, **kw)
        ps_ = mirror_decode(q, (k, v), bt, lens, S=S, partial=True, **kw)
        assert all(torch.equal(a, b) for a, b in zip(pf, ps_))


@pytest.mark.parametrize("name", list(DTYPES))
def test_empty_splits_and_zero_length_rows(name):
    """Rows of length 0 (padding rows) write zeros and the state (0, -1e30,
    0); rows with fewer pages than splits leave splits empty, which do not
    change the result."""
    case = (4, 2, 3, 64, 16, 32, 8, 0, 0.0, [0, 5, 33, 0])
    (jq, jkv, jbt, jlens), (q, kv, bt, lens), kw = _inputs(case, name)
    out = mirror_decode(q, (kv,), bt, lens, S=8, **kw)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert torch.equal(out[3], torch.zeros_like(out[3]))
    want = JPA.paged_attention_fused_ref(jq, jkv, jbt, jlens, **kw)
    np.testing.assert_allclose(_np(out)[1:3], _np(want)[1:3], **_tol(name))
    np.testing.assert_allclose(
        _np(out), _np(mirror_decode(q, (kv,), bt, lens, S=1, **kw)),
        **_tol(name))
    acc, m, l = mirror_decode(q, (kv,), bt, lens, S=8, partial=True, **kw)
    for r in (0, 3):
        assert torch.equal(acc[r], torch.zeros_like(acc[r]))
        assert bool((m[r] == rc.NEG_INF).all()) and bool((l[r] == 0).all())


@pytest.mark.parametrize("window", [5, 21, 40])
@pytest.mark.parametrize("name", list(DTYPES))
def test_window_starting_inside_a_split(window, name):
    """A window whose first key falls inside a page, a chunk and a split
    (S = 3 over the row's pages) with the softcap."""
    case = (3, 2, 2, 64, 16, 32, 8, window, 30.0, [127, 100, 61])
    (jq, jkv, jbt, jlens), (q, kv, bt, lens), kw = _inputs(case, name)
    for b in range(3):
        j_lo, _, np_ = live_pages(int(lens[b]), 16, 8, window)
        assert (int(lens[b]) - window) % 16 or j_lo == 0
    got = mirror_decode(q, (kv,), bt, lens, S=3, **kw)
    want = JPA.paged_attention_fused_ref(jq, jkv, jbt, jlens, **kw)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(name))


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 3, 8])
def test_wgmma_block_heads_and_head_dims(G, D):
    """The tensor-core block at each head dim it takes, with G query heads
    padded to HEADS_PER_BLOCK zero rows (G 1 and 3) or none (G 8): the
    mirror against the JAX reference in bf16, whole and in 3 splits, and
    its partial state against the plain version's."""
    assert wgmma_block(torch.bfloat16, D, 16)
    case = (3, 2, G, D, 16, 24, 8, 0, 0.0, [128, 37, 90])
    (jq, jkv, jbt, jlens), (q, kv, bt, lens), kw = _inputs(case, "bfloat16")
    want = JPA.paged_attention_fused_ref(jq, jkv, jbt, jlens, **kw)
    for S in (1, 3):
        got = mirror_decode(q, (kv,), bt, lens, S=S, **kw)
        np.testing.assert_allclose(_np(got), _np(want), **_tol("bfloat16"))
    acc, m, l = mirror_decode(q, (kv,), bt, lens, S=3, partial=True, **kw)
    racc, rm, rl = TPA.paged_attention_partial_ref(q, kv, bt, lens, **kw)
    np.testing.assert_allclose(m.numpy(), rm.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(l.numpy(), rl.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(acc.numpy(), racc.float().numpy(),
                               **_tol("bfloat16"))


@pytest.mark.parametrize("ps", [8, 16, 32])
@pytest.mark.parametrize("S", [1, 2, 3, 7])
def test_key_tile_ending_inside_a_page_range(ps, S):
    """Splits whose page count is not a multiple of KEY_TILE // ps: the
    last tile holds the split's last pages and then that last page again,
    whose keys lie past the split (or the row) and are masked; with a
    window, the first tile starts inside a page. bf16 at D 128 against
    the JAX reference, and the splits' partial states merged against the
    plain version's."""
    lens = [5 * ps + 3, 11 * ps, 3 * ps - 1, 13 * ps + 7]
    n = 16
    for window in (0, 2 * ps + 5):
        case = (4, 2, 3, 128, ps, 64, n, window, 0.0, lens)
        (jq, jkv, jbt, jlens), (q, kv, bt, lens_t), kw = _inputs(
            case, "bfloat16")
        mid_tile = False
        for length in lens:
            assert live_pages(length, ps, n, window)[2] > 0
            mid_tile |= any(
                (hi - lo) * ps % KEY_TILE for lo, hi in (
                    split_pages(length, ps, n, window, sp, S)
                    for sp in range(S)))
        assert mid_tile
        got = mirror_decode(q, (kv,), bt, lens_t, S=S, **kw)
        want = JPA.paged_attention_fused_ref(jq, jkv, jbt, jlens, **kw)
        np.testing.assert_allclose(_np(got), _np(want), **_tol("bfloat16"))
        acc, m, l = mirror_decode(q, (kv,), bt, lens_t, S=S, partial=True,
                                  **kw)
        racc, rm, rl = TPA.paged_attention_partial_ref(q, kv, bt, lens_t,
                                                       **kw)
        np.testing.assert_allclose(m.numpy(), rm.numpy(), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(l.numpy(), rl.numpy(), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("ps", [12, 24, 128])
@pytest.mark.parametrize("D", [64, 128])
def test_pages_the_tensor_core_block_does_not_take(D, ps):
    """bf16 at a tensor-core head dim over pages that are not a multiple of
    8 keys dividing KEY_TILE takes the scalar block: its mirror against the
    JAX reference, whole and in 3 splits, with the split pools giving the
    fused pool's bits."""
    assert not wgmma_block(torch.bfloat16, D, ps)
    case = (3, 2, 3, D, ps, 24, 4, 0, 0.0, [4 * ps, 37, 2 * ps + 5])
    (jq, jkv, jbt, jlens), (q, kv, bt, lens), kw = _inputs(case, "bfloat16")
    want = JPA.paged_attention_fused_ref(jq, jkv, jbt, jlens, **kw)
    k, v = _split(kv)
    for S in (1, 3):
        got = mirror_decode(q, (kv,), bt, lens, S=S, **kw)
        np.testing.assert_allclose(_np(got), _np(want), **_tol("bfloat16"))
        assert torch.equal(got, mirror_decode(q, (k, v), bt, lens, S=S, **kw))


@pytest.mark.parametrize("case", [CASES[i] for i in (0, 1, 5)])
@pytest.mark.parametrize("S", [1, 4])
def test_partial_negative_shard_local_lengths(case, S):
    """The sequence-sharded combine: the second half of each table at
    shard-local lengths (length - its key offset, negative for short rows)
    gives the state (0, -1e30, 0) where it holds no key, and the two
    halves' partial states combine to the whole (fp32)."""
    (_, _, _, _), (q, kv, bt, lens), kw = _inputs(case, "float32")
    ps, h = kv.shape[3], bt.shape[1] // 2
    off = h * ps
    assert int((lens - off).min()) < 0
    full = TPA.paged_attention_fused_ref(q, kv, bt, lens, **kw)
    p1 = mirror_decode(q, (kv,), bt[:, :h], lens, S=S, partial=True, **kw)
    p2 = mirror_decode(q, (kv,), bt[:, h:], lens - off, S=S, partial=True,
                       **kw)
    for b in range(q.shape[0]):
        if int(lens[b]) <= off:
            assert bool((p2[1][b] == rc.NEG_INF).all())
            assert bool((p2[2][b] == 0).all())
    got = rc.combine_partials([p1, p2], q.dtype)
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=2e-5,
                               rtol=2e-5)


def test_mirror_geometry_follows_the_source():
    """WARPS, STAGES, STEPS, lanes_per_key, the chunk's key count, the
    tensor-core block's head dims, KEY_TILE, CONSUMERS, its tiles, page
    clamp and masks, and the plan's HEADS_PER_BLOCK and MIN_SPLIT_PAGES
    are the source's, so a change to either side fails here rather than
    letting the mirror drift."""
    src = (build.CSRC / "paged_attention.cu").read_text()

    def const(name):
        m = re.search(r"constexpr int " + name + r" = (\d+);", src)
        assert m, name
        return int(m.group(1))
    assert const("kWarps") == WARPS == PK.MIN_SPLIT_PAGES
    assert const("kStages") == STAGES
    assert const("kSteps") == STEPS
    assert const("kHeadsPerBlock") == PK.HEADS_PER_BLOCK
    assert const("kKeyTile") == KEY_TILE
    assert const("kConsumers") == CONSUMERS
    for rule in ("return (D == 64 || D == 128 || D == 256) && ps % 8 == 0 "
                 "&&\n         kKeyTile % ps == 0;",
                 "if (takes_wgmma(a.D, a.ps)) return launch_wgmma(a, stream);",
                 "if (!takes_wgmma(a.D, a.ps) || a.n_split > w.max_splits)",
                 "const int n_tiles = ((p_hi - p_lo) * ps + Geo::KT - 1) / "
                 "Geo::KT;",
                 "const DecodeMask dm{p_lo * ps, min(p_hi * ps, length), "
                 "length, a.window,",
                 "const int kp = dm.kp0 + j * kKeyTile + 16 * w + gq + 8 * "
                 "(x >> 1);",
                 "const bool ok = kp < dm.hi &&",
                 "(dm.window <= 0 || dm.length - 1 - kp < dm.window);",
                 "j = c + kConsumers * i;",
                 "s[x] = expf(s[x] - m[x & 1]);",
                 "__float2bfloat16_rn(s[x]);"):
        assert rule in src, rule
    assert "? bt_row[min(p_lo + j * ppt + pg, p_hi - 1)] : 0;" in src
    for rule in ("int L = 8;",
                 "while (L < 32 && L * 8 < D) L *= 2;",
                 "a.head_groups = (a.G + kHeadsPerBlock - 1) / kHeadsPerBlock;",
                 "a.group = (a.G + a.head_groups - 1) / a.head_groups;",
                 "const int nv = (a.D * elt / 16 + L - 1) / L;",
                 "a.KC = std::min(a.ps, kSteps / nv * (32 / L));",
                 "constexpr int STEPS = kSteps / NV;",
                 "constexpr int ROWS = STEPS * kpi;",
                 "const int p_lo = j_lo + (int)((long)np * sp / a.n_split);",
                 "const int u = warp + i * kWarps;"):
        assert rule in src, rule


def test_decode_variants_anchors_are_in_the_source():
    """tools/decode_variants.py cuts the loads and the compute out of the
    source by text: its anchors must stay in it."""
    import importlib.util
    path = build.CSRC.parents[2] / "tools" / "decode_variants.py"
    spec = importlib.util.spec_from_file_location("decode_variants", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = (build.CSRC / "paged_attention.cu").read_text()
    for cut in tool.DIAGNOSTIC.values():
        for anchor in cut["sub"]:
            assert src.count(anchor) == 1, anchor
