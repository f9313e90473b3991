"""PyTorch port: the plain versions of the two paged-attention kernels (over
the fused pool and over split K and V pools) and of the chunked-prefill
attention kernel against the JAX oracles, the paged
partial/finalize/combine math, and a torch mirror of the CUDA kernels' tile
loop (page bounds with floor division, multi-page tiles, online-softmax
carry, negative shard-local positions; for the chunked kernel the [lo, hi)
key range, ragged q tiles, empty rows and strided operands) and of their
page loads from either pool layout against the plain versions. The CUDA kernels themselves run only on the GPU
(``chip_smoke.py`` holds them against these plain versions there).

Tolerances as in ``tests/test_kernels.py``: fp32 2e-5, bf16 2e-2."""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.chunked_prefill_attention import ref as JCPA  # noqa: E402
from repro.kernels.paged_attention import ref as JPA  # noqa: E402
from repro.kernels.paged_prefill_attention import ref as JPPA  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ref_common as rc  # noqa: E402
from repro_torch.kernels.chunked_prefill_attention import kernel as CK  # noqa: E402
from repro_torch.kernels.chunked_prefill_attention import ref as TCPA  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as PK  # noqa: E402
from repro_torch.kernels.paged_attention import ref as TPA  # noqa: E402
from repro_torch.kernels.paged_prefill_attention import kernel as PPK  # noqa: E402
from repro_torch.kernels.paged_prefill_attention import ref as TPPA  # noqa: E402

RNG = np.random.default_rng(42)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(atol=2e-5, rtol=2e-5) if name == "float32" else \
        dict(atol=2e-2, rtol=2e-2)


def _pair(a, name):
    """The same numpy values as a JAX and a torch array of one dtype."""
    jd, td = DTYPES[name]
    return jnp.asarray(a, jd), torch.from_numpy(np.asarray(a, np.float32)).to(td)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _edge_lengths(B, n, ps):
    base = [n * ps, ps, max(ps - 3, 1), n * ps - ps // 2]
    return np.asarray([base[i % len(base)] for i in range(B)], np.int32)


def _prefill_edges(R, Sq, n, ps):
    """A chunk ending exactly on a page boundary, a prompt shorter than one
    page, the deepest chunk, ragged rows and an all-padding row."""
    pos = np.zeros((R,), np.int32)
    lens = np.zeros((R,), np.int32)
    pos[0] = ps - Sq % ps if Sq % ps else 0
    lens[0] = pos[0] + Sq
    pos[1], lens[1] = 0, max(ps - 3, 1)
    pos[2], lens[2] = n * ps - Sq, n * ps
    for i in range(3, R - 1):
        pos[i] = int(RNG.integers(0, n * ps - Sq + 1))
        lens[i] = pos[i] + int(RNG.integers(1, Sq + 1))
    pos[-1], lens[-1] = 0, 0
    return pos, lens


FUSED_PA_CASES = [
    # (B, Hkv, G, D, page_size, P_total, pages_per_seq, window, softcap)
    (4, 4, 1, 32, 16, 16, 4, 0, 0.0),    # MHA
    (4, 2, 4, 64, 16, 32, 6, 0, 0.0),    # GQA ratio 4
    (4, 1, 8, 64, 16, 16, 4, 0, 0.0),    # GQA ratio 8, single KV head
    (4, 2, 2, 64, 32, 16, 4, 48, 0.0),   # sliding window
    (4, 2, 2, 128, 16, 8, 3, 0, 30.0),   # softcap
    (4, 2, 2, 64, 16, 16, 4, 23, 30.0),  # window + softcap
    (3, 2, 3, 128, 16, 24, 9, 0, 0.0),   # llama3.2-3b head shape (G 3, D 128)
]

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


def _decode_inputs(case, name):
    B, Hkv, G, D, ps, P, n, window, cap = case
    jq, tq = _pair(RNG.normal(size=(B, Hkv * G, D)), name)
    jkv, tkv = _pair(RNG.normal(size=(Hkv, P, 2, ps, D)), name)
    bt = RNG.integers(0, P, (B, n)).astype(np.int32)
    lens = _edge_lengths(B, n, ps)
    kw = dict(scale=D ** -0.5, window=window, softcap=cap)
    return (jq, jkv, jnp.asarray(bt), jnp.asarray(lens)), \
        (tq, tkv, torch.from_numpy(bt), torch.from_numpy(lens)), kw


def _prefill_inputs(case, name):
    R, Sq, Hkv, G, D, ps, P, n, window, cap = case
    jq, tq = _pair(RNG.normal(size=(R, Sq, Hkv, G, D)), name)
    jkv, tkv = _pair(RNG.normal(size=(Hkv, P, 2, ps, D)), name)
    bt = RNG.integers(0, P, (R, n)).astype(np.int32)
    bt[-1] = P - 1                          # padding row: the trash page
    pos, lens = _prefill_edges(R, Sq, n, ps)
    valid = (pos[:, None] + np.arange(Sq)[None, :]) < lens[:, None]
    kw = dict(scale=D ** -0.5, window=window, softcap=cap)
    return (jq, jkv, jnp.asarray(bt), jnp.asarray(pos), jnp.asarray(lens)), \
        (tq, tkv, torch.from_numpy(bt), torch.from_numpy(pos),
         torch.from_numpy(lens)), kw, valid


# ---------------------------------------------------------------------------
# plain versions against the JAX oracles
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", FUSED_PA_CASES)
@pytest.mark.parametrize("name", list(DTYPES))
def test_decode_plain_matches_jax(case, name):
    j, t, kw = _decode_inputs(case, name)
    got = TPA.paged_attention_fused_ref(*t, **kw)
    want = JPA.paged_attention_fused_ref(*j, **kw)
    assert got.dtype == t[0].dtype and got.shape == t[0].shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(name))
    acc, m, l = TPA.paged_attention_partial_ref(*t, **kw)
    jacc, jm, jl = JPA.paged_attention_partial_ref(*j, **kw)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), **_tol(name))
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=2e-5 if
                               name == "float32" else 2e-2)
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc),
                               **_tol(name) if name == "float32" else
                               dict(atol=0.1, rtol=2e-2))


@pytest.mark.parametrize("case", FUSED_PPA_CASES)
@pytest.mark.parametrize("name", list(DTYPES))
def test_prefill_plain_matches_jax(case, name):
    j, t, kw, valid = _prefill_inputs(case, name)
    got = TPPA.paged_prefill_attention_fused_ref(*t, **kw)
    want = JPPA.paged_prefill_attention_fused_ref(*j, **kw)
    assert got.dtype == t[0].dtype and got.shape == t[0].shape
    np.testing.assert_allclose(_np(got)[valid], _np(want)[valid], **_tol(name))
    acc, m, l = TPPA.paged_prefill_attention_partial_ref(*t, **kw)
    jacc, jm, jl = JPPA.paged_prefill_attention_partial_ref(*j, **kw)
    np.testing.assert_allclose(m.numpy()[valid], np.asarray(jm)[valid],
                               **_tol(name))
    np.testing.assert_allclose(l.numpy()[valid], np.asarray(jl)[valid],
                               rtol=2e-5 if name == "float32" else 2e-2)


@pytest.mark.parametrize("case", FUSED_PA_CASES[:1] + FUSED_PA_CASES[-2:])
def test_decode_finalize_and_combine(case):
    """finalize(partial) == full (ulp scale: the full version divides before
    the P.V product); the combine of two key halves with shard-local
    lengths == the whole."""
    _, (q, kv, bt, lens), kw = _decode_inputs(case, "float32")
    full = TPA.paged_attention_fused_ref(q, kv, bt, lens, **kw)
    acc, m, l = TPA.paged_attention_partial_ref(q, kv, bt, lens, **kw)
    np.testing.assert_allclose(rc.finalize_partials(acc, l, q.dtype).numpy(),
                               full.numpy(), atol=2e-6, rtol=2e-6)
    h = bt.shape[1] // 2
    ps = kv.shape[3]
    parts = [TPA.paged_attention_partial_ref(q, kv, bt[:, :h], lens, **kw),
             TPA.paged_attention_partial_ref(q, kv, bt[:, h:],
                                             lens - h * ps, **kw)]
    if kw["window"] == 0:   # every row has a valid key in the first half
        np.testing.assert_allclose(rc.combine_partials(parts, q.dtype).numpy(),
                                   full.numpy(), atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("case", FUSED_PPA_CASES)
def test_prefill_finalize_and_combine_negative_pos(case):
    """Partials over the second half of the block table see shard-local
    (negative) row positions; combined with the first half they give the
    whole, at every valid query position."""
    _, (q, kv, bt, pos, lens), kw, valid = _prefill_inputs(case, "float32")
    full = TPPA.paged_prefill_attention_fused_ref(q, kv, bt, pos, lens, **kw)
    acc, m, l = TPPA.paged_prefill_attention_partial_ref(q, kv, bt, pos,
                                                         lens, **kw)
    np.testing.assert_allclose(
        rc.finalize_partials(acc, l, q.dtype).numpy()[valid],
        full.numpy()[valid], atol=2e-6, rtol=2e-6)
    h = bt.shape[1] // 2
    off = h * kv.shape[3]
    p1 = TPPA.paged_prefill_attention_partial_ref(q, kv, bt[:, :h], pos,
                                                  lens, **kw)
    p2 = TPPA.paged_prefill_attention_partial_ref(q, kv, bt[:, h:], pos - off,
                                                  lens - off, **kw)
    assert (pos - off).min() < 0
    got = rc.combine_partials([p1, p2], q.dtype).numpy()
    live = valid & (p1[1].amax(dim=(2, 3)) > rc.NEG_INF / 2).numpy()
    np.testing.assert_allclose(got[live], full.numpy()[live], atol=2e-5,
                               rtol=2e-5)


# ---------------------------------------------------------------------------
# torch mirror of the CUDA kernels' tile loop
# ---------------------------------------------------------------------------
def floordiv(a: int, b: int) -> int:
    """csrc/paged_common.cuh floordiv, written the C way (truncating '/')."""
    q = int(a / b)
    return q - 1 if q * b != a and a < 0 else q


def _attend_block(q_rows, q_pos, kv_h, bt_row, length, window, scale, cap,
                  j_lo, j_hi, tile_pages, causal=True):
    """One block of attend_rows: [BR, D] query rows at positions q_pos
    over pages [j_lo, j_hi) of kv_h [P, 2, ps, D] through bt_row."""
    BR, D = q_rows.shape
    ps = kv_h.shape[2]
    m = torch.full((BR,), rc.NEG_INF)
    l = torch.zeros(BR)
    acc = torch.zeros(BR, D)
    for j0 in range(j_lo, j_hi, tile_pages):
        pages = bt_row[j0:min(j0 + tile_pages, j_hi)].long()
        k = kv_h[pages, 0].reshape(-1, D).float()
        v = kv_h[pages, 1].reshape(-1, D)
        s = (q_rows.float() @ k.T) * scale
        if cap > 0:
            s = cap * torch.tanh(s / cap)
        kp = j0 * ps + torch.arange(k.shape[0])
        ok = kp[None] < length
        if causal:
            ok = ok & (kp[None] <= q_pos[:, None])
        if window > 0:
            ok = ok & (q_pos[:, None] - kp[None] < window)
        s = torch.where(ok, s, torch.full_like(s, rc.NEG_INF))
        mx = torch.maximum(m, s.amax(dim=1))
        p = torch.exp(s - mx[:, None])
        corr = torch.exp(m - mx)
        l = l * corr + p.sum(dim=1)
        acc = acc * corr[:, None] + p.to(v.dtype).float() @ v.float()
        m = mx
    return acc, m, l


# Tile geometry of the mirror: pages per tile, and query tokens per prefill
# block. (4, 21) is the launcher's choice at the llama3.2-3b shape (page 16,
# G 3, D 128); (1, 5) gives one-page tiles and ragged last query tiles.
GEOMETRIES = [(4, 21), (1, 5)]


def mirror_decode(q, kv, bt, lens, *, scale, window, softcap, tp):
    B, H, D = q.shape
    Hkv, _, _, ps, _ = kv.shape
    G = H // Hkv
    acc = torch.zeros(B, H, D)
    m = torch.zeros(B, H)
    l = torch.zeros(B, H)
    for b in range(B):
        length = int(lens[b])
        j_hi = min(floordiv(length + ps - 1, ps), bt.shape[1])
        j_lo = max(floordiv(length - window, ps), 0) if window > 0 else 0
        j_lo = min(j_lo, max(j_hi, 0))
        for h in range(Hkv):
            rows = slice(h * G, (h + 1) * G)
            acc[b, rows], m[b, rows], l[b, rows] = _attend_block(
                q[b, rows], torch.full((G,), length - 1), kv[h], bt[b],
                length, window, scale, softcap, j_lo, j_hi, tp)
    return acc, m, l


def mirror_prefill(q, kv, bt, pos, lens, *, scale, window, softcap, tp, bq):
    R, Sq, Hkv, G, D = q.shape
    ps = kv.shape[3]
    acc = torch.zeros(R, Sq, Hkv, G, D)
    m = torch.zeros(R, Sq, Hkv, G)
    l = torch.zeros(R, Sq, Hkv, G)
    for r in range(R):
        p0, length = int(pos[r]), int(lens[r])
        for qi in range(math.ceil(Sq / bq)):
            q0 = qi * bq
            nt = min(bq, Sq - q0)
            pages_needed = floordiv(length + ps - 1, ps)
            causal_hi = floordiv(p0 + q0 + nt - 1, ps) + 1
            j_hi = min(pages_needed, causal_hi, bt.shape[1])
            j_lo = (max(floordiv(p0 + q0 - window + 1, ps), 0)
                    if window > 0 else 0)
            j_lo = min(j_lo, max(j_hi, 0))
            q_pos = p0 + q0 + torch.arange(nt * G) // G
            for h in range(Hkv):
                a, mm, ll = _attend_block(
                    q[r, q0:q0 + nt, h].reshape(nt * G, D), q_pos, kv[h],
                    bt[r], length, window, scale, softcap, j_lo, j_hi, tp)
                acc[r, q0:q0 + nt, h] = a.reshape(nt, G, D)
                m[r, q0:q0 + nt, h] = mm.reshape(nt, G)
                l[r, q0:q0 + nt, h] = ll.reshape(nt, G)
    return acc, m, l


def test_floordiv_matches_python():
    for a in range(-40, 41):
        for b in (1, 3, 16):
            assert floordiv(a, b) == a // b


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("case", FUSED_PA_CASES)
@pytest.mark.parametrize("name", list(DTYPES))
def test_decode_tile_loop_mirror(case, name, geometry):
    _, (q, kv, bt, lens), kw = _decode_inputs(case, name)
    acc, m, l = mirror_decode(q, kv, bt, lens, tp=geometry[0], **kw)
    got = rc.finalize_partials(acc, l, q.dtype)
    want = TPA.paged_attention_fused_ref(q, kv, bt, lens, **kw)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(name))
    racc, rm, rl = TPA.paged_attention_partial_ref(q, kv, bt, lens, **kw)
    np.testing.assert_allclose(m.numpy(), rm.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("case", FUSED_PPA_CASES)
@pytest.mark.parametrize("name", list(DTYPES))
def test_prefill_tile_loop_mirror(case, name, geometry):
    _, (q, kv, bt, pos, lens), kw, valid = _prefill_inputs(case, name)
    tp, bq = geometry
    acc, m, l = mirror_prefill(q, kv, bt, pos, lens, tp=tp, bq=bq, **kw)
    got = rc.finalize_partials(acc, l, q.dtype)
    want = TPPA.paged_prefill_attention_fused_ref(q, kv, bt, pos, lens, **kw)
    assert torch.isfinite(got.float()).all()      # padding rows included
    np.testing.assert_allclose(_np(got)[valid], _np(want)[valid],
                               **_tol(name))


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("case", FUSED_PPA_CASES[:2] + FUSED_PPA_CASES[-1:])
def test_prefill_tile_loop_mirror_partial_negative_pos(case, geometry):
    """The second half of the block table at shard-local positions: the
    mirror's page bounds (floor division of negative positions) must give
    the plain version's partial state wherever a row sees a key."""
    _, (q, kv, bt, pos, lens), kw, valid = _prefill_inputs(case, "float32")
    h = bt.shape[1] // 2
    off = h * kv.shape[3]
    args = (q, kv, bt[:, h:].contiguous(), pos - off, lens - off)
    acc, m, l = mirror_prefill(*args, tp=geometry[0], bq=geometry[1], **kw)
    racc, rm, rl = TPPA.paged_prefill_attention_partial_ref(*args, **kw)
    live = (rm > rc.NEG_INF / 2).numpy()
    assert live.any() and not live.all()
    np.testing.assert_allclose(m.numpy()[live], rm.numpy()[live], atol=1e-5)
    np.testing.assert_allclose(l.numpy()[live], rl.numpy()[live], rtol=1e-5)
    np.testing.assert_allclose(acc.numpy()[live], racc.numpy()[live],
                               atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# wrappers on the CPU
# ---------------------------------------------------------------------------
def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    _, (q, kv, bt, lens), kw = _decode_inputs(FUSED_PA_CASES[1], "float32")
    assert PK.paged_attention_fused.launches == 0
    assert torch.equal(PK.paged_attention_fused(q, kv, bt, lens, **kw),
                       TPA.paged_attention_fused_ref(q, kv, bt, lens, **kw))
    part = PK.paged_attention_fused(q, kv, bt, lens, partial=True, **kw)
    assert len(part) == 3
    _, (q, kv, bt, pos, lens), kw, _ = _prefill_inputs(FUSED_PPA_CASES[1],
                                                       "float32")
    assert torch.equal(
        PPK.paged_prefill_attention_fused(q, kv, bt, pos, lens, **kw),
        TPPA.paged_prefill_attention_fused_ref(q, kv, bt, pos, lens, **kw))
    assert PK.paged_attention_fused.launches == 0
    assert PPK.paged_prefill_attention_fused.launches == 0


def test_other_devices_raise():
    q = torch.empty((2, 4, 32), device="meta")
    kv = torch.empty((2, 4, 2, 16, 32), device="meta")
    bt = torch.empty((2, 2), dtype=torch.int32, device="meta")
    ln = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        PK.paged_attention_fused(q, kv, bt, ln, scale=1.0)
    with pytest.raises(ValueError):
        PPK.paged_prefill_attention_fused(q[:, None].reshape(2, 1, 2, 2, 32),
                                          kv, bt, ln, ln, scale=1.0)


# ---------------------------------------------------------------------------
# chunked-prefill attention (slot mode's chunk attention)
# ---------------------------------------------------------------------------
CPA_CASES = [   # the CPA_CASES of tests/test_kernels.py (block sizes dropped)
    # (B, H, Hkv, Sq, Sk, D, q_offset, causal, window, softcap)
    (1, 2, 2, 64, 64, 32, 0, True, 0, 0.0),
    (2, 4, 2, 128, 256, 64, 64, True, 0, 0.0),
    (2, 8, 2, 64, 512, 64, 448, True, 0, 0.0),   # deep prefix chunk
    (1, 4, 4, 128, 128, 64, 0, True, 96, 0.0),    # sliding window
    (1, 4, 4, 128, 128, 64, 0, True, 0, 50.0),    # softcap (gemma2)
    (2, 2, 1, 64, 128, 128, 0, False, 0, 0.0),    # cross/encoder
]

# Beyond the reference's cases: the slot path's head shape (G 3, D 128) at
# an offset that ends past the valid length, windows with and without
# causality, and a row with no key (length 0).
CPA_EXTRA = [
    (2, 6, 2, 40, 96, 128, 30, True, 0, 0.0),
    (2, 6, 2, 24, 96, 64, 50, True, 20, 30.0),
    (2, 4, 2, 24, 64, 32, 10, False, 12, 0.0),
]


def _cpa_inputs(case, name, lengths=None):
    B, H, Hkv, Sq, Sk, D, q_off, causal, window, cap = case
    jq, tq = _pair(RNG.normal(size=(B, H, Sq, D)), name)
    jk, tk = _pair(RNG.normal(size=(B, Hkv, Sk, D)), name)
    jv, tv = _pair(RNG.normal(size=(B, Hkv, Sk, D)), name)
    if lengths is None:
        lengths = RNG.integers(max(q_off + Sq, 1), Sk + 1, (B,))
    lengths = np.asarray(lengths, np.int32)
    kw = dict(scale=D ** -0.5, q_offset=q_off, causal=causal, window=window,
              softcap=cap)
    return (jq, jk, jv, jnp.asarray(lengths)), \
        (tq, tk, tv, torch.from_numpy(lengths)), kw


@pytest.mark.parametrize("case", CPA_CASES)
@pytest.mark.parametrize("name", list(DTYPES))
def test_chunked_plain_matches_jax(case, name):
    j, t, kw = _cpa_inputs(case, name)
    got = TCPA.chunked_prefill_attention_ref(*t, **kw)
    want = JCPA.chunked_prefill_attention_ref(*j, **kw)
    assert got.dtype == t[0].dtype and got.shape == t[0].shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(name))


def _cpa_strided(q, k, v):
    """The same values as views in the slot path's layouts: q a permuted
    [B, Sq, H, D] tensor, k/v permuted [B, Sk, Hkv, D] rows of a larger
    cache (every other row)."""
    B, H, Sq, D = q.shape
    qv = q.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)

    def rows(x):
        big = torch.zeros((2 * B,) + x.permute(0, 2, 1, 3).shape[1:],
                          dtype=x.dtype)
        big[::2] = x.permute(0, 2, 1, 3)
        return big[::2].permute(0, 2, 1, 3)
    return qv, rows(k), rows(v)


@pytest.mark.parametrize("case", CPA_CASES[:3] + CPA_EXTRA)
def test_chunked_plain_takes_strided_views(case):
    _, (q, k, v, lens), kw = _cpa_inputs(case, "float32")
    qv, kv_, vv = _cpa_strided(q, k, v)
    assert not qv.is_contiguous() and not kv_.is_contiguous()
    np.testing.assert_allclose(
        TCPA.chunked_prefill_attention_ref(qv, kv_, vv, lens, **kw).numpy(),
        TCPA.chunked_prefill_attention_ref(q, k, v, lens, **kw).numpy(),
        atol=1e-6, rtol=1e-6)


def mirror_chunked(q, k, v, lens, *, scale, q_offset, causal, window,
                   softcap, tile_keys, bq):
    """csrc/chunked_prefill_attention.cu in torch: one block per (batch
    row, kv head, q tile of bq tokens), rows t*G + g, keys [lo, hi). The
    contiguous rows are one-key pages in order, so the same block loop as
    the paged kernels' runs them."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    out = torch.zeros(B, H, Sq, D)
    for b in range(B):
        length = int(lens[b])
        for qi in range(math.ceil(Sq / bq)):
            q0 = qi * bq
            nt = min(bq, Sq - q0)
            hi = min(length, Sk)
            if causal:
                hi = min(hi, q_offset + q0 + nt)
            lo = max(q_offset + q0 - window + 1, 0) if window > 0 else 0
            lo = min(lo, max(hi, 0))
            q_pos = q_offset + q0 + torch.arange(nt * G) // G
            for h in range(Hkv):
                rows = q[b, h * G:(h + 1) * G, q0:q0 + nt]       # [G, nt, D]
                kv_h = torch.stack([k[b, h], v[b, h]], dim=1)[:, :, None]
                acc, _, l = _attend_block(
                    rows.transpose(0, 1).reshape(nt * G, D), q_pos, kv_h,
                    torch.arange(Sk), length, window, scale, softcap, lo, hi,
                    tile_keys, causal=causal)
                o = rc.finalize_partials(acc, l, torch.float32)
                out[b, h * G:(h + 1) * G, q0:q0 + nt] = \
                    o.reshape(nt, G, D).transpose(0, 1)
    return out.to(q.dtype)


def _cpa_valid(case, lens):
    """Query positions that see at least one key."""
    B, H, Hkv, Sq, Sk, D, q_off, causal, window, cap = case
    qp = q_off + np.arange(Sq)[None, :, None]
    kp = np.arange(Sk)[None, None, :]
    ok = kp < np.asarray(lens)[:, None, None]
    if causal:
        ok = ok & (kp <= qp)
    if window > 0:
        ok = ok & (qp - kp < window)
    return np.broadcast_to(ok.any(-1)[:, None, :, None], (B, H, Sq, D))


# (keys per tile, query tokens per block): the launcher's choice at the
# llama3.2-3b shape (G 3, D 128), and small tiles with ragged q tiles.
CPA_GEOMETRIES = [(64, 21), (16, 5)]


@pytest.mark.parametrize("geometry", CPA_GEOMETRIES)
@pytest.mark.parametrize("case", CPA_CASES + CPA_EXTRA)
@pytest.mark.parametrize("name", list(DTYPES))
def test_chunked_tile_loop_mirror(case, name, geometry):
    _, (q, k, v, lens), kw = _cpa_inputs(case, name)
    lens[-1] = max(int(lens[-1]) - 7, 1)      # ragged valid length
    got = mirror_chunked(*_cpa_strided(q, k, v), lens, tile_keys=geometry[0],
                         bq=geometry[1], **kw)
    want = TCPA.chunked_prefill_attention_ref(q, k, v, lens, **kw)
    valid = _cpa_valid(case, lens.numpy())
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(_np(got)[valid], _np(want)[valid],
                               **_tol(name))


def test_chunked_tile_loop_mirror_empty_rows_write_zeros():
    """A row of length 0 has an empty key range: the kernel writes 0 (the
    plain version's fully masked softmax is a mean of V instead; callers
    discard such rows)."""
    case = CPA_EXTRA[0]
    _, (q, k, v, _), kw = _cpa_inputs(case, "float32")
    lens = torch.tensor([0, 70], dtype=torch.int32)
    got = mirror_chunked(q, k, v, lens, tile_keys=64, bq=21, **kw)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    want = TCPA.chunked_prefill_attention_ref(q, k, v, lens, **kw)
    valid = _cpa_valid(case, lens.numpy())
    assert valid[1].any() and not valid[0].any()
    np.testing.assert_allclose(got.numpy()[valid], want.numpy()[valid],
                               atol=2e-5, rtol=2e-5)


def test_chunked_cpu_tensors_take_the_plain_version_and_count_nothing():
    _, (q, k, v, lens), kw = _cpa_inputs(CPA_CASES[1], "float32")
    assert torch.equal(CK.chunked_prefill_attention(q, k, v, lens, **kw),
                       TCPA.chunked_prefill_attention_ref(q, k, v, lens, **kw))
    assert CK.chunked_prefill_attention.launches == 0


class _OnCuda:
    """A CPU tensor that reports device 'cuda': stands in for a CUDA
    tensor on a machine without one."""

    device = torch.device("cuda")

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


def _cuda_operands():
    _, (q, k, v, lens), kw = _cpa_inputs(CPA_EXTRA[0], "float32")
    return [_OnCuda(x) for x in (q, k, v, lens)], kw


def test_chunked_cuda_tensor_without_library_raises(monkeypatch, tmp_path):
    """No nvcc: the build raises, and the wrapper raises with it."""
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "NVCC_DEFAULT", str(tmp_path / "no-nvcc"))
    monkeypatch.setenv("PATH", str(tmp_path))
    ops, kw = _cuda_operands()
    with pytest.raises(RuntimeError, match="nvcc"):
        CK.chunked_prefill_attention(*ops, **kw)
    assert CK.chunked_prefill_attention.launches == 0


def test_chunked_cuda_tensor_without_card_raises(monkeypatch):
    """A library but no card: allocating the output on the GPU raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the case without one")
    monkeypatch.setattr(build, "library", lambda name: object())
    ops, kw = _cuda_operands()
    with pytest.raises((AssertionError, RuntimeError)):
        CK.chunked_prefill_attention(*ops, **kw)
    assert CK.chunked_prefill_attention.launches == 0


def test_chunked_wrapper_checks_operands():
    q = torch.empty((2, 6, 8, 128), device="meta")
    k = torch.empty((2, 2, 32, 128), device="meta")
    ln = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        CK.chunked_prefill_attention(q, k, k, ln, scale=1.0)
    ops, kw = _cuda_operands()
    q, k, v, lens = ops
    with pytest.raises(ValueError, match="last axis"):
        CK.chunked_prefill_attention(
            _OnCuda(q._t.transpose(2, 3).contiguous().transpose(2, 3)), k, v,
            lens, **kw)
    with pytest.raises(ValueError, match="int32"):
        CK.chunked_prefill_attention(q, k, v, _OnCuda(lens._t.long()), **kw)


# ---------------------------------------------------------------------------
# split K and V pools (the TPU kernels paged_attention and
# paged_prefill_attention)
# ---------------------------------------------------------------------------
def _split(kv):
    """A fused pool's two planes as contiguous split pools: the same keys."""
    k, v = rc.split_fused(kv)
    return k.contiguous(), v.contiguous()


# GQA 4, window + softcap, and the llama3.2-3b head shape of each list
SPLIT_PA_CASES = [FUSED_PA_CASES[i] for i in (1, 5, 6)]
SPLIT_PPA_CASES = [FUSED_PPA_CASES[i] for i in (1, 5, 6)]


@pytest.mark.parametrize("case", SPLIT_PA_CASES)
@pytest.mark.parametrize("name", list(DTYPES))
def test_split_decode_plain_matches_jax_and_fused(case, name):
    (jq, jkv, jbt, jlens), (q, kv, bt, lens), kw = _decode_inputs(case, name)
    k, v = _split(kv)
    got = TPA.paged_attention_ref(q, k, v, bt, lens, **kw)
    want = JPA.paged_attention_ref(jq, jkv[:, :, 0], jkv[:, :, 1], jbt, jlens,
                                   **kw)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(name))
    assert torch.equal(got, TPA.paged_attention_fused_ref(q, kv, bt, lens,
                                                          **kw))
    assert torch.equal(PK.paged_attention(q, k, v, bt, lens, **kw), got)


@pytest.mark.parametrize("case", SPLIT_PPA_CASES)
@pytest.mark.parametrize("name", list(DTYPES))
def test_split_prefill_plain_matches_jax_and_fused(case, name):
    (jq, jkv, jbt, jpos, jlens), (q, kv, bt, pos, lens), kw, valid = \
        _prefill_inputs(case, name)
    k, v = _split(kv)
    got = TPPA.paged_prefill_attention_ref(q, k, v, bt, pos, lens, **kw)
    want = JPPA.paged_prefill_attention_ref(jq, jkv[:, :, 0], jkv[:, :, 1],
                                            jbt, jpos, jlens, **kw)
    np.testing.assert_allclose(_np(got)[valid], _np(want)[valid], **_tol(name))
    assert torch.equal(got, TPPA.paged_prefill_attention_fused_ref(
        q, kv, bt, pos, lens, **kw))
    assert torch.equal(PPK.paged_prefill_attention(q, k, v, bt, pos, lens,
                                                   **kw), got)


def test_split_wrappers_count_nothing_on_cpu_and_take_any_sq():
    """A chunk of 5 queries (the TPU kernel needs Sq % block_q == 0)."""
    case = (4, 5, 2, 3, 32, 16, 8, 3, 0, 0.0)
    _, (q, kv, bt, pos, lens), kw, _ = _prefill_inputs(case, "float32")
    k, v = _split(kv)
    out = PPK.paged_prefill_attention(q, k, v, bt, pos, lens, **kw)
    assert out.shape == q.shape
    assert PK.paged_attention.launches == 0
    assert PPK.paged_prefill_attention.launches == 0


def test_split_operand_checks():
    q = torch.zeros((2, 6, 32))
    k = torch.zeros((2, 4, 16, 32))
    with pytest.raises(ValueError, match="k_pages and v_pages"):
        PK.check_operands(q, (k, torch.zeros((2, 4, 16, 16))), {})
    with pytest.raises(TypeError, match="share a dtype"):
        PK.check_operands(q, (k, k.to(torch.bfloat16)), {})
    with pytest.raises(ValueError, match="v_pages must be contiguous"):
        PK.check_operands(q, (k, k.transpose(1, 2).contiguous()
                              .transpose(1, 2)), {})
    with pytest.raises(ValueError, match="kv_pages must be"):
        PK.check_operands(q, (k,), {})
    PK.check_operands(q, (k, k.clone()), {})


def _load_mirror(pools, bt_row, k0, nk, ps, D, elt):
    """PagedKV::load (one fused pool) or SplitPagedKV::load (two pools) of
    csrc/paged_common.cuh written out: the index arithmetic of every
    16-byte vector of the tile, over the kv head's flat pool(s)."""
    VN = 16 // elt
    dv = D // VN
    per_page = 2 * ps * dv
    p0 = k0 // ps
    k_s = torch.full((nk, D), float("nan"))
    v_s = torch.full((nk, D), float("nan"))
    for i in range((nk // ps) * per_page):
        pi, rem = divmod(i, per_page)
        row, c = divmod(rem, dv)
        page = int(bt_row[p0 + pi])
        if len(pools) == 1:
            src = pools[0][page * 2 * ps * D + row * D + c * VN:][:VN]
            is_v, key = row >= ps, row % ps
        else:
            is_v = row >= ps
            key = row - ps if is_v else row
            src = pools[1 if is_v else 0][page * ps * D + key * D
                                          + c * VN:][:VN]
        (v_s if is_v else k_s)[pi * ps + key, c * VN:(c + 1) * VN] = src
    return k_s, v_s


@pytest.mark.parametrize("elt", [2, 4])
@pytest.mark.parametrize("split", [False, True])
def test_kv_source_load_mirror(split, elt):
    """Tiles of two pages at k0 = 32 through a permuted block table: every
    element of the K and V tiles comes from the right key of the right
    page, from either pool layout."""
    P, ps, D = 6, 16, 32
    kv = torch.randn(P, 2, ps, D)
    bt = torch.tensor([5, 2, 0, 3, 1], dtype=torch.int32)
    pools = ((kv[:, 0].reshape(-1), kv[:, 1].reshape(-1)) if split
             else (kv.reshape(-1),))
    k_s, v_s = _load_mirror(pools, bt, 32, 2 * ps, ps, D, elt)
    assert torch.equal(k_s, kv[bt[2:4].long(), 0].reshape(-1, D))
    assert torch.equal(v_s, kv[bt[2:4].long(), 1].reshape(-1, D))


def test_signatures_match_the_c_launchers():
    """Every launch function build.SIGNATURES declares exists in its csrc
    source with as many parameters as it declares argument types (a
    missing ctypes argument would shift every later one)."""
    import re
    for lib, fns in build.SIGNATURES.items():
        src = (build.CSRC / f"{lib}.cu").read_text()
        for fn, argtypes in fns.items():
            m = re.search(r"\bint " + fn + r"\(([^)]*)\)", src)
            assert m, fn
            assert len(m.group(1).split(",")) == len(argtypes), fn
    assert set(build.SIGNATURES) == set(build.SOURCES)
