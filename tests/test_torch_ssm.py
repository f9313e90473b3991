"""PyTorch port, xLSTM mixers: the plain versions of the mLSTM chunkwise
kernel against the JAX oracle ``mlstm_ref`` and the interpret-mode Pallas
``mlstm_chunkwise`` (fresh state, the JAX test's shapes and tolerances:
5e-4 fp32, 5e-2 bf16); the port's ``mlstm_mix`` and ``slstm_mix`` against
the JAX ones over a sequence cut into chunks of 37, 1 and 90 tokens with
the state carried across (fp32; outputs and every state leaf); the row
subset a slot decode runs; and a torch mirror of the CUDA kernels' design
(the streaming decode step with its row groups merged in a permuted order;
the bf16 chunk passes in chunks of 128 tokens: gates with the m chain
across chunks, chunk-start states in 64 x 128 tiles with k*w split into
bf16 hi and lo parts and n's column sums in the block's order, outputs
computed over the chunks and 128-column tiles in reverse order) against
the plain version, on ragged last chunks, S 1 with permuted state rows, D
32, 64 and 96; and a
mirror of the scalar chunk loop, which fp32 chunks still take (value
tiles with private n/m, the head dim streamed in 32-column tiles). The
CUDA kernels themselves run only on the GPU (``chip_smoke.py`` holds them
against the plain version there)."""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.mlstm_chunkwise.kernel import (  # noqa: E402
    mlstm_chunkwise as jax_mlstm_chunkwise)
from repro.kernels.mlstm_chunkwise.ref import mlstm_ref as jax_mlstm_ref  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.mlstm_chunkwise import kernel as MK  # noqa: E402
from repro_torch.kernels.mlstm_chunkwise import ref as MR  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.params import from_jax_numpy  # noqa: E402

RNG = np.random.default_rng(7)

# (B, H, S, D, chunk): tests/test_kernels.py ML_CASES
ML_CASES = [
    (1, 2, 64, 32, 32),
    (2, 3, 128, 32, 32),
    (2, 2, 128, 64, 64),
    (1, 4, 256, 32, 128),
]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# mixers against JAX in fp32: the two forms (quadratic over tile pairs in
# JAX, chunkwise here) sum in another order, so the limit is 1e-5 relative
# plus 1e-5 absolute for elements near zero
MIX_TOL = dict(rtol=1e-5, atol=1e-5)


def _torch(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


def _ml_inputs(case, name):
    B, H, S, D, _ = case
    jd, td = DTYPES[name]
    q = RNG.normal(size=(B, H, S, D))
    k = np.asarray(jnp.asarray(RNG.normal(size=(B, H, S, D)), jd)
                   / np.sqrt(D), np.float32)
    v = RNG.normal(size=(B, H, S, D))
    log_i = RNG.normal(size=(B, H, S)).astype(np.float32)
    log_f = np.asarray(jax.nn.log_sigmoid(
        jnp.asarray(RNG.normal(size=(B, H, S)) + 3.0, jnp.float32)))
    jax_in = [jnp.asarray(a, jd) for a in (q, k, v)] + \
        [jnp.asarray(log_i), jnp.asarray(log_f)]
    torch_in = [_torch(a, td) for a in (q, k, v)] + \
        [_torch(log_i), _torch(log_f)]
    return jax_in, torch_in


def _fresh(B, H, D):
    return (torch.zeros((B, H, D, D)), torch.zeros((B, H, D)),
            torch.full((B, H), MR.NEG_INF))


def _bshd(t):
    """[B, H, S, ...] -> a [B, S, H, ...] view (no copy)."""
    return t.transpose(1, 2)


@pytest.mark.parametrize("case", ML_CASES)
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_mlstm_plain_matches_jax(case, name):
    """Fresh state: the port's mlstm_ref and its chunkwise plain version
    against the JAX oracle and the interpret-mode Pallas kernel."""
    B, H, S, D, chunk = case
    (jq, jk, jv, jli, jlf), (q, k, v, li, lf) = _ml_inputs(case, name)
    want_ref = jax_mlstm_ref(jq, jk, jv, jli, jlf)
    want_kernel = jax_mlstm_chunkwise(jq, jk, jv, jli, jlf, chunk=chunk,
                                      interpret=True)
    tol = dict(atol=5e-2, rtol=5e-2) if name == "bfloat16" else \
        dict(atol=5e-4, rtol=5e-4)
    got_ref = MR.mlstm_ref(q, k, v, li, lf)
    C, n, m = _fresh(B, H, D)
    got, _, _ = MR.mlstm_chunkwise_ref(_bshd(q), _bshd(k), _bshd(v),
                                       _bshd(li), _bshd(lf), C, n, m)
    assert got.dtype == q.dtype and got.shape == (B, S, H, D)
    for want in (want_ref, want_kernel):
        np.testing.assert_allclose(_np(got_ref), _np(want), **tol)
        np.testing.assert_allclose(_np(_bshd(got)), _np(want), **tol)


# ---------------------------------------------------------------------------
# the mixers against JAX, chunk by chunk with the state carried
# ---------------------------------------------------------------------------
D_MODEL, HEADS, BATCH = 64, 4, 2
CHUNKS = (37, 1, 90)


def _params(init, key):
    jp = init(jax.random.PRNGKey(key), D_MODEL, HEADS, jnp.float32)
    return jp, from_jax_numpy(None, jax.tree.map(np.asarray, jp))


def _state_close(jstate, tstate, names):
    for name in names:
        np.testing.assert_allclose(_np(tstate[name]), _np(jstate[name]),
                                   err_msg=name, **MIX_TOL)


def _run_chunks(jmix, tmix, jp, tp, jstate, tstate, names):
    x = RNG.normal(size=(BATCH, sum(CHUNKS), D_MODEL)).astype(np.float32)
    t0 = 0
    for S in CHUNKS:
        xs = x[:, t0:t0 + S]
        t0 += S
        jout, jstate = jmix(jp, jnp.asarray(xs), jstate)
        tout, tstate = tmix(tp, _torch(xs), tstate)
        np.testing.assert_allclose(_np(tout), _np(jout), **MIX_TOL)
        _state_close(jstate, tstate, names)


def test_mlstm_mix_matches_jax_over_chunks():
    jp, tp = _params(JS.init_mlstm, 1)
    jstate = JS.init_mlstm_state(BATCH, D_MODEL, HEADS, jnp.float32)
    tstate = from_jax_numpy(None, jax.tree.map(np.asarray, jstate))
    _run_chunks(lambda p, x, s: JS.mlstm_mix(p, x, s, HEADS,
                                             block=min(256, x.shape[1])),
                lambda p, x, s: TS.mlstm_mix(p, x, s, HEADS),
                jp, tp, jstate, tstate, ("C", "n", "m", "conv"))


def test_slstm_mix_matches_jax_over_chunks():
    jp, tp = _params(JS.init_slstm, 2)
    jstate = JS.init_slstm_state(BATCH, D_MODEL, HEADS, jnp.float32)
    tstate = from_jax_numpy(None, jax.tree.map(np.asarray, jstate))
    _run_chunks(lambda p, x, s: JS.slstm_mix(p, x, s, HEADS),
                lambda p, x, s: TS.slstm_mix(p, x, s, HEADS),
                jp, tp, jstate, tstate, ("c", "n", "h", "m"))


@pytest.mark.parametrize("init,mix", [(JS.init_mlstm, TS.mlstm_mix),
                                      (JS.init_slstm, TS.slstm_mix)])
def test_mixer_without_state_starts_fresh(init, mix):
    """``state=None`` is the fresh state (JAX: None at sequence start)."""
    jp, tp = _params(init, 3)
    x = RNG.normal(size=(BATCH, 20, D_MODEL)).astype(np.float32)
    jmix = JS.mlstm_mix if mix is TS.mlstm_mix else JS.slstm_mix
    jout, _ = jmix(jp, jnp.asarray(x), None, HEADS)
    tout, state = mix(tp, _torch(x), None, HEADS)
    np.testing.assert_allclose(_np(tout), _np(jout), **MIX_TOL)
    assert all(t.shape[0] == BATCH for t in state.values())


@pytest.mark.parametrize("mix,init", [
    (TS.mlstm_mix, lambda: TS.init_mlstm_state(4, D_MODEL, HEADS,
                                               torch.float32)),
    (TS.slstm_mix, lambda: TS.init_slstm_state(4, D_MODEL, HEADS))])
def test_mixer_rows_update_only_their_state(mix, init):
    """A slot decode runs rows [3, 1] of a 4-row state: those rows advance
    as if run alone, rows 0 and 2 stay bit-identical."""
    jinit = JS.init_mlstm if mix is TS.mlstm_mix else JS.init_slstm
    _, tp = _params(jinit, 4)
    state = init()
    warm = _torch(RNG.normal(size=(4, 9, D_MODEL)))
    mix(tp, warm, state, HEADS)                    # a non-trivial state
    before = {k: v.clone() for k, v in state.items()}
    rows = torch.tensor([3, 1])
    x = _torch(RNG.normal(size=(2, 1, D_MODEL)))
    alone = {k: v[rows].clone() for k, v in before.items()}
    want, _ = mix(tp, x, alone, HEADS)
    got, _ = mix(tp, x, state, HEADS, rows=rows)
    assert torch.equal(got, want)
    for k in state:
        assert torch.equal(state[k][rows], alone[k]), k
        for r in (0, 2):
            assert torch.equal(state[k][r], before[k][r]), (k, r)


def test_conv_returns_the_last_inputs_as_state():
    x = _torch(RNG.normal(size=(2, 5, 8)))
    w = _torch(RNG.normal(size=(4, 8)))
    init = _torch(RNG.normal(size=(2, 3, 8)))
    y, new = TS._mamba_conv_full(x, w, torch.zeros(8), init)
    jy, jnew = JS._mamba_conv_full(jnp.asarray(_np(x)), jnp.asarray(_np(w)),
                                   jnp.zeros(8), jnp.asarray(_np(init)))
    np.testing.assert_allclose(_np(y), _np(jy), atol=1e-6, rtol=1e-6)
    assert torch.equal(new, x[:, 2:])
    np.testing.assert_array_equal(_np(new), _np(jnew))


# ---------------------------------------------------------------------------
# torch mirror of the CUDA kernels' design (csrc/mlstm_chunkwise.cu): the
# streaming decode step and the three bf16 chunk passes
# ---------------------------------------------------------------------------
KCHUNK = MR.CHUNK      # tokens per chunk of the bf16 passes
SHORT_CHUNK = MR.SHORT_CHUNK   # and up to MR.SHORT_S tokens
KTILE = 64             # rows of C a state block
KSTATE_N = 128         # columns of C a state block
KOUT_N = 128           # columns of h an output block
NO_WEIGHT = -3.402823466e38   # a token past S: exp(NO_WEIGHT - m') = 0
DEC_COLS = 32          # C columns a decode block
DEC_ROW_GROUPS = 32    # its row groups (256 threads, float4 columns)
# the split's relative error on a product with a bf16 operand (the source's
# note): |x - (hi + lo)| <= 2^-8 |x - hi| <= 2^-16 |x|
SPLIT_REL = 2.0 ** -16


def _hi_lo(x):
    """x = hi + lo, hi = bf16(x), lo = bf16(x - hi)."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def _split_mm(a, b):
    """a @ b with a fp32 split into hi and lo bf16 parts and b exact in
    bf16: two products into one fp32 accumulator, as two wgmma."""
    hi, lo = _hi_lo(a)
    return hi.float() @ b + lo.float() @ b


def mirror_gate_pass(q, k, li, lf, c, LC):
    """Pass a for one (row, head) and chunk c of LC tokens (all chunks in
    parallel): q, k [S, D] (bf16 values), li, lf [S]. Returns the chunk's
    per-token b
    (one thread's serial sum), log_i, row max x over the chunk and carry
    exponent a = b_last - b + log_i (zero, zero, zero and NO_WEIGHT past
    S), its (b_last, row max) at the last token, and its raw scores Q K^T
    [LC, LC] (exact products, fp32 sums; zero rows and columns past S,
    whose boxes the copy fills with zeros)."""
    S = q.shape[0]
    t0, L = c * LC, min(LC, S - c * LC)
    b, lic, x = torch.zeros(LC), torch.zeros(LC), torch.zeros(LC)
    a = torch.full((LC,), NO_WEIGHT)
    b[:L], lic[:L] = lf[t0:t0 + L], li[t0:t0 + L]
    for u in range(1, L):
        b[u] = b[u] + b[u - 1]
    for u in range(L):
        x[u] = ((b[u] - b[:u + 1]) + lic[:u + 1]).max()
    a[:L] = (b[L - 1] - b[:L]) + lic[:L]
    scores = torch.zeros((LC, LC))
    scores[:L, :L] = q[t0:t0 + L] @ k[t0:t0 + L].T
    return {"b": b, "li": lic, "x": x, "a": a}, (b[L - 1], x[L - 1]), scores


def m_chain(last, m):
    """The scalar m chain from each chunk's (b_last, row max): the m carried
    into each chunk, then the final m (as each state and output block
    computes it)."""
    out = []
    for b_last, x_last in last:
        out.append(m)
        m = torch.maximum(b_last + m, x_last)
    return out + [m]


def _colsum(kw):
    """The transform warps' column sums of k*w [LC, 64] (n's update) in
    their order: a warp a piece of 8 rows, each lane sums its tokens (lane
    + 32u), then the warp's 32 lanes in a tree (shuffles)."""
    part = torch.zeros((32, kw.shape[1]))
    for u in range(kw.shape[0] // 32):
        part = part + kw[32 * u:32 * (u + 1)]           # [lane, rows]
    while part.shape[0] > 1:
        part = part[0::2] + part[1::2]
    return part[0]


def mirror_state_pass(k, v, gate, last, m0, C0, n0, LC):
    """Pass b for one (row, head) in chunks of LC: k, v [S, D] (bf16
    values), C0 [D, D], n0 [D]. Each 64 x KSTATE_N tile of C computes the m chain, then walks
    the chunks in order in fp32: writes the chunk's starting C as hi/lo
    planes (and n, from the column-0 tiles), then C <- decay * C + P with P
    = (k w)^T V, k w split, w = exp(a - m'). Returns (C planes [nc, 2, D,
    D] bf16, n starts [nc, D], C', n', m')."""
    S, D = k.shape
    nc = len(last)
    ms = m_chain(last, m0)
    planes = torch.zeros((nc, 2, D, D), dtype=torch.bfloat16)
    n_starts = torch.zeros((nc, D))
    C1, n1 = torch.zeros((D, D)), torch.zeros(D)
    for i0 in range(0, D, KTILE):
        rows = slice(i0, min(i0 + KTILE, D))
        R = rows.stop - i0
        for j0 in range(0, D, KSTATE_N):
            cols = slice(j0, min(j0 + KSTATE_N, D))
            acc = C0[rows, cols].clone()
            nacc = n0[rows].clone()
            for c in range(nc):
                t0 = c * LC
                L = min(LC, S - t0)
                w = torch.exp(gate[c]["a"] - ms[c + 1])     # 0 past S
                decay = torch.exp(last[c][0] + ms[c] - ms[c + 1])
                hi, lo = _hi_lo(acc)
                planes[c, 0, rows, cols], planes[c, 1, rows, cols] = hi, lo
                kt = torch.zeros((LC, KTILE))
                kt[:L, :R] = k[t0:t0 + L, rows]
                kw = kt * w[:, None]
                vt = torch.zeros((LC, cols.stop - j0))
                vt[:L] = v[t0:t0 + L, cols]
                acc = acc * decay + _split_mm(kw.T, vt)[:R]
                if j0 == 0:
                    n_starts[c, rows] = nacc
                    nacc = nacc * decay + _colsum(kw)[:R]
            C1[rows, cols] = acc
            if j0 == 0:
                n1[rows] = nacc
    return planes, n_starts, C1, n1, ms[nc]


def mirror_output_pass(q, v, gate, last, m0, scores, planes, n_starts, c,
                       LC):
    """Pass c for one (row, head) and chunk c of LC tokens, each
    KOUT_N-column tile of h on its own (in any order): the m chain up to
    the chunk, the gate pass's raw scores decayed and masked, split into
    hi/lo parts; then h = (g * Q C_c + S V) / den, Q C_c over C_c's hi and
    lo planes. Returns h of the chunk's tokens [L, D] in fp32."""
    S, D = q.shape
    t0 = c * LC
    L = min(LC, S - t0)
    qc, vc = q[t0:t0 + L], v[t0:t0 + L]
    m_c = m_chain(last[:c], m0)[c]
    b, li, x = (gate[c][f][:L] for f in ("b", "li", "x"))
    inter = b + m_c
    m = torch.maximum(inter, x)
    g = torch.exp(inter - m)
    e = (b[:, None] - b[None, :]) + li[None, :] - m[:, None]
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool))
    s = torch.where(tri, scores[:L, :L] * torch.exp(e), torch.zeros(()))
    nrm = g * (qc @ n_starts[c]) + s.sum(-1)
    den = torch.clamp(torch.maximum(nrm.abs(), torch.exp(
        -torch.clamp(m, max=30.0))), min=1e-30)
    s_hi, s_lo = _hi_lo(s)
    h = torch.zeros((L, D))
    for j0 in reversed(range(0, D, KOUT_N)):
        cols = slice(j0, min(j0 + KOUT_N, D))
        acc = qc @ planes[c, 0, :, cols].float() + \
            qc @ planes[c, 1, :, cols].float()
        acc = g[:, None] * acc + (s_hi.float() @ vc[:, cols]
                                  + s_lo.float() @ vc[:, cols])
        h[:, cols] = acc / den[:, None]
    return h


def mirror_decode(q, k, v, li, lf, C, n, m, perm):
    """The decode kernel for one (row, head), S = 1: q, k, v [D]; C [D, D]
    updated in place. Each block of DEC_COLS columns sums its row groups'
    partial q.C in the order ``perm`` (any order is the same sum up to
    rounding). Returns (h [D], n', m')."""
    D = q.shape[0]
    inter = lf + m
    m_new = torch.maximum(inter, li)
    g = torch.exp(inter - m_new)
    s = (q @ k) * torch.exp(li - m_new)
    w = torch.exp(li - m_new)
    den = torch.clamp(torch.maximum((g * (q @ n) + s).abs(),
                                    torch.exp(-torch.clamp(m_new, max=30.0))),
                      min=1e-30)
    kw = k * w
    h = torch.zeros(D)
    for j0 in range(0, D, DEC_COLS):
        cols = slice(j0, j0 + DEC_COLS)
        parts = [q[r::DEC_ROW_GROUPS] @ C[r::DEC_ROW_GROUPS, cols]
                 for r in range(DEC_ROW_GROUPS)]
        qc = sum(parts[r] for r in perm)
        h[cols] = (g * qc + s * v[cols]) / den
        C[:, cols] = g * C[:, cols] + kw[:, None] * v[None, cols]
    return h, g * n + kw, m_new


def mirror_mlstm_chunkwise(q, k, v, li, lf, C, n, m, *, rows):
    """The launcher: S = 1 takes the decode kernel (row groups merged in a
    permuted order), S > 1 the bf16 passes (gates and scores per chunk,
    the state walk, outputs computed over the chunks and column tiles in
    reverse order). Updates C in place at the state rows; returns (h, n',
    m') and, per (b, h), the state pass's chunk planes, n starts and the m
    carried into each chunk."""
    B, S, H, D = q.shape
    h = torch.zeros((B, S, H, D))
    n_out, m_out = torch.zeros((B, H, D)), torch.zeros((B, H))
    starts = {}
    perm = list(np.random.default_rng(3).permutation(DEC_ROW_GROUPS))
    for bb in range(B):
        sb = bb if rows is None else int(rows[bb])
        for hh in range(H):
            qs, ks, vs = (t[bb, :, hh].float() for t in (q, k, v))
            if S == 1:
                h[bb, 0, hh], n_out[bb, hh], m_out[bb, hh] = mirror_decode(
                    qs[0], ks[0], vs[0], li[bb, 0, hh], lf[bb, 0, hh],
                    C[sb, hh], n[sb, hh], m[sb, hh], perm)
                continue
            LC = MR.chunk_length(torch.bfloat16, S)
            nc = -(-S // LC)
            gate, last, scores = zip(*[mirror_gate_pass(
                qs, ks, li[bb, :, hh], lf[bb, :, hh], c, LC)
                for c in range(nc)])
            planes, n_starts, C1, n_out[bb, hh], m_out[bb, hh] = \
                mirror_state_pass(ks, vs, gate, last, m[sb, hh], C[sb, hh],
                                  n[sb, hh], LC)
            C[sb, hh] = C1
            starts[bb, hh] = (planes, n_starts,
                              m_chain(last, m[sb, hh])[:nc])
            for c in reversed(range(nc)):
                t0 = c * LC
                h[bb, t0:t0 + LC, hh] = mirror_output_pass(
                    qs, vs, gate, last, m[sb, hh], scores[c], planes,
                    n_starts, c, LC)
    return (h, n_out, m_out), starts


def _within_state_limits(got, want, name):
    """The state's limits of chip_smoke.py: C and n 1e-5 + 1e-4 |ref|, m
    1e-3 + 1e-5 |m|."""
    lim = (1e-3 + 1e-5 * want.abs()) if name == "m" else \
        (1e-5 + 1e-4 * want.abs())
    assert bool(((got - want).abs() <= lim).all()), (name, float(
        (got - want).abs().max()))


def _carried_state(Bs, H, D):
    C = _torch(RNG.normal(size=(Bs, H, D, D)) * 0.3)
    n = _torch(np.abs(RNG.normal(size=(Bs, H, D))))
    m = _torch(RNG.normal(size=(Bs, H)) * 2.0)
    return C, n, m


# (B, S, H, D, state, rows): chunks of 128 past 512 tokens with a ragged
# last one (1100 = 8 x 128 + 76), chunks of 64 up to 512 tokens (300 = 4
# x 64 + 44; 150 = 64 + 64 + 22; 70; four whole chunks at 256; a chunk
# shorter than one, 37), decode (S 1) of permuted state rows of a larger
# state; D 32 and 64 (one row tile, part of a 128-column tile) and D 96 (a
# row tile and a column box cut inside a 64-column swizzle atom)
MIRROR_CASES = [
    (1, 1100, 1, 32, "carried", None),
    (2, 300, 2, 64, "carried", None),
    (2, 150, 2, 64, "fresh", None),
    (3, 1, 2, 64, "carried", [4, 0, 2]),
    (1, 37, 1, 32, "fresh", None),
    (2, 70, 3, 96, "carried", [1, 0]),
    (1, 256, 2, 96, "carried", None),
    (4, 1, 2, 96, "carried", [5, 3, 0, 1]),
]


@pytest.mark.parametrize("case", MIRROR_CASES)
def test_kernel_design_mirror_matches_plain(case):
    """The mirror of the decode kernel and of the three bf16 passes against
    the plain version (in the kernel's chunks), on bf16 values: h within
    the split's error (1e-4 relative to the row's scale), the state within
    chip_smoke.py's state limits, rows outside ``rows`` untouched."""
    B, S, H, D, start, rows = case
    Bs = B if rows is None else max(rows) + 1
    bf = torch.bfloat16
    q = _torch(RNG.normal(size=(B, S, H, D)), bf).float()
    k = (_torch(RNG.normal(size=(B, S, H, D))) / math.sqrt(D)).to(bf).float()
    v = _torch(RNG.normal(size=(B, S, H, D)), bf).float()
    li = _torch(RNG.normal(size=(B, S, H)))
    lf = torch.nn.functional.logsigmoid(
        _torch(RNG.normal(size=(B, S, H)) + 3.0))
    C, n, m = _fresh(Bs, H, D) if start == "fresh" else \
        _carried_state(Bs, H, D)
    rows_t = None if rows is None else torch.tensor(rows)
    C_plain, C_mirror = C.clone(), C.clone()
    want = MR.mlstm_chunkwise_ref(q, k, v, li, lf, C_plain, n, m, rows=rows_t,
                                  chunk=MR.chunk_length(torch.bfloat16, S))
    got, starts = mirror_mlstm_chunkwise(q, k, v, li, lf, C_mirror, n, m,
                                         rows=rows_t)
    scale = want[0].abs().amax(-1, keepdim=True)
    assert bool(((got[0] - want[0]).abs() <= 1e-4 * scale + 1e-6).all()), \
        float((got[0] - want[0]).abs().max())
    _within_state_limits(got[1], want[1], "n")
    _within_state_limits(got[2], want[2], "m")
    idx = list(range(B)) if rows is None else rows
    _within_state_limits(C_mirror[idx], C_plain[idx], "C")
    others = [r for r in range(Bs) if r not in idx]
    assert torch.equal(C_mirror[others], C[others])
    assert torch.equal(C_plain[others], C[others])
    assert (S == 1) == (not starts)


@pytest.mark.parametrize("case", [c for c in MIRROR_CASES if c[1] > 1])
def test_state_pass_writes_each_chunks_starting_state(case):
    """The gate pass's m chain and the state pass's chunk-start planes are
    the plain version's state after the tokens before each chunk."""
    B, S, H, D, start, rows = case
    bf = torch.bfloat16
    q, k, v = (_torch(RNG.normal(size=(1, S, H, D)), bf).float()
               for _ in range(3))
    k = k / 8
    li = _torch(RNG.normal(size=(1, S, H)))
    lf = torch.nn.functional.logsigmoid(
        _torch(RNG.normal(size=(1, S, H)) + 3.0))
    C, n, m = _fresh(1, H, D) if start == "fresh" else \
        _carried_state(1, H, D)
    _, starts = mirror_mlstm_chunkwise(q, k, v, li, lf, C.clone(), n, m,
                                       rows=None)
    for hh in range(H):
        planes, n_starts, m_c = starts[0, hh]
        LC = MR.chunk_length(torch.bfloat16, S)
        for c in range(planes.shape[0]):
            t0 = c * LC
            Cp = C.clone()
            if t0:
                _, n_p, m_p = MR.mlstm_chunkwise_ref(
                    q[:, :t0], k[:, :t0], v[:, :t0], li[:, :t0], lf[:, :t0],
                    Cp, n, m, chunk=LC)
            else:
                n_p, m_p = n, m
            c_start = planes[c, 0].float() + planes[c, 1].float()
            _within_state_limits(c_start, Cp[0, hh], "C")
            _within_state_limits(n_starts[c], n_p[0, hh], "n")
            _within_state_limits(m_c[c].reshape(1), m_p[0, hh].reshape(1), "m")


@pytest.mark.parametrize("what", ["product", "column sums"])
def test_hi_lo_split_times_bf16_is_the_fp32_product(what):
    """hi = bf16(x), lo = bf16(x - hi): hi*b + lo*b (both products exact in
    fp32) is x*b within 2^-16 relative, the error the source states; bf16
    alone is off by up to 2^-8. And the state block's column sums of k*w
    (n's update, fp32 in its thread order) are the plain sum over the
    chunk's tokens within fp32 rounding."""
    if what == "column sums":
        kw = _torch(RNG.normal(size=(KCHUNK, KTILE)))
        want = kw.double().sum(0)
        got = _colsum(kw).double()
        assert float(((got - want).abs() / kw.double().abs().sum(0))
                     .max()) <= 8 * 2.0 ** -24
        return
    x = _torch(RNG.normal(size=4096) * np.exp(RNG.normal(size=4096) * 3))
    b = _torch(RNG.normal(size=4096), torch.bfloat16).float()
    hi, lo = _hi_lo(x)
    want = x.double() * b.double()
    got = hi.double() * b.double() + lo.double() * b.double()
    rel = ((got - want).abs() / want.abs()).max()
    assert float(rel) <= SPLIT_REL
    assert float(((hi.double() * b.double() - want).abs()
                  / want.abs()).max()) > 2.0 ** -10
    # and through an fp32 accumulator, as the tensor cores sum
    acc = (hi.float() * b + lo.float() * b)
    assert float(((acc.double() - want).abs() / want.abs()).max()) <= \
        SPLIT_REL + 2.0 ** -23


def test_mirror_sizes_follow_the_source():
    """The mirror's chunk lengths, tile and decode-block sizes are the
    source's (the passes' chunk and the plain version's CHUNK alike), and
    the source states the split's error the mirror holds it to."""
    import re
    src = (build.CSRC / "mlstm_chunkwise.cu").read_text()

    def const(name):
        m = re.search(r"constexpr int " + name + r" = ([^;]+);", src)
        assert m, name
        return m.group(1).split("//")[0].strip()
    assert int(const("kChunk")) == KCHUNK
    assert int(const("kShortChunk")) == SHORT_CHUNK
    assert int(const("kShortS")) == MR.SHORT_S
    assert "#define MLSTM_CHUNK 0" in src    # the chunk chosen by S
    assert int(const("kLoopChunk")) == LOOP_KCHUNK == MR.LOOP_CHUNK
    assert int(const("kStateN")) == KSTATE_N
    assert const("kStateWG") == "kStateN / 64"
    assert int(const("kOutN")) == KOUT_N
    assert "blockIdx.y * 64" in src and KTILE == 64   # a state block's rows
    assert "constexpr int U = LC / 32;" in src       # _colsum's lanes
    assert float(re.search(r"constexpr float kNoWeight = ([-.0-9e]+)f;",
                           src).group(1)) == NO_WEIGHT
    assert int(const("kDK")) == KDK          # the fp32 loop's stream tile
    assert int(const("kDecCols")) == DEC_COLS
    assert const("kDecRowGroups") == "kDecThreads / kDecGroups"
    assert int(const("kDecThreads")) // (DEC_COLS // 4) == DEC_ROW_GROUPS
    assert const("kDecGroups") == "kDecCols / 4"
    assert "about 2^-16" in src
    # the token fields of the gate scratch, in the mirror's order
    assert "enum TokenField { kB = 0, kLi = 1, kX = 2, kA = 3" in src

# ---------------------------------------------------------------------------
# torch mirror of the scalar chunk loop (csrc/mlstm_chunkwise.cu, path 3),
# which fp32 chunks still take
# ---------------------------------------------------------------------------
KDK = 32     # the loop's head-dim stream tile
LOOP_KCHUNK = MR.LOOP_CHUNK   # the loop's tokens per chunk


def _mirror_tile(q, k, v, li, lf, C_tile, n_priv, m_priv):
    """One block: (b, h) and one value tile, over q/k [S, D], v [S, DV]
    and the gates [S]; C_tile [D, DV], n_priv [D], m_priv: this tile's
    private state, walked over the chunks as the kernel does."""
    S, D = q.shape
    h = torch.zeros((S, v.shape[1]))
    for t0 in range(0, S, LOOP_KCHUNK):
        L = min(LOOP_KCHUNK, S - t0)
        b = lf[t0:t0 + L].clone()
        for t in range(1, L):                       # thread 0's serial sum
            b[t] = b[t] + b[t - 1]
        lis = li[t0:t0 + L]
        m_t = torch.empty(L)
        for t in range(L):
            e = b[t] - b[:t + 1] + lis[:t + 1]
            m_t[t] = torch.maximum(b[t] + m_priv, e.max())
        g = torch.exp(b + m_priv - m_t)
        scores = torch.zeros((LOOP_KCHUNK, LOOP_KCHUNK))
        acc = torch.zeros((L, v.shape[1]))
        qn = torch.zeros(L)
        for d0 in range(0, D, KDK):                 # q and k stream tiles
            qt = q[t0:t0 + L, d0:d0 + KDK]
            kt = k[t0:t0 + L, d0:d0 + KDK]
            scores[:L, :L] += qt @ kt.T
            acc += qt @ C_tile[d0:d0 + KDK]
            qn += qt @ n_priv[d0:d0 + KDK]
        tri = torch.tril(torch.ones((L, L), dtype=torch.bool))
        dec = torch.exp(b[:, None] - b[None, :] + lis[None, :] - m_t[:, None])
        sc = torch.where(tri, scores[:L, :L] * dec, torch.zeros(()))
        nrm = g * qn + sc.sum(-1)
        a = g[:, None] * acc + sc @ v[t0:t0 + L]
        den = torch.clamp(torch.maximum(nrm.abs(), torch.exp(
            -torch.clamp(m_t, max=30.0))), min=1e-30)
        h[t0:t0 + L] = a / den[:, None]
        m_new = m_t[L - 1]
        decay = torch.exp(b[L - 1] + m_priv - m_new)
        w = torch.exp(b[L - 1] - b + lis - m_new)
        for d0 in range(0, D, KDK):
            kt = k[t0:t0 + L, d0:d0 + KDK] * w[:, None]
            C_tile[d0:d0 + KDK] = decay * C_tile[d0:d0 + KDK] + \
                kt.T @ v[t0:t0 + L]
            n_priv[d0:d0 + KDK] = decay * n_priv[d0:d0 + KDK] + kt.sum(0)
        m_priv = m_new
    return h, n_priv, m_priv


def mirror_loop_kernel(q, k, v, li, lf, C, n, m, *, rows, DV):
    """The kernel's grid: a block per (b, h, value tile of DV columns),
    each with a private copy of its head's n and m; C's columns are
    updated in place, tile 0 alone writes the new n and m."""
    B, S, H, D = q.shape
    h = torch.zeros((B, S, H, D), dtype=q.dtype)
    n_out = torch.full((B, H, D), float("nan"))
    m_out = torch.full((B, H), float("nan"))
    for b in range(B):
        sb = b if rows is None else int(rows[b])
        for hh in range(H):
            privates = []
            for jt in range(D // DV):
                cols = slice(jt * DV, (jt + 1) * DV)
                tile = C[sb, hh, :, cols].clone()
                ht, n_p, m_p = _mirror_tile(
                    q[b, :, hh].float(), k[b, :, hh].float(),
                    v[b, :, hh, cols].float(), li[b, :, hh], lf[b, :, hh],
                    tile, n[sb, hh].clone(), m[sb, hh].clone())
                h[b, :, hh, cols] = ht.to(q.dtype)
                C[sb, hh, :, cols] = tile
                privates.append((n_p, m_p))
                if jt == 0:
                    n_out[b, hh], m_out[b, hh] = n_p, m_p
            # every tile carried the same private n and m
            for n_p, m_p in privates[1:]:
                assert torch.equal(n_p, privates[0][0])
                assert torch.equal(m_p, privates[0][1])
    return h, n_out, m_out


# (B, S, H, D, DV, state, rows): a ragged last chunk (150 = 64 + 64 + 22),
# decode (S 1), a chunk shorter than one, D of 1 and of 3 stream tiles,
# value tiles of 8/16/32 columns, state rows of a larger state
LOOP_MIRROR_CASES = [
    (2, 150, 2, 64, 16, "carried", None),
    (2, 150, 2, 64, 32, "fresh", None),
    (3, 1, 2, 64, 32, "carried", [4, 0, 2]),
    (1, 37, 1, 32, 8, "fresh", None),
    (2, 70, 3, 96, 32, "carried", [1, 0]),
]


@pytest.mark.parametrize("case", LOOP_MIRROR_CASES)
def test_kernel_loop_mirror_matches_plain(case):
    B, S, H, D, DV, start, rows = case
    Bs = B if rows is None else max(rows) + 1
    q = _torch(RNG.normal(size=(B, S, H, D)))
    k = _torch(RNG.normal(size=(B, S, H, D)) / math.sqrt(D))
    v = _torch(RNG.normal(size=(B, S, H, D)))
    li = _torch(RNG.normal(size=(B, S, H)))
    lf = torch.nn.functional.logsigmoid(
        _torch(RNG.normal(size=(B, S, H)) + 3.0))
    C, n, m = _fresh(Bs, H, D) if start == "fresh" else \
        _carried_state(Bs, H, D)
    rows_t = None if rows is None else torch.tensor(rows)
    C_plain, C_mirror = C.clone(), C.clone()
    want = MR.mlstm_chunkwise_ref(q, k, v, li, lf, C_plain, n, m, rows=rows_t)
    got = mirror_loop_kernel(q, k, v, li, lf, C_mirror, n, m, rows=rows_t,
                             DV=DV)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_np(C_mirror), _np(C_plain), atol=2e-5,
                               rtol=2e-5)
    # the new state can carry into the next call (the kernel's layout)
    assert want[1].is_contiguous() and want[2].is_contiguous()
    if rows is not None:     # state rows not named stay as they were
        others = [r for r in range(Bs) if r not in rows]
        assert torch.equal(C_plain[others], C[others])
        assert torch.equal(C_mirror[others], C[others])


def test_chunkwise_carries_across_calls():
    """Two calls with the state carried give one call's h and state: the
    engine's chunks of a prompt equal the whole prompt at once (gates as
    in the other cases: forget logits around +3)."""
    B, S, H, D = 1, 100, 2, 32
    q, k, v = (_torch(RNG.normal(size=(B, S, H, D))) for _ in range(3))
    li = _torch(RNG.normal(size=(B, S, H)))
    lf = torch.nn.functional.logsigmoid(
        _torch(RNG.normal(size=(B, S, H)) + 3.0))
    C, n, m = _fresh(B, H, D)
    h_all, n_all, m_all = MR.mlstm_chunkwise_ref(q, k, v, li, lf, C.clone(),
                                                 n, m)
    C2 = C.clone()
    h1, n1, m1 = MR.mlstm_chunkwise_ref(q[:, :30], k[:, :30], v[:, :30],
                                        li[:, :30], lf[:, :30], C2, n, m)
    h2, n2, m2 = MR.mlstm_chunkwise_ref(q[:, 30:], k[:, 30:], v[:, 30:],
                                        li[:, 30:], lf[:, 30:], C2, n1, m1)
    np.testing.assert_allclose(_np(torch.cat([h1, h2], 1)), _np(h_all),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_np(n2), _np(n_all), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_np(m2), _np(m_all), atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------
def _operands(B=2, S=5, H=2, D=32):
    q = _torch(RNG.normal(size=(B, S, H, D)))
    gates = _torch(RNG.normal(size=(B, S, 2 * H)))
    return [q, q.clone(), q.clone(), gates[..., :H],
            torch.nn.functional.logsigmoid(gates[..., H:]), *_fresh(B, H, D)]


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    ops = _operands()
    C_ref = ops[5].clone()
    got = MK.mlstm_chunkwise(*ops)
    want = MR.mlstm_chunkwise_ref(*ops[:5], C_ref, *ops[6:])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(ops[5], C_ref)
    assert MK.mlstm_chunkwise.launches == 0


class _OnCuda:
    """A CPU tensor that reports device 'cuda': stands in for a CUDA
    tensor on a machine without one."""

    device = torch.device("cuda")

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


def test_cuda_tensor_without_library_raises(monkeypatch, tmp_path):
    """No nvcc: the build raises, and the wrapper raises with it."""
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "NVCC_DEFAULT", str(tmp_path / "no-nvcc"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        MK.mlstm_chunkwise(*[_OnCuda(t) for t in _operands()])
    assert MK.mlstm_chunkwise.launches == 0


def test_cuda_tensor_without_card_raises(monkeypatch):
    """A library but no card: allocating the outputs on the GPU raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the case without one")
    monkeypatch.setattr(build, "library", lambda name: object())
    with pytest.raises((AssertionError, RuntimeError)):
        MK.mlstm_chunkwise(*[_OnCuda(t) for t in _operands()])
    assert MK.mlstm_chunkwise.launches == 0


def test_wrapper_checks_operands():
    def call(ops, **kw):
        MK.mlstm_chunkwise(*[_OnCuda(t) for t in ops], **kw)

    ops = _operands()
    with pytest.raises(ValueError, match="multiple of 32"):
        call(_operands(D=48))
    with pytest.raises(ValueError, match="last axis"):
        call([ops[0].transpose(2, 3).contiguous().transpose(2, 3)] + ops[1:])
    with pytest.raises(TypeError):
        call([ops[0].to(torch.float16)] + ops[1:])
    with pytest.raises(ValueError, match="log_f"):
        call(ops[:4] + [ops[4].double()] + ops[5:])
    with pytest.raises(ValueError, match="state rows"):
        call(ops[:5] + [o[:1] for o in ops[5:]])
    with pytest.raises(ValueError, match="rows"):
        call(ops, rows=_OnCuda(torch.tensor([0, 1, 2])))
    with pytest.raises(ValueError, match="contiguous"):
        call(ops[:5] + [ops[5].transpose(2, 3)] + ops[6:])


def test_timeline_tool_stamps_apply_to_the_source():
    """tools/mlstm_timeline.py stamps the state and output passes by text
    substitution: each anchor is once in its pass, and the stamped source
    differs from the source only by the added lines."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "tools" / "mlstm_timeline.py"
    spec = importlib.util.spec_from_file_location("mlstm_timeline", path)
    tl = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tl)
    src = (build.CSRC / "mlstm_chunkwise.cu").read_text()
    stamped = tl.stamped_source(src)
    added = [ln for ln in stamped.splitlines() if ln not in src.splitlines()]
    assert len(stamped.splitlines()) == len(src.splitlines()) + len(added)
    assert all("STAMP(" in ln or "t_start = clock64()" in ln
               or "float* trace = " in ln for ln in added), added
    assert sum("STAMP(" in ln and not ln.startswith("#define")
               for ln in added) >= len(tl.STATE_STAMPS) + len(tl.OUT_STAMPS) - 2


def test_variants_tool_cuts_apply_to_the_source():
    """tools/mlstm_variants.py cuts the passes with -DMLSTM_CUT and the
    scalar chunk loop (the fp32 chunks' path, and the bf16 path of sources
    before the passes) by text substitutions: each anchor is in the loop
    exactly once."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "tools" / "mlstm_variants.py"
    spec = importlib.util.spec_from_file_location("mlstm_variants", path)
    mv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mv)
    src = (build.CSRC / "mlstm_chunkwise.cu").read_text()
    assert "#ifndef MLSTM_CUT" in src
    assert mv.variant_source(src, "no loads") == (src, ["-DMLSTM_CUT=1"])
    assert mv.variant_source(src, "no compute") == (src, ["-DMLSTM_CUT=2"])
    loop = src[src.index("mlstm_chunkwise_kernel(const T*"):]
    for cut in mv.LOOP_CUTS.values():
        for old in cut:
            assert src.count(old) == 1 and old in loop, old
