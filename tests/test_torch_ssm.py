"""PyTorch port, xLSTM mixers: the plain versions of the mLSTM chunkwise
kernel against the JAX oracle ``mlstm_ref`` and the interpret-mode Pallas
``mlstm_chunkwise`` (fresh state, the JAX test's shapes and tolerances:
5e-4 fp32, 5e-2 bf16); the port's ``mlstm_mix`` and ``slstm_mix`` against
the JAX ones over a sequence cut into chunks of 37, 1 and 90 tokens with
the state carried across (fp32; outputs and every state leaf); the row
subset a slot decode runs; and a torch mirror of the CUDA kernel's loop
(value tiles with private n/m, the head dim streamed in 32-column tiles,
ragged last chunks, S 1, fresh and carried states, state rows) against the
plain version. The CUDA kernel itself runs only on the GPU
(``chip_smoke.py`` holds it against the plain version there)."""
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
# torch mirror of the CUDA kernel's loop (csrc/mlstm_chunkwise.cu)
# ---------------------------------------------------------------------------
KCHUNK, KDK = MR.CHUNK, 32     # the kernel's chunk and head-dim stream tile


def _mirror_tile(q, k, v, li, lf, C_tile, n_priv, m_priv):
    """One block: (b, h) and one value tile, over q/k [S, D], v [S, DV]
    and the gates [S]; C_tile [D, DV], n_priv [D], m_priv: this tile's
    private state, walked over the chunks as the kernel does."""
    S, D = q.shape
    h = torch.zeros((S, v.shape[1]))
    for t0 in range(0, S, KCHUNK):
        L = min(KCHUNK, S - t0)
        b = lf[t0:t0 + L].clone()
        for t in range(1, L):                       # thread 0's serial sum
            b[t] = b[t] + b[t - 1]
        lis = li[t0:t0 + L]
        m_t = torch.empty(L)
        for t in range(L):
            e = b[t] - b[:t + 1] + lis[:t + 1]
            m_t[t] = torch.maximum(b[t] + m_priv, e.max())
        g = torch.exp(b + m_priv - m_t)
        scores = torch.zeros((KCHUNK, KCHUNK))
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


def mirror_mlstm_chunkwise(q, k, v, li, lf, C, n, m, *, rows, DV):
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


def _carried_state(Bs, H, D):
    C = _torch(RNG.normal(size=(Bs, H, D, D)) * 0.3)
    n = _torch(np.abs(RNG.normal(size=(Bs, H, D))))
    m = _torch(RNG.normal(size=(Bs, H)) * 2.0)
    return C, n, m


# (B, S, H, D, DV, state, rows): a ragged last chunk (150 = 64 + 64 + 22),
# decode (S 1), a chunk shorter than one, D of 1 and of 3 stream tiles,
# value tiles of 8/16/32 columns, state rows of a larger state
MIRROR_CASES = [
    (2, 150, 2, 64, 16, "carried", None),
    (2, 150, 2, 64, 32, "fresh", None),
    (3, 1, 2, 64, 32, "carried", [4, 0, 2]),
    (1, 37, 1, 32, 8, "fresh", None),
    (2, 70, 3, 96, 32, "carried", [1, 0]),
]


@pytest.mark.parametrize("case", MIRROR_CASES)
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
    got = mirror_mlstm_chunkwise(q, k, v, li, lf, C_mirror, n, m,
                                 rows=rows_t, DV=DV)
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
