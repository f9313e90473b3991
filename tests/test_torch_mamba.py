"""PyTorch port, Mamba mixer: the plain version of the selective-scan kernel
against the JAX oracle ``mamba_scan_ref`` and the interpret-mode Pallas
``mamba_scan`` (zero state, the JAX test's shapes and tolerances: 2e-5
fp32, 5e-2 bf16); the port's ``mamba_mix`` against the JAX one over a
sequence cut into chunks of 37, 1 and 90 tokens with the state carried
across (fp32, 1e-5; outputs and both state leaves); the row subset a slot
decode runs, the other rows bit-identical; and a torch mirror of the two
CUDA kernels (lanes a channel with each lane's part of y summed in an xor
tree, channel blocks, time tiles staged with a ragged last tile, the chunk
kernel's exp2, its multiply-add update and its polynomial 2^v on a share
of the states, the decode kernel's rows) against the plain version. The
CUDA kernels themselves run only on the GPU (``chip_smoke.py`` holds them
against the plain version there)."""
import math
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.mamba_scan.kernel import (  # noqa: E402
    mamba_scan as jax_mamba_scan)
from repro.kernels.mamba_scan.ref import (  # noqa: E402
    mamba_scan_ref as jax_mamba_scan_ref)
from repro.models import ssm as JS  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.mamba_scan import kernel as MK  # noqa: E402
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.params import from_jax_numpy  # noqa: E402

RNG = np.random.default_rng(11)

# (B, S, d_inner, n, chunk, d_tile): tests/test_kernels.py MS_CASES
MS_CASES = [
    (1, 64, 32, 8, 32, 32),
    (2, 128, 64, 8, 32, 32),
    (2, 256, 128, 16, 64, 64),
]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# mamba_mix against JAX in fp32: the same recurrence, y's sum over the
# state in another order
MIX_TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


def _scan_inputs(B, S, d, n, rng):
    """The JAX test's distributions: dt = |N(0,1)| * 0.1, A = -exp(N)."""
    return (rng.normal(size=(B, S, d)), np.abs(rng.normal(size=(B, S, d))) * 0.1,
            rng.normal(size=(B, S, n)), rng.normal(size=(B, S, n)),
            -np.exp(rng.normal(size=(d, n))), rng.normal(size=(d,)))


@pytest.mark.parametrize("case", MS_CASES)
@pytest.mark.parametrize("name", list(DTYPES))
def test_plain_scan_matches_jax_ref_and_pallas_kernel(case, name):
    """Zero state: the port's plain version against the JAX oracle and the
    interpret-mode Pallas kernel, all fed the same numbers; the final state
    is left in ``h``."""
    B, S, d, n, chunk, d_tile = case
    jd, td = DTYPES[name]
    x, dt, Bc, Cc, A, D = _scan_inputs(B, S, d, n, RNG)
    jx, jdt, jB, jC = (jnp.asarray(a, jd) for a in (x, dt, Bc, Cc))
    jA, jD = jnp.asarray(A, jnp.float32), jnp.asarray(D, jnp.float32)
    want_ref = jax_mamba_scan_ref(jx, jdt, jB, jC, jA, jD)
    want_kernel = jax_mamba_scan(jx, jdt, jB, jC, jA, jD, chunk=chunk,
                                 d_tile=d_tile, interpret=True)
    h = torch.zeros((B, d, n))
    got = mamba_scan_ref(*(torch.from_numpy(np.array(_np(a))).to(td)
                           for a in (jx, jdt, jB, jC)),
                         torch.from_numpy(np.array(jA)),
                         torch.from_numpy(np.array(jD)), h)
    assert got.dtype == td and got.shape == (B, S, d)
    tol = 5e-2 if name == "bfloat16" else 2e-5
    for want in (want_ref, want_kernel):
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    assert bool(h.abs().sum() > 0)


@pytest.fixture(scope="module")
def mamba_params():
    d_model, d_inner, n, K = 32, 64, 16, 4
    jp = JS.init_mamba(jax.random.PRNGKey(3), d_model, d_inner, n, K,
                       jnp.float32)
    tp = from_jax_numpy(None, jax.tree.map(np.asarray, jp))
    return jp, tp, d_model


def test_mamba_mix_matches_jax_over_carried_chunks(mamba_params):
    """One sequence cut into chunks of 37, 1 and 90 tokens: every chunk's
    output and the carried conv and ssm state match JAX to 1e-5."""
    jp, tp, d_model = mamba_params
    B = 2
    xs = RNG.normal(size=(B, 128, d_model)).astype(np.float32)
    jstate, tstate = None, None
    t0 = 0
    for S in (37, 1, 90):
        x = xs[:, t0:t0 + S]
        jy, jstate = JS.mamba_mix(jp, jnp.asarray(x), jstate)
        ty, tstate = TS.mamba_mix(tp, torch.from_numpy(x), tstate)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **MIX_TOL)
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(tstate[k].numpy(),
                                       np.asarray(jstate[k]), **MIX_TOL,
                                       err_msg=k)
        t0 += S
    assert tstate["ssm"].dtype == torch.float32


def test_mamba_mix_rows_leave_other_rows_bit_identical(mamba_params):
    """A decode of rows [2, 0] of a 4-row state: those rows equal a run of
    the two rows alone, rows 1 and 3 do not change at all."""
    _, tp, d_model = mamba_params
    state = TS.init_mamba_state(4, 64, 16, 4, torch.float32)
    TS.mamba_mix(tp, torch.from_numpy(
        RNG.normal(size=(4, 9, d_model)).astype(np.float32)), state)
    before = {k: v.clone() for k, v in state.items()}
    rows = torch.tensor([2, 0])
    x = torch.from_numpy(RNG.normal(size=(2, 1, d_model)).astype(np.float32))
    alone = {k: v[rows].clone() for k, v in before.items()}
    want, _ = TS.mamba_mix(tp, x, alone)
    got, _ = TS.mamba_mix(tp, x, state, rows=rows)
    assert torch.equal(got, want)
    for k in ("conv", "ssm"):
        assert torch.equal(state[k][rows], alone[k])
        assert torch.equal(state[k][[1, 3]], before[k][[1, 3]])


def test_softplus_matches_jax_at_large_arguments():
    """dt's softplus is logaddexp(v, 0) as in jax.nn.softplus (F.softplus
    turns linear above 20 and differs there in the last bits)."""
    v = np.array([-50.0, -3.0, 0.0, 19.5, 20.5, 40.0], np.float32)
    t = torch.from_numpy(v)
    np.testing.assert_array_equal(
        torch.logaddexp(t, t.new_zeros(())).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(v))))


# ---------------------------------------------------------------------------
# torch mirror of csrc/mamba_scan.cu
# ---------------------------------------------------------------------------
SRC = (build.CSRC / "mamba_scan.cu").read_text()


def _source_define(src, name):
    m = re.search(r"#define " + name + r" (\d+)", src)
    return int(m.group(1))


def _source_constant(src, name, kind="int"):
    m = re.search(r"constexpr " + kind + r" " + name + r" = (\d+);", src)
    return int(m.group(1))


def _poly_coefficients(src):
    """kP1..kP5 of the source, as the fp32 values it compiles to."""
    m = re.search(r"constexpr float kP1 = ([\d.e-]+)f, kP2 = ([\d.e-]+)f, "
                  r"kP3 = ([\d.e-]+)f,\s+kP4 = ([\d.e-]+)f, "
                  r"kP5 = ([\d.e-]+)f;", src)
    return [float(np.float32(c)) for c in m.groups()]


# the source's shapes and defaults (tied to it by
# test_mirror_constants_are_the_sources)
MAX_N, WALKERS, TILE = 16, 128, 32      # kMaxN, kWalkers, kTile
CHUNK_LANES, POLY = 2, 0                # MAMBA_LANES, MAMBA_POLY
DECODE_LANES, DECODE_CHANNELS = 4, 64   # kDecLanes, kDecChannels
POLY_COEF = _poly_coefficients(SRC)     # kP1..kP5
POLY_ULP = 2.15                         # exp2_poly's stated largest error
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)


def _fma(a, b, c):
    """fp32 fmaf: the float64 product (exact) and sum, rounded once."""
    return (a.double() * b.double() + c.double()).float()


def _exp2_poly(v):
    """The source's exp2_poly: v clamped to [-127, 128], k = rint(v) by the
    1.5 * 2^23 add, 2^f of f = v - k by the degree-5 polynomial in Horner
    multiply-adds, 2^k from the exponent bits of v + 1.5 * 2^23 (0 at k =
    -127), the product flushed to 0 below 2^-126."""
    magic = torch.tensor(12582912.0)
    v = v.clamp(-127.0, 128.0)
    j = v + magic
    f = v - (j - magic)
    p = torch.full_like(f, POLY_COEF[4])
    for ck in POLY_COEF[3::-1]:
        p = _fma(p, f, torch.full_like(f, ck))
    p = _fma(p, f, torch.ones_like(f))
    bits = (j.view(torch.int32).long() << 23) + 0x3F800000
    bits = bits & 0xFFFFFFFF
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    scale = bits.to(torch.int32).view(torch.float32)
    out = (p.double() * scale.double()).float()
    return torch.where(out.abs() < 2.0 ** -126, torch.zeros_like(out), out)


def _by_lane(v, lanes):
    """[c, n] -> [c, lanes, MAX_N // lanes]: state j of a channel in lane
    j // P, slot j % P; states past n are zero."""
    out = v.new_zeros((v.shape[0], MAX_N))
    out[:, :v.shape[1]] = v
    return out.view(v.shape[0], lanes, MAX_N // lanes)


def _poly_mask(lanes, poly):
    """[L, P]: the states j = l*P + i whose exponential is the polynomial,
    j % 8 >= 8 - poly (chosen by state index, whatever the lanes)."""
    j = torch.arange(MAX_N).view(lanes, MAX_N // lanes)
    return (j % 8) >= 8 - poly


def _xor_tree(parts):
    """Lane 0's sum of the lanes' parts [..., L] in the order of an xor
    tree: at L 4, (p0 + p2) + (p1 + p3)."""
    q = list(parts.unbind(-1))
    o = len(q) // 2
    while o:
        q = [q[lane] + q[lane ^ o] for lane in range(len(q))]
        o //= 2
    return q[0]


def _lane_step(hs, a, dtt, dtx, bv, cv, exp2, poly=0, decode=False):
    """One step of every lane of a block's channels: hs, a [c, L, P]; dtt,
    dtx [c]; bv, cv [L, P]. The decode kernel rounds the update product by
    product; the chunk kernel's is one multiply-add, fma(da, h, dtx*B),
    with the polynomial 2^v on the states of ``_poly_mask``. Each lane's
    part of y is a running multiply-add over its states."""
    v = dtt[:, None, None] * a
    if exp2:
        da = torch.exp2(v)
        if poly:
            da = torch.where(_poly_mask(hs.shape[1], poly), _exp2_poly(v),
                             da)
    else:
        da = torch.exp(v)
    dtxb = dtx[:, None, None] * bv
    hs = da * hs + dtxb if decode else _fma(da, hs, dtxb)
    part = torch.zeros(hs.shape[:2])
    for i in range(hs.shape[2]):
        part = _fma(hs[..., i], cv[:, i], part)
    return hs, part


def _cuda_mirror(x, dt, Bc, Cc, A, D, h, rows, *, lanes=CHUNK_LANES,
                 channels=None, tile=TILE, exp2=True, poly=POLY):
    """The two CUDA kernels, written out. S 1, the decode kernel: per
    (batch row, channel) DECODE_LANES lanes of the state row rows[b], expf,
    the update rounded product by product, y = tree(parts) + D*x. S >= 2,
    the chunk kernel: blocks of ``channels`` (WALKERS // lanes by default)
    channels of one row (the last ragged), ``lanes`` lanes a channel
    holding their states from the first tile to the last, ``tile`` time
    steps staged at a time (the last tile ragged; B and C zero-padded to
    MAX_N), each lane's part of y kept a tile, then summed in the xor-tree
    order and D*x added by one multiply-add; the exponential 2^(dt * (A
    log2 e)) (``exp2``; the polynomial on ``poly`` states of every 8) or
    exp(dt * A)."""
    B, S, d = x.shape
    n = A.shape[1]
    decode = S == 1
    if decode:
        lanes, exp2, poly = DECODE_LANES, False, 0
        channels = DECODE_CHANNELS
    channels = channels or WALKERS // lanes
    a_all = A * LOG2E if exp2 else A
    y = torch.empty((B, S, d), dtype=x.dtype)
    for b in range(B):
        r = b if rows is None else int(rows[b])
        for c0 in range(0, d, channels):
            ch = slice(c0, min(c0 + channels, d))
            hs = _by_lane(h[r, ch], lanes)
            a = _by_lane(a_all[ch], lanes)
            for t0 in range(0, S, tile):
                nt = min(tile, S - t0)
                x_s = x[b, t0:t0 + nt, ch].float()            # staged tile
                dt_s = dt[b, t0:t0 + nt, ch]
                b_s = _by_lane(Bc[b, t0:t0 + nt], lanes)      # [nt, L, P]
                c_s = _by_lane(Cc[b, t0:t0 + nt], lanes)
                parts = []
                for t in range(nt):
                    hs, part = _lane_step(hs, a, dt_s[t], dt_s[t] * x_s[t],
                                          b_s[t], c_s[t], exp2, poly, decode)
                    parts.append(part)
                tree = _xor_tree(torch.stack(parts))
                dx = D[ch].expand_as(x_s)
                y[b, t0:t0 + nt, ch] = (tree + dx * x_s if decode else
                                        _fma(dx, x_s, tree)).to(x.dtype)
            h[r, ch] = hs.reshape(hs.shape[0], MAX_N)[:, :n]
    return y


def _check_mirror(B, S, d, n, rows, **kw):
    """The mirror against the plain version on inputs as mamba_mix passes
    them (x a bf16 column view, B and C column views of one fp32 tensor),
    from a random state: h to 1e-6 (the same recurrence; exp2 of the scaled
    A, the polynomial, the contracted update or a CPU's vector exp move it
    by a few ulps), y to bf16 rounding, the state rows outside the batch
    untouched."""
    rng = np.random.default_rng(B * 100 + S + 7 * n)
    Bs = B if rows is None else max(rows) + 2
    x = torch.from_numpy(rng.normal(size=(B, S, 2 * d)).astype(
        np.float32)).to(torch.bfloat16)[..., :d]
    dt = torch.from_numpy(np.exp(rng.uniform(
        math.log(1e-3), math.log(0.1), (B, S, d))).astype(np.float32))
    dbc = torch.from_numpy(rng.normal(size=(B, S, 5 + 2 * n)).astype(
        np.float32))
    Bc, Cc = dbc[..., 5:5 + n], dbc[..., 5 + n:]
    A = -torch.arange(1, n + 1, dtype=torch.float32).expand(d, n).contiguous()
    D = torch.from_numpy(rng.normal(size=(d,)).astype(np.float32))
    h0 = torch.from_numpy(rng.normal(size=(Bs, d, n)).astype(np.float32))
    rows_t = None if rows is None else torch.tensor(rows)
    h_want, h_got = h0.clone(), h0.clone()
    want = mamba_scan_ref(x, dt, Bc, Cc, A, D, h_want, rows=rows_t)
    got = _cuda_mirror(x, dt, Bc, Cc, A, D, h_got, rows_t, **kw)
    np.testing.assert_allclose(h_got.numpy(), h_want.numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2 ** -7, atol=1e-5)
    others = [i for i in range(Bs) if rows is None or i not in rows]
    if rows is not None:
        assert torch.equal(h_got[others], h0[others])
    return got, h_got


@pytest.mark.parametrize("B,S,d,n,channels,tile,rows", [
    (1, 37, 48, 16, 16, 8, None),         # ragged last tile
    (2, 20, 40, 8, 16, 32, None),         # ragged channel block, n < 16
    (3, 1, 24, 16, 16, 8, [4, 0, 2]),     # a decode of 3 of 5 state rows
    (2, 9, 16, 4, 16, 4, [1, 0]),         # tiles of 4, rows swapped
])
def test_cuda_loop_mirror_matches_plain(B, S, d, n, channels, tile, rows):
    """The kernels' mirror (the source's lanes a channel) on the cases of
    the first port's loop mirror."""
    _check_mirror(B, S, d, n, rows, channels=channels, tile=tile)


@pytest.mark.parametrize("B,S,d,n,lanes,channels,tile,rows,exp2", [
    (1, 40, 48, 16, 2, 16, 8, None, True),     # L 2, ragged last tile
    (1, 40, 48, 16, 4, 16, 8, None, True),     # L 4
    (1, 40, 48, 16, 4, 16, 8, None, False),    # L 4, expf
    (2, 19, 40, 6, 4, 16, 8, None, True),      # d_state 6: lane 1 partial
    (1, 23, 24, 1, 2, 16, 8, None, True),      # d_state 1: one state
    (3, 1, 40, 6, 2, 16, 8, [2, 4, 0], True),  # decode of 3 of 5, permuted
    (2, 32, 40, 16, 2, 16, 32, None, True),    # a chunk of exactly T steps
    (1, 40, 48, 16, 1, 16, 8, None, True),     # L 1: no parts
    (2, 19, 40, 6, 1, 16, 8, None, False),     # L 1, d_state 6, expf
    (1, 70, 72, 16, CHUNK_LANES, None, TILE, [1], True),   # the source's
])
def test_cuda_mirror_lanes_matches_plain(B, S, d, n, lanes, channels, tile,
                                         rows, exp2):
    """The mirror at every lane count, both exponentials, partial lanes,
    a permuted decode and whole tiles, against the plain version."""
    _check_mirror(B, S, d, n, rows, lanes=lanes, channels=channels,
                  tile=tile, exp2=exp2)


@pytest.mark.parametrize("lanes", [1, 2, 4])
@pytest.mark.parametrize("poly", [0, 1, 2])
def test_cuda_mirror_poly_shares_match_plain(poly, lanes):
    """The polynomial on 0, 1 and 2 states of every 8 at 1, 2 and 4 lanes
    a channel (a ragged tile and channel block, d_state 16 and 6) against
    the plain version."""
    for n in (16, 6):
        _check_mirror(1, 45, 40, n, None, lanes=lanes, channels=16, tile=16,
                      poly=poly)


def test_mirror_lanes_and_tiles_change_only_y_order():
    """L 1, 2 and 4, and tiles of 8 and 32, walk the same recurrence (the
    polynomial chosen by state index): the states agree to the last bit, y
    only to its summation order."""
    runs = [_check_mirror(1, 37, 24, 16, None, lanes=lanes, tile=tile,
                          poly=2)
            for lanes, tile in ((1, 8), (2, 32), (4, 8))]
    for y, h in runs[1:]:
        assert torch.equal(h, runs[0][1])
        np.testing.assert_allclose(_np(y), _np(runs[0][0]), rtol=2 ** -7,
                                   atol=1e-5)


def test_contracted_update_is_nearer_exact_than_the_plain_version():
    """The chunk kernel's update is one multiply-add where the plain version
    rounds da*h and dtx*B apart. Over 70 steps of 136 channels (the
    source's lanes, three channel blocks, the last ragged), against the
    recurrence in float64 on the same fp32 inputs (exp in float64): the
    mirror's state is within h's limit (1e-6 relative, 1e-7) and no
    farther from it than the plain version's, and y within bf16
    rounding of the plain version's."""
    rng = np.random.default_rng(4)
    S, d, n = 70, 136, 16
    x = torch.from_numpy(rng.normal(size=(1, S, 2 * d)).astype(
        np.float32)).to(torch.bfloat16)[..., :d]
    dt = torch.from_numpy(np.exp(rng.uniform(
        math.log(1e-3), math.log(0.1), (1, S, d))).astype(np.float32))
    dbc = torch.from_numpy(rng.normal(size=(1, S, 5 + 2 * n)).astype(
        np.float32))
    Bc, Cc = dbc[..., 5:5 + n], dbc[..., 5 + n:]
    A = -torch.arange(1, n + 1, dtype=torch.float32).expand(d, n).contiguous()
    D = torch.from_numpy(rng.normal(size=(d,)).astype(np.float32))
    h0 = torch.from_numpy(rng.normal(size=(1, d, n)).astype(np.float32))
    h_plain, h_mirror = h0.clone(), h0.clone()
    want = mamba_scan_ref(x, dt, Bc, Cc, A, D, h_plain)
    got = _cuda_mirror(x, dt, Bc, Cc, A, D, h_mirror, None)
    exact = h0[0].double()
    for t in range(S):
        dtt = dt[0, t].double()[:, None]
        exact = (torch.exp(dtt * A.double()) * exact
                 + dtt * x[0, t].double()[:, None] * Bc[0, t].double())
    err_mirror = (h_mirror[0].double() - exact).abs()
    err_plain = (h_plain[0].double() - exact).abs()
    assert bool((err_mirror <= 1e-7 + 1e-6 * exact.abs()).all())
    assert err_mirror.max() <= err_plain.max()
    np.testing.assert_allclose(_np(got), _np(want), rtol=2 ** -7, atol=1e-5)


def test_exp2_poly_within_its_bound_and_flushes_as_ex2_ftz():
    """exp2_poly against 2^v in float64 over v in [-40, 0] and down to
    -126: within the stated ulps of the correctly rounded result; exactly 1
    at 0 and 2^-126 at -126; 0 below -126, where ex2.approx.ftz's result
    would be subnormal and flushes."""
    v = torch.cat([torch.linspace(-40.0, 0.0, 400001),
                   torch.linspace(-126.0, -40.0, 20001),
                   torch.tensor([-0.5, 0.5, -1e-30, -125.5])])
    got = _exp2_poly(v).double()
    want = torch.exp2(v.double())
    ulp = torch.from_numpy(np.spacing(want.float().numpy()).astype(
        np.float64))
    err = ((got - want).abs() / ulp).max().item()
    assert err <= POLY_ULP, err
    assert f"{POLY_ULP} ulp" in SRC
    edge = _exp2_poly(torch.tensor([0.0, -126.0, -126.0001, -126.4, -126.6,
                                    -127.0, -150.0, -1e30]))
    assert edge[0].item() == 1.0 and edge[1].item() == 2.0 ** -126
    assert torch.equal(edge[2:], torch.zeros(6))


def test_xor_tree_order():
    """Lane 0's sum at L 4 is (p0 + p2) + (p1 + p3), at L 2 p0 + p1: with
    parts whose fp32 sum depends on the order, the tree gives that order's
    (2), not a running sum's (0)."""
    p = torch.tensor([1.0, 1e8, 1.0, -1e8])
    assert float(_xor_tree(p)) == float((p[0] + p[2]) + (p[1] + p[3])) == 2
    assert float(((p[0] + p[1]) + p[2]) + p[3]) == 0
    assert float(_xor_tree(p[:2])) == float(p[0] + p[1])


def test_mirror_constants_are_the_sources():
    """The mirror's shapes are csrc/mamba_scan.cu's: states, walker threads
    a block, steps a tile, lanes of each kernel, the decode kernel's
    channels a block, the chunk kernel's default exponential (exp2), its
    share of polynomial states and the polynomial's coefficients; the
    wrapper's MAX_N is the kernel's."""
    for name, want in (("kMaxN", MAX_N), ("kWalkers", WALKERS),
                       ("kTile", TILE), ("kDecLanes", DECODE_LANES),
                       ("kDecChannels", DECODE_CHANNELS)):
        assert _source_constant(SRC, name) == want, name
    assert _source_define(SRC, "MAMBA_LANES") == CHUNK_LANES
    assert _source_define(SRC, "MAMBA_POLY") == POLY
    assert _source_define(SRC, "MAMBA_EXP2") == 1
    assert "constexpr int kChannels = kWalkers / kLanes;" in SRC
    assert len(POLY_COEF) == 5 and abs(POLY_COEF[0] - math.log(2)) < 1e-6
    assert MK.MAX_N == MAX_N


def _variants_tool():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "tools" / "mamba_variants.py"
    spec = importlib.util.spec_from_file_location("mamba_variants", path)
    mv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mv)
    return mv


def test_variants_tool_switches_are_in_the_source():
    """tools/mamba_variants.py builds its variants with -D switches: each
    switch it sets has a default in the source, so every variant is built
    from this source; an older source without them gives the source
    alone."""
    mv = _variants_tool()
    src = (build.CSRC / "mamba_scan.cu").read_text()
    assert mv.variants_of(src) == mv.VARIANTS
    for _, flags, _ in mv.VARIANTS:
        for flag in flags:
            name = flag[2:].split("=")[0]
            assert f"#ifndef {name}\n#define {name} " in src, flag
    assert [v[0] for v in mv.variants_of("one thread a channel")] == \
        ["source"]


SASS = """
        Function : _ZN4mamba_scan_decode_kernelI13__nv_bfloat16EEv
        /*0000*/                   FFMA R1, R2, R3, R4 ;
        /*0010*/                   BRA 0x0 ;
        Function : _ZN4mamba_scan_chunk_kernelI13__nv_bfloat16EEv
        /*0000*/                   LDS.128 R36, [R43+0x4000] ;
        /*0010*/                   FMUL R4, R44, R83 ;
        /*0020*/                   MUFU.EX2 R77, R4 ;
        /*0030*/                   FFMA R77, R77, R20, R36 ;
        /*0040*/              @!P0 BRA 0x0 ;
        /*0050*/                   FFMA R5, R6, R7, R8 ;
        /*0060*/                   BRA 0x50 ;
        /*0070*/                   SYNCS.ARRIVE.TRANS64 RZ, [R60] ;
        /*0080*/               @P1 BRA 0x0 ;
"""


def test_variants_tool_counts_the_walk_loop_of_the_chunk_kernel():
    """tools/mamba_variants.py's SASS reading: of the bf16 chunk kernel's
    innermost loops (backward branches holding no other), the one with the
    most FFMA; the decode kernel and the enclosing tile loop are not
    counted."""
    ops = _variants_tool().walk_loop(SASS)
    assert ops == {"LDS": 1, "FMUL": 1, "MUFU": 1, "FFMA": 1, "BRA": 1}
    assert _variants_tool().walk_loop("no functions") == {}


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------
def _operands(B=2, S=5, d=8, n=16, Bs=None):
    x = torch.randn(B, S, d)
    f = dict(dtype=torch.float32)
    return (x, torch.rand(B, S, d, **f), torch.randn(B, S, n, **f),
            torch.randn(B, S, n, **f), -torch.rand(d, n, **f),
            torch.ones(d, **f), torch.zeros(Bs or B, d, n, **f))


def test_wrapper_takes_plain_version_on_cpu_and_counts_no_launch():
    ops = _operands()
    before = MK.mamba_scan.launches
    h_ref = ops[-1].clone()
    y = MK.mamba_scan(*ops)
    assert torch.equal(y, mamba_scan_ref(*ops[:-1], h_ref))
    assert MK.mamba_scan.launches == before
    assert "mamba_scan" in build.SOURCES
    assert "mamba_scan_launch" in build.SIGNATURES["mamba_scan"]


def test_wrapper_raises_on_other_devices():
    ops = [t.to("meta") for t in _operands()]
    with pytest.raises(ValueError, match="no mamba_scan kernel"):
        MK.mamba_scan(*ops)


@pytest.mark.parametrize("bad,match", [
    ("dt_bf16", "dt must be fp32"),
    ("n17", "d_state 17"),
    ("h_rows", "state row of h"),
    ("batch", "state rows for"),
    ("rows_shape", "rows must be"),
    ("x_stride", "contiguous last axis"),
    ("empty", "at least one token"),
])
def test_operand_checks(bad, match):
    x, dt, Bc, Cc, A, D, h = _operands(n=17 if bad == "n17" else 16,
                                       Bs=3 if bad == "batch" else None)
    rows = None
    if bad == "dt_bf16":
        dt = dt.to(torch.bfloat16)
    elif bad == "h_rows":
        h = torch.zeros(2, 16, 8).transpose(1, 2)
    elif bad == "rows_shape":
        rows = torch.tensor([[0, 1]])
    elif bad == "x_stride":
        x = torch.randn(2, 8, 5).transpose(1, 2)
    elif bad == "empty":
        x, dt, Bc, Cc = (t[:, :0] for t in (x, dt, Bc, Cc))
    with pytest.raises(ValueError, match=match):
        MK._check(x, dt, Bc, Cc, A, D, h, rows)
