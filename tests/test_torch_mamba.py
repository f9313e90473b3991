"""PyTorch port, Mamba mixer: the plain version of the selective-scan kernel
against the JAX oracle ``mamba_scan_ref`` and the interpret-mode Pallas
``mamba_scan`` (zero state, the JAX test's shapes and tolerances: 2e-5
fp32, 5e-2 bf16); the port's ``mamba_mix`` against the JAX one over a
sequence cut into chunks of 37, 1 and 90 tokens with the state carried
across (fp32, 1e-5; outputs and both state leaves); the row subset a slot
decode runs, the other rows bit-identical; and a torch mirror of the two
CUDA kernels (lanes a channel with each lane's part of y summed in an xor
tree, channel blocks, time tiles staged with a ragged last tile, the chunk
kernel's exp2, the decode kernel's rows) against the plain version. The
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
# the source's shapes (tied to it by test_mirror_constants_are_the_sources)
MAX_N, CHANNELS, TILE = 16, 64, 32      # kMaxN, kChannels, kTile
CHUNK_LANES, DECODE_LANES = 2, 4        # MAMBA_LANES, kDecLanes
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)


def _by_lane(v, lanes):
    """[c, n] -> [c, lanes, MAX_N // lanes]: state j of a channel in lane
    j // P, slot j % P; states past n are zero."""
    out = v.new_zeros((v.shape[0], MAX_N))
    out[:, :v.shape[1]] = v
    return out.view(v.shape[0], lanes, MAX_N // lanes)


def _xor_tree(parts):
    """Lane 0's sum of the lanes' parts [..., L] in the order of an xor
    tree: at L 4, (p0 + p2) + (p1 + p3)."""
    q = list(parts.unbind(-1))
    o = len(q) // 2
    while o:
        q = [q[lane] + q[lane ^ o] for lane in range(len(q))]
        o //= 2
    return q[0]


def _lane_step(hs, a, dtt, dtx, bv, cv, exp2):
    """One step of every lane of a block's channels: hs, a [c, L, P]; dtt,
    dtx [c]; bv, cv [L, P]. The update rounded product by product; each
    lane's part of y summed over its states as a running multiply-add."""
    v = dtt[:, None, None] * a
    da = torch.exp2(v) if exp2 else torch.exp(v)
    hs = da * hs + dtx[:, None, None] * bv
    part = torch.zeros(hs.shape[:2])
    for i in range(hs.shape[2]):
        part = part + hs[..., i] * cv[:, i]
    return hs, part


def _cuda_mirror(x, dt, Bc, Cc, A, D, h, rows, *, lanes=CHUNK_LANES,
                 channels=CHANNELS, tile=TILE, exp2=True):
    """The two CUDA kernels, written out. S 1, the decode kernel: per
    (batch row, channel) DECODE_LANES lanes of the state row rows[b], expf,
    y = tree(parts) + D*x. S >= 2, the chunk kernel: blocks of ``channels``
    channels of one row (the last ragged), ``lanes`` lanes a channel
    holding their states from the first tile to the last, ``tile`` time
    steps staged at a time (the last tile ragged; B and C zero-padded to
    MAX_N), each lane's part of y kept a tile, then summed in the xor-tree
    order and D*x added; the exponential 2^(dt * (A log2 e)) (``exp2``) or
    exp(dt * A)."""
    B, S, d = x.shape
    n = A.shape[1]
    if S == 1:
        lanes, exp2 = DECODE_LANES, False
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
                                          b_s[t], c_s[t], exp2)
                    parts.append(part)
                y[b, t0:t0 + nt, ch] = (_xor_tree(torch.stack(parts))
                                        + D[ch] * x_s).to(x.dtype)
            h[r, ch] = hs.reshape(hs.shape[0], MAX_N)[:, :n]
    return y


def _check_mirror(B, S, d, n, rows, **kw):
    """The mirror against the plain version on inputs as mamba_mix passes
    them (x a bf16 column view, B and C column views of one fp32 tensor),
    from a random state: h to 1e-6 (the same update; exp2 of the scaled A
    or a CPU's vector exp moves it by a few ulps), y to bf16 rounding, the
    state rows outside the batch untouched."""
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
    (1, 70, 72, 16, CHUNK_LANES, CHANNELS, TILE, [1], True),  # the source's
])
def test_cuda_mirror_lanes_matches_plain(B, S, d, n, lanes, channels, tile,
                                         rows, exp2):
    """The mirror at both lane counts, both exponentials, partial lanes,
    a permuted decode and whole tiles, against the plain version."""
    _check_mirror(B, S, d, n, rows, lanes=lanes, channels=channels,
                  tile=tile, exp2=exp2)


def test_mirror_lanes_and_tiles_change_only_y_order():
    """L 2 and L 4, and tiles of 8 and 32, walk the same recurrence: the
    states agree to the last bit, y only to its summation order."""
    (y2, h2), (y4, h4) = (_check_mirror(1, 37, 24, 16, None, lanes=lanes,
                                        tile=tile)
                          for lanes, tile in ((2, 8), (4, 32)))
    assert torch.equal(h2, h4)
    np.testing.assert_allclose(_np(y2), _np(y4), rtol=2 ** -7, atol=1e-5)


def test_xor_tree_order():
    """Lane 0's sum at L 4 is (p0 + p2) + (p1 + p3), at L 2 p0 + p1: with
    parts whose fp32 sum depends on the order, the tree gives that order's
    (2), not a running sum's (0)."""
    p = torch.tensor([1.0, 1e8, 1.0, -1e8])
    assert float(_xor_tree(p)) == float((p[0] + p[2]) + (p[1] + p[3])) == 2
    assert float(((p[0] + p[1]) + p[2]) + p[3]) == 0
    assert float(_xor_tree(p[:2])) == float(p[0] + p[1])


def _source_define(src, name):
    m = re.search(r"#define " + name + r" (\d+)", src)
    return int(m.group(1))


def test_mirror_constants_are_the_sources():
    """The mirror's shapes are csrc/mamba_scan.cu's: states, channels a
    block, steps a tile, lanes of each kernel, and the chunk kernel's
    default exponential (exp2); the wrapper's MAX_N is the kernel's."""
    src = (build.CSRC / "mamba_scan.cu").read_text()
    for name, want in (("kMaxN", MAX_N), ("kChannels", CHANNELS),
                       ("kTile", TILE), ("kDecLanes", DECODE_LANES)):
        m = re.search(r"constexpr int " + name + r" = (\d+);", src)
        assert m and int(m.group(1)) == want, name
    assert _source_define(src, "MAMBA_LANES") == CHUNK_LANES
    assert _source_define(src, "MAMBA_EXP2") == 1
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
