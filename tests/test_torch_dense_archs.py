"""PyTorch port: gemma2-2b, gemma2-27b and qwen3-1.7b (per-head q/k norm,
post-norms, the embedding scale, the final softcap, local/global layers)
against the JAX package on the same parameters.

The smoke configs run in fp32 with ``sliding_window`` 16 on both sides
(the smoke config keeps 4096, which a smoke-sized prompt never reaches),
so the local layers' window masks keys. The reference initialises every
norm weight to zero (it scales by ``1 + w``); here each norm leaf is filled
with seeded random values before the tree is carried across, so a norm
applied in the wrong place, or swapped with another, shows. Held against
the JAX steps: the paged steps (ragged chunks, decode, speculative verify:
equal token ids, pools to 2e-5) and the slot steps (logits to 1e-4, caches
to 2e-5); then the port's paged ``EngineCore`` against the JAX paged
engine on gemma2-2b and qwen3-1.7b (equal greedy streams and round
counts, and at spec_k 4 and with the prefix cache on, equal speculation,
cache-hit and prefill-token counts); and, within the port, each arch's
slot engine against its paged engine (equal greedy streams)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import SlidingServeScheduler as JScheduler  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.engine import EngineCore as JEngine  # noqa: E402
from repro.serving.request import Request as JRequest  # noqa: E402
from repro_torch import params as TP  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import LOCAL_ATTN  # noqa: E402
from repro_torch.core import SlidingServeScheduler  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving.engine import EngineCore  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

ARCHS = ["gemma2-2b", "gemma2-27b", "qwen3-1.7b"]
WINDOW = 16
PS = 16
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=2e-5, rtol=2e-5)
NORMS = ("ln", "post_ln", "q_norm", "k_norm", "final_norm")


def _cfgs(arch, window=WINDOW):
    return tuple(dataclasses.replace(get(arch).smoke(), sliding_window=window)
                 for get in (jget_config, get_config))


def random_norms(tree, seed):
    """``tree`` (numpy leaves) with every norm weight drawn from N(0, 0.5)
    with ``seed``, each leaf its own values."""
    rng = np.random.default_rng(seed)

    def fill(t):
        if isinstance(t, dict):
            return {k: (rng.normal(0.0, 0.5, v.shape).astype(v.dtype)
                        if k in NORMS and not isinstance(v, (dict, list))
                        else fill(v)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [fill(v) for v in t]
        return t
    return fill(tree)


def _params(arch, jcfg, tcfg):
    """The reference's parameters with random norm weights, as JAX arrays
    and as torch tensors."""
    tree = random_norms(jax.tree.map(
        np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0))), seed=7)
    return jax.tree.map(jnp.asarray, tree), TP.from_jax_numpy(tcfg, tree)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    jcfg, tcfg = _cfgs(request.param)
    return (jcfg, tcfg, *_params(request.param, jcfg, tcfg))


def test_norm_leaves_are_drawn_and_carried(setup):
    """init_params draws the leaves the reference draws (q_norm/k_norm
    [reps, Dh] with qk_norm, post_ln [reps, d] in attention and the dense
    FFN with post_norm) and the random values reach the port's tree."""
    jcfg, tcfg, jparams, tparams = setup
    slot = TP.init_params(tcfg, seed=0, device="cpu")["stacks"][0][0]
    reps, d, Dh = tcfg.num_pattern_reps, tcfg.d_model, tcfg.resolved_head_dim
    want = {"q_norm", "k_norm"} if tcfg.qk_norm else set()
    assert want <= set(slot["attn"]) and (
        tcfg.qk_norm or not {"q_norm", "k_norm"} & set(slot["attn"]))
    for name in want:
        assert slot["attn"][name].shape == (reps, Dh)
    assert ("post_ln" in slot["attn"]) == ("post_ln" in slot["ffn"]) \
        == tcfg.post_norm
    if tcfg.post_norm:
        assert slot["attn"]["post_ln"].shape == (reps, d)
    for name in ("ln", *want, *(("post_ln",) if tcfg.post_norm else ())):
        got = tparams["stacks"][0][0]["attn"][name]
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jparams["stacks"][0][0]["attn"][name]))
        assert got.abs().sum() > 0


class _Pages:
    """Distinct page ids per row; the last page of the pool is the trash."""

    def __init__(self, num_pages):
        self.next = 0
        self.tables = {}
        self.trash = (num_pages - 1) * PS

    def table(self, row, upto):
        t = self.tables.setdefault(row, [])
        while len(t) * PS < upto:
            t.append(self.next)
            self.next += 1
        return t

    def slots(self, row, start, n):
        t = self.table(row, start + n)
        return [t[p // PS] * PS + p % PS for p in range(start, start + n)]


def _chunk_args(rng, pages, rows, Lb, vocab):
    """rows: [(row id, start, n)] plus padding rows (None)."""
    R = len(rows)
    nb = max([len(pages.table(r[0], r[1] + r[2])) for r in rows if r] + [1])
    nb = 1 << (nb - 1).bit_length()
    tokens = rng.integers(1, vocab, (R, Lb)).astype(np.int32)
    pos, lens, at = (np.zeros(R, np.int32) for _ in range(3))
    tables = np.zeros((R, nb), np.int32)
    slots = np.full((R, Lb), pages.trash, np.int64)
    for i, r in enumerate(rows):
        if r is None:
            continue
        rid, start, n = r
        pos[i], lens[i], at[i] = start, start + n, n - 1
        t = pages.table(rid, start + n)
        tables[i, :len(t)] = t
        slots[i, :n] = pages.slots(rid, start, n)
    return dict(tokens=tokens, row_pos=pos, row_lens=lens, logits_at=at,
                block_tables=tables,
                write_slots=slots.reshape(-1).astype(np.int32))


def _both(jfn, tfn, jcfg, tcfg, jparams, tparams, jcache, tcache, args):
    """Run one paged step in both frameworks on the same numpy operands."""
    a = dict(args)
    tok = a.pop("tokens")
    pos = a.pop("row_pos", None)
    lead = () if pos is None else (pos,)
    jout, jcache = jfn(jcfg, jparams, jnp.asarray(tok), jcache,
                       *map(jnp.asarray, lead), rctx=JM.RunCtx(),
                       **{k: jnp.asarray(v) for k, v in a.items()})
    tout, tcache = tfn(tcfg, tparams, torch.from_numpy(tok), tcache,
                       *map(torch.from_numpy, lead),
                       **{k: torch.from_numpy(v) for k, v in a.items()})
    return np.asarray(jout), tout.numpy(), jcache, tcache


def _pools_close(jcache, tcache):
    for js, ts in zip(jcache, tcache):
        for jslot, tslot in zip(js, ts):
            np.testing.assert_allclose(tslot["kv_pages"].numpy(),
                                       np.asarray(jslot["kv_pages"]),
                                       **CACHE_TOL)


def test_paged_steps_match_jax(setup):
    """Ragged chunks (a full chunk, a short prompt, the first chunk of a
    long prompt, a padding row), that prompt's next two chunks (its
    queries past position 16 lose keys to the window), decode rows at
    lengths 41 and 6, and a verify step: equal token ids, pools to 2e-5."""
    jcfg, tcfg, jparams, tparams = setup
    num_pages = 24
    jcache = JM.init_paged_cache(jcfg, num_pages, PS)
    tcache = TM.init_paged_cache(tcfg, num_pages, PS)
    pages = _Pages(num_pages)
    rng = np.random.default_rng(3)
    V = tcfg.vocab_size
    chunk = (JM.paged_chunk_step, TM.paged_chunk_step)
    steps = [[(0, 0, 16), (1, 0, 5), (2, 0, 16), None],
             [(2, 16, 16), None], [(2, 32, 8), (0, 16, 16)]]
    for rows in steps:
        args = _chunk_args(rng, pages, rows, 16, V)
        jids, tids, jcache, tcache = _both(*chunk, jcfg, tcfg, jparams,
                                           tparams, jcache, tcache, args)
        real = [i for i, r in enumerate(rows) if r]
        assert tids[real].tolist() == jids[real].tolist()
        _pools_close(jcache, tcache)

    lens = np.asarray([40 + 1, 6, 0], np.int32)
    tables = np.zeros((3, 4), np.int32)
    slots = np.full(3, pages.trash, np.int64)
    for i, rid in enumerate((2, 1)):
        t = pages.table(rid, int(lens[i]))
        tables[i, :len(t)] = t
        slots[i] = pages.slots(rid, int(lens[i]) - 1, 1)[0]
    args = dict(tokens=rng.integers(1, V, (3, 1)).astype(np.int32),
                lengths=lens, block_tables=tables,
                write_slots=slots.astype(np.int32))
    jids, tids, jcache, tcache = _both(
        JM.paged_decode_step, TM.paged_decode_step, jcfg, tcfg, jparams,
        tparams, jcache, tcache, args)
    assert tids[:2].tolist() == jids[:2].tolist()
    _pools_close(jcache, tcache)

    args = _chunk_args(rng, pages, [(2, 41, 4), (1, 6, 2), None], 4, V)
    args.pop("logits_at")
    jpay, tpay, jcache, tcache = _both(
        JM.paged_spec_step, TM.paged_spec_step, jcfg, tcfg, jparams, tparams,
        jcache, tcache, args)
    assert tpay[:10].tolist() == jpay[:10].tolist()
    _pools_close(jcache, tcache)


def _caches_close(jcache, tcache):
    for js, ts in zip(jcache, tcache):
        for jslot, tslot in zip(js, ts):
            for name in ("k", "v"):
                np.testing.assert_allclose(tslot[name].numpy(),
                                           np.asarray(jslot[name]),
                                           **CACHE_TOL)


def _slot_run(jcfg, tcfg, jparams, tparams, seed=0):
    """Three chunks into a fresh slot cache (the last bucket-padded, logits
    at its last real token), then two ragged decode steps, in both
    frameworks; returns the port's last logits."""
    rctx = JM.RunCtx()
    B, S = 2, 64
    jcache = JM.init_cache(jcfg, B, S)
    tcache = TM.init_cache(tcfg, B, S)
    rng = np.random.default_rng(seed)
    V = tcfg.vocab_size
    for pos, at in ((0, -1), (16, -1), (32, 10)):
        tok = rng.integers(1, V, (B, 16)).astype(np.int32)
        jl, jcache = JM.chunk_prefill_step(jcfg, jparams, jnp.asarray(tok),
                                           jcache, pos, rctx=rctx,
                                           logits_at=at)
        tl, tcache = TM.chunk_prefill_step(tcfg, tparams,
                                           torch.from_numpy(tok), tcache, pos,
                                           logits_at=at)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        _caches_close(jcache, tcache)
    for lens in ([44, 40], [45, 41]):
        lens = np.asarray(lens, np.int32)
        tok = rng.integers(1, V, (B, 1)).astype(np.int32)
        jl, jcache = JM.decode_step(jcfg, jparams, jnp.asarray(tok), jcache, 0,
                                    rctx=rctx, lengths=jnp.asarray(lens))
        tl, tcache = TM.decode_step(tcfg, tparams, torch.from_numpy(tok),
                                    tcache, 0, lengths=torch.from_numpy(lens))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        _caches_close(jcache, tcache)
    return tl


def test_slot_steps_match_jax(setup):
    """Slot chunks at offsets 0, 16 and 32 (window 16: later queries lose
    the first keys) and ragged decode rows; for gemma2 the window must
    change the logits (it bites)."""
    jcfg, tcfg, jparams, tparams = setup
    logits = _slot_run(jcfg, tcfg, jparams, tparams)
    if LOCAL_ATTN in tcfg.layer_pattern:
        wide = TM.init_cache(tcfg, 2, 64)
        far = dataclasses.replace(tcfg, sliding_window=0)
        rng = np.random.default_rng(0)
        for pos in (0, 16, 32):
            tok = rng.integers(1, tcfg.vocab_size, (2, 16)).astype(np.int32)
            TM.chunk_prefill_step(far, tparams, torch.from_numpy(tok), wide,
                                  pos)
        assert not torch.allclose(
            TM.decode_step(far, tparams, torch.from_numpy(
                rng.integers(1, tcfg.vocab_size, (2, 1)).astype(np.int32)),
                wide, 0, lengths=torch.tensor([44, 40]))[0], logits)


# ---------------------------------------------------------------------------
# the paged engine against the JAX paged engine
# ---------------------------------------------------------------------------
SPEC = [(0.0, 24, 4), (0.0, 51, 4), (0.0, 37, 3)]   # tests/test_paged_engine.py


def _requests(spec, cls=Request):
    return [cls(rid=i, arrival=a, prompt_len=p, max_output=o,
                ttft_slo=900.0, tbt_slo=900.0)
            for i, (a, p, o) in enumerate(spec)]


def _scenario(name, vocab):
    """(spec, prompts, engine options) of a scenario: plain, periodic
    prompts at spec_k 4 (the n-gram drafter's best case), and prompts
    sharing a 40-token prefix (prefix-cache hits)."""
    rng = np.random.default_rng(5)
    if name == "plain":
        spec = SPEC
        prompts = {i: rng.integers(1, vocab, p).astype(np.int32)
                   for i, (_, p, _) in enumerate(spec)}
        return spec, prompts, {}
    if name == "spec_k4":
        spec = [(0.0, 32, 6) for _ in range(4)]
        prompts = {i: np.tile(rng.integers(1, vocab, 12), 3)[:32]
                   .astype(np.int32) for i in range(4)}
        return spec, prompts, {"spec_k": 4}
    shared = rng.integers(1, vocab, 40).astype(np.int32)
    spec = [(0.0, 56, 3), (0.0, 50, 3), (0.0, 61, 3)]
    prompts = {i: np.concatenate([shared, rng.integers(
        1, vocab, p - 40).astype(np.int32)]) for i, (_, p, _) in enumerate(spec)}
    return spec, prompts, {"prefix_cache": True}


COUNTS = {"plain": ("prefill_calls", "decode_calls", "iterations"),
          "spec_k4": ("spec_rounds", "spec_rows", "spec_drafts",
                      "spec_accepted", "spec_emitted", "iterations"),
          "prefix": ("cache_hit_tokens", "prefill_tokens", "prefill_calls",
                     "iterations")}


def _serve(eng, spec, prompts, cls=Request):
    out = eng.serve(_requests(spec, cls),
                    {k: v.copy() for k, v in prompts.items()},
                    max_wall_s=900.0)
    assert not out["unfinished"]
    return out


@pytest.mark.parametrize("scenario", list(COUNTS))
@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen3-1.7b"])
def test_paged_engine_matches_jax(arch, scenario):
    jcfg, tcfg = _cfgs(arch)
    jparams, tparams = _params(arch, jcfg, tcfg)
    spec, prompts, kw = _scenario(scenario, tcfg.vocab_size)
    jeng = JEngine(jcfg, JScheduler(max_budget=256, max_iter_time=5.0),
                   seed=0, cache_mode="paged", kv_capacity_tokens=2048, **kw)
    jeng.params = jparams
    want = _serve(jeng, spec, prompts, JRequest)["outputs"]
    eng = EngineCore(tcfg, SlidingServeScheduler(max_budget=256,
                                                 max_iter_time=5.0),
                     kv_capacity_tokens=2048, params=tparams, device="cpu",
                     **kw)
    assert eng.cache_mode == "paged"
    out = _serve(eng, spec, prompts)
    assert out["outputs"] == want
    for key in COUNTS[scenario]:
        assert getattr(eng.stats, key) == getattr(jeng.stats, key), key
    st = eng.stats
    assert st.token_readbacks == st.iterations
    assert st.max_round_calls <= (3 if kw.get("spec_k") else 2)
    if scenario == "spec_k4":
        assert st.spec_drafts > 0
    if scenario == "prefix":
        assert st.cache_hit_tokens > 0
    assert eng.alloc.free_blocks == eng.alloc.num_blocks


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_engine_equals_paged_engine(arch):
    """Each arch serves in slot mode too (chunks through #5 with the
    window, decode over the slot rows): the same greedy streams as the
    paged engine on the same weights."""
    jcfg, tcfg = _cfgs(arch)
    _, tparams = _params(arch, jcfg, tcfg)
    spec, prompts, _ = _scenario("plain", tcfg.vocab_size)
    outs = {}
    for mode in ("paged", "slot"):
        eng = EngineCore(tcfg, SlidingServeScheduler(max_budget=256,
                                                     max_iter_time=5.0),
                         cache_mode=mode, kv_capacity_tokens=2048,
                         max_slots=4, max_len=128, params=tparams,
                         device="cpu")
        assert eng.cache_mode == mode
        outs[mode] = _serve(eng, spec, prompts)["outputs"]
    assert outs["slot"] == outs["paged"]
