"""PyTorch port, jamba-1.5-large-398b (Mamba + attention + MoE) slot serving
and qwen2-moe-a2.7b (MoE) paged serving, on their smoke configs (fp32):

* jamba's ``init_params``/``init_cache`` trees against JAX's (fp32 Mamba
  leaves stay fp32);
* jamba's ``chunk_prefill_step`` and ``decode_step`` against the JAX steps
  on the same parameters: chunks of exact lengths 37, 1 and 26, a decode
  of every row and one that writes only row 1 (logits 1e-4; every KV row
  and Mamba state leaf 1e-5 + 1e-4 relative: a later layer carries the
  rounding of every earlier one), the unwritten row bit-identical;
* the jamba slot ``EngineCore`` against the JAX slot engine: equal greedy
  streams and ``prefill_calls``/``decode_calls``/``iterations`` with three
  requests on two slots, so that the third request starts from the Mamba
  state its slot's previous owner left (the reference never resets a
  reused slot; a slot of its own gives another stream);
* qwen2-moe's paged steps (ragged chunked prefill, decode) and its paged
  engine's greedy tokens against JAX's, with ``spec_k`` 0 and 4.

Prompts are chosen for few distinct chunk lengths: the JAX slot engine
compiles one chunk function per length."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.serving.engine as JE  # noqa: E402
import repro_torch.serving.engine as TE  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import SlidingServeScheduler as JScheduler  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.request import Request as JRequest  # noqa: E402
from repro_torch import params as TP  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import SlidingServeScheduler  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

JAMBA = "jamba-1.5-large-398b"
QWEN = "qwen2-moe-a2.7b"
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
STATE_TOL = dict(atol=1e-5, rtol=1e-4)


def _setup(arch):
    jcfg = jget_config(arch).smoke()
    tcfg = get_config(arch).smoke()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = TP.from_jax_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def jamba():
    return _setup(JAMBA)


def _leaves(tree, path=""):
    """{path: leaf} of a params/cache tree (numpy or torch leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_leaves(tree[k], f"{path}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{path}/{i}"))
        return out
    return {path: tree}


def _signature(tree):
    return {p: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for p, v in _leaves(tree).items()}


def _caches_close(jcache, tcache):
    want = _leaves(jax.tree.map(np.asarray, jcache))
    got = _leaves(tcache)
    assert sorted(got) == sorted(want)
    for p, w in want.items():
        np.testing.assert_allclose(got[p].float().numpy(), w, err_msg=p,
                                   **STATE_TOL)


def test_init_params_and_cache_trees_match_jax(jamba):
    jcfg, tcfg, jparams, _ = jamba
    drawn = TP.init_params(tcfg, seed=0, device="cpu")
    assert _signature(drawn) == _signature(jax.tree.map(np.asarray, jparams))
    mamba = drawn["stacks"][0][0]["mamba"]
    for name in ("A_log", "dt_bias", "D"):
        assert mamba[name].dtype == torch.float32, name
    assert torch.equal(mamba["A_log"][0, 0], torch.log(torch.arange(
        1, tcfg.mamba_d_state + 1, dtype=torch.float32)))
    assert "moe" in drawn["stacks"][0][1] and "lm_head" in drawn
    jcache = JM.init_cache(jcfg, 3, 64)
    tcache = TM.init_cache(tcfg, 3, 64)
    assert _signature(tcache) == _signature(jax.tree.map(np.asarray, jcache))
    # the JAX cache carried across: KV rows and Mamba state, dtypes kept
    carried = TP.from_jax_numpy(tcfg, jax.tree.map(np.asarray, jcache))
    assert _signature(carried) == _signature(tcache)
    assert not TM.supports_paged_cache(tcfg)


def test_jamba_steps_match_jax(jamba):
    """Three chunks of exact lengths (37, 1, 26) into fresh slot rows, a
    decode of every row, then one that writes only row 1 (the JAX engine
    runs every row and merges the kept row's cache back)."""
    jcfg, tcfg, jparams, tparams = jamba
    rctx = JM.RunCtx()
    B = 2
    jcache = JM.init_cache(jcfg, B, 128)
    tcache = TM.init_cache(tcfg, B, 128)
    rng = np.random.default_rng(0)
    V = tcfg.vocab_size
    pos = 0
    for S in (37, 1, 26):
        tok = rng.integers(1, V, (B, S)).astype(np.int32)
        jl, jcache = JM.chunk_prefill_step(jcfg, jparams, jnp.asarray(tok),
                                           jcache, pos, rctx=rctx)
        tl, tcache = TM.chunk_prefill_step(tcfg, tparams,
                                           torch.from_numpy(tok), tcache, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        _caches_close(jcache, tcache)
        pos += S
    lens = np.asarray([pos + 1, pos + 1], np.int32)
    tok = rng.integers(1, V, (B, 1)).astype(np.int32)
    jl, jcache = JM.decode_step(jcfg, jparams, jnp.asarray(tok), jcache, 0,
                                rctx=rctx, lengths=jnp.asarray(lens))
    tl, tcache = TM.decode_step(tcfg, tparams, torch.from_numpy(tok), tcache,
                                0, lengths=torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _caches_close(jcache, tcache)

    before = {p: v.clone() for p, v in _leaves(tcache).items()}
    tok = rng.integers(1, V, (B, 1)).astype(np.int32)
    jl, jnew = JM.decode_step(jcfg, jparams, jnp.asarray(tok), jcache, 0,
                              rctx=rctx, lengths=jnp.asarray(lens + 1))
    keep = jnp.asarray([False, True])
    jcache = jax.tree.map(
        lambda n, o: jnp.where(keep.reshape((1, -1) + (1,) * (n.ndim - 2)),
                               n, o), jnew, jcache)
    tl, tcache = TM.decode_step(tcfg, tparams, torch.from_numpy(tok), tcache,
                                0, lengths=torch.from_numpy(lens + 1),
                                write_rows=torch.tensor([1]))
    np.testing.assert_allclose(tl.numpy()[1], np.asarray(jl)[1], **LOGIT_TOL)
    _caches_close(jcache, tcache)
    for p, t in _leaves(tcache).items():       # row 0 was not written
        assert torch.equal(t[:, 0], before[p][:, 0]), p


# ---------------------------------------------------------------------------
# the jamba slot engine against the JAX slot engine
# ---------------------------------------------------------------------------
# (arrival, prompt_len, max_output): three requests on two slots, the third
# starts from the state a finished request left in its slot
REUSE = [(0.0, 24, 3), (0.0, 24, 6), (0.0, 24, 4)]


def _requests(spec, cls=Request):
    return [cls(rid=i, arrival=a, prompt_len=p, max_output=o,
                ttft_slo=900.0, tbt_slo=900.0)
            for i, (a, p, o) in enumerate(spec)]


def _prompts(cfg, spec, seed):
    rng = np.random.default_rng(seed)
    return {i: rng.integers(1, cfg.vocab_size, p).astype(np.int32)
            for i, (_, p, _) in enumerate(spec)}


def _serve(eng, spec, prompts, cls=Request):
    out = eng.serve(_requests(spec, cls),
                    {k: v.copy() for k, v in prompts.items()},
                    max_wall_s=900.0)
    assert not out["unfinished"]
    return out


def _sched():
    return SlidingServeScheduler(max_budget=256, max_iter_time=5.0)


def test_jamba_slot_engine_matches_jax_slot_engine(monkeypatch):
    cfg = jget_config(JAMBA).smoke()
    jeng = JE.EngineCore(cfg, JScheduler(max_budget=256, max_iter_time=5.0),
                         seed=0, cache_mode="slot", max_slots=2, max_len=512)
    prompts = _prompts(cfg, REUSE, 1)
    want = _serve(jeng, REUSE, prompts, JRequest)["outputs"]
    tcfg = get_config(JAMBA).smoke()
    params = TP.from_jax_numpy(tcfg, jax.tree.map(np.asarray, jeng.params))
    eng = TE.EngineCore(tcfg, _sched(), cache_mode="auto", max_slots=2,
                        max_len=512, params=params, device="cpu")
    assert eng.cache_mode == "slot"
    seen = []
    orig = TM.chunk_prefill_step

    def spy(cfg_, params_, tokens, *args, **kwargs):
        seen.append(tokens.shape[1])
        return orig(cfg_, params_, tokens, *args, **kwargs)
    monkeypatch.setattr(TE, "chunk_prefill_step", spy)
    out = _serve(eng, REUSE, prompts)
    assert out["outputs"] == want
    for key in ("prefill_calls", "decode_calls", "iterations"):
        assert getattr(eng.stats, key) == getattr(jeng.stats, key), key
    # exact-length chunks: no padding token reached the Mamba state
    assert sum(seen) == sum(p for _, p, _ in REUSE)
    assert sorted(eng.free_slots) == [0, 1] and not eng.slot_of
    # the last request took a slot a finished one left: in a slot of its
    # own (a third slot) it gives another stream
    fresh = TE.EngineCore(tcfg, _sched(), cache_mode="slot", max_slots=3,
                          max_len=512, params=params, device="cpu")
    alone = _serve(fresh, REUSE, prompts)["outputs"]
    assert alone[2] != want[2]
    assert alone[0] == want[0] and alone[1] == want[1]


def test_jamba_paged_cache_raises(jamba):
    _, tcfg, _, tparams = jamba
    with pytest.raises(ValueError):
        TE.EngineCore(tcfg, _sched(), cache_mode="paged", params=tparams,
                      device="cpu")
    with pytest.raises(ValueError):
        TM.init_paged_cache(tcfg, 4, 16)


# ---------------------------------------------------------------------------
# qwen2-moe-a2.7b over the paged cache
# ---------------------------------------------------------------------------
PS = 16


def test_qwen2_moe_paged_steps_match_jax():
    """A ragged chunk step (a full chunk, a short prompt, a padding row whose
    writes go to the trash page), then a decode step of the two rows: equal
    token ids, pools to 2e-5."""
    jcfg, tcfg, jparams, tparams = _setup(QWEN)
    P = 8
    jcache = JM.init_paged_cache(jcfg, P, PS)
    tcache = TM.init_paged_cache(tcfg, P, PS)
    rng = np.random.default_rng(4)
    trash = (P - 1) * PS
    tok = rng.integers(1, tcfg.vocab_size, (3, 16)).astype(np.int32)
    pos = np.zeros(3, np.int32)
    lens = np.asarray([16, 5, 0], np.int32)
    at = np.asarray([15, 4, 0], np.int32)
    tables = np.asarray([[0, 1], [2, 3], [0, 0]], np.int32)
    slots = np.full((3, 16), trash, np.int32)
    slots[0] = np.arange(16)
    slots[1, :5] = 2 * PS + np.arange(5)
    kw = dict(row_lens=lens, block_tables=tables, write_slots=slots.reshape(-1),
              logits_at=at)
    jids, jcache = JM.paged_chunk_step(
        jcfg, jparams, jnp.asarray(tok), jcache, jnp.asarray(pos),
        rctx=JM.RunCtx(), **{k: jnp.asarray(v) for k, v in kw.items()})
    tids, tcache = TM.paged_chunk_step(
        tcfg, tparams, torch.from_numpy(tok), tcache, torch.from_numpy(pos),
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert tids[:2].tolist() == np.asarray(jids)[:2].tolist()

    dtok = np.asarray([[int(tids[0])], [int(tids[1])]], np.int32)
    dlens = np.asarray([17, 6], np.int32)
    dslots = np.asarray([PS + 0, 2 * PS + 5], np.int32)
    dkw = dict(lengths=dlens, block_tables=tables[:2], write_slots=dslots)
    jids, jcache = JM.paged_decode_step(
        jcfg, jparams, jnp.asarray(dtok), jcache, rctx=JM.RunCtx(),
        **{k: jnp.asarray(v) for k, v in dkw.items()})
    tids, tcache = TM.paged_decode_step(
        tcfg, tparams, torch.from_numpy(dtok), tcache,
        **{k: torch.from_numpy(v) for k, v in dkw.items()})
    assert tids.tolist() == np.asarray(jids).tolist()
    for js, ts in zip(jcache, tcache):
        for jslot, tslot in zip(js, ts):
            np.testing.assert_allclose(tslot["kv_pages"].numpy(),
                                       np.asarray(jslot["kv_pages"]),
                                       atol=2e-5, rtol=2e-5)


# periodic prompts (the n-gram drafter's best case, as in
# tests/test_torch_engine.py), so that speculation drafts at spec_k 4
SPEC = [(0.0, 32, 6) for _ in range(4)]


@pytest.mark.parametrize("spec_k", [0, 4])
def test_qwen2_moe_paged_engine_matches_jax(spec_k):
    """Equal greedy streams, and at spec_k 4 the same drafting, acceptance
    and round counts."""
    cfg = jget_config(QWEN).smoke()
    jeng = JE.EngineCore(cfg, JScheduler(max_budget=256, max_iter_time=5.0),
                         seed=0, cache_mode="paged", kv_capacity_tokens=2048,
                         spec_k=spec_k)
    rng = np.random.default_rng(11)
    prompts = {i: np.tile(rng.integers(1, cfg.vocab_size, 12), 3)[:32]
               .astype(np.int32) for i in range(len(SPEC))}
    want = _serve(jeng, SPEC, prompts, JRequest)["outputs"]
    tcfg = get_config(QWEN).smoke()
    params = TP.from_jax_numpy(tcfg, jax.tree.map(np.asarray, jeng.params))
    eng = TE.EngineCore(tcfg, _sched(), kv_capacity_tokens=2048,
                        spec_k=spec_k, params=params, device="cpu")
    assert eng.cache_mode == "paged"
    out = _serve(eng, SPEC, prompts)
    assert out["outputs"] == want
    assert eng.stats.token_readbacks == eng.stats.iterations
    for key in ("spec_rounds", "spec_drafts", "spec_accepted", "iterations"):
        assert getattr(eng.stats, key) == getattr(jeng.stats, key), key
    assert (eng.stats.spec_drafts > 0) == (spec_k > 0)
    assert eng.alloc.free_blocks == eng.alloc.num_blocks
