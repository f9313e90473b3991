"""PyTorch port, slot mode: the chunk attention, ``chunk_prefill_step`` and
``decode_step`` of the llama3.2-3b smoke config against the JAX functions on
the same parameters and caches (fp32, logits to 1e-4), including a
bucket-padded chunk whose write is clamped at ``max_len``; the slot
``EngineCore`` against the JAX slot engine (equal greedy streams and equal
``prefill_calls``/``decode_calls``/``iterations``); slot against paged
within the port; cancellation through ``InferenceServer`` returning the
slot; and the launcher in slot mode."""
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
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.serving.server import InferenceServer  # noqa: E402

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config("llama3.2-3b").smoke()
    tcfg = get_config("llama3.2-3b").smoke()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = TP.from_jax_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


def _to_torch(cfg, jcache):
    return TP.from_jax_numpy(cfg, jax.tree.map(np.asarray, jcache))


def _caches_close(jcache, tcache):
    for js, ts in zip(jcache, tcache):
        for jslot, tslot in zip(js, ts):
            for name in ("k", "v"):
                np.testing.assert_allclose(tslot[name].numpy(),
                                           np.asarray(jslot[name]),
                                           **CACHE_TOL)


# ---------------------------------------------------------------------------
# model functions against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pos,Sq,window,ragged", [
    (0, 16, 0, False), (37, 9, 0, False), (20, 16, 12, False),
    (30, 16, 0, True)])
def test_chunk_attend_matches_jax(setup, pos, Sq, window, ragged):
    jcfg, tcfg, _, _ = setup
    rng = np.random.default_rng(pos + Sq)
    B, S = 2, 64
    Hkv, D = tcfg.num_kv_heads, tcfg.resolved_head_dim
    G = tcfg.num_heads // Hkv
    q = rng.normal(size=(B, Sq, Hkv, G, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    lengths = np.asarray([pos + Sq, pos + Sq - 5], np.int32) if ragged \
        else None
    want = JM._chunk_attend(jcfg, JM.RunCtx(), jnp.asarray(q), jnp.asarray(k),
                            jnp.asarray(v), pos,
                            None if lengths is None else jnp.asarray(lengths),
                            window)
    got = TM._chunk_attend(tcfg, torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), pos,
                           None if lengths is None
                           else torch.from_numpy(lengths), window)
    assert got.shape == (B, Sq, Hkv, G, D)
    valid = np.ones((B, Sq), bool)
    if ragged:      # queries past a row's length see no key in JAX either
        valid = (pos + np.arange(Sq))[None, :] < lengths[:, None]
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                               atol=2e-5, rtol=2e-5)


def test_chunk_attend_rejects_ragged_offsets(setup):
    _, tcfg, _, _ = setup
    q = torch.zeros((2, 4, 2, 2, 16))
    k = torch.zeros((2, 32, 2, 16))
    with pytest.raises(NotImplementedError):
        TM._chunk_attend(tcfg, q, k, k, torch.tensor([0, 3]), None, 0)


def test_slot_steps_match_jax(setup):
    """Two chunks into a fresh cache (the second at an offset, bucket-padded
    to 16, logits at its last real token), then ragged decode rows."""
    jcfg, tcfg, jparams, tparams = setup
    rctx = JM.RunCtx()
    B, S = 2, 128
    jcache = JM.init_cache(jcfg, B, S)
    tcache = TM.init_cache(tcfg, B, S)
    assert [[{n: tuple(t.shape) for n, t in c.items()} for c in st]
            for st in tcache] == \
        [[{n: tuple(a.shape) for n, a in c.items()} for c in st]
         for st in jcache]
    rng = np.random.default_rng(0)
    V = tcfg.vocab_size
    for pos, at in ((0, -1), (16, 10)):
        tok = rng.integers(1, V, (B, 16)).astype(np.int32)
        jl, jcache = JM.chunk_prefill_step(jcfg, jparams, jnp.asarray(tok),
                                           jcache, pos, rctx=rctx,
                                           logits_at=at)
        tl, tcache = TM.chunk_prefill_step(tcfg, tparams,
                                           torch.from_numpy(tok), tcache, pos,
                                           logits_at=at)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        _caches_close(jcache, tcache)
    for lens in ([33, 27], [34, 28]):
        lens = np.asarray(lens, np.int32)
        tok = rng.integers(1, V, (B, 1)).astype(np.int32)
        jl, jcache = JM.decode_step(jcfg, jparams, jnp.asarray(tok), jcache, 0,
                                    rctx=rctx, lengths=jnp.asarray(lens))
        tl, tcache = TM.decode_step(tcfg, tparams, torch.from_numpy(tok),
                                    tcache, 0, lengths=torch.from_numpy(lens))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        _caches_close(jcache, tcache)


def test_slot_steps_from_carried_cache_and_clamped_write(setup):
    """Start both frameworks from the same non-empty cache (the JAX one,
    carried across), then a bucket-padded chunk that ends past ``max_len``
    (its write is clamped to ``max_len - Sq``, as ``dynamic_update_slice``
    clamps it), a lockstep decode at a scalar ``pos``, and a decode whose
    writes are limited to one row."""
    jcfg, tcfg, jparams, tparams = setup
    rctx = JM.RunCtx()
    B, S = 2, 64
    rng = np.random.default_rng(1)
    V = tcfg.vocab_size
    jcache = JM.init_cache(jcfg, B, S)
    tok = rng.integers(1, V, (B, 32)).astype(np.int32)
    _, jcache = JM.chunk_prefill_step(jcfg, jparams, jnp.asarray(tok), jcache,
                                      0, rctx=rctx)
    tcache = _to_torch(tcfg, jcache)
    _caches_close(jcache, tcache)

    tok = rng.integers(1, V, (B, 32)).astype(np.int32)
    jl, jcache = JM.chunk_prefill_step(jcfg, jparams, jnp.asarray(tok), jcache,
                                       40, rctx=rctx, logits_at=20)
    tl, tcache = TM.chunk_prefill_step(tcfg, tparams, torch.from_numpy(tok),
                                       tcache, 40, logits_at=20)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _caches_close(jcache, tcache)
    # the clamp put the chunk at [32, 64), not at [40, 72)
    assert not np.allclose(np.asarray(jcache[0][0]["k"])[:, :, 32], 0)

    tok = rng.integers(1, V, (B, 1)).astype(np.int32)
    jl, jcache = JM.decode_step(jcfg, jparams, jnp.asarray(tok), jcache, 30,
                                rctx=rctx)
    tl, tcache = TM.decode_step(tcfg, tparams, torch.from_numpy(tok), tcache,
                                30)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _caches_close(jcache, tcache)

    # one kept row: the JAX engine runs every row and merges back the kept
    # row's cache; the port writes only that row
    lens = np.asarray([20, 25], np.int32)
    tok = rng.integers(1, V, (B, 1)).astype(np.int32)
    jl, jnew = JM.decode_step(jcfg, jparams, jnp.asarray(tok), jcache, 0,
                              rctx=rctx, lengths=jnp.asarray(lens))
    keep = jnp.asarray([False, True])
    jcache = jax.tree.map(
        lambda n, o: jnp.where(keep.reshape((1, -1) + (1,) * (n.ndim - 2)),
                               n, o), jnew, jcache)
    tl, tcache = TM.decode_step(tcfg, tparams, torch.from_numpy(tok), tcache,
                                0, lengths=torch.from_numpy(lens),
                                write_rows=torch.tensor([1]))
    np.testing.assert_allclose(tl.numpy()[1], np.asarray(jl)[1], **LOGIT_TOL)
    _caches_close(jcache, tcache)


# ---------------------------------------------------------------------------
# the slot engine against the JAX slot engine
# ---------------------------------------------------------------------------
SPEC = [(0.0, 24, 4), (0.0, 51, 4), (0.0, 37, 3)]   # tests/test_paged_engine.py
SPLIT_SPEC = [(0.0, 100, 2)]   # the split-allocation scenario, buckets (16, 32)


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


def _torch_engine(cfg, params, **kw):
    return TE.EngineCore(cfg, SlidingServeScheduler(max_budget=256,
                                                    max_iter_time=5.0),
                         params=params, device="cpu", **kw)


SCENARIOS = {"paged_engine_spec": (SPEC, 1, None),
             "split_allocation": (SPLIT_SPEC, 4, (16, 32))}


@pytest.fixture(scope="module")
def jax_slot_runs():
    """The JAX slot engine (max_slots 2, weights from seed 0) on each
    scenario, and its parameters as torch tensors."""
    cfg = jget_config("llama3.2-3b").smoke()
    runs = {}
    params = None
    for name, (spec, seed, buckets) in SCENARIOS.items():
        mp = pytest.MonkeyPatch()
        if buckets:
            mp.setattr(JE, "CHUNK_BUCKETS", buckets)
        eng = JE.EngineCore(cfg, JScheduler(max_budget=256, max_iter_time=5.0),
                            seed=0, cache_mode="slot", max_slots=2,
                            max_len=512)
        prompts = _prompts(cfg, spec, seed)
        out = _serve(eng, spec, prompts, JRequest)
        mp.undo()
        runs[name] = (prompts, out["outputs"], eng.stats)
        if params is None:
            params = jax.tree.map(np.asarray, eng.params)
    tcfg = get_config("llama3.2-3b").smoke()
    return tcfg, TP.from_jax_numpy(tcfg, params), runs


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_slot_engine_matches_jax_slot_engine(jax_slot_runs, scenario,
                                             monkeypatch):
    cfg, params, runs = jax_slot_runs
    spec, _, buckets = SCENARIOS[scenario]
    if buckets:
        monkeypatch.setattr(TE, "CHUNK_BUCKETS", buckets)
    prompts, want, jstats = runs[scenario]
    eng = _torch_engine(cfg, params, cache_mode="slot", max_slots=2,
                        max_len=512)
    out = _serve(eng, spec, prompts)
    assert out["outputs"] == want
    for key in ("prefill_calls", "decode_calls", "iterations"):
        assert getattr(eng.stats, key) == getattr(jstats, key), key
    if buckets:
        assert eng.stats.prefill_calls >= 4   # 100 tokens over 32-token chunks
    assert sorted(eng.free_slots) == [0, 1] and not eng.slot_of


def test_slot_equals_paged_in_the_port(jax_slot_runs):
    cfg, params, runs = jax_slot_runs
    prompts, _, _ = runs["paged_engine_spec"]
    slot = _serve(_torch_engine(cfg, params, cache_mode="slot", max_slots=4,
                                max_len=512), SPEC, prompts)
    paged_eng = _torch_engine(cfg, params, cache_mode="paged",
                              kv_capacity_tokens=2048)
    paged = _serve(paged_eng, SPEC, prompts)
    assert slot["outputs"] == paged["outputs"]
    assert paged_eng.stats.evictions == 0


def test_slot_mode_turns_off_speculation_and_prefix_cache(jax_slot_runs):
    cfg, params, _ = jax_slot_runs
    eng = _torch_engine(cfg, params, cache_mode="slot", spec_k=4,
                        prefix_cache=True, max_slots=2, max_len=64)
    assert eng.spec_k == 0 and not eng.prefix_cache
    assert eng.cache_info()["prefix_cache"] is False
    assert eng.shard_info()["kv_shards"] == 1
    assert tuple(eng.cache[0][0]["k"].shape) == (
        cfg.num_layers, 2, 64, cfg.num_kv_heads, cfg.resolved_head_dim)


def test_server_cancel_mid_decode_returns_the_slot(jax_slot_runs):
    """As tests/test_streaming_server.py's cancellation test in slot mode:
    the victim's slot returns at once, the other streams are unchanged."""
    cfg, params, runs = jax_slot_runs
    spec = [(0.0, 24, 6), (0.0, 51, 4), (0.0, 37, 3)]
    prompts = _prompts(cfg, spec, 1)
    ref = _serve(_torch_engine(cfg, params, cache_mode="slot", max_slots=4,
                               max_len=512), spec, prompts)
    core = _torch_engine(cfg, params, cache_mode="slot", max_slots=4,
                         max_len=512)
    server = InferenceServer(core)
    handles = {r.rid: server.submit_request(r, prompts[r.rid].copy())
               for r in _requests(spec)}
    victim = handles[0]
    for _ in range(1000):
        server.step()
        if victim.collected and not victim.finished:
            break
    assert victim.collected and not victim.finished
    held = len(core.free_slots)
    victim.cancel()
    assert victim.aborted and len(core.free_slots) == held + 1
    assert 0 not in core.slot_of
    server.run(max_wall_s=600.0)
    for rid in (1, 2):
        assert handles[rid].collected == ref["outputs"][rid]
    assert sorted(core.free_slots) == list(range(core.max_slots))
    assert core.stats.aborted == 1 and not core.has_work()
    report = server.close(drain_s=5.0)
    assert report["finished"] == 2


def test_launcher_slot_mode_on_cpu():
    out = launcher.main(["--device", "cpu", "--cache-mode", "slot",
                         "--requests", "3", "--qps", "50"])
    assert len(out["finished"]) == 3
    assert all(len(h.collected) == h.request.max_output
               for h in out["finished"])
