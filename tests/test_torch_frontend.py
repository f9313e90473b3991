"""PyTorch port: the network front door (verbatim copies of the reference's
``frontend/`` package) over the port's engine on the CPU, with the
llama3.2-3b smoke parameters carried across from JAX seed 0.

Every test of ``tests/test_frontend.py`` runs against the port: prefix
directory semantics, in-flight burst sharing, ``close`` draining in paged
and slot mode, stragglers aborted at the deadline, router affinity, spill
and round-robin, router parity with a single engine, HTTP/SSE parity with
the in-process API, cancel reclaiming pages, speculative bursts over SSE,
stats and the draining 503. Beside them, cross-checks with the JAX
package: the same submissions through the JAX ``EngineRouter`` and the
port's give equal placements, greedy streams, directory hits and
cache-hit tokens, and per-request SSE streams through the JAX
``HttpFrontend`` and the port's are equal."""
import asyncio
import threading
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import SlidingServeScheduler as JScheduler  # noqa: E402
from repro.frontend.client import EngineHttpClient as JClient  # noqa: E402
from repro.frontend.http_server import HttpFrontend as JFrontend  # noqa: E402
from repro.frontend.http_server import build_backend as jbuild  # noqa: E402
from repro.frontend.router import EngineRouter as JRouter  # noqa: E402
from repro.frontend.router import LocalReplica as JReplica  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.server import InferenceServer as JServer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import SlidingServeScheduler  # noqa: E402
from repro_torch.frontend.client import EngineHttpClient  # noqa: E402
from repro_torch.frontend.http_server import (HttpFrontend,  # noqa: E402
                                              build_backend)
from repro_torch.frontend.prefix_directory import PrefixDirectory  # noqa: E402
from repro_torch.frontend.router import EngineRouter, LocalReplica  # noqa: E402
from repro_torch.params import from_jax_numpy  # noqa: E402
from repro_torch.serving.block_allocator import (ROOT_CHAIN,  # noqa: E402
                                                 page_chain_hash)
from repro_torch.serving.server import InferenceServer  # noqa: E402


@pytest.fixture(scope="module")
def cfg():
    return get_config("llama3.2-3b").smoke()


@pytest.fixture(scope="module")
def params(cfg):
    """JAX seed 0's parameters (what every reference engine draws), carried
    across: greedy tokens then depend only on the prompt, in both
    packages."""
    jcfg = jget_config("llama3.2-3b").smoke()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return from_jax_numpy(cfg, jax.tree.map(np.asarray, jp))


def _server(cfg, params, **kw):
    kw.setdefault("max_budget", 256)
    budget = kw.pop("max_budget")
    kw.setdefault("kv_capacity_tokens", 2048)
    kw.setdefault("cache_mode", "paged")
    return InferenceServer.build(
        cfg, scheduler=SlidingServeScheduler(max_budget=budget,
                                             max_iter_time=5.0),
        params=params, device="cpu", **kw)


def _jserver(**kw):
    return JServer.build(
        jget_config("llama3.2-3b").smoke(),
        scheduler=JScheduler(max_budget=256, max_iter_time=5.0),
        cache_mode="paged", kv_capacity_tokens=2048, **kw)


# ---------------------------------------------------------------------------
# PrefixDirectory: pure unit semantics (no engine)
# ---------------------------------------------------------------------------
class TestPrefixDirectory:
    def test_chain_hashes_match_allocator_fold(self):
        d = PrefixDirectory(page_size=4)
        toks = list(range(10))
        chain = d.chain_hashes(toks)
        assert len(chain) == 2                      # whole pages only
        h0 = page_chain_hash(ROOT_CHAIN, toks[:4])
        assert chain == [h0, page_chain_hash(h0, toks[4:8])]

    def test_match_requires_contiguous_chain(self):
        d = PrefixDirectory(page_size=4)
        toks = list(range(12))
        chain = d.chain_hashes(toks)
        d.on_commit(0, chain[0])
        d.on_commit(0, chain[1])
        d.on_commit(1, chain[1])    # page 2 without page 1: unreachable
        assert d.match(toks) == {0: 8}

    def test_reclaim_drops_holder(self):
        d = PrefixDirectory(page_size=4)
        toks = list(range(8))
        chain = d.chain_hashes(toks)
        for h in chain:
            d.on_commit(0, h)
        assert d.match(toks) == {0: 8}
        d.on_reclaim(0, chain[1])
        assert d.match(toks) == {0: 4}
        d.on_reclaim(0, chain[0])
        assert d.match(toks) == {}
        assert d.pages_held(0) == 0

    def test_listener_adapter_and_stats(self):
        d = PrefixDirectory(page_size=4)
        lst = d.listener_for(2)
        h = page_chain_hash(ROOT_CHAIN, [1, 2, 3, 4])
        lst.on_commit(h, 1)
        assert d.match([1, 2, 3, 4, 9]) == {2: 4}
        st = d.stats()
        assert st["commits"] == 1 and st["hit_lookups"] == 1
        lst.on_reclaim(h)
        assert d.stats()["entries"] == 0


# ---------------------------------------------------------------------------
# in-flight burst sharing (defer-shared admission)
# ---------------------------------------------------------------------------
def _burst(cfg, n=4, system_len=64, unique_len=8, seed=3):
    rng = np.random.default_rng(seed)
    system = rng.integers(1, cfg.vocab_size, system_len).astype(np.int32)
    return {i: np.concatenate(
        [system, rng.integers(1, cfg.vocab_size, unique_len).astype(np.int32)])
        for i in range(n)}


def test_burst_sharing_defers_followers_and_saves_prefill(cfg, params):
    prompts = _burst(cfg)
    outs, computed, deferred = {}, {}, {}
    for defer in (True, False):
        srv = _server(cfg, params, defer_shared=defer)
        handles = {i: srv.submit(p.copy(), max_output=3)
                   for i, p in prompts.items()}
        srv.run(max_wall_s=900.0)
        assert all(h.finished for h in handles.values())
        outs[defer] = {i: list(h.collected) for i, h in handles.items()}
        computed[defer] = srv.core.stats.prefill_tokens
        deferred[defer] = srv.core.stats.deferred_admissions
    assert outs[True] == outs[False], "defer-shared changed greedy tokens"
    assert deferred[True] > 0, "burst never deferred a follower"
    assert deferred[False] == 0
    saved = computed[False] - computed[True]
    page = 16
    assert saved >= 3 * (64 // page * page - page), \
        f"only {saved} prefill tokens saved by deferral"


def test_defer_cannot_wedge_without_leader(cfg, params):
    srv = _server(cfg, params, defer_shared=True)
    h = srv.submit(np.arange(1, 40, dtype=np.int32), max_output=3)
    assert h.result(max_wall_s=900.0)
    assert srv.core.stats.deferred_admissions == 0


# ---------------------------------------------------------------------------
# graceful shutdown / drain
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["paged", "slot"])
def test_close_drains_and_reclaims(cfg, params, mode):
    srv = _server(cfg, params) if mode == "paged" else \
        InferenceServer.build(
            cfg, scheduler=SlidingServeScheduler(max_budget=256,
                                                 max_iter_time=5.0),
            cache_mode="slot", max_slots=4, max_len=512, params=params,
            device="cpu")
    rng = np.random.default_rng(0)
    hs = [srv.submit(rng.integers(1, cfg.vocab_size, 24).astype(np.int32),
                     max_output=3) for _ in range(3)]
    report = srv.close(drain_s=120.0)
    assert report["drained"] and report["finished"] == 3
    assert all(h.finished for h in hs)
    if mode == "paged":
        assert srv.core.alloc.free_blocks == srv.core.alloc.num_blocks
    else:
        assert len(srv.core.free_slots) == srv.core.max_slots
    with pytest.raises(RuntimeError):
        srv.submit(np.arange(1, 10, dtype=np.int32))
    assert srv.close() is report            # idempotent


def test_close_aborts_stragglers_at_deadline(cfg, params):
    srv = _server(cfg, params)
    h = srv.submit(np.arange(1, 60, dtype=np.int32), max_output=512)
    report = srv.close(drain_s=0.0)
    assert h.finished and h.aborted
    assert report["aborted"] == 1
    assert srv.core.alloc.free_blocks == srv.core.alloc.num_blocks


# ---------------------------------------------------------------------------
# router: affinity, spillover, zero-sync per replica
# ---------------------------------------------------------------------------
def test_router_affinity_lands_shared_stream_on_one_replica(cfg, params):
    router = EngineRouter([LocalReplica(i, _server(cfg, params))
                           for i in range(2)])
    prompts = _burst(cfg, n=4, seed=5)
    owners = []
    for p in prompts.values():
        h = router.submit(p.copy(), max_output=3)
        router.run(max_wall_s=900.0)
        assert h.finished
        owners.append(router.owner_of(h.rid))
    assert len(set(owners[1:])) == 1 and owners[1] == owners[0]
    assert router.affine_hits >= len(prompts) - 1
    assert router.directory.stats()["hit_rate"] > 0.5
    for rep in router.replicas:
        st = rep.server.core.stats
        assert st.token_readbacks == st.iterations
    assert router.close()["drained"]


def test_router_spills_when_holder_saturated(cfg, params):
    router = EngineRouter([LocalReplica(i, _server(cfg, params))
                           for i in range(2)], spill_factor=2.0)
    prompts = _burst(cfg, n=2, seed=6)
    first = router.submit(prompts[0].copy(), max_output=3)
    router.run(max_wall_s=900.0)
    holder = router.owner_of(first.rid)
    rng = np.random.default_rng(9)
    for _ in range(6):
        router.replicas[holder].server.submit(
            rng.integers(1, cfg.vocab_size, 120).astype(np.int32),
            max_output=64)
    h = router.submit(prompts[1].copy(), max_output=3)
    assert router.owner_of(h.rid) != holder
    assert router.spills == 1
    router.run(max_wall_s=900.0)
    router.close()


def test_router_round_robin_ignores_directory(cfg, params):
    router = EngineRouter([LocalReplica(i, _server(cfg, params))
                           for i in range(2)], policy="round-robin")
    for p in _burst(cfg, n=4, seed=7).values():
        router.submit(p.copy(), max_output=2)
        router.run(max_wall_s=900.0)
    assert router.routed == [2, 2]
    assert router.directory.stats()["lookups"] == 0
    router.close()


def test_router_parity_with_single_engine(cfg, params):
    prompts = _burst(cfg, n=3, seed=8)
    single = _server(cfg, params)
    ref = {i: single.submit(p.copy(), max_output=4).result(900.0)
           for i, p in prompts.items()}
    router = EngineRouter([LocalReplica(i, _server(cfg, params))
                           for i in range(2)])
    got = {}
    for i, p in prompts.items():
        h = router.submit(p.copy(), max_output=4)
        router.run(max_wall_s=900.0)
        got[i] = list(h.collected)
    assert got == ref, "routing changed greedy tokens"
    router.close()


def _router_traffic(router, cfg, policy_name):
    """A burst of four shared-prefix prompts submitted together, then two
    rounds of follow-ups (each prompt extended by its own output and a new
    user turn) one at a time. Returns placements, streams and counters."""
    prompts = _burst(cfg, n=4, seed=11)
    rng = np.random.default_rng(12)
    hs = {i: router.submit(p.copy(), max_output=3) for i, p in
          prompts.items()}
    router.run(max_wall_s=900.0)
    streams = {i: list(h.collected) for i, h in hs.items()}
    owners = {i: router.owner_of(h.rid) for i, h in hs.items()}
    for turn in range(2):
        for i in sorted(prompts):
            prompts[i] = np.concatenate(
                [prompts[i], np.asarray(streams[i][-3:], np.int32),
                 rng.integers(1, cfg.vocab_size, 5 + turn).astype(np.int32)])
            h = router.submit(prompts[i].copy(), max_output=3)
            router.run(max_wall_s=900.0)
            streams[i] = list(h.collected)
            owners[i, turn] = router.owner_of(h.rid)
    rep = router.routing_report()
    out = {"owners": owners, "streams": streams, "routed": rep["routed"],
           "spills": rep["spills"], "affine_hits": rep["affine_hits"],
           "directory": {k: rep["directory"][k] for k in (
               "lookups", "hit_lookups", "commits", "reclaims",
               "routed_hit_tokens")},
           "cache_hit_tokens": [r.server.core.stats.cache_hit_tokens
                                for r in router.replicas],
           "prefill_tokens": [r.server.core.stats.prefill_tokens
                              for r in router.replicas]}
    for r in router.replicas:
        st = r.server.core.stats
        assert st.token_readbacks == st.iterations, policy_name
    assert router.close()["drained"]
    return out


@pytest.mark.parametrize("policy", ["prefix-affine", "round-robin"])
def test_router_matches_jax_router(cfg, params, policy):
    """The same submissions through two replicas of the JAX engine and of
    the port's: equal placements, greedy streams, spills, directory
    counters and per-replica cache-hit and prefill tokens."""
    want = _router_traffic(JRouter([JReplica(i, _jserver())
                                    for i in range(2)], policy=policy),
                           cfg, policy)
    got = _router_traffic(EngineRouter([LocalReplica(i, _server(cfg, params))
                                        for i in range(2)], policy=policy),
                          cfg, policy)
    assert got == want
    if policy == "prefix-affine":
        assert sum(got["cache_hit_tokens"]) > 0
        assert got["directory"]["hit_lookups"] > 0
    else:
        assert got["directory"]["lookups"] == 0


# ---------------------------------------------------------------------------
# HTTP/SSE transport (in-thread server)
# ---------------------------------------------------------------------------
def _start(fe, client_cls):
    th = threading.Thread(target=lambda: asyncio.run(fe.serve_forever()),
                          daemon=True)
    th.start()
    cli = client_cls(port=0, timeout=300.0)
    t_end = time.perf_counter() + 60.0
    while fe.port == 0 and time.perf_counter() < t_end:
        time.sleep(0.02)
    cli.port = fe.port
    cli.wait_ready(60.0)
    return th, cli


def _stop(fe, th):
    fe.request_stop()
    th.join(timeout=60.0)
    assert not th.is_alive(), "HTTP server failed to drain on stop"


@pytest.fixture()
def http_fe(cfg, params):
    backend = build_backend(replicas=1, kv_tokens=2048, max_budget=256,
                            params=params, device="cpu")
    fe = HttpFrontend(backend, port=0, drain_s=30.0)
    th, cli = _start(fe, EngineHttpClient)
    yield fe, cli, backend
    _stop(fe, th)


def test_http_sse_parity_with_inprocess(cfg, params, http_fe):
    fe, cli, backend = http_fe
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (24, 40, 33)]
    ref_srv = _server(cfg, params)
    ref = [ref_srv.submit(np.asarray(p, np.int32), max_output=4).result(900.0)
           for p in prompts]
    got = [cli.generate(p, max_output=4).result() for p in prompts]
    assert got == ref, "SSE stream diverged from the in-process API"


def test_http_cancel_mid_stream_reclaims_pages(cfg, http_fe):
    fe, cli, backend = http_fe
    rng = np.random.default_rng(4)
    h = cli.generate(rng.integers(1, cfg.vocab_size, 48).tolist(),
                     max_output=512)
    seen = 0
    for _ in h.tokens():
        seen += 1
        if seen == 1:
            assert h.cancel()
    assert h.aborted and seen < 512
    core = backend.core
    t_end = time.perf_counter() + 60.0
    while core.has_work() and time.perf_counter() < t_end:
        time.sleep(0.02)
    held = core.alloc.num_blocks - core.alloc.free_blocks
    assert held == 0, f"{held} pages still live after HTTP cancel"
    assert core.stats.aborted == 1


@pytest.fixture()
def http_fe_spec(cfg, params):
    """Front door over a speculating engine whose drafter replays the known
    greedy stream: every draft is accepted, so each decode round emits a
    multi-token burst."""
    from repro_torch.serving.drafter import DrafterBase

    rng = np.random.default_rng(12)
    prompt = rng.integers(1, cfg.vocab_size, 24).astype(np.int32)
    ref = _server(cfg, params).submit(prompt.copy(),
                                      max_output=8).result(900.0)

    class ReplayDrafter(DrafterBase):
        def propose(self, context, k):
            gen = len(context) - len(prompt)
            if gen < 0 or gen >= len(ref):
                return None
            out = np.asarray(ref[gen:gen + k], np.int32)
            return out if len(out) else None

    backend = build_backend(replicas=1, kv_tokens=2048, max_budget=256,
                            spec_k=4, drafter=ReplayDrafter(), params=params,
                            device="cpu")
    fe = HttpFrontend(backend, port=0, drain_s=30.0)
    th, cli = _start(fe, EngineHttpClient)
    yield cli, backend, prompt, ref
    _stop(fe, th)


def test_http_sse_batches_speculative_bursts(cfg, http_fe_spec):
    cli, backend, prompt, ref = http_fe_spec
    h = cli.generate(prompt.tolist(), max_output=8)
    assert h.result() == ref, "speculative SSE stream diverged from greedy"
    frames = [d for name, d in h.events if name == "token"]
    assert frames, "no token frames seen"
    assert all("tokens" in d and d["token"] == d["tokens"][0] for d in frames)
    assert any(len(d["tokens"]) > 1 for d in frames), \
        "full-acceptance speculation never batched an SSE frame"
    fin = next(d for name, d in h.events if name == "finished")
    assert fin["n_tokens"] == len(ref)
    st = cli.stats()["engine"]
    assert st["spec_accepted"] > 0
    assert st["token_readbacks"] == st["iterations"]


def test_http_stats_and_draining_rejection(cfg, http_fe):
    fe, cli, backend = http_fe
    rng = np.random.default_rng(5)
    cli.generate(rng.integers(1, cfg.vocab_size, 24).tolist(),
                 max_output=2).result()
    st = cli.stats()
    assert st["engine"]["iterations"] > 0
    assert st["engine"]["token_readbacks"] == st["engine"]["iterations"]
    assert "cache_info" in st and "per_class" in st
    assert cli.load()["outstanding_tokens"] == 0
    assert cli.prefix_feed()["next"] > 0    # commits were exported
    # the draining 503: while the server drains, generate is refused
    fe._stopping = True
    assert cli.healthz() == {"ok": True, "draining": True}
    with pytest.raises(RuntimeError, match="503"):
        cli.generate([1, 2, 3], max_output=2)
    fe._stopping = False


def test_http_streams_match_jax_frontend(cfg, params):
    """The same prompts, concurrently, through the JAX ``HttpFrontend`` and
    the port's, each over two replicas behind the prefix-affine router:
    equal per-request token streams and terminal frames."""
    rng = np.random.default_rng(6)
    system = rng.integers(1, cfg.vocab_size, 40).tolist()
    prompts = [system + rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (5, 9, 17)] + [rng.integers(1, cfg.vocab_size,
                                                    30).tolist()]
    out = {}
    for name, (frontend, client, backend) in {
            "jax": (JFrontend, JClient,
                    jbuild(replicas=2, kv_tokens=2048, max_budget=256)),
            "port": (HttpFrontend, EngineHttpClient,
                     build_backend(replicas=2, kv_tokens=2048,
                                   max_budget=256, params=params,
                                   device="cpu"))}.items():
        fe = frontend(backend, port=0, drain_s=30.0)
        th, cli = _start(fe, client)
        try:
            hs = [cli.generate(p, max_output=5) for p in prompts]
            out[name] = [(h.result(), h.aborted,
                          next(d["n_tokens"] for n, d in h.events
                               if n == "finished")) for h in hs]
        finally:
            _stop(fe, th)
    assert out["port"] == out["jax"]
    assert all(len(toks) == 5 for toks, _, _ in out["port"])
