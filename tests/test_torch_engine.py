"""PyTorch port: the paged ``EngineCore`` on the CPU against the JAX
``EngineCore`` (equal greedy token streams on the same parameters, and equal
prefix-cache and speculation counters), and the reference engine's
invariants within the port: one readback per round, at most two dispatches
per round, the same tokens with the prefix cache on and off and with
``spec_k`` 0 and 4, eviction under a small KV pool, abort returning pages,
streaming through ``InferenceServer``, and no silent CPU fallback. The
slot mode has its own file, ``tests/test_torch_slot.py``."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import SlidingServeScheduler as JScheduler  # noqa: E402
from repro.serving.engine import EngineCore as JEngine  # noqa: E402
from repro.serving.request import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import SlidingServeScheduler  # noqa: E402
from repro_torch.params import from_jax_numpy  # noqa: E402
from repro_torch.serving.engine import EngineCore  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.serving.server import InferenceServer  # noqa: E402

SPEC = [(0.0, 24, 4), (0.0, 51, 4), (0.0, 37, 3)]   # tests/test_paged_engine.py


def _requests(spec, cls=Request):
    return [cls(rid=i, arrival=a, prompt_len=p, max_output=o,
                ttft_slo=900.0, tbt_slo=900.0)
            for i, (a, p, o) in enumerate(spec)]


def _prompts(cfg, spec, seed=1):
    rng = np.random.default_rng(seed)
    return {i: rng.integers(1, cfg.vocab_size, p).astype(np.int32)
            for i, (_, p, _) in enumerate(spec)}


def _jax_serve(prompts, spec, **kw):
    """The JAX engine (weights from seed 0, as the module fixture's) on
    ``spec``; returns the engine and its serve() result."""
    jcfg = jget_config("llama3.2-3b").smoke()
    eng = JEngine(jcfg, JScheduler(max_budget=256, max_iter_time=5.0),
                  seed=0, cache_mode="paged", kv_capacity_tokens=2048, **kw)
    out = eng.serve(_requests(spec, JRequest),
                    {k: v.copy() for k, v in prompts.items()},
                    max_wall_s=900.0)
    assert not out["unfinished"]
    return eng, out


@pytest.fixture(scope="module")
def ref():
    """The JAX engine's run of the scenario, and its parameters as torch
    tensors."""
    cfg = get_config("llama3.2-3b").smoke()
    prompts = _prompts(cfg, SPEC)
    eng, out = _jax_serve(prompts, SPEC)
    params = from_jax_numpy(cfg, jax.tree.map(np.asarray, eng.params))
    return cfg, params, prompts, out["outputs"]


def _engine(cfg, params, **kw):
    kw.setdefault("kv_capacity_tokens", 2048)
    return EngineCore(cfg, SlidingServeScheduler(max_budget=256,
                                                 max_iter_time=5.0),
                      params=params, device="cpu", **kw)


def _serve(cfg, params, prompts, spec, **kw):
    eng = _engine(cfg, params, **kw)
    out = eng.serve(_requests(spec), {k: v.copy() for k, v in prompts.items()},
                    max_wall_s=900.0)
    assert not out["unfinished"]
    return eng, out


def test_greedy_tokens_match_jax_engine(ref):
    cfg, params, prompts, want = ref
    eng, out = _serve(cfg, params, prompts, SPEC)
    assert out["outputs"] == want
    st = eng.stats
    assert st.token_readbacks == st.iterations
    assert st.max_round_calls <= 2
    assert st.evictions == 0
    assert eng.alloc.free_blocks == eng.alloc.num_blocks


def test_overlap_off_same_tokens_more_transfers(ref):
    cfg, params, prompts, want = ref
    eng, out = _serve(cfg, params, prompts, SPEC, overlap=False)
    assert out["outputs"] == want
    assert eng.stats.token_readbacks > eng.stats.iterations


def test_prefix_cache_on_off_same_tokens(ref):
    """Requests sharing a 40-token prefix: cache hits on, same tokens off,
    and the JAX engine's tokens and hit/prefill counts with the cache on."""
    cfg, params, _, _ = ref
    rng = np.random.default_rng(5)
    shared = rng.integers(1, cfg.vocab_size, 40).astype(np.int32)
    spec = [(0.0, 56, 3), (0.0, 50, 3), (0.0, 61, 3)]
    prompts = {i: np.concatenate([shared, rng.integers(
        1, cfg.vocab_size, p - 40).astype(np.int32)])
        for i, (_, p, _) in enumerate(spec)}
    on, out_on = _serve(cfg, params, prompts, spec, prefix_cache=True)
    off, out_off = _serve(cfg, params, prompts, spec, prefix_cache=False)
    assert out_on["outputs"] == out_off["outputs"]
    assert on.stats.cache_hit_tokens > 0 and off.stats.cache_hit_tokens == 0
    assert on.stats.prefill_tokens < off.stats.prefill_tokens
    jeng, jout = _jax_serve(prompts, spec, prefix_cache=True)
    assert out_on["outputs"] == jout["outputs"]
    assert on.stats.cache_hit_tokens == jeng.stats.cache_hit_tokens
    assert on.stats.prefill_tokens == jeng.stats.prefill_tokens


def test_spec_k_same_tokens(ref):
    """Periodic prompts (the n-gram drafter's best case): verify rows run,
    the greedy stream equals plain decode, one readback per round, and the
    JAX engine at spec_k=4 gives the same tokens and the same drafting,
    acceptance and rollback counts."""
    cfg, params, _, _ = ref
    rng = np.random.default_rng(11)
    spec = [(0.0, 32, 6) for _ in range(4)]
    prompts = {i: np.tile(rng.integers(1, cfg.vocab_size, 12), 3)[:32]
               .astype(np.int32) for i in range(4)}
    eng, out = _serve(cfg, params, prompts, spec, spec_k=4)
    _, base = _serve(cfg, params, prompts, spec, spec_k=0)
    assert out["outputs"] == base["outputs"]
    info = eng.spec_info()
    assert info["spec_rounds"] > 0 and info["draft_tokens"] > 0
    assert eng.stats.token_readbacks == eng.stats.iterations
    assert eng.alloc.free_blocks == eng.alloc.num_blocks
    jeng, jout = _jax_serve(prompts, spec, spec_k=4)
    assert out["outputs"] == jout["outputs"]
    for key in ("spec_rounds", "spec_rows", "spec_drafts", "spec_accepted",
                "spec_emitted", "iterations"):
        assert getattr(eng.stats, key) == getattr(jeng.stats, key), key


def test_eviction_recompute_same_tokens(ref):
    """4 x 60-token prompts fill a 256-token pool; decode growth evicts,
    and recompute reproduces the uncontended streams."""
    cfg, params, _, _ = ref
    spec = [(0.0, 60, 6) for _ in range(4)]
    prompts = _prompts(cfg, spec, seed=3)
    _, want = _serve(cfg, params, prompts, spec, kv_capacity_tokens=4096)
    eng, out = _serve(cfg, params, prompts, spec, kv_capacity_tokens=256,
                      decode_reserve_tokens=0)
    assert eng.stats.evictions > 0
    assert out["outputs"] == want["outputs"]
    eng.alloc.check_invariants()
    assert eng.alloc.free_blocks == eng.alloc.num_blocks


def test_server_streams_and_abort_returns_pages(ref):
    cfg, params, prompts, want = ref
    server = InferenceServer(_engine(cfg, params))
    core = server.core
    h0 = server.submit(prompts[0], max_output=4)
    h1 = server.submit(prompts[1], max_output=40)
    streamed = list(h0.tokens())
    assert streamed == want[0] and h0.finish_reason == "length"
    assert core.alloc.owners and not h1.finished
    held = core.alloc.num_blocks - core.alloc.free_blocks
    assert held > 0
    h1.cancel()
    assert h1.aborted and core.stats.aborted == 1
    assert core.alloc.free_blocks == core.alloc.num_blocks
    report = server.close(drain_s=5.0)
    assert report["aborted"] == 0 and report["finished"] == 1


def test_default_device_is_the_gpu(monkeypatch):
    """Without ``device=`` the engine runs on the GPU, and raises where
    there is none: it never falls back to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama3.2-3b").smoke()
    with pytest.raises(RuntimeError, match="CUDA"):
        EngineCore(cfg, SlidingServeScheduler(max_budget=64))


def test_unpaged_arch_raises(monkeypatch):
    """jamba's Mamba mixers run on the slot cache only: the engine raises
    ValueError for the paged cache, and an arch the engine does not serve
    (seamless-m4t's encoder-decoder, which the model computes but the
    reference engine cannot serve) raises NotImplementedError in every
    cache mode, both before any weight or cache is allocated. In auto mode
    jamba gets the slot cache."""
    import repro_torch.serving.engine as TE

    def allocated(*args, **kwargs):
        raise AssertionError("allocated before the config check")
    monkeypatch.setattr(TE, "init_params", allocated)
    monkeypatch.setattr(TE, "init_cache", allocated)
    monkeypatch.setattr(TE, "init_paged_cache", allocated)
    jamba = get_config("jamba-1.5-large-398b").smoke()
    with pytest.raises(ValueError, match="paged KV"):
        EngineCore(jamba, SlidingServeScheduler(max_budget=64),
                   cache_mode="paged", device="cpu")
    for mode in ("auto", "slot", "paged"):
        with pytest.raises(NotImplementedError, match="enc_dec"):
            EngineCore(get_config("seamless-m4t-large-v2").smoke(),
                       SlidingServeScheduler(max_budget=64),
                       cache_mode=mode, device="cpu")
    monkeypatch.undo()
    eng = EngineCore(jamba, SlidingServeScheduler(max_budget=64),
                     cache_mode="auto", max_slots=2, max_len=32, device="cpu")
    assert eng.cache_mode == "slot"
