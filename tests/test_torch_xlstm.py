"""PyTorch port, xlstm-125m slot serving: ``chunk_prefill_step`` and
``decode_step`` of the xlstm-125m smoke config against the JAX steps on the
same parameters (fp32; logits and every state leaf to 1e-4 relative: the
state of a later layer carries the rounding of every earlier layer, while
each mixer alone matches JAX to 1e-5 in tests/test_torch_ssm.py),
including a decode that runs only some rows; the slot ``EngineCore``
against the JAX slot engine (equal greedy streams and equal
``prefill_calls``/``decode_calls``/``iterations``, with exact-length
chunks), one scenario with more requests than slots, so that a request
starts from the state its slot's previous owner left (the reference never
resets a reused slot); ``init_params`` against the JAX tree; and the
launcher on the CPU. Prompts are chosen for few distinct chunk lengths:
the JAX engine compiles one chunk function per length."""
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

ARCH = "xlstm-125m"
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
STATE_TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config(ARCH).smoke()
    tcfg = get_config(ARCH).smoke()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = TP.from_jax_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


def _paths(tree, path=""):
    """{path: (shape, dtype name)} of every leaf of a params/cache tree."""
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_paths(tree[k], f"{path}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_paths(v, f"{path}/{i}"))
        return out
    name = str(tree.dtype).replace("torch.", "")
    return {path: (tuple(tree.shape), name)}


def test_init_params_and_cache_trees_match_jax(setup):
    jcfg, tcfg, jparams, _ = setup
    drawn = TP.init_params(tcfg, seed=0, device="cpu")
    assert _paths(drawn) == _paths(jax.tree.map(np.asarray, jparams))
    slot = drawn["stacks"][0][0]["mlstm"]
    assert slot["gate_bias"].dtype == torch.float32
    assert torch.equal(slot["gate_bias"][0, tcfg.num_heads:],
                       torch.linspace(3.0, 6.0, tcfg.num_heads))
    jcache = JM.init_cache(jcfg, 3, 64)
    tcache = TM.init_cache(tcfg, 3, 64)
    assert _paths(tcache) == _paths(jax.tree.map(np.asarray, jcache))
    assert bool((tcache[0][0]["mlstm"]["m"] == np.float32(-1e30)).all())


def _states_close(jcache, tcache):
    for js, ts in zip(jcache, tcache):
        for jslot, tslot in zip(js, ts):
            for mixer, leaves in jslot.items():
                for name, want in leaves.items():
                    np.testing.assert_allclose(
                        tslot[mixer][name].float().numpy(), np.asarray(want),
                        err_msg=f"{mixer}/{name}", **STATE_TOL)


def test_xlstm_steps_match_jax(setup):
    """Three chunks of exact lengths (37, 1, 26) into fresh state rows,
    then decode steps of every row, then one that writes only row 1 (the
    JAX engine runs every row and merges the kept row's state back)."""
    jcfg, tcfg, jparams, tparams = setup
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
        _states_close(jcache, tcache)
        pos += S
    lens = np.asarray([pos + 1, pos + 1], np.int32)
    tok = rng.integers(1, V, (B, 1)).astype(np.int32)
    jl, jcache = JM.decode_step(jcfg, jparams, jnp.asarray(tok), jcache, 0,
                                rctx=rctx, lengths=jnp.asarray(lens))
    tl, tcache = TM.decode_step(tcfg, tparams, torch.from_numpy(tok), tcache,
                                0, lengths=torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _states_close(jcache, tcache)

    before = [[{mx: {n: t.clone() for n, t in leaves.items()}
                for mx, leaves in slot.items()} for slot in st]
              for st in tcache]
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
    _states_close(jcache, tcache)
    # row 0 was not written: bit-identical to its state before the step
    for bs, ts in zip(before, tcache):
        for bslot, tslot in zip(bs, ts):
            for mixer, leaves in bslot.items():
                for name, want in leaves.items():
                    assert torch.equal(tslot[mixer][name][:, 0],
                                       want[:, 0]), (mixer, name)


def test_paged_modes_reject_recurrent_mixers(setup):
    _, tcfg, _, tparams = setup
    assert not TM.supports_paged_cache(tcfg)
    with pytest.raises(ValueError, match="slot cache only"):
        TM.forward(tcfg, tparams, torch.zeros((1, 1), dtype=torch.int32),
                   cache=TM.init_cache(tcfg, 1, 8), mode="paged_decode")


# ---------------------------------------------------------------------------
# the slot engine against the JAX slot engine
# ---------------------------------------------------------------------------
# (arrival, prompt_len, max_output). "reuse": three requests on two slots,
# the third starts from the state a finished request left in its slot;
# "split": chunks capped at 32 tokens, exact lengths 32, 32 and 6
SCENARIOS = {"reuse": ([(0.0, 24, 3), (0.0, 24, 6), (0.0, 24, 4)], 1, None),
             "split": ([(0.0, 70, 3)], 2, (16, 32))}


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


@pytest.fixture(scope="module")
def jax_slot_runs():
    """The JAX slot engine (max_slots 2, weights from seed 0) on each
    scenario, and its parameters as torch tensors."""
    cfg = jget_config(ARCH).smoke()
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
    tcfg = get_config(ARCH).smoke()
    return tcfg, TP.from_jax_numpy(tcfg, params), runs


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_xlstm_slot_engine_matches_jax_slot_engine(jax_slot_runs, scenario,
                                                   monkeypatch):
    cfg, params, runs = jax_slot_runs
    spec, _, buckets = SCENARIOS[scenario]
    if buckets:
        monkeypatch.setattr(TE, "CHUNK_BUCKETS", buckets)
    prompts, want, jstats = runs[scenario]
    eng = TE.EngineCore(cfg, SlidingServeScheduler(max_budget=256,
                                                   max_iter_time=5.0),
                        cache_mode="auto", max_slots=2, max_len=512,
                        params=params, device="cpu")
    assert eng.cache_mode == "slot"
    seen = []
    orig = TM.chunk_prefill_step

    def spy(cfg_, params_, tokens, *args, **kwargs):
        seen.append(tokens.shape[1])
        return orig(cfg_, params_, tokens, *args, **kwargs)
    monkeypatch.setattr(TE, "chunk_prefill_step", spy)
    out = _serve(eng, spec, prompts)
    assert out["outputs"] == want
    for key in ("prefill_calls", "decode_calls", "iterations"):
        assert getattr(eng.stats, key) == getattr(jstats, key), key
    # exact-length chunks: no padding token reached the recurrent state
    assert sum(seen) == sum(p for _, p, _ in spec)
    if buckets:
        assert max(seen) <= buckets[-1] and len(seen) >= 3
    else:
        # the last request took a slot that a finished one left: it starts
        # from that request's state, as in the reference, and a slot of
        # its own (a third slot) gives another stream
        fresh = TE.EngineCore(cfg, SlidingServeScheduler(
            max_budget=256, max_iter_time=5.0), cache_mode="slot",
            max_slots=3, max_len=512, params=params, device="cpu")
        alone = _serve(fresh, spec, prompts)["outputs"]
        last = len(spec) - 1
        assert alone[last] != want[last]
        assert all(alone[i] == want[i] for i in range(last))
    assert sorted(eng.free_slots) == [0, 1] and not eng.slot_of


def test_launcher_serves_xlstm_on_cpu():
    out = launcher.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                         "--qps", "50"])
    assert len(out["finished"]) == 3
    assert all(len(h.collected) == h.request.max_output
               for h in out["finished"])
