"""PyTorch port: deepseek-v3's multi-head latent attention (MLA) on the slot
cache against the JAX package, each piece on its own: the plain
chunked-prefill attention with values narrower than keys against the
reference's ``_chunk_attend`` einsum, ``mla_decode_attention``,
``mla_block`` in chunk and decode modes, ``chunk_prefill_step`` /
``decode_step`` of the deepseek-v3 smoke config (first_k_dense stack, MoE
stack), and the slot ``EngineCore`` against the JAX slot engine (equal
greedy streams and equal ``prefill_calls``/``decode_calls``/
``iterations``). Every norm weight is drawn at random (the reference
initialises them to zero) so that a misplaced one shows.

fp32; tolerances as in ``tests/test_torch_slot.py``: logits 1e-4, caches
and attention outputs 2e-5."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.serving.engine as JE  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import SlidingServeScheduler as JScheduler  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.request import Request as JRequest  # noqa: E402
from repro_torch import params as TP  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import SlidingServeScheduler  # noqa: E402
from repro_torch.kernels.chunked_prefill_attention import kernel as CK  # noqa: E402
from repro_torch.kernels.chunked_prefill_attention import ref as TCPA  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

ARCH = "deepseek-v3-671b"
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
TOL = dict(atol=2e-5, rtol=2e-5)
NORMS = ("ln", "q_ln", "kv_ln", "final_norm")


def random_norms(tree, seed):
    """``tree`` (numpy leaves) with every norm weight drawn from N(0, 0.5)."""
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


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jget_config(ARCH).smoke(), get_config(ARCH).smoke()
    tree = random_norms(jax.tree.map(
        np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0))), seed=3)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            TP.from_jax_numpy(tcfg, tree))


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# #5's plain version with its own value width
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pos,Sq,Dqk,Dv,ragged", [
    (0, 16, 24, 16, False), (37, 9, 24, 16, True), (20, 16, 192, 128, False)])
def test_chunk_attend_value_width_matches_jax(setup, pos, Sq, Dqk, Dv,
                                              ragged):
    """q [B, Sq, H, 1, Dqk] over keys Dqk wide and values Dv wide at MLA's
    scale: the port's ``_chunk_attend`` (the kernel's plain version on the
    CPU) against the reference's einsum, [B, Sq, H, 1, Dv]."""
    jcfg, tcfg, _, _ = setup
    rng = np.random.default_rng(pos + Dqk)
    B, S, H = 2, 64, 4
    q = rng.normal(size=(B, Sq, H, 1, Dqk)).astype(np.float32)
    k = rng.normal(size=(B, S, H, Dqk)).astype(np.float32)
    v = rng.normal(size=(B, S, H, Dv)).astype(np.float32)
    lengths = np.asarray([pos + Sq, pos + Sq - 5], np.int32) if ragged \
        else None
    scale = 1.0 / np.sqrt(Dqk)
    want = JM._chunk_attend(jcfg, JM.RunCtx(), _j(q), _j(k), _j(v), pos,
                            None if lengths is None else _j(lengths), 0,
                            scale=scale)
    got = TM._chunk_attend(tcfg, _t(q), _t(k), _t(v), pos,
                           None if lengths is None else _t(lengths), 0,
                           scale=scale)
    assert got.shape == (B, Sq, H, 1, Dv)
    valid = np.ones((B, Sq), bool)
    if ragged:
        valid = (pos + np.arange(Sq))[None, :] < lengths[:, None]
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                               **TOL)


def test_value_width_wrapper_checks():
    """The CUDA wrapper's operand check takes values narrower than keys
    (fp32: any multiples of 8 up to 256) and refuses wider ones; the plain
    version returns the value width."""
    q = torch.zeros((1, 4, 8, 24))
    k = torch.zeros((1, 4, 32, 24))
    lens = torch.full((1,), 32, dtype=torch.int32)
    CK._check(q, k, torch.zeros((1, 4, 32, 16)), lens)
    for v, msg in ((torch.zeros((1, 4, 32, 32)), "value width"),
                   (torch.zeros((1, 4, 32, 12)), "multiples of 8"),
                   (torch.zeros((1, 4, 31, 16)), "Sk, Dv")):
        with pytest.raises(ValueError, match=msg):
            CK._check(q, k, v, lens)
    out = TCPA.chunked_prefill_attention_ref(
        q, k, torch.ones((1, 4, 32, 16)), lens, scale=0.2, q_offset=24)
    assert out.shape == (1, 4, 8, 16) and torch.allclose(out, torch.ones(()))


# ---------------------------------------------------------------------------
# mla_decode_attention and mla_block
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("length", [[37, 12], 20])
def test_mla_decode_attention_matches_jax(length):
    rng = np.random.default_rng(5)
    B, H, R, Dr, S = 2, 4, 32, 8, 48
    args = [rng.normal(size=s).astype(np.float32)
            for s in ((B, H, R), (B, H, Dr), (B, S, R), (B, S, Dr))]
    ln = np.asarray(length, np.int32) if isinstance(length, list) else length
    want = JA.mla_decode_attention(*map(_j, args),
                                   _j(ln) if isinstance(length, list) else ln,
                                   scale=0.3)
    got = TA.mla_decode_attention(*map(_t, args),
                                  _t(ln) if isinstance(length, list) else ln,
                                  scale=0.3)
    assert got.shape == (B, H, R)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _mla_params(tparams, jparams):
    """The first stack's MLA slot, repetition 0, in both frameworks."""
    jp = jax.tree.map(lambda a: a[0], jparams["stacks"][0][0]["mla"])
    tp = {k: v[0] for k, v in tparams["stacks"][0][0]["mla"].items()}
    return jp, tp


def test_mla_block_chunk_and_decode_match_jax(setup):
    """Two chunks (the second at offset 16, whose queries see the first
    chunk's latents), a ragged decode of one row, and a lockstep decode:
    block outputs to 2e-5, the latent cache (ckv, kr) to 2e-5."""
    jcfg, tcfg, jparams, tparams = setup
    jp, tp = _mla_params(tparams, jparams)
    rctx = JM.RunCtx()
    rng = np.random.default_rng(9)
    B, S, d = 2, 48, tcfg.d_model
    jstate = {"ckv": jnp.zeros((B, S, tcfg.kv_lora_rank)),
              "kr": jnp.zeros((B, S, tcfg.qk_rope_head_dim))}
    tstate = {n: torch.zeros(a.shape) for n, a in jstate.items()}

    def both(mode, x, pos, lengths, rows=None):
        """``lengths``: None, an int (lockstep) or a numpy row vector."""
        ragged = isinstance(lengths, np.ndarray)
        jy, jnew = JM.mla_block(jcfg, rctx, jp, _j(x), jstate, mode=mode,
                                pos=pos,
                                lengths=_j(lengths) if ragged else lengths)
        ty = TM.mla_block(tcfg, tp, _t(x), tstate, mode=mode, pos=pos,
                          lengths=_t(lengths) if ragged else lengths,
                          rows=rows)
        return np.asarray(jy), ty.numpy(), jnew

    for pos, Sq in ((0, 16), (16, 11)):
        x = rng.normal(size=(B, Sq, d)).astype(np.float32)
        jy, ty, jstate = both("chunk", x, pos, None)
        np.testing.assert_allclose(ty, jy, **TOL)
        for n in ("ckv", "kr"):
            np.testing.assert_allclose(tstate[n].numpy(),
                                       np.asarray(jstate[n]), **TOL)
    # ragged decode: both rows run; the JAX state keeps row 1's writes only
    # where the port writes row 1 alone
    lens = np.asarray([28, 20], np.int32)
    x = rng.normal(size=(B, 1, d)).astype(np.float32)
    jy, ty, jnew = both("decode", x, 0, lens, rows=torch.tensor([1]))
    np.testing.assert_allclose(ty[1], jy[1], **TOL)
    keep = jnp.asarray([False, True])[:, None, None]
    jstate = {n: jnp.where(keep, jnew[n], jstate[n]) for n in jstate}
    for n in ("ckv", "kr"):
        np.testing.assert_allclose(tstate[n].numpy(), np.asarray(jstate[n]),
                                   **TOL)
    jy, ty, jstate = both("decode", x, 27, 28)
    np.testing.assert_allclose(ty, jy, **TOL)
    for n in ("ckv", "kr"):
        np.testing.assert_allclose(tstate[n].numpy(), np.asarray(jstate[n]),
                                   **TOL)
    with pytest.raises(ValueError, match="slot cache"):
        TM.mla_block(tcfg, tp, _t(x), tstate, mode="paged_decode", pos=0,
                     lengths=None)


# ---------------------------------------------------------------------------
# the model's slot steps
# ---------------------------------------------------------------------------
def test_params_and_cache_structure(setup):
    """init_params draws the reference's tree with its ``mtp`` subtree
    (the multi-token-prediction module the training loss reads), which
    from_jax_numpy carries across equal to JAX's; the slot cache holds
    ckv/kr latents; the paged cache refuses MLA."""
    jcfg, tcfg, jparams, tparams = setup
    drawn = TP.init_params(tcfg, seed=0, device="cpu")
    assert "mtp" in jparams and "mtp" in tparams and "mtp" in drawn
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    want = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in jflat}
    jmtp = jax.tree_util.tree_flatten_with_path(jparams["mtp"])[0]
    assert len(jmtp) > 3
    for p, v in jmtp:
        t = tparams["mtp"]
        for key in p:
            t = t[key.key if hasattr(key, "key") else key.idx]
        np.testing.assert_array_equal(t.numpy(), np.asarray(v))
    got = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + f"['{k}']")
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + f"[{i}]")
        else:
            got[path] = tuple(t.shape)
    walk(drawn, "")
    assert got == want
    jcache = JM.init_cache(jcfg, 2, 32)
    tcache = TM.init_cache(tcfg, 2, 32)
    assert [[{n: tuple(t.shape) for n, t in c.items()} for c in st]
            for st in tcache] == \
        [[{n: tuple(a.shape) for n, a in c.items()} for c in st]
         for st in jcache]
    with pytest.raises(ValueError):
        TM.init_paged_cache(tcfg, 4, 16)


def _caches_close(jcache, tcache):
    for js, ts in zip(jcache, tcache):
        for jslot, tslot in zip(js, ts):
            for name in ("ckv", "kr"):
                np.testing.assert_allclose(tslot[name].numpy(),
                                           np.asarray(jslot[name]), **TOL)


def test_slot_steps_match_jax(setup):
    """Chunks at offsets 0 and 16 (the second bucket-padded, logits at its
    last real token), a chunk whose write is clamped at ``max_len``, then
    ragged decode rows: logits 1e-4, latent caches 2e-5."""
    jcfg, tcfg, jparams, tparams = setup
    rctx = JM.RunCtx()
    B, S = 2, 64
    jcache = JM.init_cache(jcfg, B, S)
    tcache = TM.init_cache(tcfg, B, S)
    rng = np.random.default_rng(0)
    V = tcfg.vocab_size
    for pos, at in ((0, -1), (16, 10), (56, 3)):
        tok = rng.integers(1, V, (B, 16)).astype(np.int32)
        jl, jcache = JM.chunk_prefill_step(jcfg, jparams, _j(tok), jcache, pos,
                                           rctx=rctx, logits_at=at)
        tl, tcache = TM.chunk_prefill_step(tcfg, tparams, _t(tok), tcache, pos,
                                           logits_at=at)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        _caches_close(jcache, tcache)
    for lens in ([33, 27], [34, 28]):
        lens = np.asarray(lens, np.int32)
        tok = rng.integers(1, V, (B, 1)).astype(np.int32)
        jl, jcache = JM.decode_step(jcfg, jparams, _j(tok), jcache, 0,
                                    rctx=rctx, lengths=_j(lens))
        tl, tcache = TM.decode_step(tcfg, tparams, _t(tok), tcache, 0,
                                    lengths=_t(lens))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        _caches_close(jcache, tcache)


# ---------------------------------------------------------------------------
# the slot engine against the JAX slot engine
# ---------------------------------------------------------------------------
SPEC = [(0.0, 24, 4), (0.0, 51, 4), (0.0, 37, 3)]   # tests/test_paged_engine.py
SPLIT_SPEC = [(0.0, 100, 2), (0.0, 20, 3)]   # 100 tokens over 32-token chunks


def _requests(spec, cls=Request):
    return [cls(rid=i, arrival=a, prompt_len=p, max_output=o,
                ttft_slo=900.0, tbt_slo=900.0)
            for i, (a, p, o) in enumerate(spec)]


def _serve(eng, spec, prompts, cls=Request):
    out = eng.serve(_requests(spec, cls),
                    {k: v.copy() for k, v in prompts.items()},
                    max_wall_s=900.0)
    assert not out["unfinished"]
    return out


@pytest.mark.parametrize("spec,buckets", [(SPEC, None),
                                          (SPLIT_SPEC, (16, 32))])
def test_slot_engine_matches_jax_slot_engine(setup, spec, buckets,
                                             monkeypatch):
    """Equal greedy streams and round counts; chunks are bucket-padded
    (MLA keeps no recurrent state); ``"auto"`` picks the slot cache."""
    jcfg, tcfg, jparams, tparams = setup
    rng = np.random.default_rng(1)
    prompts = {i: rng.integers(1, tcfg.vocab_size, p).astype(np.int32)
               for i, (_, p, _) in enumerate(spec)}
    if buckets:
        monkeypatch.setattr(JE, "CHUNK_BUCKETS", buckets)
        monkeypatch.setattr(TE, "CHUNK_BUCKETS", buckets)
    jeng = JE.EngineCore(jcfg, JScheduler(max_budget=256, max_iter_time=5.0),
                         seed=0, cache_mode="slot", max_slots=2, max_len=512)
    jeng.params = jparams
    want = _serve(jeng, spec, prompts, JRequest)["outputs"]
    seen = []
    orig = TM.chunk_prefill_step

    def spy(cfg_, params_, tokens, *args, **kwargs):
        seen.append(tokens.shape[1])
        return orig(cfg_, params_, tokens, *args, **kwargs)
    monkeypatch.setattr(TE, "chunk_prefill_step", spy)
    eng = TE.EngineCore(tcfg, SlidingServeScheduler(max_budget=256,
                                                    max_iter_time=5.0),
                        cache_mode="auto", max_slots=2, max_len=512,
                        params=tparams, device="cpu")
    assert eng.cache_mode == "slot"
    out = _serve(eng, spec, prompts)
    assert out["outputs"] == want
    for key in ("prefill_calls", "decode_calls", "iterations"):
        assert getattr(eng.stats, key) == getattr(jeng.stats, key), key
    assert all(n in (buckets or TE.CHUNK_BUCKETS) for n in seen)
    assert sum(seen) > sum(p for _, p, _ in spec)     # padded chunks
    assert sorted(eng.free_slots) == [0, 1] and not eng.slot_of


def test_engine_paged_mla_raises_before_allocating(setup, monkeypatch):
    _, tcfg, _, _ = setup

    def allocated(*args, **kwargs):
        raise AssertionError("allocated before the config check")
    monkeypatch.setattr(TE, "init_params", allocated)
    monkeypatch.setattr(TE, "init_paged_cache", allocated)
    with pytest.raises(ValueError, match="paged KV"):
        TE.EngineCore(tcfg, SlidingServeScheduler(max_budget=64),
                      cache_mode="paged", device="cpu")
    assert not TM.supports_paged_cache(dataclasses.replace(tcfg))
