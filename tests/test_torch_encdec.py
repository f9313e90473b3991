"""PyTorch port: ``blockwise_attention`` (through the chunked-prefill kernel's
plain version on the CPU) against the JAX function, causal and not, with
window, softcap, ``q_offset``, ``kv_valid_len``, Sk != Sq and G > 1;
seamless-m4t's encoder, ``prefill`` and ``decode_step`` logits and its
cross cache against JAX on the same parameters (fp32 smoke config: logits
to 1e-4, caches to 2e-5, as ``tests/test_torch_slot.py``); and
``test_prefill_decode_consistency`` of ``tests/test_smoke_archs.py``
mirrored against JAX for every arch, internvl2's patch embeddings
included."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import params as TP  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=2e-5, rtol=2e-5)
# the reference test's tiling (tests/test_smoke_archs.py)
RCTX = JM.RunCtx(block_q=16, block_k=16, mlstm_block=16)
SEAMLESS = "seamless-m4t-large-v2"


def _params(arch):
    jcfg = jget_config(arch).smoke()
    tcfg = get_config(arch).smoke()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = TP.from_jax_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


def _to_torch(cfg, jtree):
    return TP.from_jax_numpy(cfg, jax.tree.map(np.asarray, jtree))


def _trees_close(jtree, ttree, tol):
    """Every leaf of a cache (nested lists and dicts) allclose."""
    if isinstance(jtree, dict):
        assert set(jtree) == set(ttree)
        for k in jtree:
            _trees_close(jtree[k], ttree[k], tol)
    elif isinstance(jtree, (list, tuple)):
        assert len(jtree) == len(ttree)
        for j, t in zip(jtree, ttree):
            _trees_close(j, t, tol)
    else:
        np.testing.assert_allclose(ttree.float().numpy(),
                                   np.asarray(jtree, np.float32), **tol)


# ---------------------------------------------------------------------------
# blockwise_attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal,window,cap,q_offset,valid,Sq,Sk,G", [
    (True, 0, 0.0, 0, None, 16, 16, 2),        # prefill over its own keys
    (False, 0, 0.0, 0, None, 24, 24, 1),       # the encoder
    (False, 0, 0.0, 0, None, 8, 40, 1),        # cross attention, Sk != Sq
    (False, 0, 0.0, 0, None, 1, 32, 1),        # cross attention decode
    (True, 12, 0.0, 0, None, 32, 32, 2),       # window
    (True, 0, 30.0, 10, [26, 20], 16, 40, 4),  # offset, lengths, softcap
    (False, 0, 20.0, 0, 9, 8, 24, 2),          # scalar valid length
    (True, 8, 50.0, 5, None, 12, 17, 3),       # a ragged last tile
])
def test_blockwise_attention_matches_jax(causal, window, cap, q_offset,
                                         valid, Sq, Sk, G):
    rng = np.random.default_rng(Sq * 100 + Sk)
    B, Hkv, D, Dv = 2, 2, 16, 8
    q = rng.normal(size=(B, Sq, Hkv, G, D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, Hkv, Dv)).astype(np.float32)
    jvalid = None if valid is None else jnp.asarray(valid, jnp.int32)
    want = JA.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.3,
        causal=causal, window=window, softcap=cap, q_offset=q_offset,
        kv_valid_len=jvalid, block_q=8, block_k=8)
    tvalid = None if valid is None else (
        torch.tensor(valid, dtype=torch.int32) if isinstance(valid, list)
        else valid)
    got = TA.blockwise_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale=0.3, causal=causal, window=window, softcap=cap,
        q_offset=q_offset, kv_valid_len=tvalid)
    assert got.shape == (B, Sq, Hkv, G, Dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


# ---------------------------------------------------------------------------
# seamless-m4t: encoder, prefill, decode_step, cross cache
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def seamless():
    return _params(SEAMLESS)


def _seamless_inputs(cfg, B=2, S=20, enc_len=24, seed=4):
    rng = np.random.default_rng(seed)
    enc = (rng.normal(size=(B, enc_len, cfg.d_model)) * 0.02).astype(
        np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 3)).astype(np.int32)
    return enc, toks


def test_seamless_encoder_matches_jax(seamless):
    jcfg, tcfg, jparams, tparams = seamless
    enc, _ = _seamless_inputs(tcfg)
    want = JM._run_encoder(jcfg, RCTX, jparams, jnp.asarray(enc))
    got = TM._run_encoder(tcfg, tparams, torch.from_numpy(enc))
    assert got.shape == enc.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_seamless_prefill_and_decode_match_jax(seamless):
    """Prefill (encoder, causal decoder, cross K/V written), then three
    greedy-fed decode steps reading the cross cache: logits and every cache
    leaf (self and cross) against JAX."""
    jcfg, tcfg, jparams, tparams = seamless
    B, S, enc_len, max_len = 2, 20, 24, 32
    enc, toks = _seamless_inputs(tcfg, B, S, enc_len)
    jcache = JM.init_cache(jcfg, B, max_len, enc_len=enc_len)
    tcache = _to_torch(tcfg, jcache)
    own = TM.init_cache(tcfg, B, max_len, enc_len=enc_len)
    _trees_close(jcache, own, CACHE_TOL)        # the same zeroed tree
    assert own[0][0]["cross_k"].shape == (
        tcfg.num_layers, B, enc_len, tcfg.num_kv_heads,
        tcfg.resolved_head_dim)
    jl, jcache = JM.prefill(jcfg, jparams, jnp.asarray(toks[:, :S]), jcache,
                            rctx=RCTX, enc_embeds=jnp.asarray(enc))
    tl, tcache = TM.prefill(tcfg, tparams, torch.from_numpy(toks[:, :S]),
                            tcache, enc_embeds=torch.from_numpy(enc))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _trees_close(jcache, tcache, CACHE_TOL)
    assert float(tcache[0][0]["cross_k"].abs().sum()) > 0
    for t in range(3):
        tok = toks[:, S + t:S + t + 1]
        jl, jcache = JM.decode_step(jcfg, jparams, jnp.asarray(tok), jcache,
                                    S + t, rctx=RCTX)
        tl, tcache = TM.decode_step(tcfg, tparams, torch.from_numpy(tok),
                                    tcache, S + t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _trees_close(jcache, tcache, CACHE_TOL)


def test_seamless_cross_cache_of_another_length_raises(seamless):
    _, tcfg, _, tparams = seamless
    enc, toks = _seamless_inputs(tcfg, enc_len=24)
    cache = TM.init_cache(tcfg, 2, 32, enc_len=16)
    with pytest.raises(ValueError, match="enc_len=24"):
        TM.prefill(tcfg, tparams, torch.from_numpy(toks[:, :8]), cache,
                   enc_embeds=torch.from_numpy(enc))


def test_seamless_init_params_structure():
    """``init_params`` draws the reference's tree: the encoder stack of
    num_encoder_layers (attention + dense FFN) with its final norm, and a
    ``cross`` attention without q/k norms in every decoder slot; the shapes
    equal JAX's, and ``from_jax_numpy`` checks the encoder's repetitions."""
    jcfg = jget_config(SEAMLESS).smoke()
    tcfg = get_config(SEAMLESS).smoke()
    shapes = jax.eval_shape(lambda: JM.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    want = {jax.tree_util.keystr(p): tuple(x.shape) for p, x in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    drawn = TP.init_params(tcfg, device="cpu")
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
    bad = jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.PRNGKey(0)))
    bad["encoder"]["stacks"][0] = jax.tree.map(lambda a: a[:1],
                                               bad["encoder"]["stacks"][0])
    with pytest.raises(ValueError, match="repeats its period"):
        TP.from_jax_numpy(tcfg, bad)


# ---------------------------------------------------------------------------
# tests/test_smoke_archs.py::test_prefill_decode_consistency against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency_matches_jax(arch):
    """prefill(S + 1) and prefill(S) + decode_step(S), each against the JAX
    functions on the same parameters, inputs and caches; and within the
    port, decode after prefill gives the longer prefill's logits (the
    reference test's own check and tolerance)."""
    B, S = 2, 32
    jcfg, tcfg, jparams, tparams = _params(arch)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tcfg.vocab_size, (B, S + 1)).astype(np.int32)
    jkw, tkw = {}, {}
    if tcfg.num_patch_tokens:
        x = (rng.normal(size=(B, tcfg.num_patch_tokens, tcfg.d_model))
             * 0.02).astype(np.float32)
        jkw["extra_embeds"], tkw["extra_embeds"] = (jnp.asarray(x),
                                                    torch.from_numpy(x))
    enc_len = 16 if tcfg.enc_dec else 0
    if enc_len:
        x = (rng.normal(size=(B, enc_len, tcfg.d_model)) * 0.02).astype(
            np.float32)
        jkw["enc_embeds"], tkw["enc_embeds"] = (jnp.asarray(x),
                                                torch.from_numpy(x))
    out = {}
    for n in (S + 1, S):
        jcache = JM.init_cache(jcfg, B, S + 1, enc_len=enc_len)
        tcache = _to_torch(tcfg, jcache)
        jl, jcache = JM.prefill(jcfg, jparams, jnp.asarray(toks[:, :n]),
                                jcache, rctx=RCTX, **jkw)
        tl, tcache = TM.prefill(tcfg, tparams, torch.from_numpy(toks[:, :n]),
                                tcache, **tkw)
        assert tl.shape == (B, tcfg.vocab_size)
        assert bool(torch.isfinite(tl).all())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        out[n] = tl
    jl, _ = JM.decode_step(jcfg, jparams, jnp.asarray(toks[:, S:S + 1]),
                           jcache, S, rctx=RCTX)
    tl, _ = TM.decode_step(tcfg, tparams, torch.from_numpy(toks[:, S:S + 1]),
                           tcache, S)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(out[S + 1].numpy(), tl.numpy(), atol=5e-3,
                               rtol=1e-3)
