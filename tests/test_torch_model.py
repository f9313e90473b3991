"""PyTorch port: the three paged steps (ragged chunked prefill, decode,
speculative verify) of the llama3.2-3b smoke config against the JAX steps,
on parameters carried across from ``repro.models.model.init_params``: equal
token ids, pools allclose (fp32 2e-5). Plus the paged KV helpers and the
parameter/cache plumbing."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import params as TP  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

RNG = np.random.default_rng(3)
PS = 16


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config("llama3.2-3b").smoke()
    tcfg = get_config("llama3.2-3b").smoke()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = TP.from_jax_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


def _pools_close(jcache, tcache):
    for js, ts in zip(jcache, tcache):
        for jslot, tslot in zip(js, ts):
            np.testing.assert_allclose(tslot["kv_pages"].numpy(),
                                       np.asarray(jslot["kv_pages"]),
                                       atol=2e-5, rtol=2e-5)


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


def _chunk_args(pages, rows, Lb, vocab):
    """rows: [(row id, start, n)] plus padding rows (None)."""
    R = len(rows)
    nb = 1
    for r in rows:
        if r is not None:
            nb = max(nb, len(pages.table(r[0], r[1] + r[2])))
    nb = 1 << (nb - 1).bit_length()
    tokens = RNG.integers(1, vocab, (R, Lb)).astype(np.int32)
    pos = np.zeros(R, np.int32)
    lens = np.zeros(R, np.int32)
    at = np.zeros(R, np.int32)
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
    return tokens, pos, lens, at, tables, slots.reshape(-1).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_paged_steps_match_jax(setup):
    jcfg, tcfg, jparams, tparams = setup
    num_pages = 24
    jcache = JM.init_paged_cache(jcfg, num_pages, PS)
    tcache = TM.init_paged_cache(tcfg, num_pages, PS)
    rctx = JM.RunCtx()
    pages = _Pages(num_pages)
    V = tcfg.vocab_size

    # 1) ragged prefill: a full chunk, a short prompt, the first chunk of a
    #    long prompt, and an all-padding row
    tok, pos, lens, at, tables, slots = _chunk_args(
        pages, [(0, 0, 16), (1, 0, 5), (2, 0, 16), None], 16, V)
    jids, jcache = JM.paged_chunk_step(
        jcfg, jparams, jnp.asarray(tok), jcache, jnp.asarray(pos), rctx=rctx,
        row_lens=jnp.asarray(lens), block_tables=jnp.asarray(tables),
        write_slots=jnp.asarray(slots), logits_at=jnp.asarray(at))
    tids, tcache = TM.paged_chunk_step(
        tcfg, tparams, _t(tok), tcache, _t(pos), row_lens=_t(lens),
        block_tables=_t(tables), write_slots=_t(slots), logits_at=_t(at))
    assert tids.dtype == torch.int32
    assert tids[:3].tolist() == np.asarray(jids)[:3].tolist()
    _pools_close(jcache, tcache)

    # 2) second chunk of row 2 at offset 16 (reads pages written in 1)
    tok, pos, lens, at, tables, slots = _chunk_args(
        pages, [(2, 16, 10), None], 16, V)
    jids, jcache = JM.paged_chunk_step(
        jcfg, jparams, jnp.asarray(tok), jcache, jnp.asarray(pos), rctx=rctx,
        row_lens=jnp.asarray(lens), block_tables=jnp.asarray(tables),
        write_slots=jnp.asarray(slots), logits_at=jnp.asarray(at))
    tids, tcache = TM.paged_chunk_step(
        tcfg, tparams, _t(tok), tcache, _t(pos), row_lens=_t(lens),
        block_tables=_t(tables), write_slots=_t(slots), logits_at=_t(at))
    assert int(tids[0]) == int(jids[0])
    _pools_close(jcache, tcache)

    # 3) decode: rows 0 and 1 write their 17th / 6th token, plus padding
    dec_tok = RNG.integers(1, V, (4, 1)).astype(np.int32)
    lens = np.asarray([17, 6, 0, 0], np.int32)
    tables = np.zeros((4, 2), np.int32)
    slots = np.full(4, pages.trash, np.int64)
    for i, (rid, ln) in enumerate([(0, 17), (1, 6)]):
        t = pages.table(rid, ln)
        tables[i, :len(t)] = t
        slots[i] = pages.slots(rid, ln - 1, 1)[0]
    slots = slots.astype(np.int32)
    jids, jcache = JM.paged_decode_step(
        jcfg, jparams, jnp.asarray(dec_tok), jcache, rctx=rctx,
        lengths=jnp.asarray(lens), block_tables=jnp.asarray(tables),
        write_slots=jnp.asarray(slots))
    tids, tcache = TM.paged_decode_step(
        tcfg, tparams, _t(dec_tok), tcache, lengths=_t(lens),
        block_tables=_t(tables), write_slots=_t(slots))
    assert tids[:2].tolist() == np.asarray(jids)[:2].tolist()
    _pools_close(jcache, tcache)

    # 4) speculative verify: row 0 = [pending, 3 drafts] at offset 17, row 1
    #    with one draft, padded to width 4, plus a padding row
    tok, pos, lens, _, tables, slots = _chunk_args(
        pages, [(0, 17, 4), (1, 6, 2), None, None], 4, V)
    tok[1, 2:] = tok[1, 1]
    jpay, jcache = JM.paged_spec_step(
        jcfg, jparams, jnp.asarray(tok), jcache, jnp.asarray(pos), rctx=rctx,
        row_lens=jnp.asarray(lens), block_tables=jnp.asarray(tables),
        write_slots=jnp.asarray(slots))
    tpay, tcache = TM.paged_spec_step(
        tcfg, tparams, _t(tok), tcache, _t(pos), row_lens=_t(lens),
        block_tables=_t(tables), write_slots=_t(slots))
    assert tpay.shape == (4 * 5,) and tpay.dtype == torch.int32
    assert tpay[:10].tolist() == np.asarray(jpay)[:10].tolist()
    _pools_close(jcache, tcache)


def test_verify_accepts_matching_drafts(setup):
    """Drafts equal to the model's own greedy continuation are all
    accepted; the payload carries [accepted, out_0..out_{S-1}]."""
    _, tcfg, _, tparams = setup
    cache = TM.init_paged_cache(tcfg, 8, PS)
    pages = _Pages(8)
    tok, pos, lens, at, tables, slots = _chunk_args(pages, [(0, 0, 8)], 16, 256)
    kw = dict(row_lens=_t(lens), block_tables=_t(tables), write_slots=_t(slots))
    first, cache = TM.paged_chunk_step(tcfg, tparams, _t(tok), cache, _t(pos),
                                       logits_at=_t(at), **kw)
    # greedy continuation of 3 tokens through decode steps on a copy
    ref_cache = [[{"kv_pages": s["kv_pages"].clone()} for s in st]
                 for st in cache]
    cont, last = [], int(first[0])
    for i in range(3):
        ln = 9 + i
        t = pages.table(0, ln)
        ids, ref_cache = TM.paged_decode_step(
            tcfg, tparams, torch.tensor([[last]], dtype=torch.int32),
            ref_cache, lengths=torch.tensor([ln], dtype=torch.int32),
            block_tables=torch.tensor([t], dtype=torch.int32),
            write_slots=torch.tensor(pages.slots(0, ln - 1, 1),
                                     dtype=torch.int32))
        last = int(ids[0])
        cont.append(last)
    vt = np.asarray([[int(first[0])] + cont], np.int32)
    _, pos, lens, _, tables, slots = _chunk_args(pages, [(0, 8, 4)], 4, 256)
    pay, _ = TM.paged_spec_step(tcfg, tparams, _t(vt), cache, _t(pos),
                                row_lens=_t(lens), block_tables=_t(tables),
                                write_slots=_t(slots))
    assert int(pay[0]) == 3 and pay[1:4].tolist() == cont


def test_write_pages_fused_and_gather_match_jax():
    Hkv, P, D, T = 2, 8, 32, 40
    kvp = RNG.normal(size=(Hkv, P, 2, PS, D)).astype(np.float32)
    k_new = RNG.normal(size=(1, T, Hkv, D)).astype(np.float32)
    v_new = RNG.normal(size=(1, T, Hkv, D)).astype(np.float32)
    slots = RNG.choice((P - 1) * PS, size=T, replace=False)
    slots[-3:] = (P - 1) * PS            # repeated writes hit only the trash
    want = np.asarray(JA.write_pages_fused(jnp.asarray(kvp), jnp.asarray(k_new),
                                           jnp.asarray(v_new),
                                           jnp.asarray(slots)))
    t = torch.from_numpy(kvp.copy())
    out = TA.write_pages_fused(t, _t(k_new), _t(v_new), _t(slots))
    assert out.data_ptr() == t.data_ptr()          # in place
    np.testing.assert_array_equal(t.numpy()[:, :P - 1], want[:, :P - 1])
    bt = RNG.integers(0, P, (3, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        TA.gather_pages(t[:, :, 0], _t(bt)).numpy(),
        np.asarray(JA.gather_pages(jnp.asarray(t[:, :, 0].numpy()),
                                   jnp.asarray(bt))))


def test_params_structure_and_cache_conversion(setup):
    jcfg, tcfg, jparams, tparams = setup
    drawn = TP.init_params(tcfg, seed=0, device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    want = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in jflat}
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
    assert drawn["final_norm"].abs().sum() == 0
    jcache = JM.init_paged_cache(jcfg, 5, PS)
    tcache = TP.from_jax_numpy(tcfg, jax.tree.map(np.asarray, jcache))
    assert tcache[0][0]["kv_pages"].shape == (2, 2, 5, 2, PS, 16)
    bf = TP.from_jax_numpy(tcfg, np.asarray(jnp.ones((3,), jnp.bfloat16)))
    assert bf.dtype == torch.bfloat16 and bf.tolist() == [1.0, 1.0, 1.0]


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen3-1.7b", "qwen2-moe-a2.7b",
                                  "xlstm-125m", "jamba-1.5-large-398b",
                                  "seamless-m4t-large-v2"])
def test_unported_features_raise(arch, monkeypatch):
    """What the port does not compute or serve raises instead of computing
    something else: for xlstm-125m and jamba (recurrent mixers, which run
    on the slot cache) the paged cache and the paged forward; seamless-m4t
    (the encoder-decoder), which the model computes, is refused by the
    engine and the launcher (with and without the HTTP front door) before
    any weight or cache is allocated, as the reference engine cannot serve
    it. gemma2-2b (post-norms, embedding scale, softcaps), qwen3-1.7b
    (per-head q/k norm) and qwen2-moe-a2.7b (the MoE FFN) are computed on
    the paged path."""
    cfg = get_config(arch).smoke()
    if arch in ("xlstm-125m", "jamba-1.5-large-398b"):
        assert TM.unsupported_features(cfg) == []
        with pytest.raises(ValueError):
            TM.init_paged_cache(cfg, 4, 16)
        with pytest.raises(ValueError):
            TM.forward(cfg, TP.init_params(cfg, device="cpu"),
                       torch.zeros((1, 1), dtype=torch.int32),
                       cache=TM.init_cache(cfg, 1, 8), mode="paged_decode")
        return
    if arch != "seamless-m4t-large-v2":
        assert TM.unsupported_features(cfg) == []
        ids, _ = TM.paged_decode_step(
            cfg, TP.init_params(cfg, device="cpu"),
            torch.ones((1, 1), dtype=torch.int32),
            TM.init_paged_cache(cfg, 2, 16),
            lengths=torch.tensor([1], dtype=torch.int32),
            block_tables=torch.zeros((1, 1), dtype=torch.int32),
            write_slots=torch.zeros((1,), dtype=torch.int32))
        assert ids.shape == (1,) and 0 <= int(ids[0]) < cfg.vocab_size
        return
    import repro_torch.serving.engine as TE
    from repro_torch.core import SlidingServeScheduler
    from repro_torch.launch import serve as launcher

    assert TM.unsupported_features(cfg) == []
    params = TP.init_params(cfg, device="cpu")
    cache = TM.init_cache(cfg, 1, 8, enc_len=6)
    logits, cache = TM.prefill(cfg, params,
                               torch.ones((1, 4), dtype=torch.int32), cache,
                               enc_embeds=torch.zeros((1, 6, cfg.d_model)))
    logits, _ = TM.decode_step(cfg, params, torch.ones((1, 1),
                                                       dtype=torch.int32),
                               cache, 4)
    assert logits.shape == (1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())

    def allocated(*a, **k):
        raise AssertionError("allocated before refusing")
    for name in ("init_params", "init_cache", "init_paged_cache"):
        monkeypatch.setattr(TE, name, allocated)
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        TE.EngineCore(cfg, SlidingServeScheduler(), cache_mode="slot",
                      device="cpu")
    for extra in ([], ["--serve-http", "--port", "0"]):
        with pytest.raises(NotImplementedError, match="encoder-decoder"):
            launcher.main(["--arch", arch, "--device", "cpu", *extra])
