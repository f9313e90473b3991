"""PyTorch port: the slot path's ``prefill`` and ``decode_step`` on a mesh,
against the JAX package on one device.

One world of 4 gloo ranks on the CPU (``spawn_world(device="cpu")``, the
bodies of ``tests/_slot_sharded_ranks.py``) runs every arch's smoke config
at mesh ``2x2`` (the K/V caches head-sharded: 2 KV heads on a model axis
of 2; MLA's latents and Mamba's state on the sequence and channels,
xLSTM's on the batch), smoke llama at ``4`` (2 KV heads on 4: the cache
sequence-sharded, decode as partials merged over the axis) and smoke
llama with 2 query heads over 1 KV head at ``4`` (half a query head a
rank). Each rank holds its shards of the reference's weights
(``from_jax_numpy``, ``param_specs``), a cache built by ``init_cache(...,
mesh=)`` and its data-parallel rows; it prefills 20 tokens (patch
embeddings, encoder frames where the arch has them) and decodes 8 greedy
steps, at a lockstep offset and with per-row lengths in turn. The MoE
archs route expert-parallel at a capacity that drops no token (the
reference on one device routes every token densely; at the default
capacity factor of 1.25 jamba's prefill drops tokens on any mesh). The JAX
package's ``prefill``/``decode_step`` run the same on one device while the
world runs. Every step's logits within 2e-5 (fp32), the greedy tokens
equal, every rank's cache leaves at ``cache_specs``' local shape.
"""
import dataclasses
import os
import pickle
import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _sharded_train_ranks as W  # noqa: E402
import _slot_sharded_ranks as R  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)
TWO_HEADS = {"num_heads": 2, "num_kv_heads": 1}
CASES = ([{"name": f"{a} 2x2", "arch": a, "mesh": "2x2"} for a in ARCHS]
         + [{"name": "llama3.2-3b 4", "arch": "llama3.2-3b", "mesh": "4"},
            {"name": "llama3.2-3b 2 heads 4", "arch": "llama3.2-3b",
             "mesh": "4", "changes": TWO_HEADS}])
RCTX = JM.RunCtx(block_q=16, block_k=16, mlstm_block=16)


def _jax_case(case, params):
    """The JAX package's prefill + greedy-fed decode steps on one device:
    the logits [1 + STEPS, B, V]. The steps are jitted (the position
    traced): run eagerly, each call compiles its layer scan anew."""
    cfg = W.case_config(case, jget_config)
    toks, extra = R.inputs(case, cfg)
    cache = JM.init_cache(cfg, R.B, R.MAX_LEN,
                          enc_len=R.ENC_LEN if cfg.enc_dec else 0)
    prefill = jax.jit(lambda p, t, c, e: JM.prefill(cfg, p, t, c, rctx=RCTX,
                                                   **e))
    decode = jax.jit(lambda p, t, c, pos, kw: JM.decode_step(
        cfg, p, t, c, pos, rctx=RCTX, **kw))
    logits, cache = prefill(params, jnp.asarray(toks), cache,
                            {k: jnp.asarray(a) for k, a in extra.items()})
    out = [np.asarray(logits)]
    for i in range(R.STEPS):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        pos, lengths = R.decode_args(i)
        kw = {} if lengths is None else {"lengths": jnp.asarray(lengths)}
        logits, cache = decode(params, tok, cache, jnp.int32(pos), kw)
        out.append(np.asarray(logits))
    return np.stack(out)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the JAX logits by case, the ranks' results): the reference runs in
    a thread of this process while the port's world runs."""
    from repro_torch.launch.local_world import spawn_world
    d = tmp_path_factory.mktemp("slot_sharded")
    params = {}
    for c in CASES:
        key = W.model_key(c)
        if key not in params:
            params[key] = JM.init_params(W.case_config(c, jget_config),
                                         jax.random.PRNGKey(0))
    path = os.path.join(d, "params.pkl")
    with open(path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params), f)
    ref = {}
    th = threading.Thread(target=lambda: ref.update(
        {c["name"]: _jax_case(c, params[W.model_key(c)]) for c in CASES}))
    th.start()
    try:
        ranks = spawn_world(R.cases, 4, os.path.join(d, "world"),
                            device="cpu", timeout=600, group_timeout=600,
                            cases=CASES, params_path=path)
    finally:
        th.join()
    assert len(ref) == len(CASES)
    return ref, ranks


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_slot_steps_on_a_mesh_match_jax(both, case):
    ref, ranks = both
    want = ref[case["name"]]                      # [1 + STEPS, B, V]
    got = np.zeros_like(want)
    for r in ranks:
        res = r[case["name"]]
        assert res["shapes_ok"]
        lo, hi = res["rows"]
        lo, hi = lo or 0, R.B if hi is None else hi
        # the ranks of one data row agree bit for bit
        if got[:, lo:hi].any():
            np.testing.assert_array_equal(got[:, lo:hi], res["logits"])
        got[:, lo:hi] = res["logits"]
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_init_cache_refuses_a_sequence_it_cannot_split():
    """A K/V cache whose heads do not divide the model axis lies on the
    sequence: a length the axis does not divide raises before anything is
    allocated."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import model as TM
    cfg = get_config("llama3.2-3b").smoke()
    mesh = MeshShape((4,), ("model",))
    with pytest.raises(ValueError, match="multiple of it"):
        TM.init_cache(cfg, 2, 30, mesh=mesh)
    cache = TM.init_cache(cfg, 2, 32, mesh=mesh)
    assert cache[0][0]["k"].shape == (2, 2, 8, 2, 16)
    cfg = dataclasses.replace(cfg, num_kv_heads=4)        # heads divide
    assert TM.init_cache(cfg, 2, 30, mesh=mesh)[0][0]["k"].shape == (
        2, 2, 30, 1, 16)
