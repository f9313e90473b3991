"""PyTorch port: the expert-parallel MoE route against the JAX package's.

* ``_dispatch_local`` / ``_combine_local`` against the reference's on the
  same numpy inputs, with tokens past capacity (dropped);
* ``moe_ffn`` with ``MoEContext(impl="ep")`` at meshes ``1x4`` and
  ``2x2`` over a world of 4 gloo ranks on the CPU, with S 8 (the
  sequence splits over the model axis: ``all_to_all`` between the ranks'
  capacity buffers) and S 7 (the replicated route), against the
  reference's ``moe_ffn_ep`` / ``_moe_ep_replicated`` on a mesh of 4 host
  devices (``tests/_sharded_train_ref.py``, one subprocess): y and aux
  within ``1e-5 + 1e-5 |ref|``, the gradients of sum(y^2) with respect to
  x and the expert weights within ``1e-4 max |g_ref|``;
* the sharded train step of the two expert-parallel archs of the slice
  (qwen2-moe-a2.7b; jamba-1.5-large-398b, also Mamba on the rank's
  ``d_inner`` channels) at ``2x2`` against the reference's sharded step,
  as ``tests/test_torch_train_sharded.py`` holds the others: its loss is
  not the dense loss (capacity drops, each shard's own aux);
* ``update_router_bias`` against the reference's.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _sharded_train_ranks as W  # noqa: E402
import test_torch_train_sharded as TS  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402

MOE_CASES = [{"name": f"moe {mesh} S{S}", "kind": "moe", "mesh": mesh,
              "S": S} for mesh in ("1x4", "2x2") for S in (8, 7)]
TRAIN_CASES = [TS.train_case_spec(arch, "2x2")
               for arch in ("qwen2-moe-a2.7b", "jamba-1.5-large-398b")]


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """The reference on every case, started with the module's first test;
    killed at the module's end if still running."""
    ref = W.start_reference(MOE_CASES + TRAIN_CASES,
                            tmp_path_factory.mktemp("moe_ep"))
    yield ref
    if ref["proc"].poll() is None:
        ref["proc"].kill()
        ref["proc"].wait()


@pytest.fixture(scope="module")
def both(reference):
    ranks = W.run_port(reference)
    return W.reference_results(reference), ranks


def _dispatch_inputs(T, K, E, seed):
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(T, 6)).astype(np.float32)
    # skewed choices, so that some experts overflow their capacity
    ids = rng.choice(E, size=(T, K), p=np.arange(E, 0, -1) / (E * (E + 1) / 2))
    w = rng.random((T, K)).astype(np.float32)
    return t, ids.astype(np.int32), w


@pytest.mark.parametrize("T,K,E,cap", [(24, 2, 8, 4), (17, 3, 4, 8),
                                       (10, 1, 2, 4), (12, 2, 16, 8)])
def test_dispatch_and_combine_match_jax(T, K, E, cap):
    """The capacity buffers, the kept flags and the combined output equal
    the reference's (tokens past ``cap`` are dropped in both)."""
    t, ids, w = _dispatch_inputs(T, K, E, seed=T * K)
    jbuf, jmeta = JMoE._dispatch_local(jnp.asarray(t), jnp.asarray(ids),
                                       jnp.asarray(w), E, cap)
    buf, meta = TMoE._dispatch_local(torch.from_numpy(t),
                                     torch.from_numpy(ids).long(),
                                     torch.from_numpy(w), E, cap)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    for a, b in zip(meta, jmeta):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    over = np.bincount(ids.ravel(), minlength=E).max() > cap
    assert bool(meta[2].all()) != over      # drops exactly when over cap
    out = np.random.default_rng(7).normal(size=(E, cap, 6)).astype(np.float32)
    want = JMoE._combine_local(jnp.asarray(out), jmeta, jnp.asarray(w), T, K)
    got = TMoE._combine_local(torch.from_numpy(out), meta,
                              torch.from_numpy(w), T, K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("case", MOE_CASES, ids=lambda c: c["name"])
def test_moe_ffn_ep_matches_jax(both, case):
    """y and aux within 1e-5 + 1e-5 |ref|; the gradients of sum(y^2) with
    respect to x and each expert stack within 1e-4 max |g_ref|."""
    ref, ranks = both
    want, got = ref[case["name"]], ranks[0][case["name"]]
    np.testing.assert_allclose(got["y"], want["y"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-5, atol=1e-5)
    for k in ("x", "w_gate", "w_up", "w_down"):
        lim = 1e-4 * np.abs(want[k]).max()
        assert np.abs(got[k] - want[k]).max() <= lim, k


@pytest.mark.parametrize("case", TRAIN_CASES, ids=lambda c: c["name"])
def test_expert_parallel_train_step_matches_jax(both, case):
    TS.check_train_case(both, case)


def test_update_router_bias_matches_jax():
    rng = np.random.default_rng(3)
    E, real = 16, 11
    bias = rng.normal(size=(E,)).astype(np.float32)
    load = rng.dirichlet(np.ones(E)).astype(np.float32)
    load[3] = 1.0 / real                    # balanced: no step
    want = JMoE.update_router_bias({"router_bias": jnp.asarray(bias),
                                    "router": 1}, jnp.asarray(load), real)
    got = TMoE.update_router_bias({"router_bias": torch.from_numpy(bias),
                                   "router": 1}, torch.from_numpy(load), real)
    assert got["router"] == 1
    np.testing.assert_array_equal(got["router_bias"].numpy(),
                                  np.asarray(want["router_bias"]))
