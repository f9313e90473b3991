"""PyTorch port: ZeRO-3 parameters (``fsdp``) and the wide data-parallel
batch (``wide_dp``) on the CPU, against the JAX package.

One world of 4 gloo ranks (``launch/local_world.spawn_world``, the bodies
of ``tests/_sharded_train_ranks.py`` and ``tests/_slot_sharded_ranks.py``)
runs every case, while the reference's sharded steps run in a subprocess
of their own on 4 host devices with Auto axes
(``tests/_sharded_train_ref.py``: its ``param_specs(..., fsdp=True)``, or
the batch on ``P(("data", "model"), None)``) and the reference's slot
steps run on one device in a thread of this process. Both start from the
reference's ``init_params(cfg, PRNGKey(0))``.

* The train step at ``2x2`` with the parameters and AdamW's state at
  ``param_specs(..., fsdp=True)``'s slices: llama3.2-3b, jamba (14 leaves
  sliced along their repetitions: a rank holds one of the two; expert
  parallelism) and deepseek-v3 (MLA, MTP, expert parallelism), against
  the reference's sharded step with the same placement; xlstm-125m with
  the batch's rows on the data and model axes (a row a rank), against the
  reference's step with the batch so placed. Within
  ``test_sharded_train_step_matches_jax``'s limits: the loss and the
  gradient norm to 1e-5 relative, every leaf of the first moment to 1e-4
  of its largest, the second step's loss to 1e-5 relative.
* After two steps every rank's parameters and m/v/master are still at
  their local shapes: no rank keeps a whole leaf.
* The slot path under ``fsdp`` at ``2x2``: llama3.2-3b's and jamba's
  ``prefill`` of 20 tokens and 8 greedy ``decode_step``s, each layer's
  slices gathered at use, against the JAX package on one device: every
  step's logits within 2e-5, the greedy tokens equal.
* The rules: ``fsdp_dims`` names the dim ``param_specs(..., fsdp=True)``
  adds, ``with_fsdp`` rebuilds those specs from it, ``batch_axes`` places
  the wide batch where its axes divide it, and a mesh without a
  data-parallel axis refuses ``fsdp``.
"""
import os
import pickle
import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _sharded_train_ranks as W  # noqa: E402
import test_torch_slot_sharded as SS  # noqa: E402
import test_torch_train_sharded as TS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.params import init_params  # noqa: E402
from repro_torch.train import tree as T  # noqa: E402

FSDP_ARCHS = ("llama3.2-3b", "jamba-1.5-large-398b", "deepseek-v3-671b")
TRAIN_CASES = ([dict(TS.train_case_spec(a, "2x2", name=f"{a} 2x2 fsdp"),
                     fsdp=True) for a in FSDP_ARCHS]
               + [dict(TS.train_case_spec("xlstm-125m", "2x2",
                                          name="xlstm-125m 2x2 wide_dp"),
                       wide_dp=True)])
SLOT_CASES = [{"name": f"{a} 2x2 fsdp slot", "kind": "slot", "arch": a,
               "mesh": "2x2", "fsdp": True}
              for a in ("llama3.2-3b", "jamba-1.5-large-398b")]
MESH = MeshShape((2, 2), ("data", "model"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's train results, the JAX slot logits by case, the
    ranks' results): the reference's subprocess, the JAX slot steps in a
    thread, and the port's world, all at once."""
    ref = W.start_reference(TRAIN_CASES + SLOT_CASES,
                            tmp_path_factory.mktemp("fsdp"))
    try:
        with open(W.reference_params(ref), "rb") as f:
            params = pickle.load(f)
        slot = {}

        def jax_slot():
            for c in SLOT_CASES:
                slot[c["name"]] = SS._jax_case(c, jax.tree.map(
                    jnp.asarray, params[W.model_key(c)]))
        th = threading.Thread(target=jax_slot)
        th.start()
        try:
            ranks = W.run_port(ref)
        finally:
            th.join()
        assert len(slot) == len(SLOT_CASES)
        return W.reference_results(ref), slot, ranks
    finally:
        if ref["proc"].poll() is None:
            ref["proc"].kill()
            ref["proc"].wait()


@pytest.mark.parametrize("case", TRAIN_CASES, ids=lambda c: c["name"])
def test_train_step_matches_jax(runs, case):
    ref, _, ranks = runs
    TS.check_train_case((ref, ranks), case)


@pytest.mark.parametrize("case", TRAIN_CASES, ids=lambda c: c["name"])
def test_every_leaf_stays_at_its_local_shape(runs, case):
    _, _, ranks = runs
    assert all(r[case["name"]]["shapes_after_ok"] for r in ranks)


@pytest.mark.parametrize("case", SLOT_CASES, ids=lambda c: c["name"])
def test_slot_steps_match_jax(runs, case):
    _, slot, ranks = runs
    want = slot[case["name"]]                    # [1 + STEPS, B, V]
    got = np.zeros_like(want)
    for r in ranks:
        res = r[case["name"]]
        assert res["shapes_ok"]
        lo, hi = res["rows"]
        lo, hi = lo or 0, want.shape[1] if hi is None else hi
        got[:, lo:hi] = res["logits"]
    np.testing.assert_allclose(got, want, **SS.TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("arch", FSDP_ARCHS + ("xlstm-125m",))
def test_fsdp_dims_rebuild_the_fsdp_specs(arch):
    cfg = get_config(arch).smoke()
    shapes = init_params(cfg, device="meta")
    dims = shd.fsdp_dims(cfg, shapes, MESH)
    want = shd.param_specs(cfg, shapes, MESH, fsdp=True)
    got = shd.with_fsdp(shd.param_specs(cfg, shapes, MESH), dims, MESH)
    assert [tuple(s) for s in T.leaves(got)] == \
        [tuple(s) for s in T.leaves(want)]
    flat = T.flatten_up_to(shapes, dims)
    assert all(d is None or s[d] == "data" for d, s in
               zip(flat, T.leaves(want)))


def test_jamba_leaves_sliced_along_their_repetitions():
    """At ``2x2`` jamba's smoke ``mamba`` ``conv_b`` and ``D`` (and their
    kind) find their stack of 2 the largest free dim: 14 leaves, which
    the model gathers whole before the repetitions."""
    cfg = get_config("jamba-1.5-large-398b").smoke()
    shapes = init_params(cfg, device="meta")
    dims = shd.fsdp_dims(cfg, shapes, MESH)
    stacked = [p for (p, _), d in zip(
        T.leaves_with_paths(shapes), T.flatten_up_to(shapes, dims))
        if p.startswith("['stacks']") and d == 0]
    assert len(stacked) == 14
    assert {p.rsplit("[", 1)[1] for p in stacked} == {"'conv_b']", "'D']"}


def test_batch_axes_and_refusals():
    assert shd.batch_axes(MESH, 4, wide_dp=True) == ("data", "model")
    assert shd.batch_axes(MESH, 2, wide_dp=True) == ("data",)
    assert shd.batch_axes(MESH, 3, wide_dp=True) == ()
    assert shd.batch_axes(MESH, 4) == ("data",)
    cfg = get_config("xlstm-125m").smoke()
    shapes = init_params(cfg, device="meta")
    assert shd.blocks_replicated(cfg, shapes, MESH)
    llama = get_config("llama3.2-3b").smoke()
    assert not shd.blocks_replicated(
        llama, init_params(llama, device="meta"), MESH)
    from repro_torch.train.train_step import TrainLayout
    with pytest.raises(ValueError, match="data-parallel axes"):
        TrainLayout(llama, MeshShape((4,), ("model",)), fsdp=True)
