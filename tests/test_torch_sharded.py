"""PyTorch port: sharded paged serving over ``torch.distributed`` on the
CPU, against the JAX package (the port of ``tests/test_sharded_serving.py``).

Each world is spawned once (``launch/local_world.spawn_world`` with the
rank bodies of ``tests/_sharded_ranks.py``: gloo on CPU tensors through a
``file://`` store, every collective bounded by the group's 60 s timeout,
the world joined with a deadline) and every case runs inside it:

* world 4, meshes ``"4"`` and ``"2x2"``: the sharded dispatch of #1 and #2
  on the reference ops test's inputs (pad and non-pad block tables,
  windows and softcaps) within 2e-6 of the JAX oracles, reaching both
  partitions (heads: Hkv 4 at model 4 and 2, Hkv 2 at model 2; sequence:
  Hkv 2 at model 4); the sharded engine on smoke llama3.2-3b (Hkv 2) and
  its 8-KV-head variant: the driver's greedy tokens equal the JAX
  single-device engine's and the port's mesh-less engine's, also at
  ``spec_k`` 4 on looping prompts, one readback per round, the pool whole,
  ``shard_info`` as the rule says, every rank's dispatches equal; the
  sampled stream equal across meshes; the refusals (a mesh that is not the
  world, slot mode ignoring the mesh, a worker's scheduler, replicas that
  disagree);
* world 1: a mesh of one is bit-identical to ``mesh=None``;
* world 2: the launcher under torchrun-style variables (``--device cpu
  --smoke --mesh 2``) finishes every request and prints the banner.
"""
import dataclasses
import os
import socket
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _sharded_ranks as W  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import SlidingServeScheduler as JScheduler  # noqa: E402
from repro.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402
from repro.kernels.paged_prefill_attention.ref import (  # noqa: E402
    paged_prefill_attention_ref)
from repro.serving.engine import EngineCore as JEngine  # noqa: E402
from repro.serving.server import InferenceServer as JServer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.local_world import spawn_world  # noqa: E402
from repro_torch.params import from_jax_numpy  # noqa: E402
from repro_torch.serving.server import InferenceServer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ("4", "2x2")
TOL = 2e-6                  # the reference test's fp32 limit
_STATIC = ("scale", "window", "softcap")
_decode_oracle = jax.jit(paged_attention_ref, static_argnames=_STATIC)
_prefill_oracle = jax.jit(paged_prefill_attention_ref,
                          static_argnames=_STATIC)


def _cfg8(cfg):
    return dataclasses.replace(cfg, num_heads=8, num_kv_heads=8)


def _jax_run(jcfg, prompt_list, **kw):
    """The reference test's ``run`` on the JAX single-device engine; returns
    (tokens by rid, the engine's params as numpy)."""
    core = JEngine(jcfg, JScheduler(max_budget=256, max_iter_time=5.0),
                   cache_mode="paged", kv_capacity_tokens=2048,
                   decode_reserve_tokens=8, **kw)
    server = JServer(core)
    hs = [server.submit(p.copy(), slo_class=cls, max_output=5)
          for p, cls in prompt_list]
    server.run(max_wall_s=200.0)
    assert core.stats.token_readbacks == core.stats.iterations
    return ({h.rid: list(h.collected) for h in hs},
            jax.tree.map(np.asarray, core.params))


def _port_run(cfg, params, prompt_list, **kw):
    core = W.engine(cfg, params, **kw)
    server = InferenceServer(core)
    hs = [server.submit(p.copy(), slo_class=cls, max_output=5)
          for p, cls in prompt_list]
    server.run(max_wall_s=200.0)
    return {h.rid: list(h.collected) for h in hs}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX engine's greedy tokens (Hkv 2, Hkv 8, spec_k 4 on looping
    prompts), its parameters as torch tensors (saved for the ranks), and
    the port's mesh-less tokens (greedy, sampled)."""
    cfg = get_config("llama3.2-3b").smoke()
    jcfg = jget_config("llama3.2-3b").smoke()
    base, jparams = _jax_run(jcfg, W.prompts(cfg))
    base8, jparams8 = _jax_run(_cfg8(jcfg), W.prompts(cfg))
    spec_base, _ = _jax_run(jcfg, W.prompts(cfg, loopy=True))
    params = from_jax_numpy(cfg, jparams)
    params8 = from_jax_numpy(_cfg8(cfg), jparams8)
    path = tmp_path_factory.mktemp("sharded") / "params.pt"
    torch.save({"cfg": cfg, "params": params, "cfg8": _cfg8(cfg),
                "params8": params8}, path)
    port = {"greedy": _port_run(cfg, params, W.prompts(cfg)),
            "greedy8": _port_run(_cfg8(cfg), params8, W.prompts(cfg)),
            "spec": _port_run(cfg, params, W.prompts(cfg, loopy=True),
                              spec_k=4),
            "sampled": _port_run(cfg, params, W.prompts(cfg),
                                 temperature=0.7, top_k=20, sample_seed=11)}
    return {"path": str(path), "jax": {"greedy": base, "greedy8": base8,
                                       "spec": spec_base}, "port": port}


@pytest.fixture(scope="module")
def world4(ref, tmp_path_factory):
    """World 4 (gloo, CPU): the ops cases, then the engine cases, in one
    spawn."""
    return spawn_world(W.world4, 4, tmp_path_factory.mktemp("w4"),
                       device="cpu", timeout=150.0, meshes=MESHES,
                       heads=(2, 4), params_path=ref["path"])


# ---- #1 and #2 dispatch against the JAX oracles ----------------------------------
@pytest.mark.parametrize("spec,Hkv,part", [("4", 2, "sequence"),
                                           ("4", 4, "heads"),
                                           ("2x2", 2, "heads"),
                                           ("2x2", 4, "heads")])
def test_sharded_ops_match_jax_oracles(world4, spec, Hkv, part):
    """Every rank's sharded decode and prefill output equals the JAX
    oracle within 2e-6 on n 2, 6 (pad) and 8, windows 0/7, softcaps 0/30;
    the ranks agree bit for bit."""
    ops = [r["ops"] for r in world4]
    for n in W.OPS_N:
        x = {k: jnp.asarray(v) for k, v in W.ops_inputs(Hkv, n).items()}
        kp, vp = x["kvp"][:, :, 0], x["kvp"][:, :, 1]
        for window, cap in W.OPS_WC:
            want = np.asarray(_decode_oracle(
                x["q"], kp, vp, x["bt"], x["ln"], scale=0.25,
                window=window, softcap=cap))
            wantp = np.asarray(_prefill_oracle(
                x["qp"], kp, vp, x["bt"], x["rp"], x["ln"], scale=0.25,
                window=window, softcap=cap))
            key = (spec, Hkv, n, window, cap)
            dec, pre, got_part = ops[0][key]
            assert got_part == part, key
            assert np.max(np.abs(dec - want)) < TOL, ("decode", key)
            assert np.max(np.abs(pre - wantp)) < TOL, ("prefill", key)
            for r in ops[1:]:
                assert np.array_equal(r[key][0], dec), ("decode ranks", key)
                assert np.array_equal(r[key][1], pre), ("prefill ranks", key)


# ---- the engine -------------------------------------------------------------------
def _driver(world4, spec, name):
    res = world4[0]["engines"][spec, name]
    assert all(r["engines"][spec, name] is None for r in world4[1:])
    assert res["readbacks"] == res["iterations"] > 0
    assert res["pool_whole"], "KV pages leaked"
    # every rank ran the driver's dispatches, and only the driver rounds
    calls = [{k: c[k] for k in ("decode_calls", "prefill_calls",
                                "spec_calls")} for c in res["counters"]]
    assert all(c == calls[0] for c in calls), calls
    assert calls[0]["decode_calls"] + calls[0]["prefill_calls"] > 0
    return res


@pytest.mark.parametrize("spec", MESHES)
@pytest.mark.parametrize("name,partition", [("greedy", None),
                                            ("greedy8", "heads")])
def test_sharded_engine_greedy_tokens_match_jax(world4, ref, spec, name,
                                                partition):
    """The driver's greedy tokens equal the JAX single-device engine's and
    the port's mesh-less engine's (Hkv 2: sequence at "4", heads at
    "2x2"; Hkv 8: heads), and shard_info follows the rule."""
    res = _driver(world4, spec, name)
    assert res["tokens"] == ref["jax"][name] == ref["port"][name]
    assert all(len(t) == 5 for t in res["tokens"].values())
    info = res["shard_info"]
    model = int(spec.split("x")[-1])
    kv = 2 if name == "greedy" else 8
    want = partition or ("sequence" if kv % model else "heads")
    assert info["kv_partition"] == want, info
    assert info["kv_shards"] == (model if want == "heads" else 1)
    assert info["kv_heads_per_shard"] == kv // info["kv_shards"]
    assert info["mesh"] == spec and info["pages_total"] > 0
    assert f"kv_partition={want}" in res["banner"]
    assert "data_plane=gloo world=4" in res["banner"]


@pytest.mark.parametrize("spec", MESHES)
def test_sharded_engine_spec_k_matches_unspeculated(world4, ref, spec):
    """spec_k 4 on looping prompts: speculation engages and the tokens are
    the unspeculated JAX stream's."""
    res = _driver(world4, spec, "spec")
    assert res["spec_rounds"] > 0, "speculation never engaged"
    assert res["tokens"] == ref["jax"]["spec"] == ref["port"]["spec"]
    assert any(c["spec_calls"] > 0 for c in res["counters"])


def test_sampled_stream_equal_across_meshes(world4, ref):
    """temperature 0.7, top-k 20, seed 11: the same stream on every mesh
    and without one, and not the greedy stream."""
    streams = [_driver(world4, spec, "sampled")["tokens"]
               for spec in MESHES]
    assert streams[0] == streams[1] == ref["port"]["sampled"]
    assert streams[0] != ref["port"]["greedy"]


def test_refusals(world4):
    """A mesh that is not the world size raises; slot mode ignores the
    mesh; the driver is the only rank with a scheduler; replicas that
    disagree raise at start-up on every rank."""
    for rank, r in enumerate(world4):
        got = r["engines"]["refused"]
        assert "holds 2 ranks, the world 4" in got["mesh_size"]
        mesh, info = got["slot_mesh"]
        assert mesh is None and info["kv_partition"] == "none"
        want = ("other than 0" if rank == 0 else
                f"rank {rank} is a worker")
        assert want in got["scheduler"]
        assert "hold different parameters" in got["replicas"]


# ---- a mesh of one, the launcher ---------------------------------------------------
def test_mesh_of_one_is_bit_identical(ref, tmp_path):
    """World 1 (gloo): mesh "1" drives the sharded engine's code path and
    gives the mesh-less engine's outputs, every request finished, one
    readback per round."""
    (none, one), = spawn_world(W.mesh_of_one, 1, tmp_path, device="cpu",
                               timeout=120.0,
                               params_path=ref["path"])
    assert none[1:3] == (True, True) and one[1:3] == (True, True)
    assert one[0] == none[0]
    assert one[3]["mesh"] == "1" and one[3]["kv_partition"] == "none"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch_two_ranks(port):
    """Both ranks of the launcher on ``port``; (return codes, outputs).
    Rank 0 is awaited first: when it cannot bind the port, rank 1 (which
    may have reached another process's listener) is killed at once."""
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                   RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        env.pop("REPRO_FORCE_MESH", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", "--device",
             "cpu", "--smoke", "--mesh", "2", "--requests", "4", "--qps",
             "50"], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        outs.append(procs[0].communicate(timeout=120))
        if procs[0].returncode != 0:
            procs[1].kill()
        outs.append(procs[1].communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [p.returncode for p in procs], outs


def test_launcher_mesh_two_ranks_on_cpu():
    """``python -m repro_torch.launch.serve --device cpu --smoke --mesh 2``
    in two processes with torchrun's variables: rank 0 prints the banner
    and finishes every request; rank 1 serves as the worker and exits.
    torchrun's rendezvous is a TCP port, which another process may take
    between ``_free_port`` and rank 0's bind: then rank 0 fails with
    EADDRINUSE before serving anything, and the run is repeated on a new
    port (at most twice more)."""
    for _ in range(3):
        rcs, outs = _launch_two_ranks(_free_port())
        if rcs[0] == 0 or "EADDRINUSE" not in outs[0][1]:
            break
    assert rcs == [0, 0], outs
    out0 = outs[0][0]
    assert ("sharded paged executor: mesh=2 kv_partition=heads shards=2 "
            "data_plane=gloo world=2") in out0, out0
    assert "finished 4/4" in out0, out0
    assert outs[1][0] == "", outs[1]
