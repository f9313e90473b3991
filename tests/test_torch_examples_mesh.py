"""PyTorch port: ``examples/serve_streaming_torch.py`` on a mesh and
``examples/router_smoke_torch.py``, on the CPU.

* One world of 4 spawned ranks (``tests/_examples_ranks.py``: gloo, a
  ``file://`` store, each collective bounded by the group's timeout and
  the world by a deadline) runs the streaming demo, ``--shared-prefix``
  and ``--spec-k 4`` at mesh ``2x2`` (the KV heads partitioned) and ``4``
  (the sequence): the driver's streams equal the mesh-less port's, and
  every check of the example holds (one readback per round, no leaked
  page, the cancelled stream aborted, the stop token, the prefix cache
  hit, speculation accepted); the workers return nothing; the slot demo
  ignores the mesh (rank 0 serves alone).
* The router smoke runs once as a subprocess (its own HTTP server
  subprocess with two replicas): its five checks pass and it exits 0.
  It starts before the world and runs beside it.
"""
import os
import signal
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import _examples_ranks as W  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.local_world import spawn_world  # noqa: E402

MESHES = ("2x2", "4")
PARTITION = {"2x2": "heads", "4": "sequence"}
ROUTER_TIMEOUT = 150.0


@pytest.fixture(scope="module")
def router():
    """The router smoke, started as a process group of its own (so that a
    timeout ends its server subprocess too)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(W.ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "2"       # beside the world's ranks
    env.pop("REPRO_FORCE_MESH", None)
    proc = subprocess.Popen(
        [sys.executable, str(W.ROOT / "examples" / "router_smoke_torch.py"),
         "--device", "cpu"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    yield proc
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(10)


@pytest.fixture(scope="module")
def ex():
    return W.load_example("serve_streaming_torch")


@pytest.fixture(scope="module")
def meshless(ex):
    """The scenarios on the port without a mesh (the bit-identity
    baseline)."""
    cfg = get_config("llama3.2-3b").smoke()
    out = {}
    for name, fn, kw in W.scenarios(ex):
        out[name] = fn(cfg, kv_capacity_tokens=W.KV, device="cpu", **kw)
    return out


@pytest.fixture(scope="module")
def world4(router, meshless, tmp_path_factory):
    return spawn_world(W.world, 4, tmp_path_factory.mktemp("examples"),
                       device="cpu", timeout=150.0, meshes=MESHES)


def _driver(world4, spec, name):
    rec, text = world4[0][spec, name]
    assert rec is not None
    assert all(r[spec, name] == (None, "") for r in world4[1:])
    return rec, text


@pytest.mark.parametrize("spec", MESHES)
def test_demo_on_a_mesh(ex, world4, meshless, spec):
    """Streams, the cancel after 3 tokens, the stop token and every counter
    equal the mesh-less run; the demo's checks hold."""
    rec, text = _driver(world4, spec, "demo")
    ex.check_demo(rec)
    assert rec == meshless["demo"]
    assert rec["spam_reason"] == "aborted" and rec["stop_reason"] == "stop"
    assert f"kv_partition={PARTITION[spec]}" in text
    assert "data_plane=gloo world=4" in text


@pytest.mark.parametrize("spec", MESHES)
def test_shared_prefix_on_a_mesh(ex, world4, meshless, spec):
    """Cache on and off: the mesh-less streams and ``cache_info``, a hit
    rate above 0, fewer prefill tokens computed, the pool whole."""
    rec, text = _driver(world4, spec, "prefix")
    ex.check_shared_prefix(rec)
    for pc in (True, False):
        got, want = rec["runs"][pc], meshless["prefix"]["runs"][pc]
        assert got["tokens"] == want["tokens"]
        assert got["cache_info"] == want["cache_info"]
    assert text.count("kv_partition=") == 1


@pytest.mark.parametrize("spec", MESHES)
def test_spec_on_a_mesh(ex, world4, meshless, spec):
    """spec_k 4 against 0: the mesh-less streams and speculation counters;
    acceptance above 0 and more than one token a verify row."""
    rec, _ = _driver(world4, spec, "spec")
    ex.check_spec(rec)
    for got, want in zip(rec["runs"], meshless["spec"]["runs"]):
        assert got["tokens"] == want["tokens"]
        assert got["spec_info"] == want["spec_info"]


def test_slot_demo_ignores_the_mesh(ex, world4):
    """Slot mode builds no mesh: rank 0 serves alone, with no banner, and
    its checks hold."""
    rec, text = _driver(world4, MESHES[-1], "slot")
    ex.check_demo(rec)
    assert rec["cache_mode"] == "slot" and "kv_partition" not in text


def test_router_smoke_passes(router, world4):
    """All five checks (SSE parity with the in-process engine, the HTTP
    cancel, directory hits and affine routing, one readback a round per
    replica, the SIGINT drain) and exit code 0."""
    try:
        out, _ = router.communicate(timeout=ROUTER_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(router.pid, signal.SIGKILL)
        out, _ = router.communicate()
        pytest.fail(f"router smoke outlived {ROUTER_TIMEOUT} s:\n{out}")
    assert router.returncode == 0, out
    for line in ("parity OK: 5 SSE streams bit-identical",
                 "cancel OK: aborted mid-stream", "router OK: directory hit",
                 "shutdown OK: SIGINT drained and exited 0",
                 "ROUTER SMOKE PASSED"):
        assert line in out, out
