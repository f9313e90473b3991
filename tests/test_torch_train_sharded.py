"""PyTorch port: sharded training over ``torch.distributed`` on the CPU,
against the JAX package's sharded step.

The port runs on a world of 4 gloo ranks (``launch/local_world.
spawn_world``, the rank bodies of ``tests/_sharded_train_ranks.py``); the
reference runs in one subprocess of its own on a mesh of 4 host devices
built with Auto axes (``tests/_sharded_train_ref.py``: its own
``make_rctx``, ``param_specs``, ``opt_state_specs`` and
``make_train_step``), at the same time. Both start from the reference's
``init_params(cfg, PRNGKey(0))`` (the port's through ``from_jax_numpy``),
take the same batches and block their loss alike (``W.LOSS_BLOCKS``).

* The train step of every dense arch of the slice at mesh ``2x2``
  (llama3.2-3b; gemma2-2b and -27b: window, softcaps, post-norms;
  qwen3-1.7b: q/k norms; xlstm-125m: data-parallel only), smoke llama also
  at ``1x4`` (two ranks share a KV head: the K/V projection is gathered),
  ``4`` (no data-parallel axis) and ``2x1x2`` (with ``pod``), and with
  ``grad_accum`` 2 and with ``compress_grads``: after one step the loss
  and the gradient norm within 1e-5 relative, every leaf of AdamW's first
  moment ((1 - b1) clip g, so the gradient) within 1e-4 max |m_ref|, and
  the second step's loss within 1e-5 relative; every rank's m/v/master at
  ``opt_state_specs``' local shape. The expert-parallel archs are held in
  ``tests/test_torch_moe_ep.py``.
* The features that no mesh refuses any longer, held the same way:
  deepseek-v3 at ``2x2`` (MLA on the rank's heads, the vocab-parallel MTP
  loss, the MoE through expert parallelism), seamless-m4t at ``2x2`` (the
  encoder's blocks and cross attention on the rank's heads; encoder
  frames from the batch), internvl2 at ``2x2`` (patch embeddings from the
  batch) and smoke llama with 2 query heads over 1 KV head at ``4`` (half
  a head a rank: the q projection gathered, each rank's ``wo`` rows on
  its own columns). ``make_rctx`` takes every arch on a mesh; a mesh
  without a process group raises.
* Checkpoints (in the same world, after the cases): a step at ``2x2``
  saved one whole leaf at a time, restored at world 1 (and by the JAX
  package) and at ``1x4``, bit-equal after gathering; a world-1
  checkpoint restored at ``2x2``; the supervisor restoring on every rank
  after a failure at ``2x2``.
* The launcher under ``torchrun``'s variables: ``--mesh 2x2 --device cpu
  --smoke --steps 3`` prints finite losses equal to the one-device
  launcher's.
"""
import dataclasses
import os
import re
import socket
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import _sharded_train_ranks as W  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch.mesh import MeshShape, make_train_mesh  # noqa: E402
from repro_torch.launch.steps import make_rctx  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def train_case_spec(arch, mesh, grad_accum=1, compress=False, name=None,
                    changes=None):
    return {"name": name or f"{arch} {mesh}", "kind": "train", "arch": arch,
            "mesh": mesh, "B": 4, "S": 32, "grad_accum": grad_accum,
            "compress": compress, "steps": 2, "changes": changes or {}}


# smoke llama with half a query head a rank at mesh "4"
TWO_HEADS = {"num_heads": 2, "num_kv_heads": 1}


def _assert_moments(got, want, compressed):
    """Every leaf within 1e-4 max |m_ref|. After the int8 round trip an
    element whose gradient lies at a rounding boundary may take the
    neighbouring code on either side (the two gradients differ in their
    last bits): its moment then differs by one step of its block,
    (1 - b1) clip scale = the block's max |m| / 127 (the block's largest
    element is coded 127). Such elements must be exactly one step off and
    at most one in a thousand."""
    flips = total = 0
    for k, w in want.items():
        g = got[k]
        lim = 1e-4 * np.abs(w).max()
        off = np.abs(g - w)
        bad = off > lim
        if compressed and bad.any():
            flat = np.abs(w).reshape(-1)
            flat = np.pad(flat, (0, -flat.size % 256)).reshape(-1, 256)
            step = np.repeat(flat.max(axis=1) / 127.0, 256)[:w.size]
            one = np.abs(off.reshape(-1) - step) <= lim
            assert not (bad.reshape(-1) & ~one).any(), k
            flips += int(bad.sum())
        else:
            assert not bad.any(), (k, off.max(), lim)
        total += w.size
    assert flips <= total // 1000, (flips, total)


def check_train_case(both, case):
    ref, ranks = both
    want = ref[case["name"]]
    got = [r[case["name"]] for r in ranks]
    assert all(g["shapes_ok"] for g in got)
    for g in got:                 # every rank reports the same step
        assert g["loss"] == got[0]["loss"]
        assert g["grad_norm"] == got[0]["grad_norm"]
    got = got[0]
    np.testing.assert_allclose(got["loss"][0], want["loss"][0], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["loss"][1], want["loss"][1], rtol=1e-5)
    assert set(got["m"]) == set(want["m"])
    _assert_moments(got["m"], want["m"], case["compress"])


CASES = ([train_case_spec("llama3.2-3b", m)
          for m in ("2x2", "1x4", "4", "2x1x2")]
         + [train_case_spec("llama3.2-3b", "2x2", grad_accum=2,
                            name="llama3.2-3b 2x2 grad_accum 2"),
            train_case_spec("llama3.2-3b", "2x2", compress=True,
                            name="llama3.2-3b 2x2 compress_grads")]
         + [train_case_spec(a, "2x2") for a in ("gemma2-2b", "gemma2-27b",
                                                "qwen3-1.7b", "xlstm-125m")]
         + [train_case_spec(a, "2x2") for a in (
             "deepseek-v3-671b", "seamless-m4t-large-v2", "internvl2-26b")]
         + [train_case_spec("llama3.2-3b", "4", changes=TWO_HEADS,
                            name="llama3.2-3b 2 heads 4")])


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """The reference on CASES, started with the module's first test, so it
    runs while the port's world and the launcher run; killed at the
    module's end if still running."""
    ref = W.start_reference(CASES, tmp_path_factory.mktemp("train_sharded"))
    yield ref
    if ref["proc"].poll() is None:
        ref["proc"].kill()
        ref["proc"].wait()


@pytest.fixture(scope="module")
def port(reference):
    """One world of the port's 4 ranks: CASES, then the checkpoints
    (``W.checkpoints``), with the world-1 checkpoint written here first;
    the weights are the reference's."""
    import pickle

    from repro_torch.train import checkpoint
    from repro_torch.train import tree as T
    d = reference["workdir"]
    with open(W.reference_params(reference), "rb") as f:
        params_np = pickle.load(f)
    case = W.CKPT_CASE
    cfg = get_config(case["arch"]).smoke()
    single = _single_step_state(cfg, params_np[case["arch"]], case)
    checkpoint.save(os.path.join(d, "world1"), 1, single)
    ranks = W.run_port(reference, ckpt={
        "saved": os.path.join(d, "saved"),
        "world1": os.path.join(d, "world1")})
    return {"dir": d, "ranks": ranks, "cfg": cfg, "params_np": params_np,
            "ckpt": [r["checkpoints"] for r in ranks],
            "single": {p: x.detach().numpy().copy()
                       for p, x in T.leaves_with_paths(single)}}


@pytest.fixture(scope="module")
def both(reference, port):
    return W.reference_results(reference), port["ranks"]


# ---- every arch on a mesh --------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_make_rctx_takes_every_arch_on_a_mesh(arch):
    """No feature is refused on a mesh: the context needs only its sizes."""
    cfg = get_config(arch).smoke()
    mesh = MeshShape((2, 2), ("data", "model"))
    assert make_rctx(cfg, mesh, train=True, seq_len=32).mesh is mesh
    assert make_rctx(cfg, None, train=True, seq_len=32).mesh is None


def test_mesh_without_process_group_raises():
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_train_mesh("2x2", device_type="cpu")


# ---- checkpoints across meshes ------------------------------------------------------
def _single_step_state(cfg, params_np, case):
    """One step of the port on one device (the world-1 run)."""
    from repro_torch.params import from_jax_numpy
    from repro_torch.train.train_step import init_train_state
    params = from_jax_numpy(cfg, params_np)
    tcfg = W._train_config(case)
    state = {"params": params,
             "train": init_train_state(cfg, params, tcfg)}
    rctx = dataclasses.replace(make_rctx(cfg, None, train=True,
                                         seq_len=case["S"]),
                               loss_vocab_blocks=W.LOSS_BLOCKS)
    step = make_train_step(cfg, rctx, tcfg)
    toks = torch.from_numpy(W.batches(case, cfg.vocab_size)[0])
    p, t, _ = step(state["params"], state["train"], {"tokens": toks})
    return {"params": p, "train": t}


def _assert_bits_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_checkpoint_written_at_2x2_restores_at_world_1_and_by_jax(port):
    """Rank 0 wrote the whole tree: the port on one device and the JAX
    package restore it bit for bit. Every rank held one whole leaf at a
    time while saving."""
    from repro.train import checkpoint as JCK
    from repro.train.optimizer import AdamWConfig as JAdamW
    from repro.train.train_step import TrainConfig as JTrainConfig
    from repro.train.train_step import init_train_state as jinit_state
    from repro_torch.train import checkpoint
    from repro_torch.train import tree as T
    saved = port["ckpt"][0]["saved"]
    assert all(r["most_whole_leaves"] == 1 for r in port["ckpt"])
    d = os.path.join(port["dir"], "saved")
    assert checkpoint.latest_step(d) == 1
    arch = W.CKPT_CASE["arch"]
    like = T.tree_map(torch.zeros_like, _single_step_state(
        port["cfg"], port["params_np"][arch], W.CKPT_CASE))
    got = checkpoint.restore(d, 1, like)
    _assert_bits_equal({p: x.numpy() for p, x in T.leaves_with_paths(got)},
                       saved)
    jparams = jax.tree.map(jax.numpy.asarray, port["params_np"][arch])
    jlike = {"params": jparams, "train": jinit_state(
        None, jparams, JTrainConfig(optimizer=JAdamW(**W.OPT)))}
    jgot = JCK.restore(d, 1, jlike)
    _assert_bits_equal({jax.tree_util.keystr(p): np.asarray(x) for p, x in
                        jax.tree_util.tree_flatten_with_path(jgot)[0]}, saved)
    assert JCK.manifest_of(d, 1)["extra"] == {"mesh": [[2, 2],
                                                       ["data", "model"]]}


def test_checkpoint_restores_across_meshes(port):
    """The 2x2 checkpoint restored at 1x4, and the world-1 checkpoint at
    2x2, are bit-equal to what was saved after gathering; each restore
    reports its resharding plan."""
    r0 = port["ckpt"][0]
    _assert_bits_equal(r0["at_1x4"], r0["saved"])
    _assert_bits_equal(r0["world1_at_2x2"], port["single"])
    assert r0["plan_1x4"]["tp_reshard_required"]
    assert r0["plan_1x4"]["old"] == "data=2 x model=2"
    assert r0["plan_1x4"]["new"] == "data=1 x model=4"
    assert r0["plan_world1"]["old"] == "data=1 x model=1"


def test_supervisor_restores_on_every_rank(port):
    """A failure injected at step 2 on every rank: one restart from the
    sharded checkpoint of step 2, the replayed losses equal the
    uninterrupted run's, and every rank's parameters end bit-equal."""
    r0 = port["ckpt"][0]
    assert (r0["end"], r0["restarts"]) == (W.CKPT_CASE["steps"], 1)
    assert r0["losses"]["supervised"] == r0["losses"]["uninterrupted"]
    assert all(r["params_equal"] and r["restarts"] == 1
               for r in port["ckpt"])


# ---- the launcher -------------------------------------------------------------------
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


LAUNCH = ["--device", "cpu", "--smoke", "--steps", "3", "--seq", "32",
          "--global-batch", "4"]


def _start_launch(workdir, port, world=4):
    """The launcher's ranks under torchrun's variables on ``port``, at
    ``--mesh 2x2``, each writing its output to files in ``workdir``."""
    procs = []
    for rank in range(world):
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                   RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        env.pop("REPRO_FORCE_MESH", None)
        with open(os.path.join(workdir, f"{port}.{rank}.out"), "w") as out, \
                open(os.path.join(workdir, f"{port}.{rank}.err"), "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.train", "--mesh",
                 "2x2", *LAUNCH], env=env, stdout=out, stderr=err))
    return {"procs": procs, "workdir": workdir, "port": port}


def _finish_launch(run):
    """(return codes, (stdout, stderr) of each rank). Rank 0 is awaited
    first: when it failed (a port it could not bind), the others are
    killed at once."""
    procs = run["procs"]
    try:     # the timeouts bound a hang; a loaded host takes its time
        procs[0].wait(timeout=600)
        if procs[0].returncode != 0:
            for p in procs[1:]:
                p.kill()
        for p in procs[1:]:
            p.wait(timeout=600)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for rank in range(len(procs)):
        base = os.path.join(run["workdir"], f"{run['port']}.{rank}")
        with open(base + ".out") as o, open(base + ".err") as e:
            outs.append((o.read(), e.read()))
    return [p.returncode for p in procs], outs


@pytest.fixture(scope="module", autouse=True)
def launched(tmp_path_factory):
    """The launcher at ``--mesh 2x2``, started with the module's first test
    so that it runs beside the reference and the port's world."""
    run = _start_launch(str(tmp_path_factory.mktemp("launch")), _free_port())
    yield run
    for p in run["procs"]:
        if p.poll() is None:
            p.kill()
            p.wait()


def _losses(out):
    return [(int(s), float(x)) for s, x in
            re.findall(r"step (\d+) loss=([-\d.naif]+)", out)]


def test_launcher_trains_on_a_2x2_mesh_under_torchrun(launched, capsys):
    """Four ranks with torchrun's variables and ``--mesh 2x2``: rank 0
    prints the losses of steps 0 and 2 (every tenth step and the last),
    finite and equal, to the printed digits, to the one-device launcher's
    on the same seed-0 weights and batches (a unit of the fourth decimal
    where the two round on either side); the others print nothing. A
    taken rendezvous port (EADDRINUSE on rank 0) is retried on a new one,
    at most twice."""
    from repro_torch.launch import train as launcher
    launcher.main(LAUNCH)
    want = _losses(capsys.readouterr().out)
    assert [s for s, _ in want] == [0, 2], want
    rcs, outs = _finish_launch(launched)
    for _ in range(2):
        if rcs[0] == 0 or "EADDRINUSE" not in outs[0][1]:
            break
        rcs, outs = _finish_launch(_start_launch(launched["workdir"],
                                                 _free_port()))
    assert rcs == [0, 0, 0, 0], outs
    out0 = outs[0][0]
    assert "mesh 2x2 ('data', 'model')" in out0, out0
    got = _losses(out0)
    assert [s for s, _ in got] == [0, 2], out0
    assert all(np.isfinite([x for _, x in got])), out0
    assert all(abs(g - w) < 1.5e-4 for (_, g), (_, w) in zip(got, want)), (
        got, want)
    assert all(o == "" for o, _ in outs[1:]), outs


# ---- the train step against the reference's sharded step (last, so that
# the reference runs while the tests above do) -----------------------------
@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_sharded_train_step_matches_jax(both, case):
    check_train_case(both, case)
