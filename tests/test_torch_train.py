"""PyTorch port: the training substrate and runtime against the JAX package.

Every test of ``tests/test_train_runtime.py`` runs here on the port
(AdamW on a quadratic, the ``lr_schedule`` shape, loss decrease with
``grad_accum`` 2 giving ``grad_accum`` 1's step, compression, checkpoint
round trip, supervisor restart, heartbeat and stragglers, data
determinism), except the elastic remesh, which goes with the mesh. Then
parity with JAX in fp32: ``lr_schedule`` over steps 0-200 and
``adamw_update`` over three steps from identical parameters and
gradients (fp32 leaves, and bf16 leaves with fp32 master copies) at 1e-6
relative, ``compress_tree`` (``q`` and scales bit-equal, the error
feedback to 1e-7), checkpoints written by either package restored by the
other bit for bit (bf16 leaves, ``None`` masters, equal manifests), and
a restore into another model's tree refused. Last, the launcher on the CPU
(``--smoke``, resuming from ``--ckpt-dir``) and its out-of-memory guard
under the supervisor."""
import threading

import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.runtime import compression as JC  # noqa: E402
from repro.train import checkpoint as JCK  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro_torch import params as TP  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.models.model import RunCtx  # noqa: E402
from repro_torch.runtime import compression  # noqa: E402
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    HeartbeatMonitor, StragglerDetector, TrainingSupervisor)
from repro_torch.train import checkpoint  # noqa: E402
from repro_torch.train import tree as T  # noqa: E402
from repro_torch.train.data import DataConfig, PackedSyntheticData  # noqa: E402
from repro_torch.train.optimizer import (  # noqa: E402
    AdamWConfig, adamw_init, adamw_update, lr_schedule)
from repro_torch.train.train_step import (  # noqa: E402
    TrainConfig, init_train_state, make_train_step)

RCTX = RunCtx()


def _jnp_leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _bits(x):
    """A leaf's bytes as a numpy array (bf16 through a uint16 view)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


# ---------------------------------------------------------------------------
# tests/test_train_runtime.py on the port
# ---------------------------------------------------------------------------
def test_adamw_descends_quadratic():
    params = {"w": torch.tensor([3.0, -2.0]), "b": torch.tensor(1.5)}
    cfg = AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=0,
                      total_steps=400)
    state = adamw_init(params)

    def loss(p):
        return torch.sum(p["w"] ** 2) + p["b"] ** 2

    for _ in range(300):
        leaves = [p.requires_grad_() for p in T.leaves(params)]
        grads = T.unflatten(params, torch.autograd.grad(loss(params), leaves))
        params, state, _ = adamw_update(cfg, params, grads, state)
    assert float(loss(params).detach()) < 1e-2
    assert int(state["step"]) == 300


def test_lr_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_ratio=0.1)
    assert float(lr_schedule(cfg, 5)) == pytest.approx(0.5, rel=1e-3)
    assert float(lr_schedule(cfg, 10)) == pytest.approx(1.0, rel=1e-3)
    assert float(lr_schedule(cfg, 100)) == pytest.approx(0.1, rel=1e-3)


def test_train_loss_decreases_and_grad_accum_matches():
    cfg = get_config("llama3.2-3b").smoke()
    data = PackedSyntheticData(DataConfig(cfg.vocab_size, 64, 8, seed=1))
    tcfg1 = TrainConfig(optimizer=AdamWConfig(lr=1e-2, warmup_steps=0,
                                              total_steps=50,
                                              weight_decay=0.0))
    step1 = make_train_step(cfg, RCTX, tcfg1)
    p = TP.init_params(cfg, seed=0, device="cpu")
    state = init_train_state(cfg, p, tcfg1)
    losses = []
    for i in range(8):
        batch = {"tokens": torch.from_numpy(data.batch(i))}
        p, state, m = step1(p, state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.1, losses

    # grad-accum(2) first step == full-batch first step
    tcfg2 = TrainConfig(optimizer=tcfg1.optimizer, grad_accum=2)
    step2 = make_train_step(cfg, RCTX, tcfg2)
    p1 = TP.init_params(cfg, seed=0, device="cpu")
    p2 = TP.init_params(cfg, seed=0, device="cpu")
    batch = {"tokens": torch.from_numpy(data.batch(0))}
    p1, _, m1 = step1(p1, init_train_state(cfg, p1, tcfg1), batch)
    p2, _, m2 = step2(p2, init_train_state(cfg, p2, tcfg2), batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 5e-3
    d = max(float((a.float() - b.float()).abs().max().detach())
            for a, b in zip(T.leaves(p1), T.leaves(p2)))
    assert d < 5e-3


def test_compression_roundtrip_and_error_feedback():
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(size=(333,)).astype(np.float32))
    q, scale, new_ef = compression.compress_leaf(g, torch.zeros_like(g))
    deq = compression.decompress_leaf(q, scale, g.shape, g.dtype)
    # int8 per-block quantization: ~0.8% of block max
    assert float((deq - g).abs().max()) < float(g.abs().max()) / 100
    # error feedback: repeated compression of a CONSTANT gradient averages
    total = torch.zeros_like(g)
    ef = torch.zeros_like(g)
    steps = 64
    for _ in range(steps):
        q, scale, ef = compression.compress_leaf(g, ef)
        total = total + compression.decompress_leaf(q, scale, g.shape,
                                                    g.dtype)
    np.testing.assert_allclose((total / steps).numpy(), g.numpy(), atol=1e-3)


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.bfloat16),
                  "d": torch.tensor(7, dtype=torch.int32)}}
    checkpoint.save(str(tmp_path), 42, tree, extra={"mesh": "2x2"})
    assert checkpoint.latest_step(str(tmp_path)) == 42
    like = T.tree_map(torch.zeros_like, tree)
    out = checkpoint.restore(str(tmp_path), 42, like)
    for a, b in zip(T.leaves(tree), T.leaves(out)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert checkpoint.manifest_of(str(tmp_path), 42)["extra"]["mesh"] == "2x2"


@pytest.mark.parametrize("like, error", [
    ({"a": torch.zeros((4, 4)), "b": torch.zeros((2,))},
     r"\['a'\] has shape \(3, 4\), expected \(4, 4\)"),
    ({"a": torch.zeros((3, 4)), "b": torch.zeros(())},
     r"\['b'\] has shape \(2,\), expected \(\)"),
    ({"a": torch.zeros((3, 4))}, "has 2 leaves, expected 1"),
    ({"a": torch.zeros((3, 4)), "b": torch.zeros((2,)),
      "c": torch.zeros((2,))}, "has 2 leaves, expected 3"),
])
def test_restore_refuses_another_models_tree(tmp_path, like, error):
    """A directory holding another configuration's checkpoint (other
    shapes, or another leaf count) is refused, not cast into the tree."""
    checkpoint.save(str(tmp_path), 1, {"a": torch.zeros((3, 4)),
                                       "b": torch.zeros((2,))})
    with pytest.raises(ValueError, match=error):
        checkpoint.restore(str(tmp_path), 1, like)


def test_supervisor_restart_from_checkpoint(tmp_path):
    sup = TrainingSupervisor(str(tmp_path), save_every=5, async_save=False)

    def step_fn(state, step):
        return {"x": state["x"] + 1.0}

    failed = {"done": False}

    def fail_at(step):
        if step == 12 and not failed["done"]:
            failed["done"] = True
            return True
        return False

    state, end, restarts = sup.run(step_fn, {"x": torch.zeros(())}, 0, 20,
                                   fail_at=fail_at)
    assert restarts == 1
    assert end == 20
    assert float(state["x"]) == 20.0   # replayed steps are idempotent


def test_heartbeat_and_straggler():
    hb = HeartbeatMonitor(["w0", "w1", "w2"], timeout=10.0)
    hb.beat("w0", now=100.0)
    hb.beat("w1", now=100.0)
    hb.beat("w2", now=89.0)
    dead = hb.check(now=100.5)
    assert dead == ["w2"]
    assert hb.alive_count() == 2

    sd = StragglerDetector(["w0", "w1", "w2"], threshold=1.5, min_samples=3)
    for _ in range(5):
        sd.record("w0", 1.0)
        sd.record("w1", 1.05)
        sd.record("w2", 2.5)
    assert sd.stragglers() == ["w2"]


def test_data_determinism_and_sharding():
    d = PackedSyntheticData(DataConfig(vocab_size=256, seq_len=32,
                                       global_batch=8, seed=3))
    full = d.batch(5, rank=0, world=1)
    halves = np.concatenate([d.batch(5, rank=0, world=2),
                             d.batch(5, rank=1, world=2)])
    np.testing.assert_array_equal(full, halves)
    np.testing.assert_array_equal(d.batch(5), d.batch(5))
    assert not np.array_equal(d.batch(5), d.batch(6))


# ---------------------------------------------------------------------------
# parity with JAX: schedule, AdamW, compression
# ---------------------------------------------------------------------------
def test_lr_schedule_matches_jax():
    cfg = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=150,
                      min_lr_ratio=0.1)
    jcfg = JO.AdamWConfig(**dataclasses.asdict(cfg))
    steps = np.arange(201, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: JO.lr_schedule(jcfg, s))(
        jnp.asarray(steps)))
    got = np.array([float(lr_schedule(cfg, torch.tensor(s)))
                    for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype):
    """Three steps from identical parameters, with identical gradients each
    step (large enough that the clip acts): parameters, moments and master
    copies within 1e-6 of each leaf's largest value; bf16 leaves with fp32
    masters, fp32 leaves with none. The limit is relative to the leaf, not
    to each element: the global norm sums in another order than XLA's (its
    last bit differs), so the clip factor and every moment may move by an
    fp32 step, which an element that is a near-cancelling sum (``b1 * m +
    (1 - b1) * g``) shows as a large relative error."""
    rng = np.random.default_rng(7)
    shapes = {"w": (4, 8), "b": (16,), "s": ()}
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    jcfg = JO.AdamWConfig(**dataclasses.asdict(cfg))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    init = {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in init.items()}
    jp["f32"] = jnp.asarray(rng.normal(size=(3, 5)).astype(np.float32))
    tp = {k: torch.from_numpy(np.asarray(v.astype(jnp.float32)).copy()).to(
        getattr(torch, dtype) if k != "f32" else torch.float32)
        for k, v in jp.items()}
    jstate = JO.adamw_init(jp)
    tstate = adamw_init(tp)
    assert (tstate["master"]["f32"] is None) and (
        (tstate["master"]["w"] is None) == (dtype == "float32"))
    for _ in range(3):
        g = {k: rng.normal(size=np.shape(v)).astype(np.float32)
             for k, v in jp.items()}
        jg = {k: jnp.asarray(v).astype(jp[k].dtype) for k, v in g.items()}
        tg = {k: torch.from_numpy(v).to(tp[k].dtype) for k, v in g.items()}
        jp, jstate, jm = JO.adamw_update(jcfg, jp, jg, jstate)
        tp, tstate, tm = adamw_update(cfg, tp, tg, tstate)
        for name in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=1e-6)
        assert int(tstate["step"]) == int(jstate["step"])
        for tree_t, tree_j in ((tp, jp), (tstate["m"], jstate["m"]),
                               (tstate["v"], jstate["v"]),
                               (tstate["master"], jstate["master"])):
            want = _jnp_leaves(tree_j)
            got = dict(T.leaves_with_paths(tree_t))
            assert set(got) == set(want)
            for k, w in want.items():
                w = np.asarray(w, np.float32)
                np.testing.assert_allclose(
                    got[k].float().numpy(), w, rtol=0,
                    atol=1e-6 * float(np.abs(w).max()), err_msg=k)


def test_compress_tree_matches_jax():
    rng = np.random.default_rng(3)
    g = {"a": rng.normal(size=(7, 100)).astype(np.float32),
         "b": [rng.normal(size=(256,)).astype(np.float32) * 1e-3,
               rng.normal(size=(3,)).astype(np.float32)]}
    ef = T.tree_map(lambda x: (rng.normal(size=x.shape) * 1e-2).astype(
        np.float32), g)
    for (_, x), (_, e) in zip(T.leaves_with_paths(g), T.leaves_with_paths(ef)):
        jq, js, jef = JC.compress_leaf(jnp.asarray(x), jnp.asarray(e))
        tq, ts, tef = compression.compress_leaf(torch.from_numpy(x),
                                                torch.from_numpy(e))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_allclose(tef.numpy(), np.asarray(jef), rtol=0,
                                   atol=1e-7)
    jout, jef = JC.compress_tree(jax.tree.map(jnp.asarray, g),
                                 jax.tree.map(jnp.asarray, ef))
    tout, tef = compression.compress_tree(T.tree_map(torch.from_numpy, g),
                                          T.tree_map(torch.from_numpy, ef))
    for tree_t, tree_j, tol in ((tout, jout, 0.0), (tef, jef, 1e-7)):
        want = _jnp_leaves(tree_j)
        for k, t in T.leaves_with_paths(tree_t):
            np.testing.assert_allclose(t.numpy(), want[k], rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------
def _states():
    """One training state, built in both packages from the same numbers:
    jamba's smoke config in bf16 (its fp32 leaves carry no master copy),
    random moments, step 5."""
    arch = "jamba-1.5-large-398b"
    jcfg = dataclasses.replace(jget_config(arch).smoke(),
                               param_dtype=jnp.bfloat16, dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(get_config(arch).smoke(),
                               param_dtype=torch.bfloat16,
                               dtype=torch.bfloat16)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)

    def moments(p):
        return jnp.asarray(rng.normal(size=p.shape).astype(np.float32))
    jopt = JO.adamw_init(jparams)
    jopt = dict(jopt, step=jnp.asarray(5, jnp.int32),
                m=jax.tree.map(moments, jparams),
                v=jax.tree.map(moments, jparams))
    jstate = {"params": jparams, "train": {"opt": jopt}}
    tparams = TP.from_jax_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    topt = adamw_init(tparams)
    for name in ("m", "v"):
        topt[name] = TP.from_jax_numpy(tcfg, jax.tree.map(np.asarray,
                                                          jopt[name]))
    topt["step"] = torch.tensor(5, dtype=torch.int32)
    return jstate, {"params": tparams, "train": {"opt": topt}}


def _assert_same_state(tstate, jstate):
    want = _jnp_leaves(jstate)
    got = dict(T.leaves_with_paths(tstate))
    assert list(got) == list(want)        # same leaves in the same order
    for k, w in want.items():
        assert str(got[k].dtype).removeprefix("torch.") == w.dtype.name, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(w), err_msg=k)


def test_checkpoint_written_by_jax_restores_in_the_port(tmp_path):
    jstate, tstate = _states()
    assert None in T.flatten_up_to(tstate["params"],
                                   tstate["train"]["opt"]["master"])
    JCK.save(str(tmp_path), 5, jstate)
    like = T.tree_map(torch.zeros_like, tstate)
    out = checkpoint.restore(str(tmp_path), 5, like)
    _assert_same_state(out, jstate)
    assert checkpoint.manifest_of(str(tmp_path), 5)["paths"] == \
        [p for p, _ in T.leaves_with_paths(tstate)]


def test_checkpoint_written_by_the_port_restores_in_jax(tmp_path):
    jstate, tstate = _states()
    checkpoint.save(str(tmp_path / "port"), 5, tstate)
    like = jax.tree.map(jnp.zeros_like, jstate)
    out = JCK.restore(str(tmp_path / "port"), 5, like)
    _assert_same_state(tstate, out)
    JCK.save(str(tmp_path / "jax"), 5, jstate)
    for name in ("port", "jax"):
        assert checkpoint.manifest_of(str(tmp_path / name), 5) == \
            JCK.manifest_of(str(tmp_path / name), 5)
    # the manifests are the same bytes
    assert (tmp_path / "port" / "step_00000005" / "manifest.msgpack"
            ).read_bytes() == (tmp_path / "jax" / "step_00000005" /
                               "manifest.msgpack").read_bytes()


def test_async_save_copies_leaves_before_the_thread(tmp_path, monkeypatch):
    """The writer thread starts only after every leaf was copied to the
    host: an in-place update made while it waits does not reach the
    checkpoint."""
    tree = {"w": torch.ones((4, 4), dtype=torch.bfloat16),
            "m": torch.zeros((3,))}
    gate = threading.Event()
    real_save = np.save

    def slow_save(*a, **k):
        assert gate.wait(timeout=30)
        return real_save(*a, **k)
    monkeypatch.setattr(np, "save", slow_save)
    thread = checkpoint.save(str(tmp_path), 1, tree, async_save=True)
    tree["w"].add_(1.0)                  # the next step, in place
    tree["m"].fill_(5.0)
    gate.set()
    thread.join(timeout=30)
    assert not thread.is_alive()
    out = checkpoint.restore(str(tmp_path), 1, tree)
    assert float(out["w"].float().max()) == 1.0
    assert float(out["m"].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def test_launcher_trains_on_the_cpu_and_resumes(tmp_path, capsys):
    args = ["--device", "cpu", "--smoke", "--seq", "32", "--global-batch",
            "4", "--ckpt-dir", str(tmp_path), "--save-every", "1"]
    first = LT.main(args + ["--steps", "2"])
    out = capsys.readouterr().out
    assert "step 0 loss=" in out and "finished at step 2 (0 restarts)" in out
    assert checkpoint.latest_step(str(tmp_path)) == 2
    second = LT.main(args + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "finished at step 3" in out
    assert int(second["train"]["opt"]["step"]) == 3
    assert int(first["train"]["opt"]["step"]) == 2
    # the resumed run went on from the checkpoint of step 2
    saved = checkpoint.restore(str(tmp_path), 3, second)
    for a, b in zip(T.leaves(saved), T.leaves(second)):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_launcher_compresses_gradients(capsys):
    state = LT.main(["--device", "cpu", "--smoke", "--seq", "32",
                     "--global-batch", "2", "--steps", "2",
                     "--compress-grads"])
    assert "ef" in state["train"]
    assert float(sum(e.abs().sum() for e in T.leaves(state["train"]["ef"]))) \
        > 0.0


@pytest.mark.parametrize("with_mesh", [False, True])
def test_rctx_is_the_references_training_context(with_mesh):
    """``launch/steps.make_rctx`` makes the reference's choices for a
    training step: remat "full", 16 loss blocks, and the MoE context
    (expert-parallel on a mesh, over its data-parallel axes)."""
    from repro.launch.steps import make_rctx as jmake_rctx
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.steps import make_rctx
    arch = "qwen2-moe-a2.7b"
    jmesh = jax.make_mesh((1, 1), ("data", "model")) if with_mesh else None
    mesh = MeshShape((1, 1), ("data", "model")) if with_mesh else None
    want = jmake_rctx(jget_config(arch).smoke(), jmesh, train=True,
                      seq_len=256)
    got = make_rctx(get_config(arch).smoke(), mesh, train=True, seq_len=256)
    assert (got.remat, got.loss_vocab_blocks) == (want.remat,
                                                  want.loss_vocab_blocks)
    for f in ("impl", "dp_axes", "tp_axis", "capacity_factor"):
        assert getattr(got.moe, f) == getattr(want.moe, f), f
    assert got.moe.impl == ("ep" if with_mesh else "dense")
    assert got.mesh is got.moe.mesh is mesh
    if with_mesh:
        assert tuple(mesh.mesh_dim_names) == tuple(want.moe.mesh.axis_names)
    assert make_rctx(get_config(arch).smoke(), None, train=False,
                     seq_len=256).remat == "none"


def test_out_of_memory_is_not_replayed(tmp_path):
    """The supervisor restores and replays a step that raised a
    RuntimeError, which torch.cuda.OutOfMemoryError is; the launcher's
    guard re-raises it as MemoryError, which goes through."""
    assert issubclass(torch.cuda.OutOfMemoryError, RuntimeError)
    calls = {"n": 0}

    def oom_once(state, step):
        calls["n"] += 1
        if calls["n"] == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return {"x": state["x"] + 1.0}

    sup = TrainingSupervisor(str(tmp_path / "a"), save_every=1,
                             async_save=False)
    state, end, restarts = sup.run(oom_once, {"x": torch.zeros(())}, 0, 3)
    assert (end, restarts, float(state["x"])) == (3, 1, 3.0)

    def oom_always(state, step):
        calls["n"] += 1
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    calls["n"] = 0
    sup = TrainingSupervisor(str(tmp_path / "b"), save_every=1,
                             async_save=False)
    with pytest.raises(MemoryError, match="out of device memory at step 0"):
        sup.run(LT.oom_as_memory_error(oom_always), {"x": torch.zeros(())},
                0, 3)
    assert calls["n"] == 1
