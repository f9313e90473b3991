"""Rank bodies of the port's sharded-training tests, and the inputs both
sides share.

``repro_torch.launch.local_world.spawn_world`` runs the bodies on spawned
ranks (gloo on CPU tensors, a ``file://`` store); what a rank returns is
pickled back to the test. The module imports numpy at the top and torch
and the port inside the bodies (never JAX), so ``_sharded_train_ref.py``
takes the shared inputs (:func:`batches`, :func:`moe_inputs`) from it; the
tests hold what the ranks return against what that reference computes.
"""
from __future__ import annotations

import dataclasses
import pickle
import zlib

import numpy as np

OPT = dict(lr=1e-3, warmup_steps=0, total_steps=100)   # both sides' AdamW
# both sides' loss in 2 sequence blocks, not make_rctx's 16: the same
# blocked, vocabulary-parallel loss, with an eighth of its collectives
# (three a block, in the forward, the recompute and the backward), which
# are most of the port's at these sizes
LOSS_BLOCKS = 2
# the expert-parallel module's shapes: 16 experts (5 real), top-2, a
# shared expert of width 12, batch 2
MOE = dict(E=16, num_real=5, top_k=2, d=8, f=6, shared=12, B=2)


def batches(case, vocab):
    """The case's token batches [B, S], one a step, from its name."""
    rng = np.random.default_rng(zlib.crc32(case["name"].encode()))
    return [rng.integers(0, vocab, (case["B"], case["S"])).astype(np.int32)
            for _ in range(case["steps"])]


def model_key(case):
    """The name of the case's model: its arch, or the arch with the
    config changes ``case["changes"]`` (such as a 2-head llama)."""
    ch = case.get("changes")
    return case["arch"] if not ch else case["arch"] + " " + " ".join(
        f"{k}={v}" for k, v in sorted(ch.items()))


def case_config(case, get_config):
    """The case's smoke config (``get_config`` of either package), with
    ``case["changes"]`` applied."""
    return dataclasses.replace(get_config(case["arch"]).smoke(),
                               **case.get("changes", {}))


def frontend(case, cfg):
    """The batch's modality inputs, the same every step (float32 numpy,
    from the case's name): patch embeddings [B, P, d] for a config with
    patch tokens, encoder frames [B, S // 2, d] for an encoder-decoder
    (``steps._enc_len`` of a train shape)."""
    rng = np.random.default_rng(zlib.crc32(case["name"].encode()) + 1)
    out = {}
    if cfg.num_patch_tokens:
        out["extra_embeds"] = rng.normal(size=(
            case["B"], cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)
    if cfg.enc_dec:
        out["enc_embeds"] = rng.normal(size=(
            case["B"], case["S"] // 2, cfg.d_model)).astype(np.float32)
    return out


def moe_inputs(S):
    """The MoE block's parameters (the reference's tree, fp32) and x [B,
    S, d]; S 8 splits over a model axis of 4, S 7 takes the replicated
    route."""
    rng = np.random.default_rng(S)
    E, d, f, sh = MOE["E"], MOE["d"], MOE["f"], MOE["shared"]

    def w(*shape, scale=0.3):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    params = {"router": w(d, E, scale=1.0), "w_gate": w(E, d, f),
              "w_up": w(E, d, f), "w_down": w(E, f, d),
              "shared": {"wi_gate": w(d, sh), "wi_up": w(d, sh),
                         "wo": w(sh, d)}}
    return params, w(MOE["B"], S, d, scale=1.0)


def _np(tree):
    from repro_torch.train import tree as T
    return {p: x.detach().cpu().numpy().copy()
            for p, x in T.leaves_with_paths(tree)}


def _rows(layout_dp, B):
    """This rank's data-parallel rows of a global batch of B (all of them
    when B does not split, as the reference's ``bspec``)."""
    if layout_dp is None or B % layout_dp.size:
        return slice(None)
    n = B // layout_dp.size
    return slice(layout_dp.index * n, (layout_dp.index + 1) * n)


def _case_rows(case, mesh):
    """This rank's rows of the case's batch: over the data-parallel axes,
    and over ``model`` too for a ``wide_dp`` case whose axes divide it
    (``launch/sharding.batch_axes``)."""
    from repro_torch.kernels import shard_utils as su
    from repro_torch.launch import sharding as shd
    axes = shd.batch_axes(mesh, case["B"], case.get("wide_dp", False))
    return _rows(su.mesh_axis(mesh, axes), case["B"]) if axes \
        else slice(None)


def _setup(case, params_np):
    """(cfg, mesh, rctx, layout, this rank's parameter shards); a case's
    ``"fsdp"`` and ``"wide_dp"`` go to the layout (ZeRO-3 slices, the
    wide batch)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.launch.steps import make_rctx
    from repro_torch.params import from_jax_numpy
    from repro_torch.train.train_step import TrainLayout
    cfg = case_config(case, get_config)
    mesh = make_train_mesh(case["mesh"], device_type="cpu")
    rctx = dataclasses.replace(make_rctx(cfg, mesh, train=True,
                                         seq_len=case["S"]),
                               loss_vocab_blocks=LOSS_BLOCKS)
    wide = "model" in shd.batch_axes(mesh, case["B"],
                                     case.get("wide_dp", False))
    layout = TrainLayout(cfg, mesh, fsdp=case.get("fsdp", False),
                         wide_dp=wide)
    params = shd.shard_tree(from_jax_numpy(cfg, params_np), layout.pspecs,
                            mesh)
    return cfg, mesh, rctx, layout, params


def _train_config(case):
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import TrainConfig
    return TrainConfig(optimizer=AdamWConfig(**OPT),
                       grad_accum=case.get("grad_accum", 1),
                       compress_grads=case.get("compress", False))


def train_case(case, params_np):
    """One train case on this rank: every step's loss, the first step's
    gradient norm, the first moment after it (gathered, on rank 0),
    whether this rank's m/v/master have ``opt_state_specs``' local
    shapes before the steps, and whether its parameters and m/v/master
    still have their local shapes after them."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import sharding as shd
    from repro_torch.train import tree as T
    from repro_torch.train.train_step import init_train_state, make_train_step
    cfg, mesh, rctx, layout, params = _setup(case, params_np)
    tcfg = _train_config(case)
    state = init_train_state(cfg, params, tcfg, layout)
    step = make_train_step(cfg, rctx, tcfg, layout)
    rows = _case_rows(case, mesh)
    extra = {k: torch.from_numpy(np.ascontiguousarray(a[rows]))
             for k, a in frontend(case, cfg).items()}

    def local_shapes_ok(with_params):
        trees = [(T.flatten_up_to(params, state["opt"][part]),
                  T.flatten_up_to(params, layout.ospecs[part]))
                 for part in ("m", "v", "master")]
        if with_params:
            trees.append((T.leaves(params), T.leaves(layout.pspecs)))
        return all(x is None or tuple(x.shape) == shd.local_shape(
            full, spec, mesh) for xs, specs in trees
            for x, spec, full in zip(xs, specs, layout.shapes))
    out = {"loss": [], "shapes_ok": local_shapes_ok(False)}
    for i, toks in enumerate(batches(case, cfg.vocab_size)):
        batch = {"tokens": torch.from_numpy(np.ascontiguousarray(
            toks[rows])), **extra}
        params, state, m = step(params, state, batch)
        out["loss"].append(float(m["loss"]))
        if i == 0:
            out["grad_norm"] = float(m["grad_norm"])
            full = shd.gather_tree(state["opt"]["m"], layout.ospecs["m"],
                                   mesh)
            if dist.get_rank() == 0:
                out["m"] = _np(full)
    out["shapes_after_ok"] = local_shapes_ok(True)
    return out


def moe_case(case):
    """``moe_ffn`` (impl "ep") on this rank's rows and experts: y and aux,
    and the gradients of sum(y^2) over the whole batch with respect to x
    and the expert weights (rank 0 returns them whole)."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import shard_utils as su
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.models import moe as M
    from repro_torch.params import from_jax_numpy
    mesh = make_train_mesh(case["mesh"], device_type="cpu")
    dp = su.mesh_axis(mesh, ("data",))
    tp = su.mesh_axis(mesh, "model")
    params_np, x_np = moe_inputs(case["S"])
    full = from_jax_numpy(None, params_np)
    specs = {"router": shd.Spec(None, None),
             "w_gate": shd.Spec("model", None, None),
             "w_up": shd.Spec("model", None, None),
             "w_down": shd.Spec("model", None, None),
             "shared": {"wi_gate": shd.Spec(None, "model"),
                        "wi_up": shd.Spec(None, "model"),
                        "wo": shd.Spec("model", None)}}
    p = shd.shard_tree(full, specs, mesh)
    for leaf in (p["w_gate"], p["w_up"], p["w_down"]):
        leaf.requires_grad_()
    rows = _rows(dp, MOE["B"])
    x = torch.from_numpy(x_np[rows].copy()).requires_grad_()
    ctx = M.MoEContext(impl="ep", mesh=mesh, dp_axes=("data",))
    y, aux = M.moe_ffn(p, x, num_real=MOE["num_real"], top_k=MOE["top_k"],
                       activation="silu", aux_free=False, ctx=ctx,
                       shared_d_ff=MOE["shared"])
    gx, *gw = torch.autograd.grad(torch.sum(y * y), [x, p["w_gate"],
                                                     p["w_up"], p["w_down"]])
    # whole tensors: rows gathered over data, expert gradients summed over
    # data (each data rank's rows) and gathered over model
    gw = [su.all_reduce(g, dp) if dp else g for g in gw]
    gw = [su.all_gather(g, 0, tp) if tp else g for g in gw]
    ys, gx = [y.detach(), gx]
    if dp is not None and MOE["B"] % dp.size == 0:
        ys, gx = su.all_gather(ys, 0, dp), su.all_gather(gx, 0, dp)
    aux = su.all_reduce(aux.detach(), dp) / dp.size if dp else aux.detach()
    if dist.get_rank():
        return None
    return {"y": ys.numpy(), "aux": float(aux), "x": gx.numpy(),
            **{k: g.numpy() for k, g in zip(("w_gate", "w_up", "w_down"),
                                            gw)}}


def start_reference(cases_list, workdir):
    """Start ``_sharded_train_ref.py`` on ``cases_list`` in a subprocess of
    its own (it runs while the test does other work); returns the handle
    :func:`run_port` and :func:`reference_results` take."""
    import json
    import os
    import subprocess
    import sys
    here = os.path.dirname(os.path.abspath(__file__))
    workdir = str(workdir)
    with open(os.path.join(workdir, "cases.json"), "w") as f:
        json.dump(cases_list, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(here), "src"), here]))
    out = os.path.join(workdir, "ref.pkl")
    with open(out + ".err", "w") as err:    # a file: a pipe could fill
        proc = subprocess.Popen(
            [sys.executable, os.path.join(here, "_sharded_train_ref.py"),
             os.path.join(workdir, "cases.json"), out], env=env,
            stdout=subprocess.DEVNULL, stderr=err)
    return {"proc": proc, "out": out, "cases": cases_list,
            "workdir": workdir}


def reference_params(ref, timeout=900.0):
    """The path of the reference's parameters (``{arch: init_params}`` as
    numpy, pickled), once it has written them; raises if it failed first.
    ``timeout`` only bounds a hang."""
    import os
    import time
    path, deadline = ref["out"] + ".params", time.monotonic() + timeout
    while not os.path.exists(path):
        if ref["proc"].poll() is not None:
            reference_results(ref)          # raises with its stderr
        if time.monotonic() > deadline:
            raise TimeoutError("the reference wrote no parameters")
        time.sleep(0.1)
    return path


def run_port(ref, timeout=900.0, **extra):
    """The port on the reference's cases and parameters: a world of 4 gloo
    ranks on the CPU running :func:`cases` (``extra`` its further
    arguments); returns the ranks' results. ``timeout`` only bounds a
    hang."""
    import os

    from repro_torch.launch.local_world import spawn_world
    return spawn_world(cases, 4, os.path.join(ref["workdir"], "world"),
                       device="cpu", timeout=timeout, group_timeout=timeout,
                       cases=ref["cases"],
                       params_path=reference_params(ref, timeout), **extra)


def reference_results(ref, timeout=900.0):
    """The reference's results, waited for (``timeout`` only bounds a
    hang)."""
    proc = ref["proc"]
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        with open(ref["out"] + ".err") as f:
            raise RuntimeError(f"the reference failed:\n{f.read()[-4000:]}")
    with open(ref["out"], "rb") as f:
        return pickle.load(f)


def cases(rank, world, cases, params_path, ckpt=None):
    """Every case of ``cases`` (``kind`` "train", "moe" or "slot": the slot
    path's steps of ``_slot_sharded_ranks.slot_case``) on this rank, then,
    with ``ckpt`` (:func:`checkpoints`' keywords), the checkpoints under
    "checkpoints"."""
    import _slot_sharded_ranks as R
    with open(params_path, "rb") as f:
        params = pickle.load(f)
    run = {"train": lambda c: train_case(c, params[model_key(c)]),
           "moe": moe_case,
           "slot": lambda c: R.slot_case(c, params[model_key(c)])}
    out = {c["name"]: run[c.get("kind", "train")](c) for c in cases}
    if ckpt is not None:
        out["checkpoints"] = checkpoints(params[CKPT_CASE["arch"]], **ckpt)
    return out


CKPT_CASE = {"name": "checkpoints", "arch": "llama3.2-3b", "mesh": "2x2",
             "B": 4, "S": 32, "steps": 4}


def checkpoints(params_np, saved, world1):
    """Checkpoints across meshes on this rank: one step at ``2x2`` saved
    to ``saved`` (step 1) and restored at ``1x4``; the world-1 checkpoint
    ``world1`` (step 1) restored at ``2x2``; then three steps under the
    supervisor with a failure injected at step 2, against the same steps
    uninterrupted. Rank 0 returns the gathered trees (numpy by path), the
    restores' resharding plans and both runs' losses; every rank the most
    whole leaves that were alive at once while it saved."""
    import weakref

    import torch
    import torch.distributed as dist
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.runtime.elastic import MeshSupervisor
    from repro_torch.train import checkpoint
    from repro_torch.train import tree as T
    from repro_torch.train.train_step import (TrainLayout, init_train_state,
                                              make_train_step)
    case = CKPT_CASE
    cfg, mesh, rctx, layout, params = _setup(case, params_np)
    tcfg = _train_config(case)
    toks = batches(case, cfg.vocab_size)
    rows = _rows(layout.dp, case["B"])

    def fresh(lay, m):
        from repro_torch.params import from_jax_numpy
        p = shd.shard_tree(from_jax_numpy(cfg, params_np), lay.pspecs, m)
        return {"params": p, "train": init_train_state(cfg, p, tcfg, lay)}

    step = make_train_step(cfg, rctx, tcfg, layout)
    losses = {}

    def one_step(st, i, key="run"):
        batch = {"tokens": torch.from_numpy(np.ascontiguousarray(
            toks[i][rows]))}
        p, t, m = step(st["params"], st["train"], batch)
        losses.setdefault(key, []).append(float(m["loss"]))
        return {"params": p, "train": t}

    state = one_step(fresh(layout, mesh), 0, "first")
    specs = layout.state_specs(state)
    ck = checkpoint.Sharded(specs, mesh)
    gather_leaf, alive, most = shd.gather_leaf, [], [0]

    def counted(x, spec, m):    # gathered whole leaves alive at once
        full = gather_leaf(x, spec, m)
        alive[:] = [r for r in alive if r() is not None] + (
            [weakref.ref(full)] if full is not x else [])
        most[0] = max(most[0], len(alive))
        return full
    shd.gather_leaf = counted
    try:
        ck.save(saved, 1, state)
    finally:
        shd.gather_leaf = gather_leaf
    out = {"saved": _np(shd.gather_tree(state, specs, mesh)),
           "most_whole_leaves": most[0]}
    mesh14 = make_train_mesh("1x4", device_type="cpu")
    lay14 = TrainLayout(cfg, mesh14)
    like = fresh(lay14, mesh14)
    ck14 = checkpoint.Sharded(lay14.state_specs(like), mesh14)
    got = ck14.restore(saved, ck14.latest_step(saved), like)
    out["at_1x4"] = _np(shd.gather_tree(got, lay14.state_specs(like),
                                        mesh14))
    out["plan_1x4"] = ck14.plan
    got = ck.restore(world1, 1, fresh(layout, mesh))
    out["world1_at_2x2"] = _np(shd.gather_tree(got, specs, mesh))
    out["plan_world1"] = ck.plan
    # the supervisor: a failure at step 2, restored on every rank
    failed = []

    def fail_at(s):
        if s == 2 and not failed:
            failed.append(s)
            return True
        return False
    sup = MeshSupervisor(saved + "-sup", ck, save_every=1)
    st, end, restarts = sup.run(
        lambda s, i: one_step(s, i, "supervised"), fresh(layout, mesh), 0,
        case["steps"], fail_at=fail_at)
    st2 = fresh(layout, mesh)
    for i in range(case["steps"]):
        st2 = one_step(st2, i, "uninterrupted")
    out.update(end=end, restarts=restarts, losses=losses,
               params_equal=all(torch.equal(a, b) for a, b in zip(
                   T.leaves(st["params"]), T.leaves(st2["params"]))))
    dist.barrier()
    return out if dist.get_rank() == 0 else {
        "params_equal": out["params_equal"], "restarts": restarts,
        "most_whole_leaves": most[0]}
