"""The JAX package's sharded train step and expert-parallel MoE block on a
mesh of host devices, for the port's sharded-training tests. Run in a
subprocess of its own (it sets the host platform's device count before
JAX starts):

    python tests/_sharded_train_ref.py CASES.json OUT.pkl

``CASES.json`` is a list of cases ("slot" cases are skipped: they carry
only the port's side). It first writes ``OUT.pkl.params``,
``{arch: init_params(smoke config, PRNGKey(0))}`` as numpy for the train
cases' archs (the port's weights too). A "train" case (``{"name", "arch",
"mesh", "B", "S", "grad_accum", "compress", "steps"}``) runs the smoke
config from those parameters through the reference's own
``make_rctx`` (the loss in ``LOSS_BLOCKS`` blocks, as the port's ranks
block it), ``param_specs``, ``opt_state_specs`` and
``make_train_step``, the batch split over the data-parallel axes as
``steps.build_cell`` splits it; it gives every step's loss, the first
step's gradient norm and the first moment after it, by key path. A case
with ``"fsdp"`` places the parameters by ``param_specs(..., fsdp=True)``
(ZeRO-3), one with ``"wide_dp"`` the batch on the data-parallel axes and
``model``, as ``build_cell``'s ``fsdp``/``wide_dp`` do. A "moe"
case (``{"name", "mesh", "S"}``) runs ``moe_ffn`` with
``MoEContext(impl="ep")`` on ``_sharded_train_ranks.moe_inputs(S)`` and
gives y, aux and the gradients of sum(y^2) with respect to x and the
expert weights. The mesh is built with ``axis_types`` Auto on every axis:
JAX 0.9 makes ``jax.make_mesh``'s axes Explicit by default, and the
vocab-sharded embedding gather then raises.
"""
import dataclasses
import json
import os
import pickle
import sys
from concurrent.futures import ThreadPoolExecutor

# four host devices; and LLVM's slower optimisations and Eigen's thread
# pool off, which take a third less CPU time for these small programs,
# compiled once or twice each (they change the rounding of fused
# operations, not what the step computes)
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=4"
                           " --xla_backend_optimization_level=0"
                           " --xla_llvm_disable_expensive_passes=true"
                           " --xla_cpu_multi_thread_eigen=false")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import _sharded_train_ranks as W  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.launch import sharding as shd  # noqa: E402
from repro.launch.mesh import dp_axes, dp_size, parse_mesh_spec  # noqa: E402
from repro.launch.steps import make_rctx  # noqa: E402
from repro.models import moe as M  # noqa: E402
from repro.models.model import init_params  # noqa: E402
from repro.train.optimizer import AdamWConfig  # noqa: E402
from repro.train.train_step import (TrainConfig, init_train_state,  # noqa: E402
                                    make_train_step)


def make_mesh(spec):
    dims, axes = parse_mesh_spec(spec)
    return jax.make_mesh(dims, axes, axis_types=(AxisType.Auto,) * len(dims),
                         devices=jax.devices()[:int(np.prod(dims))])


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def train(case, params):
    cfg = W.case_config(case, get_config)
    mesh = make_mesh(case["mesh"])
    rctx = dataclasses.replace(make_rctx(cfg, mesh, train=True,
                                         seq_len=case["S"]),
                               loss_vocab_blocks=W.LOSS_BLOCKS)
    tcfg = TrainConfig(optimizer=AdamWConfig(**W.OPT),
                       grad_accum=case["grad_accum"],
                       compress_grads=case["compress"])
    state = init_train_state(cfg, params, tcfg)

    def put(tree, specs):
        return jax.device_put(tree, jax.tree.map(
            lambda s: NamedSharding(mesh, s), specs))

    pspecs = shd.param_specs(cfg, jax.eval_shape(lambda: params), mesh,
                             fsdp=case.get("fsdp", False))
    params = put(params, pspecs)
    # the moments and masters ZeRO-sharded as build_cell shards them (the
    # reference's zero_shard needs a data-parallel axis: without one they
    # are replicated), the error feedback replicated
    specs = jax.tree.map(lambda _: P(), state)
    if dp_axes(mesh):
        specs["opt"] = shd.opt_state_specs(
            cfg, jax.eval_shape(lambda: state["opt"]), pspecs, mesh)
    state = put(state, specs)
    dpa = dp_axes(mesh)
    bspec = (dpa if len(dpa) > 1 else dpa[0]) \
        if dpa and case["B"] % dp_size(mesh) == 0 else None
    if case.get("wide_dp") and case["B"] % (dp_size(mesh)
                                            * mesh.shape["model"]) == 0:
        bspec = dpa + ("model",)
    # the step's outputs are put back on the inputs' shardings, so that
    # the second step reuses the first one's compilation
    placed = jax.tree.map(lambda x: x.sharding, (params, state))
    step = jax.jit(make_train_step(cfg, rctx, tcfg))
    out = {"loss": []}
    extra = {k: jax.device_put(jnp.asarray(a), NamedSharding(
        mesh, P(bspec, None, None))) for k, a in W.frontend(case, cfg).items()}
    for i, t in enumerate(W.batches(case, cfg.vocab_size)):
        batch = {"tokens": jax.device_put(jnp.asarray(t),
                                          NamedSharding(mesh, P(bspec, None))),
                 **extra}
        params, state, m = step(params, state, batch)
        params, state = jax.device_put((params, state), placed)
        out["loss"].append(float(m["loss"]))
        if i == 0:
            out["grad_norm"] = float(m["grad_norm"])
            out["m"] = _leaves(state["opt"]["m"])
    return out


def moe(case):
    mesh = make_mesh(case["mesh"])
    ctx = M.MoEContext(impl="ep", mesh=mesh, dp_axes=dp_axes(mesh))
    params, x = jax.tree.map(jnp.asarray, W.moe_inputs(case["S"]))
    kw = dict(num_real=W.MOE["num_real"], top_k=W.MOE["top_k"],
              activation="silu", aux_free=False, ctx=ctx)

    def loss(p, x):
        y, aux = M.moe_ffn(p, x, **kw)
        return jnp.sum(y * y), (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, x)
    return {"y": np.asarray(y), "aux": float(aux), "x": np.asarray(gx),
            **{k: np.asarray(gp[k]) for k in ("w_gate", "w_up", "w_down")}}


def main():
    cases = json.load(open(sys.argv[1]))
    out = sys.argv[2]
    train_cases = {W.model_key(c): c for c in cases
                   if c.get("kind", "train") == "train"}
    params = {k: init_params(W.case_config(c, get_config),
                             jax.random.PRNGKey(0))
              for k, c in sorted(train_cases.items())}
    with open(out + ".tmp", "wb") as f:     # the port starts from these
        pickle.dump(jax.tree.map(np.asarray, params), f)
    os.rename(out + ".tmp", out + ".params")

    def run(c):
        if c.get("kind", "train") == "train":
            return train(c, params[W.model_key(c)])
        return moe(c)
    # two cases at a time: XLA's compilation, most of the time, runs
    # outside the GIL (the results are those of one at a time); "slot"
    # cases are the port's alone (their reference runs in the test)
    ours = [c for c in cases if c.get("kind", "train") != "slot"]
    with ThreadPoolExecutor(2) as ex:
        res = dict(zip([c["name"] for c in ours], ex.map(run, ours)))
    with open(out, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main()
