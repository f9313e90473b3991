"""PyTorch port: the dry run (``launch/dryrun.py``, ``launch/steps.
build_cell``, ``analysis/{roofline,extrapolate}.py``) on the CPU.

Two processes of their own run beside each other: the port's cells
(``tests/_dryrun_cells.py``: a fake process group is process-wide) and
the reference's inputs (``tests/_dryrun_ref.py``: ``build_cell`` on host
devices with Auto axes, ``eval_shape`` and shardings only).

* The reference test's four cells (llama3.2-3b, qwen2-moe-a2.7b
  ``decode_32k`` and xlstm-125m ``train_4k`` at ``REPRO_FORCE_MESH=2x4``,
  gemma2-2b ``decode_32k`` at ``2x2x4`` multi-pod) trace rank 0's program
  with status "ok" and positive flops; ``analytic_memory_bytes``'
  ``args_bytes`` of each equals the reference's.
* Collective bytes are 0 at a ``1x1`` mesh, and at ``2x4`` llama's decode
  step's are the hand count of the port's collectives: per layer the
  row-parallel sums after attention and the MLP, the vocab-parallel
  embedding's sum (bf16 [64, 1, 3072] each), and the logits gathered over
  the model axis ([64, 128256] bf16).
* ``fsdp`` (ZeRO-3) and ``wide_dp``: llama3.2-3b ``decode_32k`` at ``2x4``
  under ``fsdp`` traces, its ``args_bytes`` the reference's, and its
  collectives are that hand count plus one all-gather a leaf and layer
  over the data axis (the leaf's tensor-parallel shard, from
  ``param_specs``: the bytes of its result, the roofline's convention);
  xlstm-125m ``train_4k``'s ``args_bytes`` under ``fsdp`` and under
  ``wide_dp`` (the batch on ``("data", "model")``) are the reference's.
* ``model_flops_estimate`` equals the reference's for every arch x shape.
* ``extrapolated_cost`` equals the full trace's flops, bytes and
  collective bytes on a smoke llama of 3 repetitions (``decode_32k`` at
  ``2x4``, and under ``fsdp``: the probes take the full model's
  placement).
"""
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
CELLS = ["llama3.2-3b decode_32k 2x4", "qwen2-moe-a2.7b decode_32k 2x4",
         "xlstm-125m train_4k 2x4", "gemma2-2b decode_32k 2x2x4",
         "llama3.2-3b decode_32k 2x4 fsdp"]
BUILT = ["xlstm-125m train_4k 2x4 fsdp", "xlstm-125m train_4k 2x4 wide_dp"]


def _start(script, out):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, HERE]),
               JAX_PLATFORMS="cpu")
    env.pop("REPRO_FORCE_MESH", None)
    err = open(out + ".err", "w")
    return subprocess.Popen([sys.executable, os.path.join(HERE, script),
                             out], env=env, stdout=err, stderr=err), err


def _result(proc, err, out):
    try:
        proc.wait(timeout=900)        # bounds a hang only
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err.close()
    if proc.returncode != 0:
        with open(out + ".err") as f:
            raise RuntimeError(f"{out} failed:\n{f.read()[-4000:]}")
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dryrun"))
    port = _start("_dryrun_cells.py", os.path.join(d, "port.json"))
    ref = _start("_dryrun_ref.py", os.path.join(d, "ref.json"))
    return (_result(*port, os.path.join(d, "port.json")),
            _result(*ref, os.path.join(d, "ref.json")))


@pytest.mark.parametrize("cell", CELLS)
def test_reference_cells_trace(runs, cell):
    port, ref = runs
    got = port["cells"][cell]
    assert got["status"] == "ok" and got["flops"] > 0 and got["bytes"] > 0
    assert got["coll"] > 0 and got["mem_gb"] > 0
    assert got["args_bytes"] == ref[cell]


@pytest.mark.parametrize("cell", BUILT)
def test_fsdp_and_wide_dp_cells_hold_the_reference_args(runs, cell):
    port, ref = runs
    assert port["cells"][cell]["args_bytes"] == ref[cell]


def _hand_count(rows, d, V, layers):
    """llama3.2-3b ``decode_32k``'s collectives at ``2x4``: (bytes by
    kind, ops)."""
    bf16 = 2
    summed = (2 * layers + 1) * rows * d * bf16
    return {"all-reduce": summed, "all-gather": rows * V * bf16}, \
        2 * layers + 2


def test_collectives_at_1x1_and_the_hand_count_at_2x4(runs):
    port, _ = runs
    assert port["cells"]["llama3.2-3b decode_32k 1x1"]["coll"] == 0
    got = port["cells"]["llama3.2-3b decode_32k 2x4"]
    by_kind, ops = _hand_count(128 // 2, 3072, 128256, 28)
    assert got["coll_by_kind"] == by_kind
    assert got["coll_ops"] == ops


def test_fsdp_decode_adds_a_gather_a_leaf_and_layer(runs):
    """Under ``fsdp`` every leaf that ``param_specs(..., fsdp=True)``
    slices over the data axis is gathered at use: a stacked leaf once a
    layer (its shard without the stack dim), the others once a step. Each
    all-gather counts its result, the leaf's tensor-parallel shard."""
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.params import init_params
    from repro_torch.train import tree as T
    port, _ = runs
    cfg = get_config("llama3.2-3b")
    mesh = MeshShape((2, 4), ("data", "model"))
    shapes = init_params(cfg, device="meta")
    specs = shd.param_specs(cfg, shapes, mesh)
    dims = T.flatten_up_to(shapes, shd.fsdp_dims(cfg, shapes, mesh))
    gathered = gathers = 0
    for (path, x), spec, d in zip(T.leaves_with_paths(shapes),
                                  T.leaves(specs), dims):
        if d is None:
            continue
        local = shd.local_shape(x.shape, spec, mesh)
        gathered += math.prod(local) * x.element_size()
        gathers += local[0] if path.startswith("['stacks']") else 1
    assert gathers > cfg.num_layers        # every layer gathers
    by_kind, ops = _hand_count(128 // 2, 3072, 128256, cfg.num_layers)
    by_kind["all-gather"] += gathered
    got = port["cells"]["llama3.2-3b decode_32k 2x4 fsdp"]
    assert got["coll_by_kind"] == by_kind
    assert got["coll_ops"] == ops + gathers


def test_model_flops_estimate_matches_jax():
    from repro.analysis import roofline as JR
    from repro.configs import get_config as jget
    from repro.configs.base import SHAPES as JSHAPES
    from repro_torch.analysis import roofline as TR
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.configs.base import SHAPES
    for arch in ARCHS:
        for name, shape in SHAPES.items():
            assert TR.model_flops_estimate(get_config(arch), shape) == \
                JR.model_flops_estimate(jget(arch), JSHAPES[name]), (arch,
                                                                     name)


@pytest.mark.parametrize("cell", ["decode_32k", "decode_32k fsdp"])
def test_extrapolated_cost_equals_the_full_trace(runs, cell):
    port, _ = runs
    got = port["extrapolated"][cell]
    assert got["reps"] == 3
    assert got["est"] == got["full"]
