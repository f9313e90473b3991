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
* ``model_flops_estimate`` equals the reference's for every arch x shape.
* ``extrapolated_cost`` equals the full trace's flops, bytes and
  collective bytes on a smoke llama of 3 repetitions (``decode_32k`` at
  ``2x4``).
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
CELLS = ["llama3.2-3b decode_32k 2x4", "qwen2-moe-a2.7b decode_32k 2x4",
         "xlstm-125m train_4k 2x4", "gemma2-2b decode_32k 2x2x4"]


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


def test_collectives_at_1x1_and_the_hand_count_at_2x4(runs):
    port, _ = runs
    assert port["cells"]["llama3.2-3b decode_32k 1x1"]["coll"] == 0
    got = port["cells"]["llama3.2-3b decode_32k 2x4"]
    rows, d, V, layers = 128 // 2, 3072, 128256, 28
    bf16 = 2
    summed = (2 * layers + 1) * rows * d * bf16
    assert got["coll_by_kind"] == {"all-reduce": summed,
                                   "all-gather": rows * V * bf16}
    assert got["coll_ops"] == 2 * layers + 2


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


def test_extrapolated_cost_equals_the_full_trace(runs):
    port, _ = runs
    got = port["extrapolated"]["decode_32k"]
    assert got["reps"] == 3
    assert got["est"] == got["full"]
