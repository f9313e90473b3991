"""The reference's dry-run inputs for ``tests/test_torch_dryrun.py``, in a
subprocess of its own (it sets the host platform's device count before
JAX starts):

    python tests/_dryrun_ref.py OUT.json

For each of the reference test's four cells, and for llama3.2-3b
``decode_32k`` and xlstm-125m ``train_4k`` at ``2x4`` under ``fsdp`` and
xlstm-125m ``train_4k`` under ``wide_dp``, ``steps.build_cell`` on a mesh
of host devices with Auto axes, and ``analytic_memory_bytes`` of its
inputs: ``eval_shape`` and shardings only, nothing is compiled (JAX 0.9
fails to compile these cells on the CPU)."""
import json
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=16")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.analysis import roofline as rl  # noqa: E402
from repro.launch.mesh import dp_size, parse_mesh_spec  # noqa: E402
from repro.launch.steps import build_cell  # noqa: E402

CELLS = [("llama3.2-3b", "decode_32k", "2x4"),
         ("qwen2-moe-a2.7b", "decode_32k", "2x4"),
         ("xlstm-125m", "train_4k", "2x4"),
         ("gemma2-2b", "decode_32k", "2x2x4"),
         ("llama3.2-3b", "decode_32k", "2x4 fsdp"),
         ("xlstm-125m", "train_4k", "2x4 fsdp"),
         ("xlstm-125m", "train_4k", "2x4 wide_dp")]


def main(out_path):
    out = {}
    for arch, shape, spec in CELLS:
        dims, axes = parse_mesh_spec(spec.split()[0])
        mesh = jax.make_mesh(dims, axes, axis_types=(AxisType.Auto,) * len(
            dims), devices=jax.devices()[:int(np.prod(dims))])
        option = {o: True for o in spec.split()[1:]}
        cell = build_cell(arch, shape, mesh, **option)
        a = rl.analytic_memory_bytes(cell.inputs, cell.cfg, cell.shape,
                                     dp_size(mesh), accum=4)
        out[f"{arch} {shape} {spec}"] = a["args_bytes"]
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
