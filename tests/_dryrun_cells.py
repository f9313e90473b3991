"""The port's dry-run cells for ``tests/test_torch_dryrun.py``, in a process
of their own (the fake process group is process-wide):

    python tests/_dryrun_cells.py OUT.json

Runs the reference test's four cells through ``launch.dryrun.run_cell``
(each at its ``REPRO_FORCE_MESH``), llama3.2-3b ``decode_32k`` at ``1x1``
and under ``fsdp`` at ``2x4``, and, for a smoke llama of 3 repetitions,
the full trace beside ``extrapolated_cost`` (decode at ``2x4``, also
under ``fsdp``). Builds
(without tracing) xlstm-125m ``train_4k`` at ``2x4`` under ``fsdp`` and
under ``wide_dp`` for their ``args_bytes``. Imports no JAX."""
import json
import os
import sys

CELLS = [("llama3.2-3b", "decode_32k", "2x4", False),
         ("qwen2-moe-a2.7b", "decode_32k", "2x4", False),
         ("xlstm-125m", "train_4k", "2x4", False),
         ("gemma2-2b", "decode_32k", "2x2x4", True),
         ("llama3.2-3b", "decode_32k", "1x1", False),
         ("llama3.2-3b", "decode_32k", "2x4 fsdp", False)]
# built only, for their args_bytes: (arch, shape, mesh, option)
BUILT = [("xlstm-125m", "train_4k", "2x4", "fsdp"),
         ("xlstm-125m", "train_4k", "2x4", "wide_dp")]


def main(out_path):
    import dataclasses

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis import extrapolate as ex
    from repro_torch.analysis import roofline as rl
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_cell
    out = {"cells": {}, "extrapolated": {}}
    for arch, shape, mesh, multi_pod in CELLS:
        os.environ["REPRO_FORCE_MESH"] = mesh.split()[0]
        r = dryrun.run_cell(arch, shape, multi_pod=multi_pod,
                            fsdp=mesh.endswith("fsdp"))
        out["cells"][f"{arch} {shape} {mesh}"] = {
            "status": r["status"], "flops": r["flops_per_dev"],
            "bytes": r["bytes_per_dev"],
            "coll": r["collective_bytes_per_dev"],
            "coll_by_kind": r["collective_by_kind"],
            "coll_ops": r["collective_ops"], "args_bytes": r["args_bytes"],
            "mem_gb": r["mem_per_dev_gb"]}
    for arch, shape, spec, option in BUILT:
        os.environ["REPRO_FORCE_MESH"] = spec
        with dryrun.fake_world(8):
            mesh = make_production_mesh(device_type="cpu")
            dryrun._warm_groups(mesh)
            with FakeTensorMode():
                cell = build_cell(arch, shape, mesh,
                                  device=dryrun.trace_device(),
                                  **{option: True})
            a = rl.analytic_memory_bytes(cell.inputs, cell.cfg, cell.shape,
                                         2, accum=4)
        out["cells"][f"{arch} {shape} {spec} {option}"] = {
            "args_bytes": a["args_bytes"]}
    cfg = dataclasses.replace(get_config("llama3.2-3b").smoke(),
                              num_layers=3)
    for shape, spec, fsdp in (("decode_32k", "2x4", False),
                              ("decode_32k", "2x4", True)):
        os.environ["REPRO_FORCE_MESH"] = spec
        with dryrun.fake_world(8):
            mesh = make_production_mesh(device_type="cpu")
            dryrun._warm_groups(mesh)
            with FakeTensorMode():
                cell = build_cell("llama3.2-3b", shape, mesh,
                                  cfg_override=cfg, fsdp=fsdp,
                                  device=dryrun.trace_device())
                full = rl.trace(cell.fn, *cell.inputs)
                est = ex.extrapolated_cost("llama3.2-3b", shape, mesh,
                                           cfg=cfg, fsdp=fsdp,
                                           device=dryrun.trace_device())
        out["extrapolated"][shape + (" fsdp" if fsdp else "")] = {
            "full": [full.flops, full.bytes, full.collectives.total_bytes],
            "est": [est["flops"], est["bytes"], est["coll"]],
            "reps": est["reps"]}
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
