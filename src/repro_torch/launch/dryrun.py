"""Multi-pod dry run: trace every (arch x input-shape x mesh) cell's program
on rank 0, with no card and no memory (port of the reference
``launch/dryrun.py``).

For each cell this shows, without hardware:
  * the per-arch sharding rules are coherent (rank 0's sharded program runs
    through, its collectives included, on its local shapes),
  * the per-device memory (the traced peak of live storage) beside the
    reference's analytic accounting,
  * the flop/byte/collective volumes for the roofline table
    (``analysis/roofline.py``).

The reference lowers and compiles one SPMD program over 512 host devices.
The port runs one process a rank, so the dry run initialises a fake
process group of the mesh's size (``torch.testing``'s ``FakeStore``: every
collective returns at once, on rank 0 alone) and traces rank 0's program
under a ``FakeTensorMode`` on device "cuda" (on "cpu" where this torch is
built without CUDA: such a build cannot index a fake CUDA tensor; the
counts are the same). The kernels count their work there
(``kernels/cost.py``) instead of launching.

Usage:
    python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--multi-pod|--both] [--roofline] [--out results.csv]
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import time
import traceback

import torch

from repro_torch.analysis import roofline as rl
from repro_torch.configs import ARCHS, cell_skip_reason
from repro_torch.configs.base import SHAPES
from repro_torch.launch.mesh import dp_size, make_production_mesh, \
    parse_mesh_spec
from repro_torch.launch.steps import build_cell

HBM_BYTES = 80e9         # an NVIDIA H100 80GB HBM3's memory


def trace_device() -> str:
    """The device of the traced program's fake tensors."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def _mesh_dims(multi_pod: bool):
    forced = os.environ.get("REPRO_FORCE_MESH")
    if forced:
        return parse_mesh_spec(forced)[0]
    return (2, 16, 16) if multi_pod else (16, 16)


class fake_world:
    """A fake process group of ``size`` ranks, this process rank 0, for the
    block (when no group exists; an existing one is left as it is), and
    the multi-axis groups of ``shard_utils`` made for it dropped after."""

    def __init__(self, size: int):
        self.size = size
        self.own = False

    def __enter__(self):
        import torch.distributed as dist
        if not dist.is_initialized():
            from torch.testing._internal.distributed.fake_pg import FakeStore
            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=self.size)
            self.own = True
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        from repro_torch.kernels import shard_utils as su
        if self.own:
            su._GROUPS.clear()
            dist.destroy_process_group()


def _warm_groups(mesh) -> None:
    """Make every multi-axis group now: the groups are built from the rank
    grid, a tensor, which the fake tensor mode cannot read."""
    import itertools

    from repro_torch.kernels import shard_utils as su
    names = tuple(mesh.mesh_dim_names)
    for n in range(2, len(names) + 1):
        for axes in itertools.combinations(names, n):
            su.mesh_axis(mesh, axes)


def traced_cell(arch: str, shape_name: str, mesh, fsdp: bool = False):
    """(the cell, its traced counts, seconds to build, seconds to trace)
    of rank 0's program on ``mesh``; None for a skipped cell."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    _warm_groups(mesh)
    t0 = time.time()
    with FakeTensorMode():
        cell = build_cell(arch, shape_name, mesh, fsdp=fsdp,
                          device=trace_device())
        if cell is None:
            return None
        t_build = time.time() - t0
        t0 = time.time()
        counts = rl.trace(cell.fn, *cell.inputs)
    return cell, counts, t_build, time.time() - t0


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             roofline: bool = False, verbose: bool = True,
             fsdp: bool = False):
    """One cell's row. ``roofline`` is the reference's flag to unroll the
    layer scans for exact counts: the port's trace runs every repetition
    anyway, so it changes nothing. ``fsdp``: the parameters and the
    optimizer state at ZeRO-3 slices (``build_cell``), each leaf gathered
    over the DP axes at use in the traced program (its all-gathers, and a
    train step's reduce-scatters, among the collectives)."""
    mesh_name = "2x16x16" if multi_pod else "16x16"
    skip = cell_skip_reason(arch, SHAPES[shape_name])
    if skip:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skip", "reason": skip}
    with fake_world(math.prod(_mesh_dims(multi_pod))):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        cell, counts, t_build, t_trace = traced_cell(arch, shape_name, mesh,
                                                     fsdp)
        n_dev, n_dp = mesh.size(), dp_size(mesh)
    analytic = rl.analytic_memory_bytes(cell.inputs, cell.cfg, cell.shape,
                                        n_dp, accum=4)
    args = analytic["args_bytes"]
    report = rl.analyze(
        arch, shape_name, mesh_name, counts=counts, num_devices=n_dev,
        model_flops=rl.model_flops_estimate(cell.cfg, cell.shape),
        memory_bytes_per_device=counts.peak_bytes)
    coll = counts.collectives
    out = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "status": "ok",
        "build_s": round(t_build, 1), "trace_s": round(t_trace, 1),
        "mem_per_dev_gb": round(counts.peak_bytes / 1e9, 3),
        "temp_gb": round((counts.peak_bytes - args) / 1e9, 3),
        "args_gb": round(args / 1e9, 3),
        "args_bytes": args,
        "flops_per_dev": counts.flops,
        "bytes_per_dev": counts.bytes,
        "collective_bytes_per_dev": coll.total_bytes,
        "collective_ops": coll.num_ops,
        "collective_by_kind": coll.by_kind,
        "kernel_calls": counts.kernel_calls,
        "roofline": report,
        "analytic_gb": round(analytic["total_bytes"] / 1e9, 3),
        # HBM fit judged on the analytic accounting, as the reference's
        "fits_hbm": analytic["total_bytes"] <= HBM_BYTES,
    }
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_name}] OK "
              f"build={t_build:.1f}s trace={t_trace:.1f}s "
              f"mem/dev={out['mem_per_dev_gb']:.2f}GB "
              f"analytic={out['analytic_gb']:.2f}GB "
              f"(fits80GB={out['fits_hbm']}) "
              f"flops/dev={out['flops_per_dev']:.3e} "
              f"coll={coll.total_bytes:.3e}B/{coll.num_ops}ops "
              f"bottleneck={report.bottleneck}", flush=True)
    return out


HEADER = ("arch,shape,mesh,flops_per_dev,bytes_per_dev,coll_bytes_per_dev,"
          "t_compute_ms,t_memory_ms,t_collective_ms,bottleneck,"
          "useful_ratio,peak_fraction,mem_per_dev_gb\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both", action="store_true", help="run 16x16 and 2x16x16")
    ap.add_argument("--roofline", action="store_true",
                    help="the reference's unrolled counts (the trace "
                         "counts every repetition anyway)")
    ap.add_argument("--fsdp", action="store_true",
                    help="ZeRO-3 parameter sharding over the DP axes "
                         "(gathered a layer at a time: the all-gathers "
                         "count as collectives)")
    ap.add_argument("--out", default=None, help="append CSV rows here")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both else [args.multi_pod]

    failures = 0
    rows = []
    for multi_pod in meshes:
        for arch in archs:
            for shape in shapes:
                try:
                    res = run_cell(arch, shape, multi_pod=multi_pod,
                                   roofline=args.roofline, fsdp=args.fsdp)
                    if res["status"] == "skip":
                        print(f"[{arch} x {shape}] SKIP: {res['reason']}",
                              flush=True)
                    else:
                        rows.append(res)
                except Exception as e:
                    failures += 1
                    print(f"[{arch} x {shape} x "
                          f"{'2x16x16' if multi_pod else '16x16'}] FAIL: "
                          f"{type(e).__name__}: {e}", flush=True)
                    traceback.print_exc()
    if args.out and rows:
        new = not os.path.exists(args.out)
        with open(args.out, "a") as f:
            if new:
                f.write(HEADER)
            for r in rows:
                f.write(r["roofline"].row() + "\n")
    print(f"dryrun: {len(rows)} ok, {failures} failed", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
