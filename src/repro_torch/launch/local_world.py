"""Run one function on a world of ranks on this host, for tests and for
``chip_smoke.py``'s multi-rank phases (``torchrun`` is the launcher for
serving and training themselves; see ``launch/serve.py`` and
``launch/train.py``).

``spawn_world(fn, world, workdir, ...)`` starts ``world`` processes with
``multiprocessing``'s spawn context. Each joins the process group through a
``file://`` store in ``workdir`` (``launch.mesh.init_distributed``: no TCP
port to race for), runs ``fn(rank, world, **kwargs)`` and pickles what it
returns into ``workdir``. The parent waits with a deadline: a rank that
fails ends the world at once (the others would only wait in a collective),
and a world still running at the deadline is killed; either raises with
the ranks' tracebacks. ``fn`` must be importable by its module path.
"""
from __future__ import annotations

import multiprocessing
import os
import pickle
import time
import traceback
from typing import Any, Callable, List


def _rank_entry(fn, rank, world, workdir, device, timeout_s, kwargs):
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed
    if device is not None and torch.device(device).type == "cpu":
        torch.set_num_threads(1)        # the ranks share the host's cores
    try:
        init_distributed(device, init_method="file://" + os.path.join(
            workdir, "store"), rank=rank, world_size=world,
            timeout_s=timeout_s)
        result = fn(rank, world, **kwargs)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn_world(fn: Callable, world: int, workdir, *, device=None,
                timeout: float = 120.0, group_timeout: float = 60.0,
                **kwargs) -> List[Any]:
    """``fn(rank, world, **kwargs)`` on ``world`` spawned ranks on
    ``device``: ``None`` or "cuda" puts every rank on the host's cards
    (shared when there are fewer cards than ranks) and fails each rank when
    there is none; "cpu" only when the caller asks for it. Returns each
    rank's result in rank order. ``group_timeout`` bounds each collective,
    ``timeout`` the whole world."""
    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world, workdir, device, group_timeout,
                               kwargs))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    late = False
    try:
        while any(p.is_alive() for p in procs):
            if time.monotonic() > deadline:
                late = True
                break
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    errs = [f"rank {r}:\n{open(path).read()}" for r in range(world)
            if os.path.exists(path := os.path.join(workdir, f"rank{r}.err"))]
    if late or errs or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(
            f"world of {world} running {fn.__name__} "
            f"{'outlived its ' + str(timeout) + ' s' if late else 'failed'} "
            f"(exit codes {[p.exitcode for p in procs]})\n" + "\n".join(errs))
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
