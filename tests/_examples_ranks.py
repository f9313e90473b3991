"""Rank body of the port's examples on a mesh.

``repro_torch.launch.local_world.spawn_world`` runs :func:`world` on
spawned ranks (gloo on CPU tensors, a ``file://`` store): every rank runs
``examples/serve_streaming_torch.py``'s scenarios on the serving mesh,
building each server alike; rank 0 drives and returns the records with
what it printed, the workers return None records. Imports torch and the
port only, so a rank starts quickly.
"""
from __future__ import annotations

import contextlib
import importlib.util
import io
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]
KV = 4096                     # the example's default --kv-tokens


def load_example(name):
    """``examples/<name>.py`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def scenarios(ex):
    """(name, scenario, its keywords) in the order every rank runs them."""
    return (("demo", ex.streaming_demo, {"cache_mode": "paged"}),
            ("prefix", ex.shared_prefix_smoke, {}),
            ("spec", ex.spec_smoke, {"spec_k": 4}))


def world(rank, world, meshes):
    """{(mesh, scenario): (record, printed text)} for every mesh, then the
    slot demo on the last mesh (which ignores it: rank 0 serves alone)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_serving_mesh
    ex = load_example("serve_streaming_torch")
    cfg = get_config("llama3.2-3b").smoke()
    out = {}
    for spec in meshes:
        mesh = make_serving_mesh(spec)
        runs = scenarios(ex)
        if spec == meshes[-1]:
            runs += (("slot", ex.streaming_demo, {"cache_mode": "slot"}),)
        for name, fn, kw in runs:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rec = fn(cfg, kv_capacity_tokens=KV, device="cpu",
                         mesh=mesh, **kw)
            out[spec, name] = (rec, buf.getvalue())
    return out
