"""PyTorch port: neither it (the dry run and its analysis among its
modules) nor ``chip_smoke.py``, its multi-rank phase tools and the port's
examples (``examples/*_torch.py``) imports JAX or the JAX package, and its
verbatim copies of the reference's pure-Python modules have not
drifted."""
import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"

# Modules the port carries as copies of the reference, with only ``repro.``
# renamed to ``repro_torch.``: the scheduler, the host-side serving modules
# (the simulator among them), the network front door, the pure-data
# model configs, the synthetic training data and the training supervisor.
VERBATIM = (
    sorted(p.relative_to(PORT).as_posix() for p in (PORT / "core").glob("*.py"))
    + [f"serving/{n}.py" for n in ("__init__", "request", "block_allocator",
                                   "drafter", "server", "workloads",
                                   "costmodel", "metrics", "simulator")]
    + [f"frontend/{n}.py" for n in ("__init__", "prefix_directory", "router",
                                    "client", "http_server")]
    + sorted(p.relative_to(PORT).as_posix()
             for p in (PORT / "configs").glob("*.py") if p.name != "base.py")
    + ["train/__init__.py", "train/data.py", "runtime/fault_tolerance.py"]
)

IMPORT_ALL = r"""
import importlib, json, pathlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "repro"
             or m.startswith("repro."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_reference_module():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT))
    assert res.returncode == 0, res.stderr
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    mods = set(report["modules"])
    for required in ("repro_torch.serving.engine", "repro_torch.models.model",
                     "repro_torch.kernels.paged_attention.kernel",
                     "repro_torch.kernels.paged_prefill_attention.kernel",
                     "repro_torch.kernels.chunked_prefill_attention.kernel",
                     "repro_torch.kernels.mamba_scan.kernel",
                     "repro_torch.models.moe",
                     "repro_torch.launch.serve", "repro_torch.params",
                     "repro_torch.frontend.http_server",
                     "repro_torch.frontend.router",
                     "repro_torch.serving.simulator",
                     "repro_torch.train.train_step",
                     "repro_torch.train.checkpoint",
                     "repro_torch.train.optimizer",
                     "repro_torch.train.data",
                     "repro_torch.runtime.compression",
                     "repro_torch.runtime.fault_tolerance",
                     "repro_torch.launch.train",
                     "repro_torch.launch.mesh",
                     "repro_torch.launch.sharding",
                     "repro_torch.launch.local_world",
                     "repro_torch.kernels.shard_utils",
                     "repro_torch.runtime.elastic",
                     "repro_torch.kernels.cost",
                     "repro_torch.launch.steps",
                     "repro_torch.launch.dryrun",
                     "repro_torch.analysis.roofline",
                     "repro_torch.analysis.extrapolate"):
        assert required in mods


def test_no_source_mentions_jax_imports():
    for path in PORT.rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax", "import repro.",
                                     "from repro.", "from repro import")), \
                f"{path}: {line}"


def _imported_modules(path: pathlib.Path) -> list:
    """Every module an ``import`` or ``from ... import`` statement of the
    file names, wherever the statement sits (inside functions too)."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                names.append("." * node.level + (node.module or ""))
            elif node.module:
                names.append(node.module)
    return names


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro") or name.startswith(".")


def test_chip_smoke_imports_no_jax_and_no_reference_module():
    names = _imported_modules(ROOT / "chip_smoke.py")
    assert any(n.startswith("repro_torch") for n in names)
    assert [n for n in names if _forbidden(n)] == []


@pytest.mark.parametrize("tool", ["examples_phase.py", "fsdp_phase.py",
                                  "mesh_all_phase.py",
                                  "sharded_phase.py",
                                  "train_sharded_phase.py"])
def test_chip_tools_import_no_jax_and_no_reference_module(tool):
    names = _imported_modules(ROOT / "tools" / tool)
    assert any(n.startswith("repro_torch") for n in names)
    assert [n for n in names if _forbidden(n)] == []


@pytest.mark.parametrize("example", sorted(
    p.name for p in (ROOT / "examples").glob("*_torch.py")))
def test_examples_import_no_jax_and_no_reference_module(example):
    """The port's examples import torch, numpy and the port only."""
    names = _imported_modules(ROOT / "examples" / example)
    assert any(n.startswith("repro_torch") for n in names)
    assert [n for n in names if _forbidden(n)] == []


def test_every_reference_example_it_ports_has_a_counterpart():
    """Each reference example that serves or trains a model has a port
    beside it (the two that run only the simulator and the cost model,
    verbatim copies here, have none)."""
    ported = {p.name[:-len("_torch.py")] + ".py"
              for p in (ROOT / "examples").glob("*_torch.py")}
    reference = {p.name for p in (ROOT / "examples").glob("*.py")
                 if not p.name.endswith("_torch.py")}
    assert reference - ported == {"quickstart.py", "cluster_simulation.py"}
    assert ported <= reference


@pytest.mark.parametrize("source,bad", [
    ("import jax.numpy as jnp", True),
    ("def f():\n    from repro.models import model", True),
    ("from repro import configs", True),
    ("from . import x", True),
    ("import repro_torch.kernels.build", False),
    ("from repro_torch.models import model", False)])
def test_import_scan_finds_forbidden_imports(tmp_path, source, bad):
    f = tmp_path / "script.py"
    f.write_text(source + "\n")
    assert any(_forbidden(n) for n in _imported_modules(f)) == bad


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy_has_not_drifted(rel):
    port = (PORT / rel).read_text()
    ref = (SRC / "repro" / rel).read_text()
    assert port.replace("repro_torch", "repro") == ref, \
        f"{rel} drifted from src/repro/{rel}"
