"""PyTorch port: the partition rules (``repro_torch.launch.sharding``) and
the elastic re-mesh plan (``repro_torch.runtime.elastic``) against the
JAX package's, leaf by leaf. Pure Python: meshes are described by their
sizes (``MeshShape`` here, ``jax.sharding.AbstractMesh`` there), so no
device and no process group is needed. A port spec equals the reference's
when ``tuple(spec) == tuple(P)``; where the reference raises (a mesh with
no data axis has no batch or ZeRO axis), the port must raise the same
exception."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec as P  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import sharding as JS  # noqa: E402
from repro.models.model import init_cache as jinit_cache  # noqa: E402
from repro.models.model import init_paged_cache as jinit_paged  # noqa: E402
from repro.models.model import init_params as jinit_params  # noqa: E402
from repro.runtime.elastic import plan_remesh as jplan  # noqa: E402
from repro.runtime.elastic import resharding_plan as jresharding  # noqa: E402
from repro.train.optimizer import adamw_init as jadamw_init  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch import sharding as S  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.models.model import (init_cache, init_paged_cache,  # noqa: E402
                                      supports_paged_cache)
from repro_torch.params import init_params  # noqa: E402
from repro_torch.runtime.elastic import (MeshPlan, plan_remesh,  # noqa: E402
                                         resharding_plan)
from repro_torch.train.optimizer import adamw_init  # noqa: E402
from repro_torch.train.tree import leaves_with_paths  # noqa: E402

MESHES = [((4,), ("model",)), ((2, 4), ("data", "model")),
          ((2, 2, 4), ("pod", "data", "model"))]


# ---- the elastic plan ---------------------------------------------------------
def test_elastic_remesh_plan():
    """tests/test_train_runtime.py::test_elastic_remesh_plan on the port."""
    p = plan_remesh(256)
    assert p.shape == (16, 16) and p.axes == ("data", "model")
    p2 = plan_remesh(512)
    assert p2.shape == (2, 16, 16) and p2.axes == ("pod", "data", "model")
    # losing 16 devices of 256: model axis preserved
    p3 = plan_remesh(240)
    assert p3.shape == (15, 16)
    assert not resharding_plan(p, p3)["tp_reshard_required"]
    # an awkward count falls back to a smaller model axis
    p4 = plan_remesh(24)
    assert p4.shape == (3, 8)
    assert resharding_plan(p, p4)["tp_reshard_required"]


def test_elastic_plans_equal_the_reference():
    """plan_remesh(n) for n in 1..1024, and resharding_plan from 256 and
    from the previous count, equal the reference's."""
    base, jbase = plan_remesh(256), jplan(256)
    prev, jprev = base, jbase
    for n in range(1, 1025):
        p, jp = plan_remesh(n), jplan(n)
        assert (p.shape, p.axes, p.describe()) == \
            (jp.shape, jp.axes, jp.describe()), n
        assert resharding_plan(base, p) == jresharding(jbase, jp), n
        assert resharding_plan(prev, p) == jresharding(jprev, jp), n
        prev, jprev = p, jp
    assert MeshPlan((2, 4), ("data", "model")).describe() == \
        "data=2 x model=4"


# ---- the partition rules ------------------------------------------------------
def _jax_specs(tree):
    """{keystr path: tuple(P)} of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {jax.tree_util.keystr(p): tuple(s) for p, s in flat}


def _port_specs(tree):
    return {p: tuple(s) for p, s in leaves_with_paths(tree)}


def _same(port_fn, jax_fn):
    """Both rule calls give the same specs by path, or raise the same
    exception type."""
    try:
        want = jax_fn()
    except Exception as e:          # the reference's own refusal
        with pytest.raises(type(e)):
            port_fn()
        return 0
    got = port_fn()
    if isinstance(want, P):
        assert tuple(got) == tuple(want)
        return 1
    want, got = _jax_specs(want), _port_specs(got)
    assert got == want
    return len(want)


def _meshes():
    return [(MeshShape(d, a), AbstractMesh(d, a)) for d, a in MESHES]


def _configs(arch):
    return get_config(arch).smoke(), jget_config(arch).smoke()


@pytest.fixture(scope="module")
def shapes():
    """Per arch: (port cfg, jax cfg, port params on the meta device, JAX
    params as shapes)."""
    out = {}
    for arch in ARCHS:
        cfg, jcfg = _configs(arch)
        out[arch] = (cfg, jcfg, init_params(cfg, 0, device="meta"),
                     jax.eval_shape(lambda c=jcfg: jinit_params(
                         c, jax.random.PRNGKey(0))))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_state_specs_equal_the_reference(arch, shapes):
    """param_specs (with and without fsdp) and opt_state_specs over each
    package's own AdamW state, on meshes (4,), (2, 4) and (2, 2, 4)."""
    cfg, jcfg, params, jparams = shapes[arch]
    opt = adamw_init(params)
    jopt = jax.eval_shape(jadamw_init, jparams)
    compared = 0
    for mesh, jmesh in _meshes():
        for fsdp in (False, True):
            compared += _same(
                lambda: S.param_specs(cfg, params, mesh, fsdp=fsdp),
                lambda: JS.param_specs(jcfg, jparams, jmesh, fsdp=fsdp))
        try:
            jps = JS.param_specs(jcfg, jparams, jmesh)
        except Exception:
            jps = None
        if jps is not None:
            ps = S.param_specs(cfg, params, mesh)
            compared += _same(
                lambda: S.opt_state_specs(cfg, opt, ps, mesh),
                lambda: JS.opt_state_specs(jcfg, jopt, jps, jmesh))
    assert compared > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_equal_the_reference(arch):
    """cache_specs over the slot cache, paged_cache_specs over the paged
    pools (the archs that have them) and batch_spec, per mesh."""
    cfg, jcfg = _configs(arch)
    enc = 8 if cfg.enc_dec else 0
    cache = init_cache(cfg, 4, 32, device="meta", enc_len=enc)
    jcache = jax.eval_shape(lambda: jinit_cache(jcfg, 4, 32, enc_len=enc))
    compared = 0
    for mesh, jmesh in _meshes():
        compared += _same(lambda: S.cache_specs(cfg, cache, mesh),
                          lambda: JS.cache_specs(jcfg, jcache, jmesh))
        if supports_paged_cache(cfg):
            pools = init_paged_cache(cfg, 9, 8, device="meta")
            jpools = jax.eval_shape(lambda: jinit_paged(jcfg, 9, 8))
            assert _same(lambda: S.paged_cache_specs(cfg, pools, mesh),
                         lambda: JS.paged_cache_specs(jcfg, jpools, jmesh)) > 0
        for extra in (1, 2):
            compared += _same(lambda: S.batch_spec(mesh, extra),
                              lambda: JS.batch_spec(jmesh, extra))
    assert compared > 0


@pytest.mark.parametrize("kv_heads", [2, 4, 8])
def test_paged_cache_specs_split_heads_when_they_divide(kv_heads):
    """The one rule at world sizes 1-4: heads sharded exactly when the
    model axis (> 1) divides them, and each rank's shard shape."""
    cfg = dataclasses.replace(get_config("llama3.2-3b").smoke(),
                              num_heads=2 * kv_heads, num_kv_heads=kv_heads)
    jcfg = dataclasses.replace(jget_config("llama3.2-3b").smoke(),
                               num_heads=2 * kv_heads, num_kv_heads=kv_heads)
    pools = init_paged_cache(cfg, 9, 8, device="meta")
    jpools = jax.eval_shape(lambda: jinit_paged(jcfg, 9, 8))
    for m in (1, 2, 3, 4):
        mesh, jmesh = MeshShape((m,), ("model",)), AbstractMesh((m,),
                                                                ("model",))
        _same(lambda: S.paged_cache_specs(cfg, pools, mesh),
              lambda: JS.paged_cache_specs(jcfg, jpools, jmesh))
        leaf = pools[0][0]["kv_pages"]
        spec = S.paged_cache_specs(cfg, pools, mesh)[0][0]["kv_pages"]
        split = m > 1 and kv_heads % m == 0
        want = list(leaf.shape)
        want[1] //= m if split else 1
        assert S.local_shape(leaf.shape, spec, mesh) == tuple(want)


def test_full_width_llama_specs_equal_the_reference():
    """llama3.2-3b at full width, its shape tree built on the meta device:
    param_specs (with fsdp) on a 16 x 16 mesh and the paged pools'."""
    cfg, jcfg = get_config("llama3.2-3b"), jget_config("llama3.2-3b")
    params = init_params(cfg, 0, device="meta")
    assert all(p.device.type == "meta" for _, p in leaves_with_paths(params))
    jparams = jax.eval_shape(lambda: jinit_params(jcfg,
                                                  jax.random.PRNGKey(0)))
    shapes = {p: tuple(x.shape) for p, x in leaves_with_paths(params)}
    jshapes = {jax.tree_util.keystr(p): tuple(x.shape) for p, x in
               jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert shapes == jshapes
    mesh = MeshShape((16, 16), ("data", "model"))
    jmesh = AbstractMesh((16, 16), ("data", "model"))
    for fsdp in (False, True):
        assert _same(lambda: S.param_specs(cfg, params, mesh, fsdp=fsdp),
                     lambda: JS.param_specs(jcfg, jparams, jmesh,
                                            fsdp=fsdp)) == len(shapes)
    pools = init_paged_cache(cfg, 4097, 16, device="meta")
    jpools = jax.eval_shape(lambda: jinit_paged(jcfg, 4097, 16))
    for m in (2, 3, 4, 8):
        _same(lambda: S.paged_cache_specs(cfg, pools, MeshShape((m,),
                                                                ("model",))),
              lambda: JS.paged_cache_specs(jcfg, jpools,
                                           AbstractMesh((m,), ("model",))))
    assert np.prod(S.local_shape(
        pools[0][0]["kv_pages"].shape,
        S.paged_cache_specs(cfg, pools, MeshShape((2,), ("model",)))
        [0][0]["kv_pages"], MeshShape((2,), ("model",)))) * 2 == \
        pools[0][0]["kv_pages"].numel()
