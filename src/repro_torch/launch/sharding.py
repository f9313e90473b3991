"""Per-arch partition rules: params, optimizer state, caches, inputs.

Port of the reference ``launch/sharding.py``'s rule functions, over the
port's trees (nested dicts and lists of tensors; a leaf's path is
``jax.tree_util.keystr``'s, from ``train/tree.py``, so the reference's
name patterns carry over verbatim). A spec is a :class:`Spec`, one entry
per dim: an axis name, a tuple of axis names, or ``None`` (replicated);
``tuple(spec)`` equals ``tuple()`` of the reference's ``PartitionSpec``.

Rules are name/shape-driven over the param tree (Megatron-style TP on the
``model`` axis, DP over (``pod``, ``data``)):

* column-parallel: attention q/k/v, MLP up/gate, Mamba in-proj, MLA q_b/kv_b
  (output-feature dim on ``model``);
* row-parallel: attention/MLP/Mamba output projections (input-feature dim on
  ``model``);
* expert-parallel: MoE expert stacks sharded on the expert dim;
* vocab-parallel embedding / LM head;
* small tensors (norms, biases, routers, MLA latent down-projs) replicated.

KV caches shard heads on ``model`` when the head count divides the axis, else
the *sequence* dim. Recurrent states shard d_inner. xlstm-125m is
replicated over ``model`` (DP only). ZeRO: optimizer moments/master weights
additionally shard their largest still-replicated dim over the DP axes
(``zero_shard``).

Serving uses :func:`paged_cache_specs` (each rank allocates its pool at
:func:`local_shape`) and the slot path :func:`cache_specs`
(``models.model.init_cache(..., mesh=)``); sharded training (``train/train_step.py``) places
the parameters by :func:`param_specs` and the optimizer state by
:func:`opt_state_specs`. A mesh here is a ``DeviceMesh`` or a
``launch.mesh.MeshShape``: the rules read its axis sizes only.
:func:`shard_tree` (this rank's shards of a whole tree, each leaf at
:func:`local_shape`) is the counterpart of the reference's
``shardings_of`` + ``jax.device_put``, and :func:`shardings_of` (this
rank's empty local tensors of a shape tree) that of ``shardings_of``
alone, for the dry run; :func:`gather_leaf` (every rank
gets the whole leaf back, for checkpoints) and :func:`gather_tree` (the
whole tree, for tests and small states) need a ``DeviceMesh``.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import shard_utils as su
from repro_torch.launch.mesh import axis_sizes, dp_axes, dp_size
from repro_torch.train.tree import leaves_with_paths, tree_map, unflatten


class Spec:
    """A partition spec: one entry a dim, ``Spec("model", None)``. Not a
    tuple, so the tree walkers of ``train/tree.py`` keep it as a leaf;
    ``tuple(spec)`` gives its entries."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        self.parts = tuple(parts)

    def __iter__(self):
        return iter(self.parts)

    def __len__(self):
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __repr__(self):
        return f"Spec{self.parts!r}"


def _map_with_path(fn, tree: Any) -> Any:
    """``fn(path, leaf)`` over the leaves of ``tree``, in its structure."""
    return unflatten(tree, [fn(p, leaf) for p, leaf in
                            leaves_with_paths(tree)])


# leaf-name patterns -> which dim (from the end, ignoring the leading stack
# dim) goes on the model axis. "col" = last dim, "row" = second-to-last.
_COL = re.compile(
    r"(wq'\]|wk'\]|wv'\]|wi_gate'\]|wi_up'\]|in_proj'\]|up_proj'\]|"
    r"dt_proj'\]|wq_b'\]|w_gates'\]|conv_w'\]|conv_b'\]|dt_bias'\]|D'\])")
_ROW = re.compile(r"(wo'\]|out_proj'\]|down_proj'\]|x_proj'\]|A_log'\])")
_EXPERT = re.compile(r"(w_gate'\]|w_up'\]|w_down'\])")
_REPL = re.compile(
    r"(ln'\]|norm'\]|gn_scale'\]|gate_bias'\]|router|bias|embed'\]|"
    r"wq_a'\]|wkv_a'\]|wkv_b'\]|q_ln'\]|kv_ln'\]|r_gates'\]|proj'\])")


def _spec_for_leaf(path: str, shape: Tuple[int, ...], cfg: ModelConfig,
                   tp: str) -> Spec:
    nd = len(shape)
    if path.endswith("['embed']"):
        return Spec(tp, None)
    if path.endswith("['lm_head']"):
        return Spec(None, tp)
    if cfg.name == "xlstm-125m":
        return Spec(*([None] * nd))          # DP-only tiny model
    if _EXPERT.search(path):
        # [*, E, d, f] / [*, E, f, d]: experts on model (EP)
        return Spec(*([None] * (nd - 3) + [tp, None, None]))
    if path.endswith("['wkv_b']"):
        # [*, kvr, H*(dn+dv)]: heads (last dim) on model
        return Spec(*([None] * (nd - 1) + [tp]))
    if _REPL.search(path):
        return Spec(*([None] * nd))
    if _ROW.search(path):
        # [*, d_in, d_out] (and A_log/x_proj's [*, d_inner, ...]): the
        # second-to-last dim on model
        return Spec(*([None] * (nd - 2) + [tp, None]))
    if _COL.search(path):
        return Spec(*([None] * (nd - 1) + [tp]))
    return Spec(*([None] * nd))


def param_specs(cfg: ModelConfig, params_shape: Any, mesh,
                fsdp: bool = False) -> Any:
    """The param tree's specs. ``fsdp=True`` additionally shards each
    parameter's largest still-replicated dim over the DP axes (ZeRO-3)."""
    tp = "model"

    def one(path, leaf):
        spec = _spec_for_leaf(path, tuple(leaf.shape), cfg, tp)
        spec = _validated(spec, leaf.shape, mesh)
        if fsdp:
            spec = zero_shard(spec, leaf.shape, mesh)
        return spec

    return _map_with_path(one, params_shape)


def fsdp_dims(cfg: ModelConfig, params_shape: Any, mesh) -> Any:
    """Per parameter leaf, the dim that ``param_specs(..., fsdp=True)``
    shards over the DP axes beyond ``param_specs(...)`` (ZeRO-3: the
    model gathers it over those axes at use), or None where it found none;
    a tree shaped like the parameters. All None on a mesh without a DP
    axis (nothing to shard over; the reference's ``zero_shard`` raises
    there)."""
    if not dp_axes(mesh):
        return tree_map(lambda _: None, params_shape)
    plain = param_specs(cfg, params_shape, mesh)
    full = param_specs(cfg, params_shape, mesh, fsdp=True)

    def one(a: Spec, b: Spec):
        dims = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
        return dims[0] if dims else None

    return tree_map(one, plain, full)


def fsdp_of(cfg: ModelConfig, fsdp, mesh, params_shape: Any = None) -> Any:
    """The :func:`fsdp_dims` tree that an ``fsdp`` argument names: None
    for False (or None), the parameters' own dims for True (of
    ``params_shape``, the config's shapes on the meta device when None),
    else ``fsdp`` itself, a tree of dims."""
    if fsdp is True:
        if params_shape is None:
            from repro_torch.params import init_params
            params_shape = init_params(cfg, device="meta")
        return fsdp_dims(cfg, params_shape, mesh)
    return fsdp or None


def with_fsdp(specs: Any, dims: Any, mesh) -> Any:
    """``param_specs``' specs with each leaf's FSDP dim of ``dims`` (a
    :func:`fsdp_dims` tree) on the DP axes: ``param_specs(...,
    fsdp=True)`` when ``dims`` are the same parameters' own."""
    dp = dp_axes(mesh)
    entry = dp if len(dp) > 1 else dp[0] if dp else None

    def one(spec: Spec, d):
        if d is None:
            return spec
        parts = list(spec)
        parts[d] = entry
        return Spec(*parts)

    return tree_map(one, specs, dims)


def batch_axes(mesh, B: int, wide_dp: bool = False) -> Tuple[str, ...]:
    """The mesh axes that a global batch of ``B`` rows lies on, as the
    reference's ``build_cell`` places it: the DP axes where their size
    divides ``B`` (else none: every rank holds the whole batch), and with
    ``wide_dp`` the DP axes and ``model`` where their product divides
    ``B`` (every rank its own rows)."""
    dp = dp_axes(mesh)
    sizes = axis_sizes(mesh)
    if wide_dp and "model" in sizes and B % (dp_size(mesh)
                                              * sizes["model"]) == 0:
        return dp + ("model",)
    return dp if B % dp_size(mesh) == 0 else ()


def blocks_replicated(cfg: ModelConfig, params_shape: Any, mesh) -> bool:
    """Whether ``param_specs`` leaves every leaf but the vocab-parallel
    embedding and LM head whole on the ``model`` axis (xlstm-125m): a wide
    batch's rows then run on each rank as its own."""
    for path, spec in leaves_with_paths(param_specs(cfg, params_shape,
                                                    mesh)):
        if path in ("['embed']", "['lm_head']"):
            continue
        if any("model" in _entry_axes(e) for e in spec):
            return False
    return True


def _validated(spec: Spec, shape, mesh) -> Spec:
    """Drop shardings that do not divide evenly (avoid padded-shard blowup)."""
    sizes = axis_sizes(mesh)
    parts = []
    for i, s in enumerate(spec):
        if s is None:
            parts.append(None)
            continue
        axes = s if isinstance(s, tuple) else (s,)
        size = 1
        for a in axes:
            size *= sizes[a]
        parts.append(s if shape[i] % size == 0 else None)
    return Spec(*parts)


def zero_shard(spec: Spec, shape, mesh) -> Spec:
    """ZeRO-1: shard the largest still-replicated dim over the DP axes."""
    dp = dp_axes(mesh)
    n = dp_size(mesh)
    # already DP-sharded (e.g. FSDP params): nothing to add
    for entry in spec:
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a in dp:
                return spec
    best, best_size = None, 0
    for i in range(len(shape)):
        cur = spec[i] if i < len(spec) else None
        if cur is None and shape[i] % n == 0 and shape[i] > best_size:
            best, best_size = i, shape[i]
    if best is None:
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    parts[best] = dp if len(dp) > 1 else dp[0]
    return Spec(*parts)


def opt_state_specs(cfg: ModelConfig, opt_shape: Any, pspecs: Any,
                    mesh) -> Any:
    """Moments/master mirror the params + ZeRO sharding; step is replicated."""
    by_path: Dict[str, Spec] = dict(leaves_with_paths(pspecs))

    def one(path, leaf):
        if path.endswith("['step']"):
            return Spec()
        # strip the leading "['m']"/"['v']"/"['master']" to find the param
        pspec: Optional[Spec] = by_path.get(path.split("]", 1)[1])
        if pspec is None:
            pspec = Spec(*([None] * len(leaf.shape)))
        return zero_shard(pspec, leaf.shape, mesh)

    return _map_with_path(one, opt_shape)


def cache_specs(cfg: ModelConfig, cache_shape: Any, mesh) -> Any:
    """The slot cache's specs (``models.model.init_cache`` leaves)."""
    tp = "model"
    sizes = axis_sizes(mesh)
    dp = dp_axes(mesh)
    dpa = dp if len(dp) > 1 else dp[0]
    heads_fit = cfg.num_kv_heads % sizes[tp] == 0

    def one(p, leaf):
        nd = len(leaf.shape)
        B = leaf.shape[1] if nd >= 2 else 1
        bspec = dpa if B % dp_size(mesh) == 0 else None
        if cfg.name == "xlstm-125m":
            return _validated(Spec(*([None, bspec] + [None] * (nd - 2))),
                              leaf.shape, mesh)
        if re.search(r"\['(k|v|cross_k|cross_v)'\]", p):
            # [R, B, S, Hkv, Dh]
            if heads_fit:
                return _validated(Spec(None, bspec, None, tp, None),
                                  leaf.shape, mesh)
            return _validated(Spec(None, bspec, tp, None, None), leaf.shape,
                              mesh)
        if re.search(r"\['(ckv|kr)'\]", p):
            # [R, B, S, latent] -- shard sequence
            return _validated(Spec(None, bspec, tp, None), leaf.shape, mesh)
        if "['mamba']" in p:
            # conv [R, B, K-1, di] / ssm [R, B, di, n]
            if p.endswith("['conv']"):
                return _validated(Spec(None, bspec, None, tp), leaf.shape,
                                  mesh)
            return _validated(Spec(None, bspec, tp, None), leaf.shape, mesh)
        if "['mlstm']" in p or "['slstm']" in p:
            return _validated(Spec(*([None, bspec] + [None] * (nd - 2))),
                              leaf.shape, mesh)
        return _validated(Spec(*([None] * nd)), leaf.shape, mesh)

    return _map_with_path(one, cache_shape)


def with_data_axis(mesh):
    """``mesh``, or where it has no data-parallel axis (the port's mesh
    "4") a ``MeshShape`` of its sizes behind a ``data`` axis of 1: the
    reference's :func:`cache_specs` indexes the first data-parallel axis,
    and a batch on an axis of 1 is the whole batch. Read the specs and
    :func:`local_shape` both against what this returns."""
    from repro_torch.launch.mesh import MeshShape
    if dp_axes(mesh):
        return mesh
    return MeshShape((1, *mesh.shape), ("data", *mesh.mesh_dim_names))


def paged_cache_specs(cfg: ModelConfig, cache_shape: Any, mesh,
                      axis: str = "model") -> Any:
    """Specs of the *serving* paged KV pools (``init_paged_cache`` leaves,
    fused head-interleaved ``[reps, Hkv, num_pages, 2, page_size, Dh]``).

    Mirrors :func:`cache_specs`' head rule: pages shard their KV-head dim on
    ``axis`` when the head count divides it; otherwise the pools stay
    replicated and the attention ops sequence-shard the computation instead
    (partial-softmax combine). A mesh without ``axis`` replicates the pools.
    The shared ``head_shards`` rule keeps placement, ops dispatch and
    reporting in lockstep."""
    from repro_torch.kernels.shard_utils import head_shards
    heads_fit = head_shards(cfg.num_kv_heads, mesh, axis) > 1

    def one(path, leaf):
        nd = len(leaf.shape)
        if heads_fit and nd >= 2:
            return _validated(Spec(None, axis, *([None] * (nd - 2))),
                              leaf.shape, mesh)
        return Spec(*([None] * nd))

    return _map_with_path(one, cache_shape)


def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's shard of a leaf of ``shape`` under ``spec``
    (each sharded dim divided by its axes' sizes; ``_validated`` specs
    divide evenly)."""
    sizes = axis_sizes(mesh)
    out = []
    for i, n in enumerate(shape):
        s = spec[i] if i < len(spec) else None
        for a in (() if s is None else s if isinstance(s, tuple) else (s,)):
            n //= sizes[a]
        out.append(n)
    return tuple(out)


def batch_spec(mesh, extra_dims: int = 1) -> Spec:
    dp = dp_axes(mesh)
    dpa = dp if len(dp) > 1 else dp[0]
    return Spec(dpa, *([None] * extra_dims))


def _entry_axes(entry) -> Tuple[str, ...]:
    return () if entry is None else entry if isinstance(entry, tuple) \
        else (entry,)


def shard_leaf(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of the whole leaf ``x`` under ``spec``: along each
    sharded dim the block of its coordinate on that dim's axes (row-major
    over a tuple of axes), as a tensor of its own."""
    for i, entry in enumerate(spec):
        ax = su.mesh_axis(mesh, _entry_axes(entry))
        if ax is not None:
            x = su.own_slice(x, i, ax)
    return x.clone(memory_format=torch.contiguous_format)


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    """This rank's shards of a whole tree (``None`` leaves stay ``None``):
    each leaf at ``local_shape(leaf.shape, spec, mesh)``."""
    return tree_map(lambda x, s: shard_leaf(x, s, mesh), tree, specs)


@torch.no_grad()
def gather_leaf(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole leaf from every rank's block ``x`` (a collective: every
    rank of the mesh calls it, and every rank gets the whole leaf)."""
    for i, entry in enumerate(spec):
        ax = su.mesh_axis(mesh, _entry_axes(entry))
        if ax is not None:
            x = su.all_gather(x, i, ax)
    return x


def shardings_of(shape_tree: Any, specs: Any, mesh, device=None) -> Any:
    """The counterpart of the reference's ``shardings_of`` (sharded
    ``ShapeDtypeStruct`` stand-ins): this rank's local tensors of a shape
    tree (leaves with ``shape`` and ``dtype``, such as a tree on the meta
    device), each an empty tensor at ``local_shape(leaf.shape, spec,
    mesh)`` on ``device`` (the leaf's when None). Under a
    ``FakeTensorMode`` they are fake tensors that hold no memory: the dry
    run's inputs (``launch/steps.build_cell``)."""
    return tree_map(lambda x, s: torch.empty(
        local_shape(x.shape, s, mesh), dtype=x.dtype,
        device=x.device if device is None else device), shape_tree, specs)


def gather_tree(tree: Any, specs: Any, mesh) -> Any:
    """The whole tree from every rank's shards (a collective over the mesh;
    leaves in flattening order on every rank)."""
    return tree_map(lambda x, s: gather_leaf(x, s, mesh), tree, specs)
