"""Mesh helpers of the sharded kernel dispatch and of sharded training:
the ONE partition rule for paged KV, the collectives of the two serving
partitions, and the differentiable collectives of tensor, expert and data
parallelism.

Port of the reference ``kernels/shard_utils.py``. The reference writes each
sharded op as a per-shard function under ``shard_map`` (and lets GSPMD
place the rest), and its shim here covers two JAX versions of it. PyTorch
has no counterpart: a rank runs its shard's body itself, on plain tensors
(its shard of the KV pool, as ``launch/sharding.paged_cache_specs`` places
it, or of the parameters, as ``param_specs`` places them), and calls the
collectives over the mesh axis's process group explicitly.

Serving (both attention ops, ``paged_attention/ops.py`` and
``paged_prefill_attention/ops.py``, share them):

* :func:`gather_heads` -- the head partition's re-replication of the
  attention output (pure data movement: bit-identical to one device);
* :func:`combine_partials` -- the sequence partition's flash-decode
  combine: the global maximum of the row maxima, then the sums of the
  rescaled value partials and normalizers, and one division.

Training: every rank of the ``model`` axis computes the whole loss of its
data-parallel rows, so a collective's backward is the conjugate that keeps
each rank's gradient of a replicated tensor whole (Megatron's f and g):

* :func:`reduce_from` -- sum-reduce forward, identity backward (a
  row-parallel product's partial sums);
* :func:`copy_to` -- identity forward, sum-reduce backward (a replicated
  tensor entering a rank-specific computation: a column-parallel
  product's input, a replicated weight applied to this rank's heads or
  tokens);
* :func:`gather_from` -- gather forward, own slice backward (a shard
  re-replicated for replicated work);
* :func:`gather_to_own` -- gather forward, reduce-scatter backward (a
  shard gathered for rank-specific work: each rank takes other columns of
  the whole);
* :func:`scatter_to` -- own slice forward, gather backward;
* :func:`all_to_all` -- the exchange of equal blocks along dim 0, itself
  its inverse, so it is its own backward.

``torch.distributed.nn.functional``'s ``all_reduce`` and ``all_gather``
are not used: their backward sums every rank's gradient, ``M`` times too
large when each rank holds the whole loss. An :class:`Axis` names a group
(one mesh axis, or several such as ``("pod", "data")``), its size and this
rank's coordinate. Gloo, the data plane of ranks that share a card, takes
CUDA tensors for every collective used here (``all_gather``,
``all_reduce``, ``all_to_all_single``, ``reduce_scatter_tensor``) and
copies them through the host inside.

A mesh is a ``torch.distributed`` ``DeviceMesh`` (``launch/mesh.py``);
the rule functions also take a ``MeshShape`` (sizes, no ranks), which
has the two attributes read here.

"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch


def axis_size(mesh, axis: str) -> int:
    """Size of ``axis`` on ``mesh`` (a ``DeviceMesh`` or a
    ``launch.mesh.MeshShape``); 1 when there is no mesh (single-device
    dispatch) or the mesh does not carry the axis."""
    if mesh is None:
        return 1
    return int(dict(zip(mesh.mesh_dim_names, mesh.shape)).get(axis, 1))


def head_shards(num_kv_heads: int, mesh, axis: str) -> int:
    """The ONE partition rule for paged KV: how many ways the KV heads (and
    with them the page pools) split on ``axis`` -- the axis size when it
    divides the head count, else 1 (replicated pools + sequence-sharded
    attention fallback). Both ops dispatchers, ``paged_cache_specs``, the
    model's KV write and ``EngineCore.kv_shards`` consult this so cache
    placement, kernel dispatch and reporting can never disagree."""
    m = axis_size(mesh, axis)
    return m if m > 1 and num_kv_heads % m == 0 else 1


def shard_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (0 without a mesh or the axis)."""
    if axis_size(mesh, axis) <= 1:
        return 0
    return int(mesh.get_local_rank(axis))


def local_heads(num_heads: int, num_kv_heads: int, mesh, axis: str) -> slice:
    """The heads (of ``num_heads``, kv-major) that this rank's shard of the
    KV pool serves: all of them unless :func:`head_shards` splits the KV
    heads, else the rank's contiguous ``num_heads / shards``."""
    shards = head_shards(num_kv_heads, mesh, axis)
    if shards == 1:
        return slice(None)
    per = num_heads // shards
    i = shard_index(mesh, axis)
    return slice(i * per, (i + 1) * per)


def gather_heads(x: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    """All-gather this rank's head slice ``x`` along ``dim`` over ``axis``,
    in the axis's rank order: every rank gets the whole output. One
    ``all_gather`` on either backend (gloo takes CUDA tensors)."""
    import torch.distributed as dist
    group = mesh.get_group(axis)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def combine_partials(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                     out_dtype, mesh, axis: str) -> torch.Tensor:
    """Merge the shards' un-normalized flash states (fp32 ``acc [..., D]``,
    ``m [...]``, ``l [...]``) over ``axis``, in the reference's order:
    ``m_glob = max(m)``, ``c = exp(m - m_glob)``, ``num = sum(acc * c)``,
    ``den = sum(l * c)``, ``num / max(den, 1e-30)``. The two sums travel
    as one all-reduce of ``[acc * c | l * c]`` (elementwise the same sums).
    A shard whose keys all lie past a row's length holds ``m = -1e30``, so
    its ``c`` is 0 whatever its ``acc`` and ``l``."""
    import torch.distributed as dist
    group = mesh.get_group(axis)
    m_glob = m.clone()
    dist.all_reduce(m_glob, op=dist.ReduceOp.MAX, group=group)
    c = torch.exp(m - m_glob)
    buf = torch.cat([acc * c[..., None], (l * c)[..., None]], dim=-1)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    num, den = buf[..., :-1], buf[..., -1]
    return (num / torch.clamp(den, min=1e-30)[..., None]).to(out_dtype)


def column_shard(block_tables: torch.Tensor, mesh, axis: str):
    """The sequence partition's block-table columns of this rank: the
    tables padded with page 0 to a multiple of the axis size ``M`` (the pad
    columns lie past every row's length, so the masks drop them), and rank
    ``i``'s columns ``[i*n_loc, (i+1)*n_loc)``. Returns ``(columns,
    key offset i*n_loc)``, the offset in pages."""
    M = axis_size(mesh, axis)
    R, n = block_tables.shape
    if n % M:
        block_tables = torch.cat(
            [block_tables, block_tables.new_zeros((R, M - n % M))], dim=1)
    n_loc = block_tables.shape[1] // M
    i = shard_index(mesh, axis)
    return block_tables[:, i * n_loc:(i + 1) * n_loc].contiguous(), i * n_loc


# ---- training: groups over mesh axes ----------------------------------------------
@dataclasses.dataclass(frozen=True)
class Axis:
    """A group of this rank's mesh: the process group spanning one mesh
    axis or several (``("pod", "data")``, in that order, the first the
    slowest), its size and this rank's coordinate on it (the flattened
    coordinate, row-major over the axes)."""

    group: Any
    size: int
    index: int
    names: Tuple[str, ...]


_GROUPS: Dict[tuple, Any] = {}


def _axes_group(mesh, axes: Tuple[str, ...]):
    """The process group of this rank over ``axes`` of ``mesh``: the mesh's
    own group for one axis; for several, groups made once per mesh with
    ``new_group`` (every rank makes every coset's group, in one order, as
    ``new_group`` requires), cached by the mesh and the axes (a traced
    program, such as the dry run's under a fake tensor mode, reads the
    cache: the rank grid is a tensor, which such a mode cannot read)."""
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    import torch.distributed as dist
    key = (mesh, axes)
    if key not in _GROUPS:
        names = tuple(mesh.mesh_dim_names)
        ranks = mesh.mesh
        order = [names.index(a) for a in names if a not in axes] + \
            [names.index(a) for a in axes]
        cosets = ranks.permute(order).reshape(-1, math.prod(
            ranks.shape[names.index(a)] for a in axes))
        me = dist.get_rank()
        mine = None
        for row in cosets.tolist():
            if row != sorted(row):
                raise ValueError(f"mesh ranks {row} over {axes} are not "
                                 f"in the axes' row-major order")
            g = dist.new_group(row)
            if me in row:
                mine = g
        _GROUPS[key] = mine
    return _GROUPS[key]


def mesh_axis(mesh, axes) -> Optional[Axis]:
    """The :class:`Axis` of ``axes`` (a name or a tuple of names; names the
    mesh lacks count as size 1) on ``mesh``, or None when its size is 1 or
    there is no mesh: there is then nothing to communicate."""
    if mesh is None:
        return None
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    axes = tuple(a for a in axes if sizes.get(a, 1) > 1)
    if not axes:
        return None
    index = 0
    for a in axes:
        index = index * sizes[a] + int(mesh.get_local_rank(a))
    return Axis(_axes_group(mesh, axes), math.prod(sizes[a] for a in axes),
                index, axes)


def all_reduce(x: torch.Tensor, ax: Axis, op=None) -> torch.Tensor:
    """The elementwise sum (or ``op``) over ``ax`` of ``x``, a new tensor;
    not differentiable."""
    import torch.distributed as dist
    x = x.contiguous().clone()
    dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=ax.group)
    return x


def all_gather(x: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in the axis's order;
    not differentiable."""
    import torch.distributed as dist
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(ax.size)]
    dist.all_gather(parts, x, group=ax.group)
    return torch.cat(parts, dim=dim)


def own_slice(x: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (equal blocks)."""
    n = x.shape[dim] // ax.size
    return x.narrow(dim, ax.index * n, n)


def reduce_scatter(x: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    """The sum over ``ax`` of ``x``, this rank's block along ``dim``."""
    import torch.distributed as dist
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // ax.size, *xt.shape[1:]))
    dist.reduce_scatter_tensor(out, xt, group=ax.group)
    return out.movedim(0, dim).contiguous()


def _all_to_all(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """Block ``j`` of dim 0 to rank ``j``; block ``j`` of the result from
    rank ``j``."""
    import torch.distributed as dist
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=ax.group)
    return out


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.ax), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return all_gather(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        return own_slice(g, ctx.dim, ctx.ax).contiguous(), None, None


class _GatherToOwn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return all_gather(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.ax), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return own_slice(x, dim, ax).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.ax), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _all_to_all(x, ax)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.ax), None


def reduce_from(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """Sum over ``ax`` forward, identity backward (``x`` without an axis)."""
    return x if ax is None else _ReduceFrom.apply(x, ax)


def copy_to(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """Identity forward, sum over ``ax`` backward."""
    return x if ax is None else _CopyTo.apply(x, ax)


def gather_from(x: torch.Tensor, dim: int, ax: Optional[Axis]
                ) -> torch.Tensor:
    """All-gather along ``dim`` forward, this rank's block backward."""
    return x if ax is None else _GatherFrom.apply(x, dim, ax)


def gather_to_own(x: torch.Tensor, dim: int, ax: Optional[Axis]
                  ) -> torch.Tensor:
    """All-gather along ``dim`` forward, reduce-scatter backward: for a
    gathered tensor of which each rank uses its own part."""
    return x if ax is None else _GatherToOwn.apply(x, dim, ax)


def scatter_to(x: torch.Tensor, dim: int, ax: Optional[Axis]
               ) -> torch.Tensor:
    """This rank's block along ``dim`` forward, all-gather backward."""
    return x if ax is None else _ScatterTo.apply(x, dim, ax)


def all_to_all(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """Block ``j`` of dim 0 to rank ``j`` (its own backward)."""
    return x if ax is None else _AllToAll.apply(x, ax)


def max_over(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """The elementwise maximum over ``ax``, outside the autograd graph."""
    import torch.distributed as dist
    return x.detach() if ax is None else all_reduce(x.detach(), ax,
                                                    dist.ReduceOp.MAX)
