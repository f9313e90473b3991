"""Mesh helpers of the sharded kernel dispatch: the ONE partition rule for
paged KV, and the collectives of the two partitions.

Port of the reference ``kernels/shard_utils.py``. The reference writes each
sharded op as a per-shard function under ``shard_map``, and its shim here
covers two JAX versions of it. PyTorch has no counterpart: a rank runs its
shard's body itself, on plain tensors (its shard of the KV pool, as
``launch/sharding.paged_cache_specs`` places it), and calls the collectives
over the mesh axis's process group explicitly. The bodies' collectives
live here, so both attention ops (``paged_attention/ops.py``,
``paged_prefill_attention/ops.py``) share them:

* :func:`gather_heads` -- the head partition's re-replication of the
  attention output (pure data movement: bit-identical to one device);
* :func:`combine_partials` -- the sequence partition's flash-decode
  combine: the global maximum of the row maxima, then the sums of the
  rescaled value partials and normalizers, and one division.

A mesh is a ``torch.distributed`` ``DeviceMesh`` (``launch/mesh.py``);
the rule functions also take a ``MeshShape`` (sizes, no ranks), which
has the two attributes read here.
"""
from __future__ import annotations

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
