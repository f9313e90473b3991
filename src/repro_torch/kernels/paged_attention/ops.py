"""Dispatch of the paged-attention decode kernel, as the model calls it
(port of the reference ``paged_attention/ops.py``), over the fused pool
``[Hkv, P, 2, ps, D]``.

``mesh=None`` or a 1-wide ``axis`` is the single-device call: the CUDA
kernel for tensors on the GPU, its plain PyTorch version for tensors on the
CPU. On a mesh each rank runs its shard's part of the reference's
``shard_map`` body itself, with the collectives of ``shard_utils``:

* **head-sharded** (the KV head count divides the axis): ``kv_pages`` is
  the rank's head slice of the pool, and the rank runs the unmodified
  kernel on its query heads (kv-major, so an equal contiguous split keeps
  every query head with its KV head), then all-gathers the ``[B, H, D]``
  output: pure data movement, the single-device result bit for bit.
* **sequence-sharded** (the heads do not divide): the pool is replicated.
  Rank ``i`` attends over its columns of the block tables (padded with
  page 0 to a multiple of the axis) with the kernel's ``partial=True``
  mode at shard-local lengths ``len - i * n_loc * ps`` (both masks depend
  only on ``length - k_pos``), and the flash-decode combine merges the
  shards' ``(acc, m, l)``.
"""
from __future__ import annotations

from repro_torch.kernels import shard_utils as su
from repro_torch.kernels.paged_attention.kernel import paged_attention_fused


def paged_attention_auto(q, kv_pages, block_tables, lengths, *, scale,
                         window=0, softcap=0.0, mesh=None, axis="model",
                         kv_heads=None):
    """Mesh-aware dispatch of one decode attention (see the module
    docstring). q [B, H, D] is whole on every rank. On a mesh,
    ``kv_pages`` is this rank's shard of the pool and ``kv_heads`` the
    whole pool's KV head count (a rank cannot tell a head slice from a
    replicated pool by its shape)."""
    M = su.axis_size(mesh, axis)
    if M <= 1:
        return paged_attention_fused(q, kv_pages, block_tables, lengths,
                                     scale=scale, window=window,
                                     softcap=softcap)
    if kv_heads is None:
        raise ValueError("paged_attention_auto on a mesh needs kv_heads, "
                         "the whole pool's KV head count")
    shards = su.head_shards(kv_heads, mesh, axis)
    if kv_pages.shape[0] * shards != kv_heads:
        raise ValueError(f"kv_pages holds {kv_pages.shape[0]} KV heads; "
                         f"the rule places {kv_heads // shards} of "
                         f"{kv_heads} on each of {shards} shards")
    if shards > 1:
        heads = su.local_heads(q.shape[1], kv_heads, mesh, axis)
        out = paged_attention_fused(q[:, heads].contiguous(), kv_pages,
                                    block_tables, lengths, scale=scale,
                                    window=window, softcap=softcap)
        return su.gather_heads(out, 1, mesh, axis)
    cols, off = su.column_shard(block_tables, mesh, axis)
    ps = kv_pages.shape[3]
    acc, m, l = paged_attention_fused(q, kv_pages, cols, lengths - off * ps,
                                      scale=scale, window=window,
                                      softcap=softcap, partial=True)
    return su.combine_partials(acc, m, l, q.dtype, mesh, axis)
