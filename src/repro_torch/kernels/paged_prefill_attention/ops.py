"""Dispatch of the paged-prefill kernel, as the model calls it (port of the
reference ``paged_prefill_attention/ops.py``), over the fused pool
``[Hkv, P, 2, ps, D]``.

``mesh=None`` or a 1-wide ``axis`` is the single-device call: the CUDA
kernel for tensors on the GPU, its plain PyTorch version for tensors on the
CPU. On a mesh each rank runs its shard's body with the collectives of
``shard_utils``, as the decode op does:

* **head-sharded**: ``q [R, Sq, Hkv, G, D]`` is sliced on ``Hkv`` in
  lockstep with the rank's head slice of the pool, the kernel runs
  unmodified, and the output is all-gathered on that dim (bit-identical).
* **sequence-sharded**: replicated pool; rank ``i`` attends over its
  block-table columns with ``partial=True`` at ``row_pos - off`` and
  ``lengths - off`` (``off = i * n_loc * ps``: every mask term depends only
  on position differences), and the flash combine merges the shards.
"""
from __future__ import annotations

from repro_torch.kernels import shard_utils as su
from repro_torch.kernels.paged_prefill_attention.kernel import (
    paged_prefill_attention_fused)


def paged_prefill_attention_auto(q, kv_pages, block_tables, row_pos,
                                 lengths, *, scale, window=0, softcap=0.0,
                                 mesh=None, axis="model"):
    """Mesh-aware dispatch of one ragged prefill attention (see the module
    docstring). q is whole on every rank and names the pool's KV head
    count (its dim 2); on a mesh ``kv_pages`` is this rank's shard."""
    M = su.axis_size(mesh, axis)
    if M <= 1:
        return paged_prefill_attention_fused(q, kv_pages, block_tables,
                                             row_pos, lengths, scale=scale,
                                             window=window, softcap=softcap)
    kv_heads = q.shape[2]
    shards = su.head_shards(kv_heads, mesh, axis)
    if kv_pages.shape[0] * shards != kv_heads:
        raise ValueError(f"kv_pages holds {kv_pages.shape[0]} KV heads; "
                         f"the rule places {kv_heads // shards} of "
                         f"{kv_heads} on each of {shards} shards")
    if shards > 1:
        heads = su.local_heads(kv_heads, kv_heads, mesh, axis)
        out = paged_prefill_attention_fused(
            q[:, :, heads].contiguous(), kv_pages, block_tables, row_pos,
            lengths, scale=scale, window=window, softcap=softcap)
        return su.gather_heads(out, 2, mesh, axis)
    cols, off = su.column_shard(block_tables, mesh, axis)
    off = off * kv_pages.shape[3]
    acc, m, l = paged_prefill_attention_fused(
        q, kv_pages, cols, row_pos - off, lengths - off, scale=scale,
        window=window, softcap=softcap, partial=True)
    return su.combine_partials(acc, m, l, q.dtype, mesh, axis)
