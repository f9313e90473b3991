"""Hand-written CUDA kernels for the serving hot path, each with a wrapper
(``kernel.py``), its plain PyTorch version (``ref.py``) and the dispatch the
model calls (``ops.py``; for the three kernels training runs through, also
an ``autograd.Function``: the kernel forward, the plain version's gradient,
``autograd.py``):

- ``paged_attention`` — decode GQA attention over the fused paged KV pool
  ``[Hkv, P, 2, ps, D]`` through block tables, or over split K and V pools
  ``[Hkv, P, ps, D]`` (``csrc/paged_attention.cu``).
- ``paged_prefill_attention`` — ragged chunked prefill over the same pools,
  with per-(row, q tile) page-range pruning
  (``csrc/paged_prefill_attention.cu``).
- ``chunked_prefill_attention`` — a query chunk at a cache offset over
  contiguous K/V rows read in place through their strides (the slot
  engine's chunk attention, ``csrc/chunked_prefill_attention.cu``).
- ``mlstm_chunkwise`` — the xLSTM mLSTM recurrence over a chunk of any
  length from the carried state ``(C, n, m)``, which it reads and writes
  (every mLSTM call of the slot engine, ``csrc/mlstm_chunkwise.cu``).
- ``mamba_scan`` — the Mamba-1 selective scan over a chunk of any length
  from the carried state ``h``, which it reads and writes (every Mamba call
  of the slot engine, ``csrc/mamba_scan.cu``).
- ``ref_common`` — the plain math both paged ``ref.py`` wrap.
- ``build`` — nvcc build and ctypes loading of ``csrc/``.
"""
