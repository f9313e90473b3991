"""Dispatch of the mLSTM chunkwise kernel, as the model calls it (port of
the reference ``mlstm_chunkwise/ops.py``, with the carried state; PyTorch
runs eagerly, so there is no jit and no static-argument list)."""
from __future__ import annotations

from repro_torch.kernels.mlstm_chunkwise.kernel import mlstm_chunkwise


def mlstm_chunkwise_op(q, k, v, log_i, log_f, C, n, m, *, rows=None):
    """The CUDA kernel for tensors on the GPU, its plain PyTorch version for
    tensors on the CPU. The chunk length is a runtime integer."""
    return mlstm_chunkwise(q, k, v, log_i, log_f, C, n, m, rows=rows)
