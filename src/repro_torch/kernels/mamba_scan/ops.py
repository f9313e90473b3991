"""Dispatch of the Mamba selective-scan kernel, as the model calls it (port
of the reference ``mamba_scan/ops.py``, with the carried state; PyTorch
runs eagerly, so there is no jit and no static-argument list)."""
from __future__ import annotations

from repro_torch.kernels.mamba_scan.kernel import mamba_scan


def mamba_scan_op(x, dt, Bc, Cc, A, D, h, *, rows=None):
    """The CUDA kernel for tensors on the GPU, its plain PyTorch version for
    tensors on the CPU. The chunk length is a runtime integer."""
    return mamba_scan(x, dt, Bc, Cc, A, D, h, rows=rows)
