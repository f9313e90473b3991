"""Dispatch of the Mamba selective-scan kernel, as the model calls it (port
of the reference ``mamba_scan/ops.py``, with the carried state; PyTorch
runs eagerly, so there is no jit and no static-argument list), and its
gradient from a fresh state.

Training runs the scan from a zero state through ``MambaScanFresh``: its
forward allocates that state itself and launches the wrapper on it (the
CUDA kernel for a CUDA tensor, the plain version for a CPU tensor), so the
kernel's in-place state write never touches a tensor that autograd saved;
its backward recomputes the plain version (``ref.py``) from the saved
inputs under autograd and returns their gradients. That backward is the
only place the plain version runs when a card is present. It runs there
because the reference has no backward kernel to port: JAX differentiates
the ``lax.scan`` the reference trains through. A hand-written backward
kernel (a reverse scan) is later work. The Function is used only when
grad mode is on and an input requires grad; serving calls the wrapper
directly."""
from __future__ import annotations

import torch

from repro_torch.kernels.autograd import grads_of_plain
from repro_torch.kernels.mamba_scan.kernel import cost, mamba_scan
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref


def mamba_scan_op(x, dt, Bc, Cc, A, D, h, *, rows=None):
    """The CUDA kernel for tensors on the GPU, its plain PyTorch version for
    tensors on the CPU. The chunk length is a runtime integer."""
    return mamba_scan(x, dt, Bc, Cc, A, D, h, rows=rows)


def _zero_state(x, A):
    return torch.zeros((x.shape[0], *A.shape), dtype=torch.float32,
                       device=x.device)


class MambaScanFresh(torch.autograd.Function):
    """#6 from a zero state with a gradient: the kernel forward, the plain
    backward. Returns (y, the final state h), h outside the graph."""

    @staticmethod
    def forward(ctx, x, dt, Bc, Cc, A, D):
        ctx.save_for_backward(x, dt, Bc, Cc, A, D)
        h = _zero_state(x, A)
        y = mamba_scan(x, dt, Bc, Cc, A, D, h)
        ctx.mark_non_differentiable(h)
        return y, h

    @staticmethod
    def backward(ctx, grad_y, _grad_h):
        saved = ctx.saved_tensors          # unpacked once (checkpoints)
        x, A = saved[0], saved[4]
        return tuple(grads_of_plain(
            lambda *a: mamba_scan_ref(*a, _zero_state(x, A)),
            saved, ctx.needs_input_grad, grad_y, "mamba_scan",
            cost(*x.shape, A.shape[1], x.dtype)))


def mamba_scan_fresh_op(x, dt, Bc, Cc, A, D):
    """The scan from a zero state; returns (y, the final state h).
    Differentiable (through ``MambaScanFresh``) when grad mode is on and an
    input requires grad."""
    ins = (x, dt, Bc, Cc, A, D)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        return MambaScanFresh.apply(*ins)
    h = _zero_state(x, A)
    return mamba_scan(*ins, h), h
