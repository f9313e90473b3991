"""The backward of the kernels on the training path (#5, #6, #7): each
kernel's ``autograd.Function`` (in its ``ops.py``) launches the kernel in
its forward and, in its backward, differentiates the kernel's plain version
(``ref.py``) recomputed from the saved inputs. The reference has no
backward kernel to port (JAX differentiates the XLA code it trains
through); hand-written backward kernels are later work.

On tensors that hold no data (a traced program: the dry run) the backward
recomputes nothing: it returns empty gradients and counts twice the
kernel's forward work (``kernels/cost.py``), the work of a backward
kernel, as the forward counts the kernel's."""
from __future__ import annotations

import torch

from repro_torch.kernels import cost as C


def grads_of_plain(fn, inputs, needs, grad_out, kernel=None, work=None):
    """Gradients of ``fn(*inputs)`` (a plain version, recomputed under
    autograd) against ``grad_out`` for the inputs whose ``needs`` is set;
    None for the others. On tensors that hold no data: empty gradients,
    and ``work`` (the kernel's forward ``Work``) counted twice for
    ``kernel``."""
    if C.is_fake(grad_out):
        C.record(kernel + " backward", C.Work(
            2 * work.flops, 2 * work.bytes, work.dtype))
        return [torch.empty_like(t) if n else None
                for t, n in zip(inputs, needs)]
    inputs = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
    with torch.enable_grad():
        out = fn(*inputs)
    wanted = [t for t in inputs if t.requires_grad]
    grads = iter(torch.autograd.grad(out, wanted, grad_out))
    return [next(grads) if t.requires_grad else None for t in inputs]
