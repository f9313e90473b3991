"""The backward of the kernels on the training path (#5, #6, #7): each
kernel's ``autograd.Function`` (in its ``ops.py``) launches the kernel in
its forward and, in its backward, differentiates the kernel's plain version
(``ref.py``) recomputed from the saved inputs. The reference has no
backward kernel to port (JAX differentiates the XLA code it trains
through); hand-written backward kernels are later work."""
from __future__ import annotations

import torch


def grads_of_plain(fn, inputs, needs, grad_out):
    """Gradients of ``fn(*inputs)`` (a plain version, recomputed under
    autograd) against ``grad_out`` for the inputs whose ``needs`` is set;
    None for the others."""
    inputs = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
    with torch.enable_grad():
        out = fn(*inputs)
    wanted = [t for t in inputs if t.requires_grad]
    grads = iter(torch.autograd.grad(out, wanted, grad_out))
    return [next(grads) if t.requires_grad else None for t in inputs]
