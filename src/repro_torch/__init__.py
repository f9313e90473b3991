"""PyTorch/CUDA port of the SlidingServe serving system.

The JAX package ``repro`` is the reference; this package keeps its
subpackage layout (``repro_torch/models/model.py`` is the counterpart of
``repro/models/model.py``, and so on) and imports nothing from it. The
scheduler (``core``) and the host-side serving modules are verbatim copies
of the reference (``tests/test_torch_isolation.py`` guards against drift);
the model, the paged engine and the two paged-attention kernels are ports,
the kernels hand-written in CUDA C++ for Hopper (``csrc/``).

Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""
