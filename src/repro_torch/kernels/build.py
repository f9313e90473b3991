"""Build and load the CUDA kernels of ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled at first use by ``nvcc`` for ``sm_90a``
into ``build/kernels/lib<name>-<hash>.so`` under the repository root (the
hash covers the sources and flags, so an edited source rebuilds) and loaded
with ``ctypes``. The sources expose plain C functions: no PyTorch headers,
which keeps a build at seconds rather than minutes. A failed build raises;
nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("paged_attention", "paged_prefill_attention",
           "chunked_prefill_attention", "mlstm_chunkwise", "mamba_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# Argument types of each library's launch functions, in the order of the C
# signatures in csrc/. Pointers and the stream are c_void_p: ctypes would
# otherwise pass a Python int as a 32-bit int.
SIGNATURES = {
    "paged_attention": {
        "paged_attention_fused_launch": [
            _P, _P, _P, _P,              # q, kv_pages, block_tables, lengths
            _P, _P, _P,                  # out, m_out, l_out
            _P, _P,                      # split scratch, tickets (or null)
            _I, _I, _I, _I, _I, _I, _I,  # B, Hkv, G, D, P, ps, n
            _F, _I, _F,                  # scale, window, softcap
            _I, _I, _I, _P],             # partial, n_split, is_bf16, stream
        "paged_attention_mma_attributes": [
            _I, _I, _P],                 # D, Dv, info[6]
        "paged_attention_split_launch": [
            _P, _P, _P, _P, _P,          # q, k_pages, v_pages, bt, lengths
            _P,                          # out
            _P, _P,                      # split scratch, tickets (or null)
            _I, _I, _I, _I, _I, _I, _I,  # B, Hkv, G, D, P, ps, n
            _F, _I, _F,                  # scale, window, softcap
            _I, _I, _P]},                # n_split, is_bf16, stream
    "paged_prefill_attention": {
        "paged_prefill_attention_fused_launch": [
            _P, _P, _P, _P, _P,          # q, kv_pages, bt, row_pos, lengths
            _P, _P, _P,                  # out, m_out, l_out
            _P, _P,                      # split scratch, tickets (or null)
            _I, _I, _I, _I, _I, _I, _I, _I,  # R, Sq, Hkv, G, D, P, ps, n
            _F, _I, _F,                  # scale, window, softcap
            _I, _I, _I, _P],             # partial, n_split, is_bf16, stream
        "paged_prefill_attention_mma_attributes": [
            _I, _I, _P],                 # D, Dv, info[6]
        "paged_prefill_attention_split_launch": [
            _P, _P, _P, _P, _P, _P,      # q, k_pages, v_pages, bt, row_pos,
                                         # lengths
            _P,                          # out
            _P, _P,                      # split scratch, tickets (or null)
            _I, _I, _I, _I, _I, _I, _I, _I,  # R, Sq, Hkv, G, D, P, ps, n
            _F, _I, _F,                  # scale, window, softcap
            _I, _I, _P]},                # n_split, is_bf16, stream
    "chunked_prefill_attention": {
        "chunked_prefill_attention_launch": [
            _P, _P, _P, _P, _P,          # q, k, v, lengths, out
            _P, _P, _P,                  # split scratch: acc, m, l (or null)
            _L, _L, _L, _L, _L, _L,      # q, k strides (batch, head, position)
            _L, _L, _L, _L, _L, _L,      # v, out strides
            _I, _I, _I, _I, _I, _I, _I,  # B, Sq, Sk, Hkv, G, D, Dv
            _I, _I, _I, _F, _F,          # q_offset, causal, window, scale,
                                         # softcap
            _I, _I, _P],                 # n_split, is_bf16, stream
        "chunked_prefill_attention_mma_plan": [
            _I, _I, _I, _I, _I,          # Sq, Sk, G, D, Dv
            _I, _I, _I, _P],             # q_offset, causal, window, info[2]
        "chunked_prefill_attention_mma_attributes": [
            _I, _I, _P]},                # D, Dv, info[6]
    "mlstm_chunkwise": {
        "mlstm_chunkwise_launch": [
            _P, _P, _P, _P, _P,          # q, k, v, log_i, log_f
            _L, _L, _L, _L, _L, _L,      # q, k strides (batch, token, head)
            _L, _L, _L,                  # v strides
            _L, _L, _L, _L, _L, _L,      # log_i, log_f strides
            _P, _P, _P, _P,              # C (in place), n, m, rows (or null)
            _L, _L, _L,                  # C, n, m batch strides
            _P, _P, _P,                  # h, n_out, m_out
            _P, _P, _P,                  # scratch: gates, C planes, n (or null)
            _I, _I, _I, _I,              # B, S, H, D
            _I, _P],                     # is_bf16, stream
        "mlstm_chunkwise_plan": [_I, _I, _I, _P],    # S, D, is_bf16, info[4]
        "mlstm_chunkwise_pass_attributes": [
            _I, _I, _I, _P]},            # S, D, pass, info[6]
    "mamba_scan": {"mamba_scan_launch": [
        _P, _L, _L,                  # x and its strides (batch, token)
        _P, _L, _L,                  # dt
        _P, _L, _L,                  # Bc
        _P, _L, _L,                  # Cc
        _P, _P,                      # A, D
        _P, _L, _P,                  # h (in place), its batch stride, rows
        _P,                          # y
        _I, _I, _I, _I,              # B, S, d, n
        _I, _P],                     # is_bf16, stream
        "mamba_scan_attributes": [_I, _P]},   # kernel, info[8]
}

_loaded: Dict[str, ctypes.CDLL] = {}


NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"   # where nvcc is, off the PATH


def nvcc() -> str:
    path = shutil.which("nvcc") or NVCC_DEFAULT
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's nvcc (PATH or /usr/local/cuda)")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Tuple[float, str]]:
    """Compile every library of ``names`` that is not built yet, all nvcc
    processes at once. Returns ``{name: (seconds, ptxas report)}`` for the
    ones compiled here; raises RuntimeError if any build fails."""
    todo = {n: _target(n) for n in names if not _target(n).exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    report = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built first if needed), with the
    argument and return types of its launch functions declared."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        for fn_name, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


MMA_ATTRIBUTES = ("registers", "spill_bytes", "smem_bytes", "blocks_per_sm",
                  "rows", "key_tile")
INVALID_VALUE = 1            # cudaErrorInvalidValue


@functools.lru_cache(maxsize=None)
def mma_attributes(name: str, D: int, Dv: Optional[int] = None
                   ) -> Dict[str, int]:
    """Registers, spill bytes, dynamic shared memory, resident blocks per
    SM, query rows a block and keys a tile of library ``name``'s bf16
    tensor-core kernel at key width ``D`` and value width ``Dv`` (``D``
    when None), as the library and the CUDA runtime report them (needs a
    card). The instantiated pairs and the block's shape are the library's
    own (``mma_launch`` in its source, ``wg::Geometry`` in
    ``csrc/attend_wgmma.cuh``): nothing in Python repeats them. Raises
    ValueError for a pair that has no tensor-core kernel."""
    Dv = D if Dv is None else Dv
    info = (ctypes.c_int * len(MMA_ATTRIBUTES))()
    code = getattr(library(name), f"{name}_mma_attributes")(D, Dv, info)
    if code == INVALID_VALUE:
        raise ValueError(f"{name}: no bf16 tensor-core kernel at head_dim "
                         f"{D}, value width {Dv}")
    check(name, code)
    return dict(zip(MMA_ATTRIBUTES, info))


def check_mma_geometry(name: str, G: int, D: int,
                       Dv: Optional[int] = None) -> None:
    """Raise ValueError for a bf16 launch of library ``name`` that its
    tensor-core kernel does not take: a (head dim, value width) pair it is
    not instantiated for (``Dv`` is ``D`` when None), or more query heads
    per kv head than a block has rows."""
    rows = mma_attributes(name, D, Dv)["rows"]
    if G > rows:
        raise ValueError(f"{name}: bf16 takes at most {rows} query heads per "
                         f"kv head at head_dim {D}, got {G}")


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (the split plans' input)."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def check(name: str, code: int) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if code != 0:
        msg = getattr(library(name), f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} "
                           f"({msg})")
