"""Build and load the port's hand-written CUDA kernels.

Every ``src/repro_torch/csrc/*.cu`` is compiled for Hopper
(``sm_90a``) by ``nvcc``, one process per source, all started together, and
linked into one shared library with a plain C interface that is loaded with
``ctypes``.  The library lands in ``build/repro_torch/<hash>/`` at the root
of the checkout, keyed by a hash of the sources, so an edited kernel is
rebuilt and an unchanged one is loaded as it is; each source's compiler
output (ptxas's registers and spills a kernel) is kept there as
``<stem>.nvcc.log``.  Nothing is built when a module is imported:
:func:`library` builds at the first launch.

Each C entry point takes its pointers and the CUDA stream as ``void*``,
launches on that stream, and returns ``cudaGetLastError()``;
:func:`check` turns a nonzero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# C entry point -> argtypes (every one returns an int cudaError_t)
_SIGNATURES = {
    "rt_hash_probe": [_P, _I, _P, _I, _P, _P, _P],
    "rt_hash_probe_floor": [_P, _I, _P, _I, _I, _P, _P],
    "rt_masked_compact": [_P, _P, _I, _L, _I, _P, _P, _P, _I, _P],
    "rt_probe_place": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "rt_frontier_expand": [_I, _P, _I, _L, _P, _P, _L, _P, _P, _P],
    "rt_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float,
                           _I, _I, _I, _I, _I, _P],
    "rt_ssd_scan": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "rt_paged_stage_tables": [_P, _P, _L, _P],
    "rt_paged_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           ctypes.c_float, _I, _P],
}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = Path("/usr/local/cuda/bin/nvcc")
    if cuda.exists():
        return str(cuda)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    srcs = sorted(_CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {_CSRC}")
    return srcs


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for p in srcs + sorted(_CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path, srcs) -> None:
    """One ``nvcc -c`` per source, all in parallel, then one link."""
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(dir=out.parent))
    try:
        procs = []
        for src in srcs:
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *_NVCC_FLAGS, "-I", str(_CSRC), "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        errors = []
        for src, _, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src.name}:\n{log}")
            # ptxas's report (registers, spills) of each kernel, kept beside the library
            (out.parent / f"{src.stem}.nvcc.log").write_text(log)
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        so = tmp / out.name
        link = [nvcc, *_NVCC_FLAGS, "-shared", *(str(o) for _, o, _ in procs), "-o", str(so)]
        res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + res.stdout)
        os.replace(so, out)  # atomic: concurrent builders see all or nothing
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from the checkout's sources on first
    use."""
    global _lib
    if _lib is not None:
        return _lib
    srcs = _sources()
    out_dir = _BUILD_ROOT / _digest(srcs)
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "librepro_torch_kernels.so"
    if not so.exists():
        _compile(so, srcs)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(code: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code}")


def stream_ptr(tensor) -> int:
    """The raw handle of the current CUDA stream on ``tensor``'s device."""
    return torch.cuda.current_stream(tensor.device).cuda_stream


def require_cuda(name: str, *tensors) -> None:
    """Kernel wrappers take contiguous CUDA tensors on one device only."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: kernel needs CUDA tensors, got {t.device}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
