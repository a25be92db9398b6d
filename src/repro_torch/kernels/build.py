"""Build and load the hand-written Hopper kernels (CUDA C++, ``sm_90a``).

Each source under ``csrc/`` is compiled by ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  All missing libraries are built
together, one ``nvcc`` process per source, at first use.  Libraries are
named by a hash of the sources and flags, so an edited source is rebuilt,
and land in ``build/repro_torch_kernels/`` at the root of the checkout.

No library links against the CUDA driver: K3's tensor-core kernel gets
``cuTensorMapEncodeTiled`` (its TMA descriptors) from the already loaded
``libcuda.so.1`` with ``dlsym`` at its first launch.

Nothing here runs at import time: the CPU tests import every module of the
package on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

#: kernel library name -> its translation unit (headers are shared).
SOURCES = {"kernel_matrix": "kernel_matrix.cu", "solver": "solver.cu",
           "flash_attention": "flash_attention.cu", "ssd": "ssd.cu",
           "flash_attention_bwd": "flash_attention_bwd.cu",
           "ssd_bwd": "ssd_bwd.cu"}
HEADERS = ("tiles.cuh", "budget.cuh", "hopper.cuh")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
#: nvcc's messages per library (ptxas register / shared-memory report).
BUILD_LOG: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name],) + HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every library that is not built yet, all in parallel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: _lib_path(n) for n in SOURCES if not _lib_path(n).exists()}
    procs = {}
    for name, out in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            Path(tmp).unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: concurrent builds race safely
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {n: _lib_path(n) for n in SOURCES}


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built (with the others) on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            paths = build_all()
            for n, p in paths.items():
                if n not in _LIBS:
                    _LIBS[n] = _declare(n, ctypes.CDLL(str(p)))
        return _LIBS[name]


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: C signatures: every pointer and the stream as c_void_p (64-bit).  Each
#: entry: the library's prefix, its launch function and that function's
#: argument types, and the argument count of its plan query before the two
#: output pointers (``csrc/budget.cuh``).
_SIGNATURES = {
    "kernel_matrix": ("k1", "k1_kernel_matrix",
                      [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _P], 5),
    "solver": ("k2", "k2_solve_lanes",
               [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                _F, _F, _F, _P], 6),
    "flash_attention": ("k3", "k3_flash_attention",
                        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, _P], 7),
    "ssd": ("k4", "k4_ssd_scan",
            [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
             _P], 8),
    "flash_attention_bwd": ("k3b", "k3b_flash_attention_bwd",
                            [_P] * 10 + [_I] * 11 + [_P], 7),
    "ssd_bwd": ("k4b", "k4b_ssd_scan_bwd", [_P] * 16 + [_I] * 9 + [_P], 8),
}


#: Further C functions of a library: (symbol, argument types, result).
_EXTRAS = {
    "flash_attention_bwd": (("k3b_scratch_floats", [_I] * 7,
                             ctypes.c_int64),),
}


def _declare(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    prefix, fn_name, argtypes, n_plan_args = _SIGNATURES[name]
    int_p = ctypes.POINTER(_I)
    for sym, args, res in (
            *_EXTRAS.get(name, ()),
            (fn_name, argtypes, _I),
            (f"{prefix}_error_string", [_I], ctypes.c_char_p),
            (f"{prefix}_plan", [_I] * n_plan_args + [int_p, int_p], _I),
            (f"{prefix}_instances", [], _I),
            (f"{prefix}_instance_name", [_I], ctypes.c_char_p),
            (f"{prefix}_attributes", [_I, _I, _I, int_p], _I)):
        fn = getattr(lib, sym)
        fn.argtypes = args
        fn.restype = res
    return lib


def c_prefix(name: str) -> str:
    """The C prefix of library ``name`` (``k1`` .. ``k4``, ``k3b``,
    ``k4b``)."""
    return _SIGNATURES[name][0]


def check(lib: ctypes.CDLL, prefix: str, rc: int) -> None:
    """Raise if a launch returned a CUDA error code (refused launches never
    run, and a later synchronize would not report them)."""
    if rc != 0:
        msg = getattr(lib, f"{prefix}_error_string")(rc).decode()
        raise RuntimeError(f"{prefix} launch failed: CUDA error {rc} ({msg})")


def check_tensor(t: torch.Tensor, name: str, shape: tuple,
                 dtype: torch.dtype = torch.float32) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``shape`` and
    ``dtype``: what every kernel's C interface assumes of its pointers."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.shape != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(fn, device: torch.device, *args) -> int:
    """Call the C launcher ``fn(*args, stream)`` with ``device``'s current
    stream, as the current device.  The device is switched only when it is
    not the current one already, and the stream is read as a raw handle
    (PyTorch's own launch path), so the common call costs a few attribute
    reads."""
    idx = device.index
    if idx == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    with torch.cuda.device(idx):
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))
