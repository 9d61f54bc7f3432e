"""Build and bind the port's CUDA kernels: ``nvcc`` by hand into one shared
library per source, with a plain C interface loaded through ``ctypes``.

Each ``kernels/csrc/<name>.cu`` compiles for ``sm_90a`` into
``build/repro_torch_kernels/lib<name>-<hash>.so`` at the repository root,
at first use. The hash covers the source, the shared header and the flags,
so a stale library is never loaded. ``build()`` starts one ``nvcc`` per
source, all at once. Every C entry point returns ``cudaGetLastError()``;
``check`` raises when it is not 0, since a refused launch never runs and
``torch.cuda.synchronize()`` would not report it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Sequence

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("colstats", "fw_grad", "residual_update", "fused_step", "sparse_grad",
           "sparse_colstats", "step_tail")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_libraries: Dict[str, ctypes.CDLL] = {}
_functions: Dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed"
        )
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES, ptxas_verbose: bool = False) -> Dict[str, str]:
    """Compile every named source whose library is missing, one ``nvcc``
    process each, all started together. Returns the compiler output by
    name (``ptxas_verbose`` adds each kernel's registers and spills)."""
    jobs = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        if ptxas_verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((name, out, tmp, proc))
    logs, failed = {}, []
    for name, out, tmp, proc in jobs:
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)  # atomic: a concurrent build loads a whole file
        else:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{logs[name]}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def function(lib_name: str, fn_name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point ``fn_name`` of ``lib<lib_name>``, built on first
    use, with its argument types declared (pointers and the stream as
    ``c_void_p``, or ctypes would pass them as 32-bit ints)."""
    fn = _functions.get(fn_name)
    if fn is not None:
        return fn
    lib = _libraries.get(lib_name)
    if lib is None:
        out = _target(lib_name)
        if not out.exists():
            build((lib_name,))
        lib = _libraries[lib_name] = ctypes.CDLL(str(out))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
    fn = _functions[fn_name] = getattr(lib, fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(lib_name: str, err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if err != 0:
        msg = _libraries[lib_name].repro_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def f32(x: float) -> float:
    """A constant as the f32 that torch's f32 ops compute with (a kernel's
    float argument)."""
    return float(np.float32(x))


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(
            f"the CUDA kernels take float32 or bfloat16, got {t.dtype}"
        ) from None


def require_cuda(*tensors: torch.Tensor) -> torch.device:
    """The common CUDA device of ``tensors``, all contiguous; raises otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(
                f"kernel operands must share one CUDA device, got {t.device} "
                f"and {dev}"
            )
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    return dev


_no_lanes: Dict[int, torch.Tensor] = {}  # device index -> a 1-entry int32 buffer


def lane_ids_arg(lanes: torch.Tensor):
    """``(pointer, count)`` of the lane ids a lane kernel takes. No lane (every
    lane frozen) still passes a valid pointer, with count 0: a null pointer
    means a one-lane launch to the C entry points."""
    if lanes.numel():
        return lanes.data_ptr(), lanes.numel()
    buf = _no_lanes.get(lanes.device.index)
    if buf is None:
        buf = _no_lanes[lanes.device.index] = torch.zeros(1, dtype=torch.int32,
                                                          device=lanes.device)
    return buf.data_ptr(), 0


def stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream
