"""Build, load and bind the package's CUDA kernels (``csrc/*.cu``, which
share ``csrc/*.cuh`` headers).

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, loaded with ``ctypes``. The build happens
at first use, into ``_build/`` inside the package (listed in ``.gitignore``),
keyed by a hash of every file under ``csrc/`` and the flags, so a fresh
checkout builds itself and an unchanged one reuses its library. Nothing here runs at import time:
the CPU tests import every module on a machine without ``nvcc``.

Each wrapper in ``ops`` that launches a kernel adds one to
``launch_counts[name]`` per launch, so a run can show that it went through
the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no FMA contraction: the kernels keep the plain versions' rounding
    "--fmad=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

launch_counts: collections.Counter = collections.Counter()

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "hipsc_contact_substep": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                              _F, _F, _I, _F, _F, _F, _F, _F, _F, _P),
    "hipsc_bio_moments": (_P, _P, _P, _P, _I, _I, _F, _I, _P),
    "hipsc_ftcs_subcycle": (_P, _P, _I, _I, _F, _F, _P),
    "hipsc_contact_seed": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           _F, _F, _I, _F, _F, _F, _F, _F, _F, _P),
    "hipsc_contact_masked": (_P, _P, _P, _P, _P, _P, _P, _I, _I,
                             _F, _F, _I, _F, _F, _F, _F, _F, _F, _P),
    "hipsc_mask_compact": (_P, _P, _P, _P, _I, _I, _I, _P),
}


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def sources() -> list:
    """The translation units ``nvcc`` compiles."""
    return sorted(SRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """The library's path, keyed by the flags and every file under
    ``csrc/`` (headers included, so an edited header never reuses a stale
    library)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(p for p in SRC_DIR.rglob("*") if p.is_file()):
        digest.update(src.relative_to(SRC_DIR).as_posix().encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libhipsc_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library of the same sources exists.
    The compiler's resource report (registers, spills) goes to
    ``<library>.log``."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    target.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, target)
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.hipsc_cuda_error_string.argtypes = (ctypes.c_int,)
            lib.hipsc_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(name: str, *args) -> None:
    """Call one C entry point on the current stream and raise on the CUDA
    error it returns (a refused launch never runs, and a later synchronise
    would not report it)."""
    lib = library()
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        msg = lib.hipsc_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    """Validate a kernel operand before its pointer is passed on."""
    if t.device.type != "cuda" or t.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: expected a tensor on the current CUDA device, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
