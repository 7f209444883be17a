"""Build, load and bind the package's CUDA kernels (``csrc/*.cu``, which
share ``csrc/*.cuh`` headers).

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, loaded with ``ctypes``. The build happens
at first use, into ``_build/`` inside the package (listed in ``.gitignore``),
keyed by a hash of every file under ``csrc/`` and the flags, so a fresh
checkout builds itself and an unchanged one reuses its library. Nothing here runs at import time:
the CPU tests import every module on a machine without ``nvcc``.

Each wrapper in ``ops`` that launches a kernel adds one to
``launch_counts[name]`` per launch (``count_launch``), so a run can show
that it went through the kernels. A launch made while a CUDA graph is being
captured is not run then: it counts into the capture's tally instead
(``capturing``), and each replay of the graph adds that tally to
``launch_counts`` (``HipscEngine.run_steps``).
"""

from __future__ import annotations

import collections
import contextlib
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
# the tally of the graph being captured, or None
_capture_tally: Optional[collections.Counter] = None

_lib: Optional[ctypes.CDLL] = None
_limits: dict = {}
_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "hipsc_deposit": (_P, _P, _P, _P, _L, _I, _P),
    "hipsc_contact_substep": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _I, _I, _F, _F, _I, _F, _F, _F, _F, _F, _F, _P),
    "hipsc_bio_moments": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _F, _I, _I, _P),
    "hipsc_ftcs_diffuse": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _F, _F, _F, _F, _P),
    "hipsc_contact_seed": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _F, _F, _I, _F, _F, _F, _F, _F, _F, _P, _P),
    "hipsc_contact_masked": (_P, _P, _P, _P, _P, _P, _I, _I, _I,
                             _F, _F, _I, _F, _F, _F, _F, _F, _F, _P, _P),
    "hipsc_mask_compact": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P),
    "hipsc_dynslice_probe": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "hipsc_dynslice_probe2": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
}
# stencil runs per row: 3 in 2D, 9 in 3D (the kernels' N_RUNS)
RUN_COUNTS = (3, 9)


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
    """Compile the kernels unless a library of the same sources exists: one
    ``nvcc -c`` per source, all started together, then one link. The
    compiler's resource report (registers, spills) goes to
    ``<library>.log``."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = target.with_suffix(f".{os.getpid()}")
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objects = [Path(f"{stem}.{src.stem}.o") for src in sources()]
    procs = [subprocess.Popen([nvcc(), *compile_flags, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources(), objects)]
    logs = [(src.name, p.communicate()[0], p.returncode) for src, p in zip(sources(), procs)]
    failed = [(name, rc, out) for name, out, rc in logs if rc != 0]
    if not failed:
        tmp = Path(f"{stem}.tmp")
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, objects)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(("link", proc.stdout, proc.returncode))
        if proc.returncode != 0:
            failed.append(("link", proc.returncode, proc.stdout))
    for obj in objects:
        obj.unlink(missing_ok=True)
    target.with_suffix(".log").write_text(
        "".join(f"== {name} (rc {rc})\n{out}" for name, out, rc in logs))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{name} ({rc}):\n{out[-4000:]}" for name, rc, out in failed))
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
            lib.hipsc_device_limits.argtypes = (ctypes.POINTER(ctypes.c_int),) * 2
            lib.hipsc_device_limits.restype = ctypes.c_int
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


def count_launch(name: str) -> None:
    """Count one launch of kernel ``name``: into ``launch_counts``, or into
    the tally of the graph being captured."""
    (launch_counts if _capture_tally is None else _capture_tally)[name] += 1


@contextlib.contextmanager
def capturing():
    """While a CUDA graph is captured: yields the Counter of the launches
    the graph holds (``count_launch`` counts there instead)."""
    global _capture_tally
    outer, _capture_tally = _capture_tally, collections.Counter()
    try:
        yield _capture_tally
    finally:
        _capture_tally = outer


def device_limits() -> dict:
    """The current card's ``n_sm`` (multiprocessors) and ``smem_optin`` (the
    most dynamic shared memory one block may ask for), read once per
    device."""
    dev = torch.cuda.current_device()
    if dev not in _limits:
        lib = library()
        n_sm, smem = ctypes.c_int(0), ctypes.c_int(0)
        rc = lib.hipsc_device_limits(ctypes.byref(n_sm), ctypes.byref(smem))
        if rc != 0:
            raise RuntimeError(f"hipsc_device_limits: CUDA error {rc} "
                               f"({lib.hipsc_cuda_error_string(rc).decode()})")
        _limits[dev] = dict(n_sm=n_sm.value, smem_optin=smem.value)
    return _limits[dev]


def counted_name(name: str, n_runs: int) -> str:
    """The ``launch_counts`` key of a run-bounds kernel: its 3D form (9
    runs) counts apart from its 2D form."""
    return name if n_runs == 3 else f"{name}_3d"


def run_count(bounds: torch.Tensor) -> int:
    """Stencil runs of a (C, 2 * n_runs) run-bounds table; raises unless
    n_runs is 3 (2D) or 9 (3D)."""
    n_runs = bounds.shape[1] // 2 if bounds.dim() == 2 else 0
    if n_runs not in RUN_COUNTS or bounds.shape[1] != 2 * n_runs:
        raise ValueError(f"bounds: expected (C, 6) or (C, 18), got {tuple(bounds.shape)}")
    return n_runs


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
