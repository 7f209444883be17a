"""Native (C++) output tier, built at first use and bound with ctypes.

``get_lib()`` compiles ``fastio.cpp`` with ``g++`` into ``_build/`` inside
the package (listed in ``.gitignore``), under a name keyed by a hash of the
source and the flags, and loads it. A failed build raises with the
compiler's output; ``HIPSC_TORCH_NO_NATIVE_IO=1`` is the one way to run the
pure-Python writers instead (``get_lib()`` then returns None).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

SRC = Path(__file__).resolve().parent / "fastio.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")
# the environment switch that selects the pure-Python writers
DISABLE_ENV = "HIPSC_TORCH_NO_NATIVE_IO"

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SRC.read_bytes())
    return BUILD_DIR / f"libhipsc_fastio_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless one of the same source exists; raises
    with the compiler's output when ``g++`` fails."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SRC.name} (rc {proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, target)  # atomic against concurrent builds
    return target


def get_lib():
    """The bound library, or None when ``HIPSC_TORCH_NO_NATIVE_IO`` is set."""
    global _lib
    if os.environ.get(DISABLE_ENV):
        return None
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.hipsc_fmt_repr.restype = ctypes.c_int
            lib.hipsc_fmt_repr.argtypes = [ctypes.c_double, ctypes.c_char_p]
            lib.hipsc_write_values_csv.restype = ctypes.c_int
            lib.hipsc_write_values_csv.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_int64,
            ]
            lib.hipsc_write_matrix_e18.restype = ctypes.c_int
            lib.hipsc_write_matrix_e18.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64,
            ]
            _lib = lib
        return _lib
