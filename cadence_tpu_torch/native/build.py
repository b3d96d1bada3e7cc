"""Build and load the native wirec encoder (wirec.cc, which includes
packer.cc) with g++, bound with ctypes.

The shared library's name carries a hash of both sources, so an edited
source is rebuilt once and an unchanged tree never recompiles. Each
process compiles into a temporary file of its own in the build directory
and moves it into place with os.replace, so processes that build at the
same moment (test workers on a fresh checkout) never write one file
together: the last rename wins and every rename installs a whole library.
Nothing builds at import time.

`load_wirec` returns None only when there is no g++; a source that does
not compile raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC_PACKER = os.path.join(_DIR, "packer.cc")
_SRC_WIREC = os.path.join(_DIR, "wirec.cc")
_BUILD_DIR = os.path.join(_DIR, "_build")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> str:
    """The library's path for the current sources (wirec.cc and the
    packer.cc it includes)."""
    h = hashlib.sha256()
    for path in (_SRC_WIREC, _SRC_PACKER):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libcadence_wirec_{h.hexdigest()[:16]}.so")


def available() -> bool:
    """True when a C++ compiler is on PATH (the library can be built)."""
    return shutil.which("g++") is not None


def build() -> str:
    """Compile the library unless it is already built for these sources;
    returns its path."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=_BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        p = subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
                            "-o", tmp, _SRC_WIREC], capture_output=True, text=True)
        if p.returncode != 0:
            raise RuntimeError(f"g++ failed to build {_SRC_WIREC}:\n{p.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def _configure(lib: ctypes.CDLL) -> None:
    I64, I64P = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
    U8P, I32P = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)
    lib.cadence_wirec_measure.restype = I64
    # lanes [W, E, L], W, E, L, kinds/widths/scales/consts [L], num_threads
    lib.cadence_wirec_measure.argtypes = [I64P, I64, I64, I64, I64P, I64P, I64P, I64P, I64]
    lib.cadence_wirec_emit.restype = I64
    # lanes, W, E, L, the seven profile columns [P], P, B, K, slab, bases, n_events, num_threads
    lib.cadence_wirec_emit.argtypes = ([I64P, I64, I64, I64] + [I64P] * 7
                                       + [I64, I64, I64, U8P, I64P, I32P, I64])


def load_wirec() -> Optional[ctypes.CDLL]:
    """The native wirec encoder, built on first use; None without g++."""
    global _lib
    with _lock:
        if _lib is None:
            if not available():
                return None
            lib = ctypes.CDLL(build())
            _configure(lib)
            _lib = lib
        return _lib
