"""Build and load the native host code with g++, bound with ctypes: the
wirec encoder (wirec.cc, which includes packer.cc, so the one library
also exports the blob packers) and the host corpus generator
(generator.cc). Both sources are byte-for-byte copies of the JAX
package's.

Each library's name carries a hash of its sources, so an edited source is
rebuilt once and an unchanged tree never recompiles. Each process
compiles into a temporary file of its own in the build directory and
moves it into place with os.replace, so processes that build at the same
moment (test workers on a fresh checkout) never write one file together:
the last rename wins and every rename installs a whole library. Nothing
builds at import time.

`load_wirec` and `load_generator` return None only when there is no g++;
a source that does not compile raises. Every entry point is declared with
its 64-bit argument and return types: ctypes' defaults would cut an int64
offset or count to 32 bits.
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
_SRC_GEN = os.path.join(_DIR, "generator.cc")
_BUILD_DIR = os.path.join(_DIR, "_build")

_lock = threading.Lock()
_libs: dict = {}


def _so_path(stem: str, sources) -> str:
    h = hashlib.sha256()
    for path in sources:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def library_path() -> str:
    """The wirec library's path for the current sources (wirec.cc and the
    packer.cc it includes)."""
    return _so_path("cadence_wirec", (_SRC_WIREC, _SRC_PACKER))


def generator_library_path() -> str:
    """The generator library's path for the current generator.cc."""
    return _so_path("cadence_generator", (_SRC_GEN,))


def wirec_cached() -> bool:
    """True when the wirec library is already built for the current
    sources: a look at the file its hash names, never a compiler run, so a
    booting host can report whether it has the native encoder without
    waiting on g++."""
    try:
        return os.path.exists(library_path())
    except OSError:
        return False


def available() -> bool:
    """True when a C++ compiler is on PATH (the libraries can be built)."""
    return shutil.which("g++") is not None


def _build(so: str, src: str) -> str:
    """Compile `src` into `so` unless it is already built; returns `so`."""
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=_BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        p = subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
                            "-o", tmp, src], capture_output=True, text=True)
        if p.returncode != 0:
            raise RuntimeError(f"g++ failed to build {src}:\n{p.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def build() -> str:
    """Compile the wirec library unless it is already built for these
    sources; returns its path."""
    return _build(library_path(), _SRC_WIREC)


def build_generator() -> str:
    """Compile the generator library unless it is already built; returns
    its path."""
    return _build(generator_library_path(), _SRC_GEN)


_I64 = ctypes.c_int64
_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_PROFILE = [_I64P] * 7  # lane, kind, offset, width, scale, const, base_index [P]


def _configure_wirec(lib: ctypes.CDLL) -> None:
    # packer.cc: blob, offsets [W + 1], W, max_events, num_lanes, out, num_threads;
    # returns the events packed or -(workflow + 1) * 1000 - err
    lib.cadence_pack_corpus.restype = _I64
    lib.cadence_pack_corpus.argtypes = [ctypes.c_char_p, _I64P, _I64, _I64, _I64, _I64P, _I64]
    lib.cadence_pack_corpus32.restype = _I64
    lib.cadence_pack_corpus32.argtypes = [ctypes.c_char_p, _I64P, _I64, _I64, _I64, _I32P, _I64]
    lib.cadence_wirec_measure.restype = _I64
    # lanes [W, E, L], W, E, L, kinds/widths/scales/consts [L], num_threads
    lib.cadence_wirec_measure.argtypes = [_I64P, _I64, _I64, _I64, _I64P, _I64P, _I64P, _I64P, _I64]
    lib.cadence_wirec_emit.restype = _I64
    # lanes, W, E, L, the profile columns, P, B, K, slab, bases, n_events, num_threads
    lib.cadence_wirec_emit.argtypes = ([_I64P, _I64, _I64, _I64] + _PROFILE
                                       + [_I64, _I64, _I64, _U8P, _I64P, _I32P, _I64])
    lib.cadence_wirec_pack_fused.restype = _I64
    # blob, offsets [W + 1], W, E, L, lanes scratch [W, E, L], the profile columns, P, B, K,
    # slab, bases, n_events, misfit out [1], num_threads
    lib.cadence_wirec_pack_fused.argtypes = ([ctypes.c_char_p, _I64P, _I64, _I64, _I64, _I64P]
                                             + _PROFILE
                                             + [_I64, _I64, _I64, _U8P, _I64P, _I32P, _I64P, _I64])


def _configure_generator(lib: ctypes.CDLL) -> None:
    lib.cadence_generate_corpus.restype = _I64
    # seed, first_index, num_workflows, max_events, num_lanes, out, num_threads
    lib.cadence_generate_corpus.argtypes = [ctypes.c_uint64, _I64, _I64, _I64, _I64, _I64P, _I64]


def _load(stem: str, build_fn, configure) -> Optional[ctypes.CDLL]:
    with _lock:
        if stem not in _libs:
            if not available():
                return None
            lib = ctypes.CDLL(build_fn())
            configure(lib)
            _libs[stem] = lib
        return _libs[stem]


def load_wirec() -> Optional[ctypes.CDLL]:
    """The native wirec encoder and blob packers, built on first use; None
    without g++."""
    return _load("wirec", build, _configure_wirec)


def load_generator() -> Optional[ctypes.CDLL]:
    """The native corpus generator, built on first use; None without g++."""
    return _load("generator", build_generator, _configure_generator)
