"""Native (C++) host-side components, built on demand with the system g++.

Copied from dynamo_tpu/native/__init__.py: `load(name)` compiles
`native/<name>.cpp` with `g++ -O2 -shared -fPIC -std=c++17` at first use
and loads it with ctypes; None when there is no toolchain (the callers keep
a pure-Python fallback). Unlike the JAX package, which writes the library
next to its source, the library lands in `<checkout>/build/dynamo_tpu_torch/`
under a name hashed from the source and the flags (as ops/build.py names
the CUDA libraries), so a fresh checkout builds what it needs and an edited
source never loads a stale library. A failed build, load or start is logged and
counted (NATIVE_STATS.build_failures), never silent.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

log = logging.getLogger("dynamo_tpu_torch.native")

_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dynamo_tpu_torch"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_LOCK = threading.Lock()
_LIBS: Dict[str, Optional[ctypes.CDLL]] = {}


class NativeStats:
    """Process-local counters of the native builds."""

    def __init__(self):
        self.build_failures = 0    # compile, load or start failures
        # (fallback on; a start failure is counted by its caller)
        self.last_error = ""


NATIVE_STATS = NativeStats()


def library_path(name: str) -> Path:
    """The library of native/<name>.cpp, named by a hash of the source and
    the flags."""
    h = hashlib.sha256((_DIR / f"{name}.cpp").read_bytes()
                       + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{h[:16]}.so"


def _build(name: str) -> Optional[Path]:
    lib = library_path(name)
    if lib.exists():
        return lib
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # compile to a private temp path and rename into place: a concurrent
        # process must never dlopen a partially written library
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp),
                        str(_DIR / f"{name}.cpp")],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
        return lib
    except (subprocess.SubprocessError, OSError) as e:
        stderr = getattr(e, "stderr", b"") or b""
        msg = stderr.decode(errors="replace")[:500] or str(e)
        NATIVE_STATS.build_failures += 1
        NATIVE_STATS.last_error = f"{name}: {msg}"
        log.warning("native build of %s failed (%s); using the Python "
                    "fallback", name, msg)
        return None


def load(name: str) -> Optional[ctypes.CDLL]:
    """Build (if needed) and dlopen a native component; None on failure."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        path = _build(name)
        lib = None
        if path is not None:
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                NATIVE_STATS.build_failures += 1
                NATIVE_STATS.last_error = f"{name}: dlopen: {e}"
                log.warning("dlopen %s failed: %s", path, e)
        _LIBS[name] = lib
        return lib
