"""Native runtime components, compiled on first use.

The reference keeps its whole runtime in C++ (src/Makefile builds one binary
with g++ -O3). Here the device compute path is JAX/XLA, so native code is
for the host-side runtime around it: the flat-BVH builder (``bvh_builder.cpp``),
which must chew through millions of primitives at scene-load time — a
per-node Python loop would take minutes on dragon-scale meshes
(pages/Page2.md:57: 1.8M triangles).

Compilation is `g++ -O3 -shared` into a content-addressed cache under
``<checkout>/build/native`` (listed in .gitignore; RT795_NATIVE_CACHE moves
it), loaded via ctypes. Every native entry point has a pure-NumPy fallback so the
framework still works where no compiler is available.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_LIBS: dict = {}


def _cache_dir() -> str:
    d = os.environ.get("RT795_NATIVE_CACHE") or os.path.join(
        os.path.dirname(os.path.dirname(_HERE)), "build", "native")
    os.makedirs(d, exist_ok=True)
    return d


def load_native(name: str) -> "ctypes.CDLL | None":
    """Compile (if needed) and dlopen native/<name>.cpp; None on failure."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        src = os.path.join(_HERE, name + ".cpp")
        try:
            with open(src, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()[:16]
            so = os.path.join(_cache_dir(), f"{name}-{digest}.so")
            if not os.path.exists(so):
                tmp = so + f".tmp{os.getpid()}"
                subprocess.run(
                    ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                     "-o", tmp, src],
                    check=True, capture_output=True)
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
        except (OSError, subprocess.CalledProcessError):
            lib = None
        _LIBS[name] = lib
        return lib
