"""Build the port's host C++ engines (``native/*.cpp``) at first use.

Each library is compiled with ``g++`` into ``build/circminer_tpu_torch/`` at
the repository root (beside the CUDA library of ``_ext.py``), named by a
hash of its sources and flags: a changed source builds anew, an unchanged
one is loaded as built, and nothing is ever written into the package's
own tree.  The ``*_native.py`` bindings call ``build_library`` from their
``_build``; nothing builds at import time.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from typing import List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(_PKG, "native")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), ".cache", "native")
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def native_source(name: str) -> str:
    return os.path.join(NATIVE_DIR, name)


def library_path(stem: str, sources: List[str], flags: List[str]) -> str:
    h = hashlib.sha256()
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(GXX_FLAGS + flags).encode())
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def build_library(stem: str, sources: List[str], flags: List[str] = ()) -> str:
    """Compile ``sources[0]`` (which ``#include``s the rest of ``sources``)
    unless the library for these sources and flags exists; return its
    path.  A failed build raises with the compiler's output."""
    flags = list(flags)
    so = library_path(stem, sources, flags)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", *GXX_FLAGS, *flags, sources[0], "-o", tmp]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}): {' '.join(cmd)}"
                           f"\n{res.stderr}")
    os.replace(tmp, so)   # atomic: concurrent builders never see half a file
    return so
