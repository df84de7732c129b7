"""ctypes bindings for the native alignment kernels (native/align_kernels.cpp).

Builds the shared library at first use (into build/circminer_tpu_torch/,
see ops/_native.py); falls back cleanly to the numpy oracle in ops/align.py
when a compiler is unavailable.  ``dispatch()`` returns a module-like namespace with the same
function signatures as the oracle wrappers so pipeline code can stay agnostic.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np

from ._native import build_library, native_source

_SRC = native_source("align_kernels.cpp")
_LIB = None

_lib = None


def _build() -> bool:
    global _LIB
    try:
        _LIB = build_library("align", [_SRC])
        return True
    except Exception as e:  # pragma: no cover
        sys.stderr.write(f"[align_native] build failed ({e}); "
                         "using numpy fallback\n")
        return False


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _build():
        return None
    lib = ctypes.CDLL(_LIB)
    # raw-pointer mode (see chain_native.py): ndpointer validation cost
    # dominates these microsecond-scale scalar calls
    p = ctypes.c_void_p
    ci = ctypes.c_int
    for name, extra in (
        ("edit_local_right_sc", 0), ("edit_local_left_sc", 0),
        ("local_right", 0), ("local_left", 0),
    ):
        fn = getattr(lib, name)
        fn.argtypes = [p, ci, p, ci, ci, ci, ci, p]
        fn.restype = None
    for name in ("drop_local_right_sc", "drop_local_left_sc"):
        fn = getattr(lib, name)
        fn.argtypes = [p, ci, p, ci, ci, ci, ci, ci, ci, ci, ci, p]
        fn.restype = None
    lib.one_side_banded.argtypes = [p, ci, p, ci, ci]
    lib.one_side_banded.restype = ctypes.c_int64
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _c(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int8)


class NativeAligner:
    """Same call surface as the ops.align oracle wrappers."""

    def __init__(self):
        self.lib = _load()
        if self.lib is None:
            raise RuntimeError("native alignment library unavailable")
        self._out = np.zeros(4, dtype=np.int64)

    def edit_local_alignment_right_sc(self, s, t, w, max_ed, max_sc):
        o = self._out
        sc, tc = _c(s), _c(t)
        self.lib.edit_local_right_sc(sc.ctypes.data, len(s), tc.ctypes.data,
                                     len(t), w, max_ed, max_sc, o.ctypes.data)
        return int(o[0]), int(o[1]), int(o[2]), int(o[3])

    def edit_local_alignment_left_sc(self, s, t, w, max_ed, max_sc):
        o = self._out
        sc, tc = _c(s), _c(t)
        self.lib.edit_local_left_sc(sc.ctypes.data, len(s), tc.ctypes.data,
                                    len(t), w, max_ed, max_sc, o.ctypes.data)
        return int(o[0]), int(o[1]), int(o[2]), int(o[3])

    def local_alignment_right(self, s, t, w, max_ed, max_sc):
        o = self._out
        sc, tc = _c(s), _c(t)
        self.lib.local_right(sc.ctypes.data, len(s), tc.ctypes.data, len(t),
                             w, max_ed, max_sc, o.ctypes.data)
        return int(o[0]), int(o[1]), int(o[2])

    def local_alignment_left(self, s, t, w, max_ed, max_sc):
        o = self._out
        sc, tc = _c(s), _c(t)
        self.lib.local_left(sc.ctypes.data, len(s), tc.ctypes.data, len(t),
                            w, max_ed, max_sc, o.ctypes.data)
        return int(o[0]), int(o[1]), int(o[2])

    def drop_local_alignment_right_sc(self, s, t, w, max_ed, max_sc, sm):
        o = self._out
        sc, tc = _c(s), _c(t)
        self.lib.drop_local_right_sc(sc.ctypes.data, len(s), tc.ctypes.data,
                                     len(t), w, max_ed, max_sc, sm.mat,
                                     sm.mis, sm.ind, sm.xd, o.ctypes.data)
        return int(o[0]), int(o[1]), int(o[2]), int(o[3])

    def drop_local_alignment_left_sc(self, s, t, w, max_ed, max_sc, sm):
        o = self._out
        sc, tc = _c(s), _c(t)
        self.lib.drop_local_left_sc(sc.ctypes.data, len(s), tc.ctypes.data,
                                    len(t), w, max_ed, max_sc, sm.mat,
                                    sm.mis, sm.ind, sm.xd, o.ctypes.data)
        return int(o[0]), int(o[1]), int(o[2]), int(o[3])

    def global_one_side_banded_alignment(self, s, t, w):
        sc, tc = _c(s), _c(t)
        return int(self.lib.one_side_banded(sc.ctypes.data, len(s),
                                            tc.ctypes.data, len(t), w))
