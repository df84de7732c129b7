"""Build, load and launch the hand-written CUDA kernels (csrc/*.cu).

The kernels are compiled with ``nvcc -gencode arch=compute_90a,code=sm_90a``
into a shared library with a plain C interface and loaded with ctypes; no
PyTorch headers are involved, so a build takes seconds.  The library goes
to ``build/circminer_tpu_torch/`` at the repository root, named by a hash
of the source and the flags: the first launch builds it, a changed source
builds anew, and the build never runs at import time.

``launch`` is the one place a kernel is started.  It checks every tensor
(device, dtype, shape, contiguity), passes pointers and the current stream
as ``c_void_p``, raises on a non-zero ``cudaGetLastError`` and adds one to
``LAUNCHES[name]``.  It never falls back to a plain torch version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "align_kernels.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build",
                         "circminer_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel name -> (C symbol, number of int statics after the pointers)
KERNELS = {
    "xdrop": ("cm_xdrop", 5),        # w, mat, mis, ind, xd
    "edit_sc": ("cm_edit_sc", 3),    # w, max_ed, max_sc
    "edit_end": ("cm_edit_end", 2),  # w, max_ed
    "one_side": ("cm_one_side", 1),  # w, a bound on every row's wv
}
I_KERNEL = 128  # DP extent of every kernel: cells i = 0 .. 127 of a diagonal


def band_layout(w: int, one_sided: bool = False):
    """(G, NC) of the band-local kernels at band w: G lanes of NC cells per
    item hold the window slots of a diagonal, w + 2 (xdrop, edit_sc,
    edit_end) or w // 2 + 2 for ``one_sided`` (one_side, whose rows' wv
    are all <= w); ``band_layout`` in csrc/align_kernels.cu makes the same
    choice.  One lane per item while the slots fit 8 cells, then 8 cells
    per lane; a band wider than 2I - 2 changes no cell's test and is held
    at that."""
    wa = min(w, 2 * I_KERNEL - 2)
    slots = (wa // 2 if one_sided else wa) + 2
    if slots <= 8:
        return 1, max(slots, 2)
    g = 2
    while g * 8 < slots and g < 32:
        g *= 2
    return g, 8


# launches per kernel since the last reset_launches(); only launch() adds
LAUNCHES = {name: 0 for name in KERNELS}

_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME) to build "
                           "circminer_tpu_torch/csrc/align_kernels.cu")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> str:
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libcm_align_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless the library for this source exists;
    return its path.  A failed build raises with nvcc's output."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, _SRC]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}"
                           f"\n{res.stdout}\n{res.stderr}")
    with open(so[:-3] + ".log", "w") as f:  # ptxas registers / smem
        f.write(f"built in {time.perf_counter() - t0:.1f} s: "
                f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)
    return so


def bind(lib):
    """Declare the C signature of every kernel symbol of a loaded library."""
    p, c = ctypes.c_void_p, ctypes.c_int
    for sym, n_statics in KERNELS.values():
        fn = getattr(lib, sym)
        # s, t, n, m, wv, out, B, L, statics..., stream
        fn.argtypes = [p] * 6 + [c, c] + [c] * n_statics + [p]
        fn.restype = c
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(build()))
    return _lib


def _check(x: torch.Tensor, name: str, dtype, shape) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(name: str, s, t, n, m, wv, ncols: int, I: int, statics):
    """Run kernel ``name`` over the [B, L] int8 pair batch (s, t) with
    lengths n, m (and per-item band wv for one_side) on the current stream.
    Returns the int32 [B, ncols] output, allocated here."""
    if I != I_KERNEL:
        raise ValueError(f"the CUDA kernels take I = {I_KERNEL}, got {I}")
    B, L = s.shape
    if L > I:
        raise ValueError(f"rows of {L} bases exceed the DP extent I = {I}")
    _check(s, "s", torch.int8, (B, L))
    _check(t, "t", torch.int8, (B, L))
    _check(n, "n", torch.int32, (B,))
    _check(m, "m", torch.int32, (B,))
    if (wv is not None) != (name == "one_side"):
        raise ValueError("wv (the per-item band) goes to one_side only")
    if wv is not None:
        _check(wv, "wv", torch.int32, (B,))
    sym, n_statics = KERNELS[name]
    if len(statics) != n_statics:
        raise ValueError(f"{name} takes {n_statics} statics, got {statics}")
    out = torch.empty((B, ncols), dtype=torch.int32, device=s.device)
    if B == 0:
        return out
    fn = getattr(_load(), sym)
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        err = fn(s.data_ptr(), t.data_ptr(), n.data_ptr(), m.data_ptr(),
                 wv.data_ptr() if wv is not None else None, out.data_ptr(),
                 B, L, *(int(v) for v in statics), stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
    LAUNCHES[name] += 1
    return out
