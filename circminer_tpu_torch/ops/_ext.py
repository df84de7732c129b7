"""Build, load and launch the hand-written CUDA kernels (csrc/*.cu).

The kernels are compiled with ``nvcc -gencode arch=compute_90a,code=sm_90a``
into one shared library with a plain C interface and loaded with ctypes;
no PyTorch headers are involved, so a build takes seconds.  Every source
under ``csrc/`` is compiled to an object by its own nvcc, all started
together, and the objects are linked into ``build/circminer_tpu_torch/``
at the repository root, named by a hash of all the sources and the flags:
the first launch builds it, a changed source builds anew, and the build
never runs at import time.

``launch`` (the DP kernels' ``(s, t, n, m, wv)`` signature) and
``launch_tensors`` (a list of tensors and int statics, as ``KERNELS``
declares them) are the only places a kernel is started.  Each checks every
tensor (device, dtype, shape, contiguity), passes pointers and the current
stream as ``c_void_p``, raises on a non-zero ``cudaGetLastError`` and adds
one to ``LAUNCHES[name]``.  Neither falls back to a plain torch version.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import time
from typing import NamedTuple, Optional, Tuple

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build",
                         "circminer_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class Kernel(NamedTuple):
    """A kernel's C symbol, the names of its int statics (after the
    pointers, before the stream) and, for a ``launch_tensors`` kernel, the
    names of its tensor arguments in order (None: the DP signature s, t, n,
    m, wv, out, B, L)."""
    sym: str
    statics: Tuple[str, ...]
    tensors: Optional[Tuple[str, ...]] = None


KERNELS = {
    "xdrop": Kernel("cm_xdrop", ("w", "mat", "mis", "ind", "xd")),
    "edit_sc": Kernel("cm_edit_sc", ("w", "max_ed", "max_sc")),
    "edit_end": Kernel("cm_edit_end", ("w", "max_ed")),
    # w: a bound on every row's wv
    "one_side": Kernel("cm_one_side", ("w",)),
    "chain_dp": Kernel(
        "cm_chain_dp", ("b", "NL", "S", "P", "k", "max_ed", "max_intron"),
        ("posf", "qposf", "validf", "ub", "mee", "e1", "ol_iv", "iv_nseg",
         "seg_end", "seg_next", "dp", "back")),
    "mr_pair_fold": Kernel(
        "cm_mr_pair_fold", ("B", "P", "max_tlen", "contig_num",
                            "scan_level"),
        ("mr", "pairs", "o_t", "orient", "live", "stopped", "mr_out",
         "aux")),
    "walk_fold": Kernel(
        "cm_walk_fold", ("WPP", "N", "fam", "left", "ST", "EW", "max_ed",
                         "max_sc", "band"),
        ("events", "act", "inv", "n_act", "p_live", "p_pos", "p_len",
         "lane_defer", "ed_th", "bound", "out")),
    "tiny_dp": Kernel(
        "cm_tiny_dp", ("B", "Ls", "Lt", "NM", "MM", "w", "max_ed", "end"),
        ("s", "t", "n", "m", "tiny", "banded", "out")),
    "walk_scan": Kernel(
        "cm_walk_scan", ("STW", "WPP", "NIV", "NS", "G", "KSCAN"),
        ("ws", "slot", "lane", "iv_spos", "iv_epos", "t2s_state", "ws_out")),
    "walk_init": Kernel(
        "cm_walk_init", ("N", "WPP", "STW", "ST", "NIV", "NT", "EW", "band",
                         "left_bits"),
        ("act4", "pos4", "len4", "aiv4", "row4", "qs04", "fiv", "riv",
         "iv_epos", "iv_tids", "trans_start", "t2s_off", "inv", "n_act",
         "over", "act", "p_live", "over_tid", "ws", "slot", "lane", "prow",
         "events", "nev")),
    "walk_pool": Kernel(
        "cm_walk_pool", ("STW", "WPP", "RL", "G", "L", "band", "MIDP",
                         "ENDP", "W"),
        ("ws", "lane", "prow", "seqsf", "genome", "m_win", "m_rows",
         "m_tiny", "e_win", "e_rows", "n", "maps")),
    "walk_commit": Kernel(
        "cm_walk_commit", ("STW", "WPP", "EW", "MIDP", "ENDP", "NIV", "mat",
                           "mis", "band", "max_ed", "max_sc"),
        ("ws", "maps", "md", "xres", "e_rows", "lane", "iv_spos", "iv_epos",
         "events", "nev", "ws_out")),
    "chain_cells": Kernel(
        "cm_chain_cells", ("B", "NL", "S", "n_nb", "n_iv", "P", "seg_pad",
                           "k", "max_ed"),
        ("pos", "cnt", "qpos", "seq_len", "nb_bits", "iv_spos", "iv_epos",
         "iv_max_end", "iv_min_end", "iv_max_next", "iv_nseg", "seg_end",
         "seg_next", "qposf", "validf", "ub", "mee", "e1", "ol_iv")),
    "extract_kbest": Kernel(
        "cm_extract_kbest", ("R", "NL", "S", "C", "iters"),
        ("dp10", "back", "pos", "qpos", "cnt", "rpos", "qp", "clen", "sc10",
         "cn", "incomplete")),
    "extend_core": Kernel(
        "cm_extend_core", ("N", "fam", "left", "max_sc", "band"),
        ("pos", "length", "ed_th", "bound", "has_tids", "iv", "exon_len",
         "covered", "wx", "walk_inb", "gen_inb", "g_ed", "g_sclen",
         "g_indel", "g_score", "w_ed", "w_sclen", "w_indel", "w_score",
         "fold", "over", "act", "ok", "pos_out", "best", "defer")),
    # the leftover extends: extend_core's wrap-up, left then right
    "extend_leftover": Kernel(
        "cm_extend_leftover", ("N", "NL", "max_ed", "max_sc", "band"),
        ("rp4", "qp4", "pos_r", "remain_end", "est_mid", "genL_inb",
         "genR_inb", "dp_ed", "dp_sclen", "dp_indel", "dp_score", "ok", "pos",
         "best")),
    "pair_grid": Kernel(
        "cm_pair_grid", ("B", "KB1", "NL", "P", "k", "NIV", "ST", "SP",
                         "SEG_PAD", "NG"),
        ("sf_i", "sf_b", "rp4", "qp4", "cn4", "lens4", "defer", "iv_tids",
         "iv_ntid", "iv_nseg_true", "iv_nseg", "seg_gene_p", "gene_start",
         "gene_end", "grid_b", "tlen_g", "valid", "slot_i", "slot_b",
         "n_union", "mate_i", "mate_b", "defer_out")),
}
DP_KERNELS = tuple(n for n, k in KERNELS.items() if k.tensors is None)
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


# launches per kernel since the last reset_launches(); only the launchers add
LAUNCHES = {name: 0 for name in KERNELS}

_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME) to build "
                           "the kernels of circminer_tpu_torch/csrc/")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def sources():
    """Every CUDA source of the library, in a fixed order."""
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256()
    for src in sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libcm_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless the library for these sources exists;
    return its path.  One nvcc per source, all started together, then one
    link.  A failed build raises with nvcc's output."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in sources():
        obj = f"{tmp}.{os.path.basename(src)}.o"
        cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = [], None
    for cmd, _, proc in jobs:
        out, err = proc.communicate()
        log.append(f"{' '.join(cmd)}\n{out}{err}")
        if proc.returncode != 0 and failed is None:
            failed = (f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                      f"{out}\n{err}")
    if failed is None:
        cmd = [_nvcc(), "-shared", *NVCC_FLAGS[:2], "-o", f"{tmp}.tmp",
               *(obj for _, obj, _ in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            failed = (f"nvcc link failed ({res.returncode}): "
                      f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    for _, obj, _ in jobs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed is not None:
        raise RuntimeError(failed)
    with open(so[:-3] + ".log", "w") as f:  # ptxas registers / smem
        f.write(f"built in {time.perf_counter() - t0:.1f} s\n"
                + "\n".join(log))
    os.replace(f"{tmp}.tmp", so)
    return so


def bind(lib):
    """Declare the C signature of every kernel symbol of a loaded library."""
    p, c = ctypes.c_void_p, ctypes.c_int
    for spec in KERNELS.values():
        fn = getattr(lib, spec.sym)
        if spec.tensors is None:
            # s, t, n, m, wv, out, B, L, statics..., stream
            fn.argtypes = [p] * 6 + [c, c] + [c] * len(spec.statics) + [p]
        else:
            fn.argtypes = ([p] * len(spec.tensors)
                           + [c] * len(spec.statics) + [p])
        fn.restype = c
    lib.cm_error_string.argtypes = [c]
    lib.cm_error_string.restype = ctypes.c_char_p
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


def _raise_on(name: str, err: int) -> None:
    """Raise with the CUDA runtime's text if a launch returned an error."""
    if err != 0:
        text = _load().cm_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err} ({text})")


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
    spec = KERNELS[name]
    if spec.tensors is not None:
        raise ValueError(f"{name} launches through launch_tensors")
    if len(statics) != len(spec.statics):
        raise ValueError(f"{name} takes statics {spec.statics}, got "
                         f"{statics}")
    out = torch.empty((B, ncols), dtype=torch.int32, device=s.device)
    if B == 0:
        return out
    fn = getattr(_load(), spec.sym)
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        err = fn(s.data_ptr(), t.data_ptr(), n.data_ptr(), m.data_ptr(),
                 wv.data_ptr() if wv is not None else None, out.data_ptr(),
                 B, L, *(int(v) for v in statics), stream)
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return out


def launch_tensors(name: str, args, statics) -> None:
    """Run kernel ``name`` on the current stream of its tensors' device.
    ``args``: one (tensor, dtype, shape) per name of
    ``KERNELS[name].tensors``, each checked (the wrapper allocates the
    outputs among them); ``statics``: its int statics in order."""
    spec = KERNELS[name]
    if spec.tensors is None or len(args) != len(spec.tensors):
        raise ValueError(f"{name} takes tensors {spec.tensors}, got "
                         f"{len(args)}")
    if len(statics) != len(spec.statics):
        raise ValueError(f"{name} takes statics {spec.statics}, got "
                         f"{statics}")
    dev = args[0][0].device
    for (x, dtype, shape), tname in zip(args, spec.tensors):
        _check(x, tname, dtype, shape)
        if x.device != dev:
            raise ValueError(f"{tname} is on {x.device}, {spec.tensors[0]} "
                             f"on {dev}")
    fn = getattr(_load(), spec.sym)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(x.data_ptr() for x, _, _ in args),
                 *(int(v) for v in statics), stream)
    _raise_on(name, err)
    LAUNCHES[name] += 1
