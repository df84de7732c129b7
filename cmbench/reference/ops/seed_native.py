"""ctypes bindings for the native batched seed lookup
(native/lookup_kernels.cpp).

The k-mer index stays in host RAM and a whole read batch is resolved in one
multithreaded C++ call — the host half of the hybrid seeding design: lookup
is a memory-latency pointer workload (the reference's getCandidates +
checksum bisect, HashTable.c:1093-1098 / match_read.cpp:54-110) that CPUs
do well, while the TPU runs the batched chain DP over the gathered seed
tensors.  The pure-device lookup path (ops/seed.py) remains available for
HBM-resident index deployments.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np

from ._native import build_library, native_source

_SRC = native_source("lookup_kernels.cpp")
_LIB = None

_lib = None


def _build() -> bool:
    global _LIB
    try:
        _LIB = build_library("lookup", [_SRC], ["-pthread"])
        return True
    except Exception as e:  # pragma: no cover
        sys.stderr.write(f"[seed_native] build failed ({e}); "
                         "using numpy fallback\n")
        return False


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _build():
        return None
    lib = ctypes.CDLL(_LIB)
    # raw-pointer mode (see chain_native.py)
    p = ctypes.c_void_p
    ci = ctypes.c_int32
    lib.batch_lookup.argtypes = [p, p, ci, ci, p, p,
                                 ctypes.c_int64,
                                 p, ci,
                                 ci, ci, ci, ci,
                                 p, p, p, p, ci]
    lib.batch_lookup.restype = None
    lib.batch_gather.argtypes = [p, p, p, ci, ci, ci, p, ci]
    lib.batch_gather.restype = None
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


class NativeSeeder:
    """Batched host lookup against one contig's index."""

    def __init__(self, ci, cfg):
        self.lib = _load()
        if self.lib is None:
            raise RuntimeError("native lookup library unavailable")
        self.ci = ci
        self.cfg = cfg
        self.entry_hv = np.ascontiguousarray(ci.entry_hv, dtype=np.int32)
        self.entry_checksum = np.ascontiguousarray(ci.entry_checksum,
                                                   dtype=np.int16)
        self.entry_pos = np.ascontiguousarray(ci.entry_pos, dtype=np.int32)
        # 2p-bit hv-prefix radix table: sized so buckets average ~1 entry
        # (p = ceil(log4 n), capped at 12 -> <=134 MB), built once per
        # contig with a bincount+cumsum and cached on the ContigIndex.
        w = cfg.window_size
        n = max(2, ci.n_entries)
        p = min(w, 12, max(1, (int(np.ceil(np.log2(n))) + 1) // 2))
        cached = getattr(ci, "_prefix_cache", None)
        if cached is not None and cached[0] == p:
            starts = cached[1]
        else:
            pfx = (self.entry_hv >> np.int32(2 * (w - p))).astype(np.int64)
            counts = np.bincount(pfx, minlength=1 << (2 * p))
            starts = np.zeros((1 << (2 * p)) + 1, dtype=np.int64)
            np.cumsum(counts, out=starts[1:])
            ci._prefix_cache = (p, starts)
        self.prefix_starts = starts
        self.prefix_shift = 2 * (w - p)

    def lookup(self, reads: np.ndarray, lens: np.ndarray):
        """reads [B, L] int8, lens [B] int32 ->
        (qpos, start, cnt) int32 [B, NL] + high int32 [B]."""
        cfg = self.cfg
        B, L = reads.shape
        NL = cfg.n_kmer_lists
        qpos = np.empty((B, NL), dtype=np.int32)
        start = np.empty((B, NL), dtype=np.int32)
        cnt = np.empty((B, NL), dtype=np.int32)
        high = np.empty(B, dtype=np.int32)
        a_reads = np.ascontiguousarray(reads, dtype=np.int8)
        a_lens = np.ascontiguousarray(lens, dtype=np.int32)
        self.lib.batch_lookup(
            a_reads.ctypes.data, a_lens.ctypes.data,
            B, L, self.entry_hv.ctypes.data, self.entry_checksum.ctypes.data,
            self.entry_hv.shape[0],
            self.prefix_starts.ctypes.data, self.prefix_shift,
            cfg.kmer, cfg.checksum_len, NL, cfg.seed_lim,
            qpos.ctypes.data, start.ctypes.data, cnt.ctypes.data,
            high.ctypes.data, cfg.resolved_threads)
        return qpos, start, cnt, high

    def gather(self, start: np.ndarray, cnt: np.ndarray, cap: int):
        """start/cnt int32 [R, NL] -> positions int32 [R, NL, cap]."""
        R, NL = start.shape
        pos = np.empty((R, NL, cap), dtype=np.int32)
        a_start = np.ascontiguousarray(start, dtype=np.int32)
        a_cnt = np.ascontiguousarray(cnt, dtype=np.int32)
        self.lib.batch_gather(
            self.entry_pos.ctypes.data, a_start.ctypes.data,
            a_cnt.ctypes.data,
            R, NL, cap, pos.ctypes.data, self.cfg.resolved_threads)
        return pos
