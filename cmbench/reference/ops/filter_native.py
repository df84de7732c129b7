"""ctypes bindings for the native per-read mapping finish engine
(native/filter_kernels.cpp).

Same semantics as the Python orchestration (pipeline/mapping.py
process_read_pe + pipeline/extend.py + pipeline/categories.py — the
FilterRead/TransExtension/rule-engine port of src/filter.cpp:124-395,
src/extend.cpp, src/utils.cpp), but one multithreaded C++ call finishes a
whole chained read batch.  Parity with the Python path is pinned by
tests/test_filter_native.py.
"""

from __future__ import annotations

import ctypes
import sys
from typing import List

import numpy as np

from ..config import Config, INF, NOPROC_NOMATCH
from ._native import build_library, native_source

_SRC = native_source("filter_kernels.cpp")
_ALIGN_SRC = native_source("align_kernels.cpp")
_CHAIN_SRC = native_source("chain_kernels.cpp")
_CIRC_SRC = native_source("circ_kernels.cpp")
_LIB = None

MR_FIELDS = 20  # layout documented in filter_kernels.cpp batch_filter_pe

_lib = None


def _build() -> bool:
    global _LIB
    try:
        _LIB = build_library("filter", [_SRC, _ALIGN_SRC, _CHAIN_SRC,
                                          _CIRC_SRC], ["-pthread"])
        return True
    except Exception as e:  # pragma: no cover
        sys.stderr.write(f"[filter_native] build failed ({e}); "
                         "using python orchestration\n")
        return False


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _build():
        return None
    lib = ctypes.CDLL(_LIB)
    # raw-pointer mode (see chain_native.py): arrays pass as .ctypes.data
    p = ctypes.c_void_p
    ci = ctypes.c_int32
    cl = ctypes.c_int64
    anno_sig = [
        p, p, ci, p,
        p, p, p, p, p,
        p, p,
        p, p, p, ci,
        p, p,
        p, cl,
        p, ci,
    ]
    cfg_sig = [ci] * 12
    lib.batch_filter_pe.argtypes = (
        [p, p, ci, ci,
         p, p, p, p, p, p, ci, ci,
         p, cl] + anno_sig + cfg_sig + [p, ci])
    lib.batch_filter_pe.restype = None
    lib.batch_filter_se.argtypes = (
        [p, p, ci, ci,
         p, p, p, p, p, ci, ci,
         p, cl] + anno_sig + cfg_sig + [p, p, ci])
    lib.batch_filter_se.restype = None
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _u32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), dtype=np.uint32)


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), dtype=np.int32)


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), dtype=np.int64)


class NativeFilter:
    """Batched PE/SE mapping finish for one contig."""

    def __init__(self, db, contig: int, genome_codes: np.ndarray,
                 cfg: Config, align_type: int = 0):
        self.lib = _load()
        if self.lib is None:
            raise RuntimeError("native filter library unavailable")
        self.cfg = cfg
        self.contig = contig
        ca = db.contigs[contig]
        self.genome = np.ascontiguousarray(genome_codes, dtype=np.int8)
        self.iv_spos = _u32(ca.iv_spos)
        self.iv_epos = _u32(ca.iv_epos)
        self.n_iv = int(ca.iv_spos.shape[0])
        self.iv_seg_off = _i64(ca.iv_seg_off)
        self.seg_start = _u32(ca.seg_start)
        self.seg_end = _u32(ca.seg_end)
        self.seg_next = _u32(ca.seg_next)
        self.seg_gene = _i32(ca.seg_gene)
        self.seg_uid = _i32(ca.seg_uid)
        self.uid_tid_off = _i64(ca.uid_tid_off)
        self.uid_tid = _i32(ca.uid_tid)
        self.t2s_off = _i64(ca.t2s_off)
        self.t2s_state = np.ascontiguousarray(ca.t2s_state, dtype=np.uint8)
        self.trans_start = _i32(ca.trans_start_ind)
        self.n_trans = int(len(ca.transcript_ids))
        self.gene_start = _u32(ca.gene_start)
        self.gene_end = _u32(ca.gene_end)
        self.intr_bits = np.ascontiguousarray(ca.intronic.bits,
                                              dtype=np.uint8)
        # BitMask covers positions 0..length+1 (io/gtf.py BitMask)
        self.intr_len = int(ca.intronic.length) + 2
        shifts = db.con2chr[contig]
        self.chr_names: List[str] = [cs.contig for cs in shifts]
        self.shift_vals = _i64([cs.shift for cs in shifts])
        self.align_type = align_type

    def _anno_args(self):
        d = lambda a: a.ctypes.data
        return [d(self.iv_spos), d(self.iv_epos), self.n_iv,
                d(self.iv_seg_off),
                d(self.seg_start), d(self.seg_end), d(self.seg_next),
                d(self.seg_gene), d(self.seg_uid),
                d(self.uid_tid_off), d(self.uid_tid),
                d(self.t2s_off), d(self.t2s_state), d(self.trans_start),
                self.n_trans,
                d(self.gene_start), d(self.gene_end),
                d(self.intr_bits), self.intr_len,
                d(self.shift_vals), int(self.shift_vals.shape[0])]

    def _cfg_args(self):
        c = self.cfg
        return [c.kmer, c.max_ed, c.max_sc, c.band_width, c.max_tlen,
                c.scan_level, self.contig, 1, -3, -3, 8, self.align_type]

    @staticmethod
    def mr_to_state(mr, chr_names: List[str]) -> np.ndarray:
        """MatchedRead -> int64[MR_FIELDS] row."""
        try:
            chr_idx = chr_names.index(mr.chr_r1)
        except ValueError:
            chr_idx = -1
        return np.array([
            mr.type, mr.spos_r1, mr.epos_r1, mr.qspos_r1, mr.qepos_r1,
            mr.mlen_r1, mr.ed_r1, int(mr.r1_forward),
            mr.spos_r2, mr.epos_r2, mr.qspos_r2, mr.qepos_r2,
            mr.mlen_r2, mr.ed_r2, int(mr.r2_forward),
            mr.tlen, mr.junc_num, int(mr.gm_compatible),
            chr_idx, mr.contig_num], dtype=np.int64)

    @staticmethod
    def state_to_mr(st: np.ndarray, mr, chr_names: List[str]):
        """int64[MR_FIELDS] row -> MatchedRead fields in place.  One
        tolist() replaces 20 numpy scalar reads (this runs per read per
        batch in every batched finish path)."""
        (mr.type, mr.spos_r1, mr.epos_r1, mr.qspos_r1, mr.qepos_r1,
         mr.mlen_r1, mr.ed_r1, r1f, mr.spos_r2, mr.epos_r2, mr.qspos_r2,
         mr.qepos_r2, mr.mlen_r2, mr.ed_r2, r2f, mr.tlen, mr.junc_num,
         gm, ci, mr.contig_num) = st.tolist()
        mr.touched = True
        mr.r1_forward = bool(r1f)
        mr.r2_forward = bool(r2f)
        mr.gm_compatible = bool(gm)
        if 0 <= ci < len(chr_names):
            mr.chr_r1 = mr.chr_r2 = chr_names[ci]

    def filter_pe(self, seqs: np.ndarray, lens: np.ndarray,
                  ch_rpos: np.ndarray, ch_qpos: np.ndarray,
                  ch_clen: np.ndarray, ch_score: np.ndarray,
                  ch_n: np.ndarray, high: np.ndarray,
                  mr_state: np.ndarray, n_threads: int = None) -> None:
        """seqs int8 [4n, L] (r1f, r1rc, r2f, r2rc); chain arrays from
        NativeChainer.chain_batch over the same rows; mr_state int64
        [n, MR_FIELDS], updated in place."""
        n4, L = seqs.shape
        n = n4 // 4
        C = ch_clen.shape[1]
        NL = ch_rpos.shape[2]
        if n_threads is None:
            n_threads = self.cfg.resolved_threads
        a = [np.ascontiguousarray(seqs, dtype=np.int8), _i32(lens),
             _i32(ch_rpos), _i32(ch_qpos), _i32(ch_clen),
             np.ascontiguousarray(ch_score, dtype=np.float64),
             _i32(ch_n), _i32(high)]
        self.lib.batch_filter_pe(
            a[0].ctypes.data, a[1].ctypes.data, n, L,
            a[2].ctypes.data, a[3].ctypes.data, a[4].ctypes.data,
            a[5].ctypes.data, a[6].ctypes.data, a[7].ctypes.data, C, NL,
            self.genome.ctypes.data, int(self.genome.shape[0]),
            *self._anno_args(), *self._cfg_args(),
            mr_state.ctypes.data, n_threads)

    def filter_se(self, seqs: np.ndarray, lens: np.ndarray,
                  ch_rpos: np.ndarray, ch_qpos: np.ndarray,
                  ch_clen: np.ndarray, ch_score: np.ndarray,
                  ch_n: np.ndarray, mr_state: np.ndarray,
                  n_threads: int = None) -> np.ndarray:
        """seqs int8 [2n, L] (fwd, rc per read). Returns state int32[n]."""
        n2, L = seqs.shape
        n = n2 // 2
        C = ch_clen.shape[1]
        NL = ch_rpos.shape[2]
        out = np.zeros(n, dtype=np.int32)
        if n_threads is None:
            n_threads = self.cfg.resolved_threads
        a = [np.ascontiguousarray(seqs, dtype=np.int8), _i32(lens),
             _i32(ch_rpos), _i32(ch_qpos), _i32(ch_clen),
             np.ascontiguousarray(ch_score, dtype=np.float64), _i32(ch_n)]
        self.lib.batch_filter_se(
            a[0].ctypes.data, a[1].ctypes.data, n, L,
            a[2].ctypes.data, a[3].ctypes.data, a[4].ctypes.data,
            a[5].ctypes.data, a[6].ctypes.data, C, NL,
            self.genome.ctypes.data, int(self.genome.shape[0]),
            *self._anno_args(), *self._cfg_args(),
            mr_state.ctypes.data, out.ctypes.data, n_threads)
        return out
