"""circRNA calling stage (ProcessCirc equivalent).

Reference: src/process_circ.cpp.  Stage 2 re-reads the mapping stage's
"remain" FASTQ (sorted by packed-genome position), and for every CHIBSJ /
CHI2BSJ read pair re-chains the unmapped read segment against a dense
per-gene 8-mer table, re-extends with the edit-distance aligner, classifies
the split geometry (FR/RF vs. back-splice), realigns across the breakpoint,
and accumulates CircRes records that are grouped into the final
``.circ_report``.

Faithfully preserved reference quirk: the per-gene chaining runs in
gene-local coordinates (RegionalHashTable::create_table is called with
start=0, process_circ.cpp:858,875), so the annotation gates inside the chain
DP see local positions; chain rpos are shifted back to contig coordinates at
emission (chain.cpp:501).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import (Config, CHIBSJ, CHI2BSJ, CONCRD, ORPHAN, BPRES,
                      FR, RF, CR, NCR, MCR, UD, NF, CIRC_TYPE_NAMES,
                      MINLB, MAXUB, INF)
from ..ops.chain import Chain, chain_seeds_host
from ..ops.encode import decode_seq, kmer_hashes
from ..io.fasta import get_shift, ConShift
from .types import MatchedMate, MatchedRead
from .extend import TransExtension, GenomeView, AlignRes, EDIT_ALIGNMENT
from .mapping import ReadRecord
from . import categories as cat
from ..utils import logging as ulog
from ..utils.timing import GLOBAL_TIMER as T

MAXHIT = 1000     # hash_table.cpp:6
TOPCHAIN = 10     # process_circ.cpp:19


@dataclasses.dataclass
class CircRes:
    chr: str = ""
    rname: str = ""
    spos: int = 0
    epos: int = 0
    type: int = NF
    start_signal: str = ""
    end_signal: str = ""
    start_bp_ref: str = ""
    end_bp_ref: str = ""

    def sort_key(self):
        return (self.chr, self.spos, self.epos, self.type)

    def same_event(self, o: "CircRes") -> bool:
        return (self.chr == o.chr and self.spos == o.spos
                and self.epos == o.epos)


class RegionalHashTable:
    """Dense per-gene k-mer table (src/hash_table.cpp) as sorted arrays."""

    def __init__(self, window_size: int, gene_seq: np.ndarray,
                 seed_lim: int):
        self.window_size = window_size
        self.seed_lim = seed_lim
        h = kmer_hashes(gene_seq, window_size)  # -1 where N
        valid = h >= 0
        hv = h[valid]
        locs = np.nonzero(valid)[0].astype(np.int64)  # 0-based gene-local
        order = np.argsort(hv, kind="stable")         # locs stay ascending
        self._hv = hv[order]
        self._locs = locs[order]

    def find(self, hv: int) -> np.ndarray:
        """Locations of hv; empty when absent or count > MAXHIT
        (hash_table.cpp:74-77)."""
        lo = np.searchsorted(self._hv, hv, "left")
        hi = np.searchsorted(self._hv, hv, "right")
        if hi - lo > MAXHIT:
            return np.zeros(0, dtype=np.int64)
        return self._locs[lo:hi]

    def find_batch(self, hv_arr: np.ndarray, seed_lim: int):
        """Vectorized find over many hashes: returns (pos [NL, cap] int32
        0-based gene-local, cnt [NL] int32) with the same MAXHIT and
        seed_lim drops as the scalar path (counts above either limit
        become empty lists)."""
        lo = np.searchsorted(self._hv, hv_arr, "left")
        hi = np.searchsorted(self._hv, hv_arr, "right")
        cnt = (hi - lo).astype(np.int64)
        cnt[(cnt > MAXHIT) | (cnt > seed_lim)] = 0
        cap = max(1, int(cnt.max()) if len(cnt) else 1)
        offs = np.arange(cap, dtype=np.int64)
        idx = np.minimum(lo[:, None] + offs[None, :], len(self._locs) - 1) \
            if len(self._locs) else np.zeros((len(lo), cap), np.int64)
        pos = self._locs[idx] if len(self._locs) else \
            np.zeros((len(lo), cap), np.int64)
        mask = offs[None, :] < cnt[:, None]
        return np.where(mask, pos, 0).astype(np.int32), cnt.astype(np.int32)


class ProcessCirc:
    def __init__(self, db, gi, cfg: Config, output_prefix: str):
        """gi: GenomeIndex (codes used; hash table not needed here)."""
        self.db = db
        self.gi = gi
        self.cfg = cfg
        self.prefix = output_prefix
        self.circ_res: List[CircRes] = []
        self.candid_lines: List[str] = []
        self.window_size = cfg.circ_window
        self.step = cfg.circ_step
        self.contig = -1
        self.genome: Optional[GenomeView] = None
        self.ext: Optional[TransExtension] = None
        self.ctx = None
        self._ht_cache: Dict[int, RegionalHashTable] = {}
        # speculative-execution caches for the device extension path
        # (filled by _run_device's wave phase, consumed by the select
        # phase; key prefix = the read's slot in the current group)
        self._spec_key = None
        self._chain_cache: Dict = {}
        self._fec_cache: Dict = {}
        # per-call scratch (mirrors the reference's member seqs)
        self.fullmap_seq = None
        self.remain_seq = None
        self.r1_seq = None
        self.r2_seq = None
        self.fullmap_seq_len = 0
        self.remain_seq_len = 0
        self.r1_seq_len = 0
        self.r2_seq_len = 0

    # --- contig state ---
    def load_contig(self, contig: int):
        self.contig = contig
        self._ht_cache.clear()
        codes = self.gi.contigs[contig].codes
        self.genome = GenomeView(codes)
        self.ext = TransExtension(self.db, contig, self.genome, self.cfg,
                                  EDIT_ALIGNMENT)
        self.ctx = cat.RuleContext(self.db, contig, self.cfg)
        # native batched chainer for the gene-local re-chaining (same
        # event-order semantics as chain_seeds_host; None -> python oracle)
        try:
            from ..ops.chain_native import NativeChainer
            self.nchainer = NativeChainer(self.db.contigs[contig], self.cfg)
        except Exception:
            self.nchainer = None

    def _pac2str(self, start: int, length: int) -> str:
        s = self.genome.get(start, length)
        return decode_seq(s) if s is not None else "N" * length

    # --- per-gene hash table (process_circ.cpp:832-889) ---
    def check_removables(self, spos: int) -> None:
        """Evict cached gene tables whose gene ends before the current
        read position (process_circ.cpp:805-812): the candidate stream is
        position-sorted, so genes left behind never recur."""
        if not self._ht_cache:
            return
        dead = [gid for gid, (_, ge) in self._ht_cache.items() if ge < spos]
        for gid in dead:
            del self._ht_cache[gid]

    def get_hash_table(self, gene_start: int, gene_end: int,
                       gene_id: int) -> RegionalHashTable:
        ent = self._ht_cache.get(gene_id)
        if ent is None:
            gene_len = gene_end - gene_start + 1
            seq = self.genome.get(gene_start, gene_len)
            if seq is None:
                seq = np.zeros(0, dtype=np.int8)
            ht = RegionalHashTable(self.window_size, seq, self.cfg.seed_lim)
            self._ht_cache[gene_id] = (ht, gene_end)
            return ht
        return ent[0]

    # --- chaining over the gene (process_circ.cpp:678-737) ---
    def chaining(self, qspos: int, qepos: int, ht: RegionalHashTable,
                 remain_seq: np.ndarray, shift: int,
                 h: Optional[np.ndarray] = None) -> List[Chain]:
        w = self.window_size
        seq_len = qepos - qspos + 1
        if seq_len < w:
            return []
        if h is None:
            h = kmer_hashes(remain_seq, w)
        idx = np.arange(qspos - 1, qepos - w + 1, self.step)
        idx = idx[idx < len(h)]
        hv_arr = h[idx]
        ok = hv_arr >= 0
        if ulog.TRACE_LEVEL >= 2:  # process_circ.cpp:692 (N inside kmer)
            for _ in range(int((~ok).sum())):
                ulog.vaf(2, "Hash val not found!!!")
        qpos_arr = idx[ok].astype(np.int32)
        if len(qpos_arr) == 0:
            return []
        if self.nchainer is not None:
            pos_b, cnt_b = ht.find_batch(hv_arr[ok], self.cfg.seed_lim)
            rp, qp, cl, sc, n = self.nchainer.chain_batch(
                pos_b[None], cnt_b[None], qpos_arr[None],
                np.array([qepos], np.int32), k=w, shift=shift, n_threads=1,
                reuse_buffers=True)
            from ..ops.chain_native import NativeChainer
            chains = NativeChainer.to_chains(rp[0], qp[0], cl[0], sc[0],
                                             n[0], w)
        else:
            seed_lists = [ht.find(int(hv)) for hv in hv_arr[ok]]
            seed_lists = [
                (s if len(s) <= self.cfg.seed_lim
                 else np.zeros(0, dtype=np.int64)) for s in seed_lists]
            chains = chain_seeds_host(qepos, qpos_arr.astype(np.int64),
                                      seed_lists, self.cfg, self.db,
                                      self.contig, kmer=w, shift=shift)
        qpos_list = qpos_arr
        if ulog.TRACE_LEVEL >= 1 and chains:  # process_circ.cpp:714
            ulog.vaf(1, "Chaining score:%.4f,\t len: %d",
                     chains[0].score, len(chains))
        # keep the prefix of chains with non-increasing missed-kmer count
        # (process_circ.cpp:716-736)
        kmer_cnt = len(qpos_list)
        if ulog.TRACE_LEVEL >= 2:  # process_circ.cpp:717
            ulog.vaf(2, "Allowed missing kmers: %d",
                     (qepos - qspos + 1) // 20 * 3 + 1)
        least_miss = INF
        kept = []
        for ch in chains:
            missing = kmer_cnt - ch.chain_len
            if ulog.TRACE_LEVEL >= 2:  # :723 (also for the breaking one)
                ulog.vaf(2, "Actual missing: %d", missing)
            if missing > least_miss:
                break
            least_miss = missing
            kept.append(ch)
            if ulog.TRACE_LEVEL >= 1:  # :733 frag dump
                for i, fr in enumerate(ch.frags):
                    ulog.vaf(1, "#%d\tfrag[%d]: %d\t%d\t%d",
                             len(kept) - 1, i, fr.rpos - shift, fr.qpos,
                             fr.flen)
        return kept

    # --- exact coordinates for a candidate chain (process_circ.cpp:739-789)
    def find_exact_coord(self, mm_r1: MatchedMate, mm_r2: MatchedMate,
                         partial_mm: MatchedMate, direction: int, qspos: int,
                         rseq: np.ndarray, rlen: int, whole_len: int,
                         bc: Chain) -> bool:
        from .extend import run_gen
        return run_gen(self.find_exact_coord_g(
            mm_r1, mm_r2, partial_mm, direction, qspos, rseq, rlen,
            whole_len, bc), self.ext.svc)

    def find_exact_coord_g(self, mm_r1: MatchedMate, mm_r2: MatchedMate,
                           partial_mm: MatchedMate, direction: int,
                           qspos: int, rseq: np.ndarray, rlen: int,
                           whole_len: int, bc: Chain):
        """Generator form: yields alignment requests so a wave scheduler
        can batch the extension DPs of MANY candidates as device
        dispatches (the stage-2 device path; extend_batch.run_waves)."""
        cfg = self.cfg
        set_mm(bc, qspos, rlen, direction, partial_mm)
        qspos -= 1  # 0-based

        cat.overlap_to_spos(mm_r1, self.db, self.contig)
        cat.overlap_to_spos(mm_r2, self.db, self.contig)
        cat.overlap_to_spos(partial_mm, self.db, self.contig)

        common_tid = cat.same_transcript_multi(
            self.db, self.contig, [mm_r1, mm_r2, partial_mm], 3)
        if not common_tid:
            return False

        partial_mm.middle_ed = yield from self.ext.calc_middle_ed_g(
            bc, cfg.max_ed, rseq, rlen)
        if partial_mm.middle_ed > cfg.max_ed:
            return False
        partial_mm.is_concord = False
        if bc.chain_len <= 0:
            partial_mm.type = ORPHAN
            partial_mm.matched_len = 0
            return False
        err = partial_mm.middle_ed
        partial_mm.matched_len = rlen
        lok, err = yield from self.ext.extend_chain_left_g(
            common_tid, bc, rseq[qspos:], qspos, MINLB, partial_mm, err)
        if qspos == 0:
            rok, err = yield from self.ext.extend_chain_right_g(
                common_tid, bc, rseq, rlen, MAXUB, partial_mm, err)
        else:
            rok, err = yield from self.ext.extend_chain_right_g(
                common_tid, bc, rseq, whole_len, MAXUB, partial_mm, err)
        from .extend import update_match_mate_info
        update_match_mate_info(lok, rok, err, partial_mm, cfg)
        return partial_mm.type == CONCRD

    # --- split-map classification (process_circ.cpp:892-1130) ---
    def check_split_map_single(self, mm_r1, mm_r2, partial_mm,
                               r1_partial: bool, cr: CircRes) -> int:
        if r1_partial:
            split_ed = (mm_r1.right_ed + mm_r1.left_ed + mm_r1.middle_ed +
                        partial_mm.right_ed + partial_mm.left_ed +
                        partial_mm.middle_ed)
            if mm_r1.qspos < partial_mm.qspos:
                valid = self.final_check(mm_r2, mm_r1, partial_mm, cr)
            else:
                valid = self.final_check(mm_r2, partial_mm, mm_r1, cr)
        else:
            split_ed = (mm_r2.right_ed + mm_r2.left_ed + mm_r2.middle_ed +
                        partial_mm.right_ed + partial_mm.left_ed +
                        partial_mm.middle_ed)
            if mm_r2.qspos < partial_mm.qspos:
                valid = self.final_check(mm_r1, mm_r2, partial_mm, cr)
            else:
                valid = self.final_check(mm_r1, partial_mm, mm_r2, cr)
        if split_ed > self.cfg.max_ed:
            valid = UD
        return valid

    def check_split_map_double(self, mm_r1_1, mm_r2_1, mm_r1_2, mm_r2_2,
                               cr: CircRes) -> int:
        """process_circ.cpp:922-1130 (overlapping split mates)."""
        cfg = self.cfg
        r1_ed = (mm_r1_1.right_ed + mm_r1_1.left_ed + mm_r1_1.middle_ed +
                 mm_r1_2.right_ed + mm_r1_2.left_ed + mm_r1_2.middle_ed)
        r2_ed = (mm_r2_1.right_ed + mm_r2_1.left_ed + mm_r2_1.middle_ed +
                 mm_r2_2.right_ed + mm_r2_2.left_ed + mm_r2_2.middle_ed)
        if r1_ed > cfg.max_ed or r2_ed > cfg.max_ed:
            return UD
        mm_r1_l = mm_r1_1 if mm_r1_1.spos <= mm_r1_2.spos else mm_r1_2
        mm_r1_r = mm_r1_2 if mm_r1_1.spos <= mm_r1_2.spos else mm_r1_1
        mm_r2_l = mm_r2_1 if mm_r2_1.spos <= mm_r2_2.spos else mm_r2_2
        mm_r2_r = mm_r2_2 if mm_r2_1.spos <= mm_r2_2.spos else mm_r2_1
        r1_reg = mm_r1_l.qspos < mm_r1_r.qspos
        r2_reg = mm_r2_l.qspos < mm_r2_r.qspos

        if r1_reg and r2_reg:
            if mm_r1_l.dir == 1:
                if mm_r1_r.spos <= mm_r2_l.spos:
                    return FR
                if mm_r1_l.epos >= mm_r2_r.epos:
                    return RF
            if mm_r1_l.dir == -1:
                if mm_r2_r.spos <= mm_r1_l.spos:
                    return FR
                if mm_r2_l.epos >= mm_r1_r.epos:
                    return RF
        elif r1_reg and not r2_reg:
            full_mm = _copy_mm(mm_r1_l)
            if not full_mm.merge_to_right(mm_r1_r, cfg.max_ed):
                return UD
            self.remain_seq, self.remain_seq_len = self.r2_seq, self.r2_seq_len
            return self.final_check(full_mm, mm_r2_l, mm_r2_r, cr)
        elif not r1_reg and r2_reg:
            full_mm = _copy_mm(mm_r2_l)
            if not full_mm.merge_to_right(mm_r2_r, cfg.max_ed):
                return UD
            self.remain_seq, self.remain_seq_len = self.r1_seq, self.r1_seq_len
            return self.final_check(full_mm, mm_r1_l, mm_r1_r, cr)
        else:
            # BSJ on the overlap (process_circ.cpp:989-1127)
            if mm_r1_l.spos == mm_r2_l.spos and mm_r1_r.epos == mm_r2_r.epos:
                cat.overlap_to_spos(mm_r1_l, self.db, self.contig)
                cat.overlap_to_epos(mm_r1_r, self.db, self.contig)
                end_tids = self._collect_bp_tids_end(mm_r1_r)
                start_tids = self._collect_bp_tids_start(mm_r1_l)
                best_ed1 = cfg.max_ed + 1
                best_ed2 = cfg.max_ed + 1
                for (tid_s, sdiff) in start_tids:
                    for (tid_e, ediff) in end_tids:
                        if tid_s != tid_e or sdiff != ediff:
                            continue
                        common = [tid_s]
                        beg_bp = mm_r1_l.spos - mm_r1_l.sclen_left - sdiff
                        end_bp = mm_r1_r.epos + mm_r1_r.sclen_right - ediff
                        qcut = mm_r1_r.qepos + mm_r1_r.sclen_right - ediff
                        ed1 = self.split_realignment(
                            qcut, beg_bp, end_bp, self.r1_seq,
                            self.r1_seq_len, common)
                        if qcut < 2 or qcut + 2 > self.r1_seq_len:
                            es1 = ss1 = ""
                        else:
                            s = decode_seq(self.r1_seq[qcut - 2:qcut + 2])
                            es1, ss1 = s[:2], s[2:]
                        qcut2 = mm_r2_r.qepos + mm_r2_r.sclen_right - ediff
                        ed2 = self.split_realignment(
                            qcut2, beg_bp, end_bp, self.r2_seq,
                            self.r2_seq_len, common)
                        if qcut2 < 2 or qcut2 + 2 > self.r2_seq_len:
                            ss2 = es2 = ""
                        else:
                            s = decode_seq(self.r2_seq[qcut2 - 2:qcut2 + 2])
                            es2, ss2 = s[:2], s[2:]
                        if ed1 < best_ed1 and ed2 < best_ed2:
                            nsb = self._pac2str(beg_bp, 2)
                            neb = self._pac2str(end_bp - 1, 2)
                            if ss1 == "":
                                cr_set(cr, beg_bp, end_bp, ss2, es2, nsb, neb)
                            elif ss2 == "":
                                cr_set(cr, beg_bp, end_bp, ss1, es1, nsb, neb)
                            else:
                                cr_set(cr, beg_bp, end_bp,
                                       consensus2(ss1, ss2),
                                       consensus2(es1, es2), nsb, neb)
                            best_ed1, best_ed2 = ed1, ed2
                if best_ed1 <= cfg.max_ed and best_ed2 <= cfg.max_ed:
                    return CR
                qcut = mm_r1_r.qepos + mm_r1_r.sclen_right
                beg_bp = mm_r1_l.spos - mm_r1_l.sclen_left
                end_bp = mm_r1_r.epos + mm_r1_r.sclen_right
                if (qcut < 2 or qcut > self.r1_seq_len - 2
                        or qcut > self.r2_seq_len - 2):
                    return MCR
                s1 = decode_seq(self.r1_seq[qcut - 2:qcut + 2])
                s2 = decode_seq(self.r2_seq[qcut - 2:qcut + 2])
                cr_set(cr, beg_bp, end_bp,
                       consensus2(s1[2:], s2[2:]), consensus2(s1[:2], s2[:2]),
                       self._pac2str(beg_bp, 2), self._pac2str(end_bp - 1, 2))
                if start_tids and end_tids:
                    return NCR
                return MCR
        return UD

    # --- BP-adjacent transcript collection (process_circ.cpp:999-1031,
    #     1196-1242) ---
    def _collect_bp_tids_end(self, mm_right: MatchedMate
                             ) -> List[Tuple[int, int]]:
        """Transcripts whose exon END is within BPRES of the split right end."""
        db, c = self.db, self.contig
        ca = db.contigs[c]
        out = []
        ind = mm_right.exon_ind_epos
        while 0 <= ind < ca.n_intervals and \
                mm_right.spos < int(ca.iv_epos[ind]):
            for e in db.interval_segs(c, ind):
                diff = (mm_right.epos + mm_right.sclen_right -
                        int(ca.seg_end[e]))
                if abs(diff) <= BPRES:
                    for tid in db.seg_tids(c, e):
                        out.append((int(tid), diff))
            ind -= 1
        return out

    def _collect_bp_tids_start(self, mm_left: MatchedMate
                               ) -> List[Tuple[int, int]]:
        db, c = self.db, self.contig
        ca = db.contigs[c]
        out = []
        ind = mm_left.exon_ind_spos
        while 0 <= ind < ca.n_intervals and \
                mm_left.epos > int(ca.iv_spos[ind]):
            for e in db.interval_segs(c, ind):
                diff = (mm_left.spos - mm_left.sclen_left -
                        int(ca.seg_start[e]))
                if abs(diff) <= BPRES:
                    for tid in db.seg_tids(c, e):
                        out.append((int(tid), diff))
            ind += 1
        return out

    # --- final split check (process_circ.cpp:1136-1341) ---
    def final_check(self, full_mm: MatchedMate, split_mm_left: MatchedMate,
                    split_mm_right: MatchedMate, cr: CircRes) -> int:
        cfg = self.cfg
        if split_mm_left.epos < split_mm_right.spos:
            if full_mm.dir == 1:
                if full_mm.spos <= split_mm_left.spos:
                    return FR
                if full_mm.epos >= split_mm_right.epos:
                    return RF
            if full_mm.dir == -1:
                if full_mm.epos >= split_mm_right.epos:
                    return FR
                if full_mm.spos <= split_mm_left.spos:
                    return RF
        elif (split_mm_right.spos <= split_mm_left.spos
              and split_mm_left.epos >= split_mm_right.epos):
            # back-splice geometry (short circRNA allowed)
            if full_mm.spos < split_mm_right.spos:
                off = split_mm_right.spos - full_mm.spos
                sc_rem = cfg.max_sc - full_mm.sclen_left
                if off <= sc_rem:
                    full_mm.spos = split_mm_right.spos
                    full_mm.sclen_left += off
                    full_mm.qspos += off
                    full_mm.matched_len -= off
            if full_mm.epos > split_mm_left.epos:
                off = full_mm.epos - split_mm_left.epos
                sc_rem = cfg.max_sc - full_mm.sclen_right
                if off <= sc_rem:
                    full_mm.epos = split_mm_left.epos
                    full_mm.sclen_right += off
                    full_mm.qepos -= off
                    full_mm.matched_len -= off
            if (full_mm.spos >= split_mm_right.spos
                    and full_mm.epos <= split_mm_left.epos):
                db, c = self.db, self.contig
                cat.overlap_to_spos(full_mm, db, c)
                cat.overlap_to_epos(full_mm, db, c)
                cat.overlap_to_spos(split_mm_right, db, c)
                cat.overlap_to_epos(split_mm_right, db, c)
                cat.overlap_to_spos(split_mm_left, db, c)
                cat.overlap_to_epos(split_mm_left, db, c)

                end_tids = self._collect_bp_tids_end(split_mm_left)
                start_tids = self._collect_bp_tids_start(split_mm_right)

                best_ed = cfg.max_ed + 1
                for (tid_s, sdiff) in start_tids:
                    for (tid_e, ediff) in end_tids:
                        if tid_s != tid_e or sdiff != ediff:
                            continue
                        common = [tid_s]
                        qcut = (split_mm_left.qepos +
                                split_mm_left.sclen_right - ediff)
                        beg_bp = (split_mm_right.spos -
                                  split_mm_right.sclen_left - sdiff)
                        end_bp = (split_mm_left.epos +
                                  split_mm_left.sclen_right - ediff)

                        if full_mm.sclen_right > 0:
                            if full_mm.epos + full_mm.sclen_right > end_bp:
                                fm_qcut = full_mm.qepos + (end_bp -
                                                           full_mm.epos)
                                fm_ed = self.split_realignment(
                                    fm_qcut, beg_bp, end_bp,
                                    self.fullmap_seq, self.fullmap_seq_len,
                                    common)
                                if fm_ed > cfg.max_ed:
                                    continue
                            elif full_mm.sclen_right > cfg.max_sc:
                                continue
                        if full_mm.sclen_left > 0:
                            if full_mm.spos - full_mm.sclen_left < beg_bp:
                                fm_qcut = full_mm.sclen_left + \
                                    (full_mm.spos - beg_bp)
                                fm_ed = self.split_realignment(
                                    fm_qcut, beg_bp, end_bp,
                                    self.fullmap_seq, self.fullmap_seq_len,
                                    common)
                                if fm_ed > cfg.max_ed:
                                    continue
                            elif full_mm.sclen_left > cfg.max_sc:
                                continue

                        ed = self.split_realignment(
                            qcut, beg_bp, end_bp, self.remain_seq,
                            self.remain_seq_len, common)
                        if ed < best_ed:
                            s = decode_seq(self.remain_seq[qcut - 2:qcut + 2])
                            cr_set(cr, beg_bp, end_bp, s[2:], s[:2],
                                   self._pac2str(beg_bp, 2),
                                   self._pac2str(end_bp - 1, 2))
                            if ed == 0:
                                return CR
                            best_ed = ed
                if best_ed <= cfg.max_ed:
                    return CR
                qcut = split_mm_left.qepos + split_mm_left.sclen_right
                beg_bp = split_mm_right.spos - split_mm_right.sclen_left
                end_bp = split_mm_left.epos + split_mm_left.sclen_right
                if qcut < 2 or qcut > self.remain_seq_len - 2:
                    return MCR
                s = decode_seq(self.remain_seq[qcut - 2:qcut + 2])
                cr_set(cr, beg_bp, end_bp, s[:2], s[2:],
                       self._pac2str(beg_bp, 2), self._pac2str(end_bp - 1, 2))
                if start_tids and end_tids:
                    return NCR
                return MCR
        return self.rescue_overlapping_bsj(full_mm, split_mm_left,
                                           split_mm_right, cr)

    # --- realign across the breakpoint (process_circ.cpp:1343-1392) ---
    def split_realignment(self, qcutpos: int, beg_bp: int, end_bp: int,
                          seq: np.ndarray, seq_len: int,
                          common_tid: List[int]) -> int:
        cfg = self.cfg
        if qcutpos <= 0 or qcutpos >= seq_len:
            return cfg.max_ed + 1
        last_bp = self.genome.get(end_bp, 1)
        last_err = 0 if (last_bp is not None
                         and seq[qcutpos - 1] == last_bp[0]) else 1
        first_bp = self.genome.get(beg_bp, 1)
        first_err = 0 if (first_bp is not None
                          and seq[qcutpos] == first_bp[0]) else 1

        best_left = AlignRes(beg_bp)
        best_right = AlignRes(end_bp)
        lok, _ = self.ext.extend_left(
            common_tid, seq, end_bp, qcutpos - 1, cfg.max_ed - last_err,
            beg_bp, best_left)
        rok, _ = self.ext.extend_right(
            common_tid, seq[qcutpos + 1:], beg_bp, seq_len - qcutpos - 1,
            cfg.max_ed - first_err, end_bp, best_right)
        best_left.ed += last_err
        best_right.ed += first_err
        if lok and rok and best_left.ed + best_right.ed <= cfg.max_ed:
            return best_left.ed + best_right.ed
        return cfg.max_ed + 1

    # --- full-mate split realignment (process_circ.cpp:1394-1489) ---
    def split_realignment_full(self, qcutpos: int, full_mm: MatchedMate,
                               split_mm_left: MatchedMate,
                               split_mm_right: MatchedMate,
                               cr: CircRes) -> int:
        cfg = self.cfg
        if qcutpos <= 0 or qcutpos >= self.fullmap_seq_len:
            return UD
        qcutpos += full_mm.qspos - 1
        if qcutpos <= 0 or qcutpos >= self.fullmap_seq_len:
            return UD
        db, c = self.db, self.contig
        cat.overlap_to_spos(split_mm_left, db, c)
        cat.overlap_to_epos(split_mm_left, db, c)
        cat.overlap_to_spos(split_mm_right, db, c)
        cat.overlap_to_epos(split_mm_right, db, c)
        common = cat.same_transcript_multi(
            db, c, [split_mm_left, split_mm_right], 2)
        if not common:
            return UD
        lbp = self.genome.get(split_mm_left.epos, 1)
        last_err = 0 if (lbp is not None and
                         self.fullmap_seq[qcutpos - 1] == lbp[0]) else 1
        fbp = self.genome.get(split_mm_right.spos, 1)
        first_err = 0 if (fbp is not None and
                          self.fullmap_seq[qcutpos] == fbp[0]) else 1
        best_left = AlignRes(split_mm_right.spos)
        best_right = AlignRes(split_mm_left.epos)
        lok, lm_pos = self.ext.extend_left(
            common, self.fullmap_seq, split_mm_left.epos, qcutpos - 1,
            cfg.max_ed - last_err, split_mm_right.spos, best_left)
        rok, rm_pos = self.ext.extend_right(
            common, self.fullmap_seq[qcutpos + 1:], split_mm_right.spos,
            self.fullmap_seq_len - qcutpos - 1, cfg.max_ed - first_err,
            split_mm_left.epos, best_right)
        best_left.ed += last_err
        best_right.ed += first_err
        if not lok or not rok or best_left.ed + best_right.ed > cfg.max_ed:
            return UD
        nsl = MatchedMate()
        nsl.spos = lm_pos
        nsl.epos = split_mm_left.epos
        nsl.qspos = best_left.sclen
        nsl.qepos = qcutpos
        nsl.dir = full_mm.dir
        nsl.matched_len = qcutpos - best_left.sclen
        nsl.sclen_left = best_left.sclen
        nsl.sclen_right = 0
        nsl.left_ed = best_left.ed
        nsl.right_ed = 0
        nsl.middle_ed = 0
        nsl.left_ok = True
        nsl.right_ok = True
        nsr = MatchedMate()
        nsr.spos = split_mm_right.spos
        nsr.epos = rm_pos
        nsr.qspos = qcutpos + 1
        nsr.qepos = self.fullmap_seq_len - best_right.sclen
        nsr.dir = full_mm.dir
        nsr.matched_len = self.fullmap_seq_len - qcutpos - best_right.sclen
        nsr.sclen_left = 0
        nsr.sclen_right = best_right.sclen
        nsr.left_ed = 0
        nsr.right_ed = best_right.ed
        nsr.middle_ed = 0
        nsr.left_ok = True
        nsr.right_ok = True
        self.r1_seq, self.r1_seq_len = self.remain_seq, self.remain_seq_len
        self.r2_seq, self.r2_seq_len = self.fullmap_seq, self.fullmap_seq_len
        return self.check_split_map_double(split_mm_right, nsr,
                                           split_mm_left, nsl, cr)

    # --- rescue via full-mate junctions (process_circ.cpp:1491-1552) ---
    def rescue_overlapping_bsj(self, full_mm: MatchedMate,
                               split_mm_left: MatchedMate,
                               split_mm_right: MatchedMate,
                               cr: CircRes) -> int:
        if full_mm.spos < split_mm_right.spos <= full_mm.epos:
            cat.get_junctions(self.ctx, full_mm)
            qcut = 0
            for ji in full_mm.junc_info:
                if ji.end == split_mm_right.spos:
                    qcut = ji.bp_matched
            if qcut == 0:
                qcut = split_mm_right.spos - full_mm.spos
            if self.split_realignment_full(qcut, full_mm, split_mm_left,
                                           split_mm_right, cr) == CR:
                return CR
        if full_mm.spos <= split_mm_left.epos < full_mm.epos:
            cat.get_junctions(self.ctx, full_mm)
            qcut = 0
            for ji in full_mm.junc_info:
                if ji.beg == split_mm_left.epos:
                    qcut = ji.bp_matched
            if qcut == 0:
                qcut = full_mm.matched_len - (full_mm.epos -
                                              split_mm_left.epos)
            if self.split_realignment_full(qcut, full_mm, split_mm_left,
                                           split_mm_right, cr) == CR:
                return CR
        return UD

    # --- per-read entry points (process_circ.cpp:334-645) ---
    def call_circ(self, rec1: ReadRecord, rec2: ReadRecord):
        if ulog.TRACE_LEVEL >= 2:  # process_circ.cpp:346-347
            from ..ops.encode import decode_seq
            mr = rec1.mr
            ulog.vaf(2, "%s\n%s", decode_seq(rec1.seq),
                     decode_seq(rec2.seq))
            ulog.vaf(2, "%s\t%s\t%d\t%d\t%d\t%d\t%d\t%d\t%d\t%d",
                     rec1.rname, mr.chr_r1, mr.spos_r1, mr.epos_r1,
                     mr.mlen_r1, mr.spos_r2, mr.epos_r2, mr.mlen_r2,
                     mr.tlen, mr.type)
        self.fullmap_seq = self.remain_seq = None
        self.r1_seq = self.r2_seq = None
        self.fullmap_seq_len = self.remain_seq_len = 0
        self.r1_seq_len = self.r2_seq_len = 0
        self.check_removables(rec1.mr.spos_r1)
        if rec1.mr.type == CHIBSJ:
            self.call_circ_single_split(rec1, rec2)
        elif rec1.mr.type == CHI2BSJ:
            self.call_circ_double_split(rec1, rec2)

    def _conloc(self, mr: MatchedRead):
        from ..io.fasta import chrloc2conloc
        _, s1, e1 = chrloc2conloc(self.db.chr2con, mr.chr_r1, mr.spos_r1,
                                  mr.epos_r1)
        _, s2, e2 = chrloc2conloc(self.db.chr2con, mr.chr_r2, mr.spos_r2,
                                  mr.epos_r2)
        out = dataclasses.replace(mr)
        out.spos_r1, out.epos_r1 = s1, e1
        out.spos_r2, out.epos_r2 = s2, e2
        return out

    def _single_split_setup(self, rec1: ReadRecord, rec2: ReadRecord):
        """The deterministic head of call_circ_single_split (partial-mate
        selection, remain window, gene overlap), shared with the
        speculative device wave phase so both enumerate IDENTICAL
        candidates.  Returns None on the early exits, else a dict."""
        mr = self._conloc(rec1.mr)
        r1_partial = mr.mlen_r1 < mr.mlen_r2
        if r1_partial:
            remain = rec1.seq if mr.r1_forward else rec1.rcseq
            fullm = rec2.seq if mr.r2_forward else rec2.rcseq
            self.remain_seq_len = rec1.seq_len
            self.fullmap_seq_len = rec2.seq_len
        else:
            remain = rec2.seq if mr.r2_forward else rec2.rcseq
            fullm = rec1.seq if mr.r1_forward else rec1.rcseq
            self.remain_seq_len = rec2.seq_len
            self.fullmap_seq_len = rec1.seq_len
        self.remain_seq = remain
        self.fullmap_seq = fullm

        mm_r1 = MatchedMate.from_matched_read(mr, 1, rec1.seq_len, r1_partial)
        mm_r2 = MatchedMate.from_matched_read(mr, 2, rec2.seq_len,
                                              not r1_partial)
        if r1_partial:
            right_matched = (mm_r1.qspos - 1) > (rec1.seq_len - mm_r1.qepos)
            qspos = 1 if right_matched else mm_r1.qepos + 1
            qepos = (mm_r1.qspos - 1) if right_matched else rec1.seq_len
            whole_len = rec1.seq_len
        else:
            right_matched = (mm_r2.qspos - 1) > (rec2.seq_len - mm_r2.qepos)
            qspos = 1 if right_matched else mm_r2.qepos + 1
            qepos = (mm_r2.qspos - 1) if right_matched else rec2.seq_len
            whole_len = rec2.seq_len

        remain_len = qepos - qspos + 1
        if qepos < qspos or remain_len < self.window_size:
            return None
        if ulog.TRACE_LEVEL >= 2:  # process_circ.cpp:421-422
            from ..ops.encode import decode_seq
            ulog.vaf(2, "R%d partial: [%d-%d]", 1 if r1_partial else 2,
                     qspos, qepos)
            ulog.vaf(2, "%s", decode_seq(remain))
        gene_iv = self.db.gene_overlap(self.contig, mm_r1.spos)
        if gene_iv is None:
            ulog.vaf(2, "Gene not found!")  # process_circ.cpp:403
            return None
        return dict(mr=mr, r1_partial=r1_partial, remain=remain,
                    fullm=fullm, mm_r1=mm_r1, mm_r2=mm_r2, qspos=qspos,
                    qepos=qepos, whole_len=whole_len,
                    remain_len=remain_len, gene_iv=gene_iv)

    def call_circ_single_split(self, rec1: ReadRecord, rec2: ReadRecord):
        cfg = self.cfg
        su = self._single_split_setup(rec1, rec2)
        if su is None:
            return
        (mr, r1_partial, remain, mm_r1, mm_r2, qspos, qepos, whole_len,
         remain_len, gene_iv) = (su["mr"], su["r1_partial"], su["remain"],
                                 su["mm_r1"], su["mm_r2"], su["qspos"],
                                 su["qepos"], su["whole_len"],
                                 su["remain_len"], su["gene_iv"])
        ca = self.db.contigs[self.contig]
        best_cr = CircRes(type=NF)
        h_remain = kmer_hashes(remain, self.window_size)
        if ulog.TRACE_LEVEL >= 2:  # process_circ.cpp:406
            ulog.vaf(2, "# Gene overlaps: %d",
                     int(ca.gv_seg_off[gene_iv + 1])
                     - int(ca.gv_seg_off[gene_iv]))
        for e in range(int(ca.gv_seg_off[gene_iv]),
                       int(ca.gv_seg_off[gene_iv + 1])):
            gs = int(ca.gv_gene_start[e])
            ge = int(ca.gv_gene_end[e])
            gid = int(ca.gv_gene_id[e])
            ckey = (self._spec_key, e) if self._spec_key is not None \
                else None
            if ckey is not None and ckey in self._chain_cache:
                chains = self._chain_cache[ckey]
            else:
                ht = self.get_hash_table(gs, ge, gid)
                chains = self.chaining(qspos, qepos, ht, remain, gs,
                                       h=h_remain)
            if not chains:
                continue
            forward = mr.r1_forward if r1_partial else mr.r2_forward
            direction = 1 if forward else -1
            for ci_, ch in enumerate(chains[:TOPCHAIN]):
                hit = (self._fec_cache.get((self._spec_key, e, ci_))
                       if self._spec_key is not None else None)
                if hit is not None:
                    partial_mm = hit
                else:
                    partial_mm = MatchedMate.default(cfg.max_ed)
                    self.find_exact_coord(mm_r1, mm_r2, partial_mm,
                                          direction, qspos, remain,
                                          remain_len, whole_len, ch)
                if partial_mm.type != CONCRD:
                    continue
                con_shift = get_shift(self.db.con2chr, self.contig,
                                      mm_r1.spos)
                if ulog.TRACE_LEVEL >= 2:  # process_circ.cpp:441
                    ulog.vaf(2, "Coordinates: [%d-%d]",
                             partial_mm.spos - con_shift.shift,
                             partial_mm.epos - con_shift.shift)
                cr = CircRes()
                typ = self.check_split_map_single(mm_r1, mm_r2, partial_mm,
                                                  r1_partial, cr)
                self.candid_lines.append(self._candid_line_single(
                    rec1.rname, mm_r1, mm_r2, partial_mm, con_shift, typ))
                if typ < CR:
                    best_cr.type = typ
                    return
                if CR <= typ <= MCR and typ < best_cr.type:
                    best_cr = CircRes(
                        chr=con_shift.contig, rname=rec1.rname,
                        spos=cr.spos - con_shift.shift,
                        epos=cr.epos - con_shift.shift, type=typ,
                        start_signal=cr.start_signal,
                        end_signal=cr.end_signal,
                        start_bp_ref=cr.start_bp_ref,
                        end_bp_ref=cr.end_bp_ref)
                    if typ == CR:
                        self.circ_res.append(best_cr)
                        return
        if CR <= best_cr.type <= MCR:
            self.circ_res.append(best_cr)
        if ulog.TRACE_LEVEL >= 1:
            ulog.vaf(1, "circ %s: best type %d at %d-%d", rec1.rname,
                     best_cr.type, best_cr.spos, best_cr.epos)

    def call_circ_double_split(self, rec1: ReadRecord, rec2: ReadRecord):
        ulog.vaf(2, "Double split read...")  # process_circ.cpp:487
        cfg = self.cfg
        mr = self._conloc(rec1.mr)
        r1_remain = rec1.seq if mr.r1_forward else rec1.rcseq
        r2_remain = rec2.seq if mr.r2_forward else rec2.rcseq
        self.r1_seq, self.r2_seq = r1_remain, r2_remain
        self.r1_seq_len, self.r2_seq_len = rec1.seq_len, rec2.seq_len

        r1_right = (mr.qspos_r1 - 1) > (rec1.seq_len - mr.qepos_r1)
        r2_right = (mr.qspos_r2 - 1) > (rec2.seq_len - mr.qepos_r2)
        r1_qspos = 1 if r1_right else mr.qepos_r1 + 1
        r2_qspos = 1 if r2_right else mr.qepos_r2 + 1
        r1_qepos = (mr.qspos_r1 - 1) if r1_right else rec1.seq_len
        r2_qepos = (mr.qspos_r2 - 1) if r2_right else rec2.seq_len
        r1_len = r1_qepos - r1_qspos + 1
        r2_len = r2_qepos - r2_qspos + 1
        if r1_len < self.window_size and r2_len < self.window_size:
            return
        if r1_len < self.window_size or r2_len < self.window_size:
            self.call_circ_single_split(rec1, rec2)
        if ulog.TRACE_LEVEL >= 2:  # process_circ.cpp:545-548
            ulog.vaf(2, "R1 partial: [%d-%d]", r1_qspos, r1_qepos)
            ulog.vaf(2, "remain: %s",
                     decode_seq(r1_remain[r1_qspos - 1:r1_qepos]))
            ulog.vaf(2, "R2 partial: [%d-%d]", r2_qspos, r2_qepos)
            ulog.vaf(2, "remain: %s",
                     decode_seq(r2_remain[r2_qspos - 1:r2_qepos]))
        gene_iv = self.db.gene_overlap(self.contig, mr.spos_r1)
        if gene_iv is None:
            ulog.vaf(2, "Gene not found!")  # process_circ.cpp:525
            return
        ca0 = self.db.contigs[self.contig]
        if ulog.TRACE_LEVEL >= 2:  # process_circ.cpp:528
            ulog.vaf(2, "# Gene overlaps: %d",
                     int(ca0.gv_seg_off[gene_iv + 1]
                         - ca0.gv_seg_off[gene_iv]))
        mm_r1 = MatchedMate.from_matched_read(mr, 1, rec1.seq_len, True)
        mm_r2 = MatchedMate.from_matched_read(mr, 2, rec2.seq_len, True)
        ca = self.db.contigs[self.contig]
        best_cr = CircRes(type=NF)
        h_r1 = kmer_hashes(r1_remain, self.window_size)
        h_r2 = kmer_hashes(r2_remain, self.window_size)
        for e in range(int(ca.gv_seg_off[gene_iv]),
                       int(ca.gv_seg_off[gene_iv + 1])):
            gs = int(ca.gv_gene_start[e])
            ge = int(ca.gv_gene_end[e])
            gid = int(ca.gv_gene_id[e])
            ht = self.get_hash_table(gs, ge, gid)
            bc1 = self.chaining(r1_qspos, r1_qepos, ht, r1_remain, gs,
                                h=h_r1)
            bc2 = self.chaining(r2_qspos, r2_qepos, ht, r2_remain, gs,
                                h=h_r2)
            if not bc1 and not bc2:
                continue
            if not bc1 or not bc2:
                self.call_circ_single_split(rec1, rec2)
                continue
            for ch1 in bc1[:TOPCHAIN]:
                for ch2 in bc2[:TOPCHAIN]:
                    r1_pm = MatchedMate.default(cfg.max_ed)
                    r2_pm = MatchedMate.default(cfg.max_ed)
                    set_mm(ch1, r1_qspos, r1_len, mm_r1.dir, r1_pm)
                    set_mm(ch2, r2_qspos, r2_len, mm_r2.dir, r2_pm)
                    cat.overlap_to_spos(mm_r1, self.db, self.contig)
                    cat.overlap_to_spos(mm_r2, self.db, self.contig)
                    cat.overlap_to_spos(r1_pm, self.db, self.contig)
                    cat.overlap_to_spos(r2_pm, self.db, self.contig)
                    common = cat.same_transcript_multi(
                        self.db, self.contig, [mm_r1, mm_r2, r1_pm, r2_pm], 4)
                    if not common:
                        continue
                    if int(ch1.rpos[0]) <= int(ch2.rpos[0]):
                        success = self.ext.extend_both_mates(
                            ch1, ch2, common, r1_remain, r2_remain,
                            r1_qspos, r2_qspos, r1_qepos, r2_qepos,
                            r1_pm, r2_pm)
                    else:
                        success = self.ext.extend_both_mates(
                            ch2, ch1, common, r2_remain, r1_remain,
                            r2_qspos, r1_qspos, r2_qepos, r1_qepos,
                            r2_pm, r1_pm)
                    if not success:
                        continue
                    if r1_pm.type == CONCRD and r2_pm.type == CONCRD:
                        con_shift = get_shift(self.db.con2chr, self.contig,
                                              mm_r1.spos)
                        if ulog.TRACE_LEVEL >= 2:  # :605-608
                            ulog.vaf(2, "R1 Partial Coordinates: [%d-%d]",
                                     r1_pm.spos - con_shift.shift,
                                     r1_pm.epos - con_shift.shift)
                            ulog.vaf(2, "R2 Partial Coordinates: [%d-%d]",
                                     r2_pm.spos - con_shift.shift,
                                     r2_pm.epos - con_shift.shift)
                        cr = CircRes()
                        typ = self.check_split_map_double(
                            mm_r1, mm_r2, r1_pm, r2_pm, cr)
                        self.candid_lines.append(self._candid_line_double(
                            rec1.rname, mm_r1, mm_r2, r1_pm, r2_pm,
                            con_shift, typ))
                        if typ < CR:
                            best_cr.type = typ
                            return
                        if CR <= typ <= MCR and typ < best_cr.type:
                            best_cr = CircRes(
                                chr=con_shift.contig, rname=rec1.rname,
                                spos=cr.spos - con_shift.shift,
                                epos=cr.epos - con_shift.shift, type=typ,
                                start_signal=cr.start_signal,
                                end_signal=cr.end_signal,
                                start_bp_ref=cr.start_bp_ref,
                                end_bp_ref=cr.end_bp_ref)
                            if typ == CR:
                                self.circ_res.append(best_cr)
                                return
        if CR <= best_cr.type <= MCR:
            self.circ_res.append(best_cr)
        else:
            self.call_circ_single_split(rec1, rec2)

    # --- candidate pam lines (process_circ.cpp:1685-1711) ---
    def _candid_line_single(self, rname, mm_r1, mm_r2, partial_mm,
                            con_shift: ConShift, typ: int) -> str:
        sh = con_shift.shift
        return (f"{rname}\t{con_shift.contig}\t"
                f"{partial_mm.spos - sh}\t{partial_mm.epos - sh}\t"
                f"{partial_mm.qspos}\t{partial_mm.matched_len}\t"
                f"{partial_mm.dir}\t"
                f"{mm_r1.spos - sh}\t{mm_r1.epos - sh}\t{mm_r1.qspos}\t"
                f"{mm_r1.matched_len}\t{mm_r1.dir}\t"
                f"{mm_r2.spos - sh}\t{mm_r2.epos - sh}\t{mm_r2.qspos}\t"
                f"{mm_r2.matched_len}\t{mm_r2.dir}\t{typ}")

    def _candid_line_double(self, rname, mm_r1, mm_r2, r1_pm, r2_pm,
                            con_shift: ConShift, typ: int) -> str:
        sh = con_shift.shift
        return (f"{rname}\t{con_shift.contig}\t"
                f"{r1_pm.spos - sh}\t{r1_pm.epos - sh}\t{r1_pm.qspos}\t"
                f"{r1_pm.matched_len}\t{r1_pm.dir}\t"
                f"{r2_pm.spos - sh}\t{r2_pm.epos - sh}\t{r2_pm.qspos}\t"
                f"{r2_pm.matched_len}\t{r2_pm.dir}\t"
                f"{mm_r1.spos - sh}\t{mm_r1.epos - sh}\t{mm_r1.qspos}\t"
                f"{mm_r1.matched_len}\t{mm_r1.dir}\t"
                f"{mm_r2.spos - sh}\t{mm_r2.epos - sh}\t{mm_r2.qspos}\t"
                f"{mm_r2.matched_len}\t{mm_r2.dir}\t{typ}")

    # --- stream + report (process_circ.cpp:195-331, 1570-1631) ---
    def run(self, pairs, native: Optional[bool] = None) -> None:
        """pairs: iterable of (rec1, rec2) already sorted by genome_spos.

        native=None (default) routes through the batched C++ stage-2
        engine (ops/circ_native.py) when available and per-read tracing is
        off; native=False forces the per-read Python oracle."""
        if native is None:
            native = ulog.TRACE_LEVEL == 0
        if native:
            # Materialize ONCE so the Python fallback below sees the same
            # records if the native engine raises (pairs is usually the
            # iter_sorted_remain generator, which a failed native attempt
            # would otherwise exhaust).
            pairs = list(pairs)
            try:
                self._run_native(pairs)
                return
            except Exception as e:  # pragma: no cover - fallback only
                import sys
                sys.stderr.write(f"[circ] native stage-2 unavailable "
                                 f"({e}); using python path\n")
        for line, (rec1, rec2) in enumerate(pairs):
            # process_circ.cpp:290 counts streamed FASTQ records
            ulog.vaf(2, "Line: %d", line)
            if rec1.mr.contig_num != self.contig:
                self.load_contig(rec1.mr.contig_num)
            self.call_circ(rec1, rec2)

    def _run_native(self, pairs: List) -> None:
        """Batched native stage 2: one C++ call per contig run of the
        sorted stream; Python only formats report/candidate lines."""
        from ..ops.circ_native import NativeCirc, sig_str
        from ..ops.filter_native import NativeFilter
        i = 0
        n_all = len(pairs)
        while i < n_all:
            contig = pairs[i][0].mr.contig_num
            j = i
            while j < n_all and pairs[j][0].mr.contig_num == contig:
                j += 1
            chunk = pairs[i:j]
            i = j
            nc = NativeCirc(self.db, contig, self.gi.contigs[contig].codes,
                            self.cfg)
            n = len(chunk)
            with T.phase("circ_prep"):
                L = max(max(r1.seq_len, r2.seq_len) for r1, r2 in chunk)
                seqs = np.zeros((4 * n, L), dtype=np.int8)
                lens = np.zeros(4 * n, dtype=np.int32)
                mr_state = np.zeros((n, 20), dtype=np.int64)
                evict = np.zeros(n, dtype=np.int64)
                rnames = []
                for p, (r1, r2) in enumerate(chunk):
                    seqs[4 * p, :r1.seq_len] = r1.seq
                    seqs[4 * p + 1, :r1.seq_len] = r1.rcseq
                    seqs[4 * p + 2, :r2.seq_len] = r2.seq
                    seqs[4 * p + 3, :r2.seq_len] = r2.rcseq
                    lens[4 * p] = lens[4 * p + 1] = r1.seq_len
                    lens[4 * p + 2] = lens[4 * p + 3] = r2.seq_len
                    mr_state[p] = NativeFilter.mr_to_state(r1.mr,
                                                           nc.chr_names)
                    evict[p] = r1.mr.spos_r1
                    rnames.append(r1.rname)
                chr_idx = mr_state[:, 18]
                if (chr_idx < 0).any():
                    raise RuntimeError("unmapped chr name in BSJ stream")
                # chr-relative -> contig coordinates (circ.py _conloc)
                sh = nc.shift_vals[chr_idx]
                for col in (1, 2, 8, 9):
                    mr_state[:, col] += sh
            with T.phase("circ_native"):
                res, cand = nc.run(seqs, lens, mr_state, evict)
            for row in res.tolist():
                ri, typ, ci_ = row[0], row[1], row[2]
                self.circ_res.append(CircRes(
                    chr=nc.chr_names[ci_], rname=rnames[ri],
                    spos=row[3], epos=row[4], type=typ,
                    start_signal=sig_str(row[5:7]),
                    end_signal=sig_str(row[7:9]),
                    start_bp_ref=sig_str(row[9:11]),
                    end_bp_ref=sig_str(row[11:13])))
            for row in cand.tolist():
                ri, kind, ci_ = row[0], row[1], row[2]
                name = nc.chr_names[ci_]
                f = row[3:]
                if kind == 0:
                    # partial, mm_r1, mm_r2, typ (circ.py
                    # _candid_line_single order: partial first)
                    self.candid_lines.append(
                        f"{rnames[ri]}\t{name}\t"
                        + "\t".join(str(v) for v in f[:15])
                        + f"\t{f[15]}")
                else:
                    self.candid_lines.append(
                        f"{rnames[ri]}\t{name}\t"
                        + "\t".join(str(v) for v in f[:20])
                        + f"\t{f[20]}")

    def report_events(self, path: str):
        with open(path, "w") as f:
            if not self.circ_res:
                return
            res = sorted(self.circ_res, key=CircRes.sort_key)
            groups: List[List[CircRes]] = []
            for r in res:
                if groups and r.same_event(groups[-1][0]) \
                        and r.type == groups[-1][0].type:
                    groups[-1].append(r)
                elif groups and r.same_event(groups[-1][0]):
                    # same (chr,spos,epos) but different type: the reference
                    # groups on equality of (chr,spos,epos) only
                    groups[-1].append(r)
                else:
                    groups.append([r])
            for grp in groups:
                last = grp[0]
                if last.type != CR:
                    continue
                ss = consensus_many([g.start_signal for g in grp])
                es = consensus_many([g.end_signal for g in grp])
                ok = "Pass" if (ss == last.start_bp_ref
                                and es == last.end_bp_ref) else "Fail"
                names = ",".join(g.rname for g in grp)
                f.write(f"{last.chr}\t{last.spos}\t{last.epos}\t{len(grp)}\t"
                        f"{CIRC_TYPE_NAMES[last.type]}\t{ss}-{es}\t"
                        f"{last.start_bp_ref}-{last.end_bp_ref}\t{ok}\t"
                        f"{names}\n")

    def write_candidates(self, path: str):
        with open(path, "w") as f:
            for line in self.candid_lines:
                f.write(line + "\n")


# --- helpers -----------------------------------------------------------------

def set_mm(ch: Chain, qspos: int, rlen: int, direction: int,
           mm: MatchedMate):
    """process_circ.cpp:1713-1752."""
    spos = int(ch.rpos[0])
    epos = int(ch.rpos[-1] + ch.flen[-1] - 1)
    qepos = qspos + rlen - 1
    mm.set(spos, epos, qspos, qepos, direction)


def _copy_mm(mm: MatchedMate) -> MatchedMate:
    return dataclasses.replace(mm, junc_info=list(mm.junc_info))


def cr_set(cr: CircRes, sp, ep, ssignal, esignal, sbref, ebref):
    cr.spos = sp
    cr.epos = ep
    cr.start_signal = ssignal
    cr.end_signal = esignal
    cr.start_bp_ref = sbref
    cr.end_bp_ref = ebref


def consensus2(s1: str, s2: str) -> str:
    """utils.cpp:759-769."""
    if len(s1) != len(s2):
        return ""
    return "".join(a if a == b else "N" for a, b in zip(s1, s2))


def consensus_many(vseq: List[str]) -> str:
    """utils.cpp:771-817 (majority per column, ties N)."""
    if not vseq:
        return ""
    if any(len(s) != len(vseq[0]) for s in vseq):
        return ""
    out = []
    for i in range(len(vseq[0])):
        counts = {}
        for s in vseq:
            ch = s[i].upper()
            counts[ch] = counts.get(ch, 0) + 1
        best_ch, best_cnt = "N", 0
        for ch in "ACGT":
            if counts.get(ch, 0) > best_cnt:
                best_cnt = counts.get(ch, 0)
                best_ch = ch
        out.append(best_ch if best_cnt >= len(vseq) // 2 else "N")
    return "".join(out)
