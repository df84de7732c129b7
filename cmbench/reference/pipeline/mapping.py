"""Read-level mapping orchestration (FilterRead equivalent).

Reference: src/filter.cpp.  For each PE read: 4 chain sets (R1/R2 x fwd/rc),
orientation chosen by chain score sums, cross-product chain pairing gated by
shared transcript/gene/tlen, paired extension, then the category decision
lattice (CONCRD .. NOPROC_NOMATCH).

The host implementation here orchestrates; seed lookup + chaining can come
either from the host oracle or from the batched device kernels (see
device_pipeline.py), which produce identical chain lists.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..config import (Config, CONCRD, DISCRD, CHIORF, CHIBSJ, CHI2BSJ,
                      CONGEN, CHIFUS, CONGNM, OEA2, CANDID, OEANCH, ORPHAN,
                      NOPROC_MANYHIT, NOPROC_NOMATCH, MAXDISCRDTLEN, MINLB,
                      MAXUB)
from ..ops.chain import Chain, chain_seeds_host
from ..ops.encode import revcomp
from ..io.fasta import get_shift
from .types import MatchedMate, MatchedRead
from .extend import TransExtension, GenomeView, run_gen
from ..utils import logging as ulog
from . import categories as cat


@dataclasses.dataclass
class MatePair:
    """common.h:356-368."""
    type: int
    score: float
    forward: Chain
    reverse: Chain
    common_tid: List[int]


@dataclasses.dataclass
class ReadRecord:
    """A parsed read (Record equivalent, common.h:427-456)."""
    rname: str
    seq: np.ndarray          # int8 codes, forward
    rcseq: np.ndarray
    qual: str
    seq_len: int
    mr: MatchedRead = None


class Mapper:
    """Per-contig mapping engine."""

    def __init__(self, db, contig: int, genome_codes: np.ndarray,
                 cfg: Config, seeder=None):
        self.db = db
        self.contig = contig
        self.cfg = cfg
        self.genome = GenomeView(genome_codes)
        self.ext = TransExtension(db, contig, self.genome, cfg)
        self.ctx = cat.RuleContext(db, contig, cfg)
        self.seeder = seeder  # callable(seq) -> (qpos[], seed_pos[][]) or None

    # --- seeding + chaining (filter.cpp:470-482) ---
    def get_best_chains(self, seq: np.ndarray) -> Tuple[List[Chain], int]:
        qpos, seed_pos, high = self.seeder(seq)
        chains = chain_seeds_host(len(seq), qpos, seed_pos, self.cfg,
                                  self.db, self.contig)
        return chains, high

    # --- chain pairing (filter.cpp:485-551) ---
    def pair_chains(self, fwd: List[Chain], rev: List[Chain],
                    saved_type: int) -> Tuple[List[MatePair], List[bool],
                                              List[bool]]:
        db, c, cfg = self.db, self.contig, self.cfg
        f_iv = [db.get_location_overlap_ind(c, int(ch.rpos[0]))[0]
                for ch in fwd]
        r_iv = [db.get_location_overlap_ind(c, int(ch.rpos[0]))[0]
                for ch in rev]
        pairs: List[MatePair] = []
        f_paired = [False] * len(fwd)
        r_paired = [False] * len(rev)
        for i, fc in enumerate(fwd):
            for j, rc in enumerate(rev):
                fs = int(fc.rpos[0])
                rs = int(rc.rpos[0])
                fe = int(fc.rpos[-1] + fc.flen[-1])
                re = int(rc.rpos[-1] + rc.flen[-1])
                tlen = (re - fs) if fs < rs else (fe - rs)
                common_tid: List[int] = []
                same_tr = same_gen = False
                if f_iv[i] is not None and r_iv[j] is not None:
                    common_tid = cat.same_transcript2(db, c, f_iv[i], r_iv[j])
                    same_tr = bool(common_tid)
                if (not same_tr and f_iv[i] is not None and
                        ((cfg.scan_level == 0 and saved_type > CONGEN) or
                         (cfg.scan_level > 0 and saved_type >= CONGEN))):
                    same_gen = cat.same_gene_span(db, c, f_iv[i], rs, re)
                if (not same_gen and r_iv[j] is not None
                        and saved_type >= CONGEN):
                    same_gen = cat.same_gene_span(db, c, r_iv[j], fs, fe)
                if same_tr or same_gen or (tlen <= MAXDISCRDTLEN
                                           and saved_type >= CONGNM):
                    pairs.append(MatePair(
                        type=0 if same_tr else (1 if same_gen else 2),
                        score=fc.score + rc.score,
                        forward=fc, reverse=rc, common_tid=common_tid))
                    f_paired[i] = True
                    r_paired[j] = True
        return pairs, f_paired, r_paired

    # --- paired-mate processing (filter.cpp:244-395) ---
    def process_mates_g(self, forward_chain: List[Chain], forward_rec,
                        backward_chain: List[Chain], backward_rec,
                        mr: MatchedRead, r1_forward: bool):
        db, c, cfg = self.db, self.contig, self.cfg
        pairs, f_paired, r_paired = self.pair_chains(
            forward_chain, backward_chain, mr.type)
        if ulog.TRACE_LEVEL >= 1:  # filter.cpp:260-263
            ulog.vaf(1, "#pairs = %d", len(pairs))
            for i, mp in enumerate(pairs):
                ulog.vaf(2, "Mate[%d]: %d, %d", i,
                         int(mp.forward.rpos[0]), int(mp.reverse.rpos[0]))

        min_ret1 = ORPHAN
        min_ret2 = ORPHAN
        r1_genic = False
        r2_genic = False

        for mp in pairs:
            r1_mm = MatchedMate.default(cfg.max_ed)
            r2_mm = MatchedMate.default(cfg.max_ed)
            r1_mm.dir = 1
            r2_mm.dir = -1
            is_fwd_left = cat.is_left_chain(mp.forward, mp.reverse,
                                            forward_rec.seq_len)
            if ulog.TRACE_LEVEL >= 1:  # pair trace (filter.cpp:262-270)
                ulog.vaf(1, "MatePair type %d score %.4f fwd@%d rev@%d "
                         "tids %s fwd_left=%s", mp.type, mp.score,
                         int(mp.forward.rpos[0]), int(mp.reverse.rpos[0]),
                         list(map(int, mp.common_tid)), is_fwd_left)
            if is_fwd_left:
                success = yield from self.ext.extend_both_mates_g(
                    mp.forward, mp.reverse, mp.common_tid, forward_rec.seq,
                    backward_rec.rcseq, 1, 1, forward_rec.seq_len,
                    backward_rec.seq_len, r1_mm, r2_mm)
                if success:
                    con_shift = get_shift(db.con2chr, c, r1_mm.spos)
                    cat.overlap_to_epos(r1_mm, db, c)
                    cat.overlap_to_spos(r1_mm, db, c)
                    cat.overlap_to_epos(r2_mm, db, c)
                    cat.overlap_to_spos(r2_mm, db, c)
                    if r1_mm.type == CONCRD and r2_mm.type == CONCRD:
                        if cat.concordant_explanation(
                                self.ctx, r1_mm, r2_mm, mr, con_shift.contig,
                                con_shift.shift, r1_forward, mp.type) \
                                and cfg.scan_level == 0:
                            return CONCRD
                    elif ((r1_mm.type == CANDID and r2_mm.type == CONCRD) or
                          (r1_mm.type == CONCRD and r2_mm.type == CANDID)):
                        cat.check_bsj(self.ctx, r1_mm, r2_mm, mr,
                                      con_shift.contig, con_shift.shift,
                                      r1_forward)
                    elif r1_mm.type == CANDID and r2_mm.type == CANDID:
                        cat.check_2bsj(self.ctx, r1_mm, r2_mm, mr,
                                       con_shift.contig, con_shift.shift,
                                       r1_forward)
            else:
                success = yield from self.ext.extend_both_mates_g(
                    mp.reverse, mp.forward, mp.common_tid, backward_rec.rcseq,
                    forward_rec.seq, 1, 1, backward_rec.seq_len,
                    forward_rec.seq_len, r2_mm, r1_mm)
                if success:
                    con_shift = get_shift(db.con2chr, c, r2_mm.spos)
                    cat.overlap_to_epos(r1_mm, db, c)
                    cat.overlap_to_spos(r1_mm, db, c)
                    cat.overlap_to_epos(r2_mm, db, c)
                    cat.overlap_to_spos(r2_mm, db, c)
                    if r1_mm.type == CONCRD and r2_mm.type == CONCRD:
                        cat.check_chimeric(self.ctx, r2_mm, r1_mm, mr,
                                           con_shift.contig, con_shift.shift,
                                           not r1_forward)
                    elif ((r1_mm.type == CANDID and r2_mm.type == CONCRD) or
                          (r1_mm.type == CONCRD and r2_mm.type == CANDID)):
                        cat.check_bsj(self.ctx, r2_mm, r1_mm, mr,
                                      con_shift.contig, con_shift.shift,
                                      not r1_forward)
                    elif r1_mm.type == CANDID and r2_mm.type == CANDID:
                        cat.check_2bsj(self.ctx, r2_mm, r1_mm, mr,
                                       con_shift.contig, con_shift.shift,
                                       not r1_forward)

            if ulog.TRACE_LEVEL >= 1:  # extension outcome (filter.cpp:281)
                ulog.vaf(1, "R1 ext: type %d [%d-%d] q[%d-%d] ed %d/%d/%d | "
                         "R2 ext: type %d [%d-%d] q[%d-%d] ed %d/%d/%d | "
                         "mr.type %d", r1_mm.type, r1_mm.spos, r1_mm.epos,
                         r1_mm.qspos, r1_mm.qepos, r1_mm.left_ed,
                         r1_mm.middle_ed, r1_mm.right_ed, r2_mm.type,
                         r2_mm.spos, r2_mm.epos, r2_mm.qspos, r2_mm.qepos,
                         r2_mm.left_ed, r2_mm.middle_ed, r2_mm.right_ed,
                         mr.type)
            min_ret1 = min(r1_mm.type, min_ret1)
            min_ret2 = min(r2_mm.type, min_ret2)
            r1_genic = (r1_mm.exons_spos is not None or
                        r1_mm.exons_epos is not None)
            r2_genic = (r2_mm.exons_spos is not None or
                        r2_mm.exons_epos is not None)

        if mr.type in (CONCRD, DISCRD, CHIORF, CHIBSJ, CHI2BSJ):
            return mr.type

        # leftover single-chain extension (filter.cpp:356-394)
        if min_ret1 != CONCRD:
            for i, ch in enumerate(forward_chain):
                if not f_paired[i]:
                    mm1 = MatchedMate.default(cfg.max_ed)
                    ex_ret = yield from self.ext.extend_chain_both_sides_g(
                        ch, forward_rec.seq, forward_rec.seq_len, mm1, 1)
                    min_ret1 = min(ex_ret, min_ret1)
                    cat.overlap_to_spos(mm1, db, c)
                    cat.overlap_to_epos(mm1, db, c)
                    r1_genic = (mm1.exons_spos is not None or
                                mm1.exons_epos is not None)
        if min_ret2 != CONCRD:
            for i, ch in enumerate(backward_chain):
                if not r_paired[i]:
                    mm2 = MatchedMate.default(cfg.max_ed)
                    ex_ret = yield from self.ext.extend_chain_both_sides_g(
                        ch, backward_rec.rcseq, backward_rec.seq_len, mm2, -1)
                    min_ret2 = min(ex_ret, min_ret2)
                    cat.overlap_to_spos(mm2, db, c)
                    cat.overlap_to_epos(mm2, db, c)
                    r2_genic = (mm2.exons_spos is not None or
                                mm2.exons_epos is not None)

        if ((min_ret1 == ORPHAN and min_ret2 == CONCRD) or
                (min_ret1 == CONCRD and min_ret2 == ORPHAN)):
            new_type = OEANCH
        elif min_ret1 == ORPHAN or min_ret2 == ORPHAN:
            new_type = ORPHAN
        elif min_ret1 == CONCRD and min_ret2 == CONCRD and r1_genic \
                and r2_genic:
            new_type = CHIFUS
        elif min_ret1 == CONCRD and min_ret2 == CONCRD:
            new_type = OEA2
        else:
            new_type = CANDID
        mr.update_type(new_type)
        return mr.type

    def process_mates(self, forward_chain, forward_rec, backward_chain,
                      backward_rec, mr: MatchedRead, r1_forward: bool) -> int:
        return run_gen(self.process_mates_g(forward_chain, forward_rec,
                                            backward_chain, backward_rec,
                                            mr, r1_forward), self.ext.svc)

    # --- SE read pipeline (filter.cpp:86-121) ---
    def process_read_se_g(self, rec: ReadRecord, chains2=None):
        """Single-end: extend every forward chain, then every RC chain,
        short-circuiting on the first CONCRD; otherwise the best (minimum)
        category across all extensions."""
        if chains2 is None:
            fc, _ = self.get_best_chains(rec.seq)
            bc, _ = self.get_best_chains(rec.rcseq)
        else:
            (fc, _), (bc, _) = chains2
        min_ret = ORPHAN
        for ch in fc:
            mm = MatchedMate.default(self.cfg.max_ed)
            ex_ret = yield from self.ext.extend_chain_both_sides_g(
                ch, rec.seq, rec.seq_len, mm, 1)
            if ex_ret == CONCRD:
                self._record_se(rec, mm, True)
                return CONCRD
            min_ret = min(ex_ret, min_ret)
        for ch in bc:
            mm = MatchedMate.default(self.cfg.max_ed)
            ex_ret = yield from self.ext.extend_chain_both_sides_g(
                ch, rec.rcseq, rec.seq_len, mm, -1)
            if ex_ret == CONCRD:
                self._record_se(rec, mm, False)
                return CONCRD
            min_ret = min(ex_ret, min_ret)
        return min_ret

    def process_read_se(self, rec: ReadRecord, chains2=None) -> int:
        return run_gen(self.process_read_se_g(rec, chains2), self.ext.svc)

    def _record_se(self, rec: ReadRecord, mm: MatchedMate, forward: bool):
        """Store the successful SE mate into rec.mr so SAM output has
        chr/pos/ed (the reference leaves rec->mr defaults in SE mode;
        we populate it — strictly more informative output)."""
        cs = get_shift(self.db.con2chr, self.contig, mm.spos)
        mr = rec.mr
        mr.type = CONCRD
        mr.chr_r1 = cs.contig
        mr.spos_r1 = mm.spos - cs.shift
        mr.epos_r1 = mm.epos - cs.shift
        mr.mlen_r1 = mm.matched_len
        mr.qspos_r1 = mm.qspos
        mr.qepos_r1 = mm.qepos
        mr.ed_r1 = mm.left_ed + mm.middle_ed + mm.right_ed
        mr.r1_forward = forward
        mr.contig_num = self.contig

    # --- PE read pipeline (filter.cpp:124-241) ---
    def process_read_pe_g(self, rec1: ReadRecord, rec2: ReadRecord,
                          chains4=None):
        """chains4: optional precomputed ((fc1, fhh1), (bc1, bhh1),
        (fc2, fhh2), (bc2, bhh2)) from the device pipeline."""
        cfg = self.cfg
        if chains4 is None:
            fc_r1, fhh_r1 = self.get_best_chains(rec1.seq)
            bc_r1, bhh_r1 = self.get_best_chains(rec1.rcseq)
            fc_r2, fhh_r2 = self.get_best_chains(rec2.seq)
            bc_r2, bhh_r2 = self.get_best_chains(rec2.rcseq)
        else:
            (fc_r1, fhh_r1), (bc_r1, bhh_r1), (fc_r2, fhh_r2), \
                (bc_r2, bhh_r2) = chains4

        if ulog.TRACE_LEVEL >= 1:  # chain-set dump (filter.cpp:140-177)
            for tag, chains in (("R1 Forward", fc_r1), ("R1 Reverse", bc_r1),
                                ("R2 Forward", fc_r2), ("R2 Reverse", bc_r2)):
                ulog.vaf(1, "%s/%s", tag.split()[0], rec1.rname)
                ulog.vaf(1, "%s score:%.4f,\t len: %d", tag,
                         chains[0].score if chains else 0.0, len(chains))
                for j, ch in enumerate(chains):
                    for i in range(ch.chain_len):
                        ulog.vaf(2, "#%d\tfrag[%d]: %d\t%d\t%d", j, i,
                                 int(ch.rpos[i]), int(ch.qpos[i]),
                                 int(ch.flen[i]))

        mr = rec1.mr
        if len(fc_r1) + len(bc_r1) + len(fc_r2) + len(bc_r2) <= 0:
            if (fhh_r1 + bhh_r1 > 0) and (fhh_r2 + bhh_r2 > 0):
                mr.update_type(NOPROC_MANYHIT)
                return NOPROC_MANYHIT
            mr.update_type(NOPROC_NOMATCH)
            return NOPROC_NOMATCH
        if len(fc_r1) + len(bc_r1) <= 0 or len(fc_r2) + len(bc_r2) <= 0:
            mr.update_type(OEANCH)
            return OEANCH

        fc1_score = fc_r1[0].score if fc_r1 else 0.0
        bc1_score = bc_r1[0].score if bc_r1 else 0.0
        fc2_score = fc_r2[0].score if fc_r2 else 0.0
        bc2_score = bc_r2[0].score if bc_r2 else 0.0

        def _decision_trace():
            if ulog.TRACE_LEVEL >= 1:  # per-read decision (vafprintf lvl 1)
                ulog.vaf(1, "%s: type %d chains %d/%d/%d/%d spos %d-%d",
                         rec1.rname, mr.type, len(fc_r1), len(bc_r1),
                         len(fc_r2), len(bc_r2), mr.spos_r1, mr.epos_r1)

        if ulog.TRACE_LEVEL >= 2:  # filter.cpp:202
            ulog.vaf(2, "Scores: fc1=%f, bc1=%f, fc2=%f, bc2=%f",
                     fc1_score, bc1_score, fc2_score, bc2_score)
        if fc1_score + bc2_score >= fc2_score + bc1_score:
            if ulog.TRACE_LEVEL >= 1:  # filter.cpp:207
                ulog.vaf(1, "Forward R1 / Backward R2")
            att1 = yield from self.process_mates_g(fc_r1, rec1, bc_r2, rec2,
                                                   mr, True)
            if cfg.scan_level == 0 and att1 == CONCRD:
                _decision_trace()
                return CONCRD
            if ulog.TRACE_LEVEL >= 1:  # filter.cpp:214
                ulog.vaf(1, "Backward R1 / Forward R2")
            att2 = yield from self.process_mates_g(fc_r2, rec2, bc_r1, rec1,
                                                   mr, False)
            if cfg.scan_level == 0 and att2 == CONCRD:
                _decision_trace()
                return CONCRD
        else:
            if ulog.TRACE_LEVEL >= 1:  # filter.cpp:224
                ulog.vaf(1, "Backward R1 / Forward R2")
            att1 = yield from self.process_mates_g(fc_r2, rec2, bc_r1, rec1,
                                                   mr, False)
            if cfg.scan_level == 0 and att1 == CONCRD:
                _decision_trace()
                return CONCRD
            if ulog.TRACE_LEVEL >= 1:  # filter.cpp:231
                ulog.vaf(1, "Forward R1 / Backward R2")
            att2 = yield from self.process_mates_g(fc_r1, rec1, bc_r2, rec2,
                                                   mr, True)
            if cfg.scan_level == 0 and att2 == CONCRD:
                _decision_trace()
                return CONCRD
        _decision_trace()
        return mr.type

    def process_read_pe(self, rec1: ReadRecord, rec2: ReadRecord,
                        chains4=None) -> int:
        return run_gen(self.process_read_pe_g(rec1, rec2, chains4),
                       self.ext.svc)


def make_host_seeder(ci, cfg: Config):
    """Host seed lookup closure: seq -> (qpos, seed_pos, high_hit_count)."""
    from ..ops.seed_host import lookup_read_host

    def seeder(seq: np.ndarray):
        hits = lookup_read_host(seq, ci, cfg)
        n_slots = cfg.max_seg_cnt
        qpos = hits.qpos.copy()
        seed_pos = []
        high = 0
        for s in range(n_slots):
            if hits.count[s] > 0:
                seed_pos.append(
                    ci.entry_pos[hits.start[s]:hits.start[s] + hits.count[s]]
                    .astype(np.int64))
            else:
                seed_pos.append(np.zeros(0, dtype=np.int64))
            if s % 2 == 0 and hits.high_hit[s]:
                high += 1
        return qpos, seed_pos, high

    return seeder
