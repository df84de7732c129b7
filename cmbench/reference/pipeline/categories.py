"""Concordance / chimeric / BSJ rule engine.

Reference: src/utils.cpp:53-320 (calc_tlen, concordant_explanation,
check_chimeric, check_bsj, check_2bsj), 322-664 (same_transcript/same_gene
families), 667-757 (lazy annotation lookups, junction reconstruction),
827-939 (is_left_chain, remove_side_introns).

MatchedMate.exons_spos/epos hold disjoint-interval indices (or None), the
array-world stand-in for the reference's IntervalInfo pointers.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..config import (Config, CONCRD, DISCRD, CHIORF, CHIBSJ, CHI2BSJ,
                      CONGEN, CONGNM, INF, MAXDISCRDTLEN, LARIAT2BEGTH)
from .types import MatchedMate, MatchedRead, JuncInfo


# --- lazy annotation lookups (utils.cpp:667-695) ---

def overlap_to_spos(mm: MatchedMate, db, contig: int):
    if mm.looked_up_spos or mm.exons_spos is not None:
        return
    mm.exons_spos, mm.exon_ind_spos = db.get_location_overlap_ind(
        contig, mm.spos)
    mm.looked_up_spos = True


def overlap_to_epos(mm: MatchedMate, db, contig: int):
    if mm.looked_up_epos or mm.exons_epos is not None:
        return
    mm.exons_epos, mm.exon_ind_epos = db.get_location_overlap_ind(
        contig, mm.epos)
    mm.looked_up_epos = True


def overlap_to_mpos(mm: MatchedMate, db, contig: int) -> Optional[int]:
    iv, _ = db.get_location_overlap_ind(contig, (mm.spos + mm.epos) // 2)
    return iv


def gene_overlap(mm: MatchedMate, db, contig: int):
    if mm.looked_up_gene or mm.gene_info_iv is not None:
        return
    mm.gene_info_iv = db.gene_overlap(contig, mm.spos)
    mm.looked_up_gene = True


# --- transcript / gene set relations (utils.cpp:322-664) ---

def _iv_tids(db, contig, iv: Optional[int]) -> List[int]:
    if iv is None:
        return []
    return [int(t) for t in db.interval_tids(contig, iv)]


def intersect_trans(l1: List[int], l2: List[int]) -> List[int]:
    out = []
    s2 = l2
    for t in l1:
        if t in s2:
            out.append(t)
    return out


def same_transcript2(db, contig, iv_a, iv_b) -> List[int]:
    if iv_a is None or iv_b is None:
        return []
    return intersect_trans(_iv_tids(db, contig, iv_a),
                           _iv_tids(db, contig, iv_b))


def same_transcript3(db, contig, iv_a, iv_b, iv_c) -> List[int]:
    """utils.cpp:356-376 (quirk preserved: intersects (a&b) with a again,
    not with c)."""
    if iv_a is None or iv_b is None or iv_c is None:
        return []
    ab = same_transcript2(db, contig, iv_a, iv_b)
    if not ab:
        return []
    return intersect_trans(ab, _iv_tids(db, contig, iv_a))


def same_transcript4(db, contig, iv_a, iv_b, iv_c, iv_d) -> List[int]:
    if iv_a is None or iv_b is None or iv_c is None or iv_d is None:
        return []
    ab = same_transcript2(db, contig, iv_a, iv_b)
    if not ab:
        return []
    cd = same_transcript2(db, contig, iv_c, iv_d)
    if not cd:
        return []
    return intersect_trans(ab, cd)


def same_transcript_mpos(db, contig, segments: List[MatchedMate]
                         ) -> List[int]:
    """utils.cpp:400-417 — mid-position overlaps."""
    ivs = [overlap_to_mpos(mm, db, contig) for mm in segments]
    if len(segments) == 4:
        return same_transcript4(db, contig, *ivs)
    if len(segments) == 3:
        return same_transcript3(db, contig, *ivs)
    if len(segments) == 2:
        return same_transcript2(db, contig, *ivs)
    return []


def same_transcript_multi(db, contig, segments: List[MatchedMate], size: int
                          ) -> List[int]:
    """utils.cpp:419-603 — try all spos/epos interval combinations in the
    reference's order until a common transcript is found."""
    for mm in segments[:size]:
        overlap_to_spos(mm, db, contig)

    def iv(mm, use_epos):
        if use_epos:
            overlap_to_epos(mm, db, contig)
            return mm.exons_epos
        return mm.exons_spos

    if size == 2:
        combos = [(0, 0), (0, 1), (1, 0), (1, 1)]
        for c in combos:
            r = same_transcript2(db, contig, iv(segments[0], c[0]),
                                 iv(segments[1], c[1]))
            if r:
                return r
    elif size == 3:
        combos = [(0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
                  (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1)]
        for c in combos:
            r = same_transcript3(db, contig, iv(segments[0], c[0]),
                                 iv(segments[1], c[1]), iv(segments[2], c[2]))
            if r:
                return r
    elif size == 4:
        # reference order: vary seg0..2 with seg3.spos, then with seg3.epos
        combos = [(a, b, cc, d) for d in (0, 1)
                  for a in (0, 1) for b in (0, 1) for cc in (0, 1)]
        # reference enumerates (0,0,0,0),(0,0,1,0),(0,1,0,0),(0,1,1,0),
        # (1,0,0,0),(1,0,1,0),(1,1,0,0),(1,1,1,0), then same with d=1
        combos = [(0, 0, 0, 0), (0, 0, 1, 0), (0, 1, 0, 0), (0, 1, 1, 0),
                  (1, 0, 0, 0), (1, 0, 1, 0), (1, 1, 0, 0), (1, 1, 1, 0),
                  (0, 0, 0, 1), (0, 0, 1, 1), (0, 1, 0, 1), (0, 1, 1, 1),
                  (1, 0, 0, 1), (1, 0, 1, 1), (1, 1, 0, 1), (1, 1, 1, 1)]
        for c in combos:
            r = same_transcript4(db, contig, iv(segments[0], c[0]),
                                 iv(segments[1], c[1]), iv(segments[2], c[2]),
                                 iv(segments[3], c[3]))
            if r:
                return r
    return []


def same_gene_iv(db, contig, iv_a, iv_b) -> bool:
    """utils.cpp:605-615 (shared gene id between two exon intervals)."""
    if iv_a is None or iv_b is None:
        return False
    ca = db.contigs[contig]
    genes_a = {int(ca.seg_gene[e]) for e in db.interval_segs(contig, iv_a)}
    for e in db.interval_segs(contig, iv_b):
        if int(ca.seg_gene[e]) in genes_a:
            return True
    return False


def same_gene_span(db, contig, iv_mate, s: int, e: int) -> bool:
    """utils.cpp:617-627 — [s,e] within any gene of the mate's interval."""
    if iv_mate is None:
        return False
    ca = db.contigs[contig]
    for eidx in db.interval_segs(contig, iv_mate):
        g = int(ca.seg_gene[eidx])
        if int(ca.gene_start[g]) <= s and e <= int(ca.gene_end[g]):
            return True
    return False


def same_gene_mm(db, contig, mm: MatchedMate, other: MatchedMate) -> bool:
    """utils.cpp:629-639."""
    if mm.exons_spos is None:
        return False
    return same_gene_span(db, contig, mm.exons_spos, other.spos, other.epos)


# --- tlen over transcripts (utils.cpp:53-113) ---

def calc_tlen(db, contig, sm: MatchedMate, lm: MatchedMate
              ) -> Tuple[int, int]:
    """Returns (tlen, intron_num); tlen -1 when no transcript explains."""
    ca = db.contigs[contig]
    min_tlen = INF
    best_in = 0
    for e in db.interval_segs(contig, sm.exons_epos):
        for tid in db.seg_tids(contig, e):
            tid = int(tid)
            start_ind = db.get_trans_start_ind(contig, tid)
            start_ti = sm.exon_ind_epos - start_ind
            if start_ti < 0:
                continue
            end_ti = lm.exon_ind_spos - start_ind
            if (lm.exon_ind_spos < start_ind
                    or end_ti >= db.trans2seg_len(contig, tid)
                    or db.trans2seg_state(contig, tid, end_ti) == 0):
                continue
            if start_ti == end_ti:
                inn = 0
                tlen = lm.spos - sm.epos + 1
            else:
                pre_zero = False
                inn = 0
                tlen = int(ca.iv_epos[sm.exons_epos]) - sm.epos + 1
                this_iv = sm.exon_ind_epos
                for kk in range(start_ti + 1, end_ti):
                    this_iv += 1
                    if db.trans2seg_state(contig, tid, kk) != 0:
                        tlen += int(ca.iv_epos[this_iv]) - \
                            int(ca.iv_spos[this_iv]) + 1
                        pre_zero = False
                    else:
                        if not pre_zero:
                            inn += 1
                        pre_zero = True
                tlen += lm.spos - int(ca.iv_spos[lm.exons_spos]) + 1
            if tlen < min_tlen:
                best_in = inn
                min_tlen = tlen
    if min_tlen == INF:
        return -1, best_in
    return min_tlen + sm.matched_len - 1 + lm.matched_len - 1, best_in


# --- decision rules (utils.cpp:157-320) ---

class RuleContext:
    """Bundles db/contig/cfg/contig_num for the rule functions."""

    def __init__(self, db, contig: int, cfg: Config):
        self.db = db
        self.contig = contig
        self.cfg = cfg


def _same_exon(db, contig, iv_a, iv_b) -> bool:
    """Any pair of segs with identical (start,end) across the two interval
    seg lists (UniqSeg::same_exon, common.cpp:128-130)."""
    if iv_a is None or iv_b is None:
        return False
    ca = db.contigs[contig]
    spans_a = {(int(ca.seg_start[e]), int(ca.seg_end[e]))
               for e in db.interval_segs(contig, iv_a)}
    for e in db.interval_segs(contig, iv_b):
        if (int(ca.seg_start[e]), int(ca.seg_end[e])) in spans_a:
            return True
    return False


def concordant_explanation(ctx: RuleContext, sm: MatchedMate,
                           lm: MatchedMate, mr: MatchedRead, chr_: str,
                           shift: int, r1_sm: bool, pair_type: int) -> bool:
    """utils.cpp:157-213."""
    db, c, cfg = ctx.db, ctx.contig, ctx.cfg
    if sm.spos > lm.spos:
        return False
    on_cdna = (sm.exons_spos is not None and sm.exons_epos is not None
               and lm.exons_spos is not None and lm.exons_epos is not None)

    if sm.exons_spos is None or lm.exons_spos is None:
        tlen = lm.spos - sm.epos - 1 + lm.matched_len + sm.matched_len
        if tlen <= cfg.max_tlen or tlen <= MAXDISCRDTLEN:
            mr.update(sm, lm, chr_, shift, tlen, 0, False, CONGNM, r1_sm,
                      ctx.contig)
    else:
        if _same_exon(db, c, sm.exons_spos, lm.exons_spos):
            tlen = lm.spos + lm.matched_len - sm.spos
            if tlen <= cfg.max_tlen:
                mr.update(sm, lm, chr_, shift, tlen, 0, on_cdna,
                          CONCRD if pair_type == 0 else CONGEN, r1_sm,
                          ctx.contig)
            else:
                mr.update(sm, lm, chr_, shift, tlen, 0, on_cdna, DISCRD,
                          r1_sm, ctx.contig)

    if sm.exons_epos is None or lm.exons_spos is None:
        tlen = lm.spos - sm.epos - 1 + sm.matched_len + lm.matched_len
        if tlen <= cfg.max_tlen or tlen <= MAXDISCRDTLEN:
            mr.update(sm, lm, chr_, shift, tlen, 0, False, CONGNM, r1_sm,
                      ctx.contig)
    else:
        tlen, intron_num = calc_tlen(db, c, sm, lm)
        if 0 <= tlen <= cfg.max_tlen:
            mr.update(sm, lm, chr_, shift, tlen, intron_num, on_cdna,
                      CONCRD if pair_type == 0 else CONGEN, r1_sm, ctx.contig)
        else:
            if tlen < 0:
                tlen = lm.spos - sm.epos - 1 + sm.matched_len + lm.matched_len
                intron_num = 0
            mr.update(sm, lm, chr_, shift, tlen, intron_num, on_cdna, DISCRD,
                      r1_sm, ctx.contig)
    return mr.type == CONCRD


def check_chimeric(ctx: RuleContext, sm: MatchedMate, lm: MatchedMate,
                   mr: MatchedRead, chr_: str, shift: int, r1_sm: bool
                   ) -> bool:
    """utils.cpp:215-231."""
    if mr.type == CONCRD:
        return False
    if sm.exons_spos is None or lm.exons_spos is None:
        return False
    if same_gene_iv(ctx.db, ctx.contig, sm.exons_spos, lm.exons_spos) \
            and sm.spos < lm.spos:
        mr.update(sm, lm, chr_, shift, lm.epos - sm.spos + 1, 0, False,
                  CHIORF, r1_sm, ctx.contig)
        return True
    return False


def _lariat_ciRNA(ctx: RuleContext, sm: MatchedMate, lm: MatchedMate) -> bool:
    """The ciRNA lariat test shared by check_bsj/check_2bsj
    (utils.cpp:250-252, 304-306)."""
    db, c = ctx.db, ctx.contig
    ca = db.contigs[c]
    if not (ca.intronic[sm.spos] and ca.intronic[lm.spos]):
        return False
    if sm.exon_ind_spos < 0 or lm.exon_ind_epos < 0:
        return False
    if sm.exon_ind_spos != lm.exon_ind_epos:
        return False
    return (sm.spos - int(ca.iv_epos[sm.exon_ind_spos])) <= LARIAT2BEGTH


def check_bsj(ctx: RuleContext, sm: MatchedMate, lm: MatchedMate,
              mr: MatchedRead, chr_: str, shift: int, r1_sm: bool) -> bool:
    """utils.cpp:235-266."""
    db, c = ctx.db, ctx.contig
    if mr.type in (CONCRD, DISCRD):
        return False
    if (not sm.right_ok) or (not lm.left_ok):
        return False
    if sm.exons_spos is None or lm.exons_spos is None:
        if ((sm.exons_spos is not None and same_gene_mm(db, c, sm, lm)) or
                (lm.exons_spos is not None and same_gene_mm(db, c, lm, sm))):
            mr.update(sm, lm, chr_, shift, lm.epos - sm.spos + 1, 0, False,
                      CHIBSJ, r1_sm, ctx.contig)
            return True
        if _lariat_ciRNA(ctx, sm, lm):
            mr.update(sm, lm, chr_, shift, lm.epos - sm.spos + 1, 0, False,
                      CHIBSJ, r1_sm, ctx.contig)
            return True
        return False
    if same_gene_iv(db, c, sm.exons_spos, lm.exons_spos):
        mr.update(sm, lm, chr_, shift, lm.epos - sm.spos + 1, 0, False,
                  CHIBSJ, r1_sm, ctx.contig)
        return True
    return False


def check_2bsj(ctx: RuleContext, sm: MatchedMate, lm: MatchedMate,
               mr: MatchedRead, chr_: str, shift: int, r1_sm: bool) -> bool:
    """utils.cpp:270-320."""
    db, c = ctx.db, ctx.contig
    if mr.type < CHI2BSJ:
        return False
    if sm.spos > lm.spos:
        return False
    if sm.right_ok and lm.right_ok and sm.spos != lm.spos:
        return False
    if sm.left_ok and lm.left_ok and sm.epos != lm.epos:
        return False
    if sm.left_ok and lm.right_ok:
        return False
    if sm.exons_spos is None or lm.exons_spos is None:
        if ((sm.exons_spos is not None and same_gene_mm(db, c, sm, lm)) or
                (lm.exons_spos is not None and same_gene_mm(db, c, lm, sm))):
            mr.update(sm, lm, chr_, shift, lm.epos - sm.spos + 1, 0, False,
                      CHI2BSJ, r1_sm, ctx.contig)
            return True
        if _lariat_ciRNA(ctx, sm, lm):
            mr.update(sm, lm, chr_, shift, lm.epos - sm.spos + 1, 0, False,
                      CHI2BSJ, r1_sm, ctx.contig)
            return True
        return False
    if same_gene_iv(db, c, sm.exons_spos, lm.exons_spos):
        mr.update(sm, lm, chr_, shift, lm.epos - sm.spos + 1, 0, False,
                  CHI2BSJ, r1_sm, ctx.contig)
        return True
    return False


# --- junction reconstruction (utils.cpp:697-757) ---

def get_junctions(ctx: RuleContext, mm: MatchedMate, indel_th: int = 3):
    db, c = ctx.db, ctx.contig
    overlap_to_spos(mm, db, c)
    overlap_to_epos(mm, db, c)
    mm.junc_info = []
    if mm.exons_spos is None or mm.exons_epos is None:
        return
    ca = db.contigs[c]
    for e in db.interval_segs(c, mm.exons_spos):
        for tid in db.seg_tids(c, e):
            tid = int(tid)
            start_ind = db.get_trans_start_ind(c, tid)
            start_ti = mm.exon_ind_spos - start_ind
            if start_ti < 0:
                continue
            end_ti = mm.exon_ind_epos - start_ind
            if (mm.exon_ind_epos < start_ind
                    or end_ti >= db.trans2seg_len(c, tid)
                    or db.trans2seg_state(c, tid, end_ti) == 0):
                continue
            if start_ti == end_ti:
                return
            junc_start = int(ca.iv_epos[mm.exons_spos])
            covered = int(ca.iv_epos[mm.exons_spos]) - mm.spos + 1
            this_iv = mm.exon_ind_spos
            infos = []
            for kk in range(start_ti + 1, end_ti):
                this_iv += 1
                if db.trans2seg_state(c, tid, kk) != 0:
                    if junc_start < int(ca.iv_spos[this_iv]):
                        infos.append(JuncInfo(junc_start,
                                              int(ca.iv_spos[this_iv]),
                                              covered))
                    covered += int(ca.iv_epos[this_iv]) - \
                        int(ca.iv_spos[this_iv]) + 1
                    junc_start = int(ca.iv_epos[this_iv])
            if junc_start < int(ca.iv_spos[mm.exons_epos]):
                infos.append(JuncInfo(junc_start,
                                      int(ca.iv_spos[mm.exons_epos]),
                                      covered))
            covered += mm.epos - int(ca.iv_spos[mm.exons_epos]) + 1
            mm.junc_info = infos
            if abs(covered - mm.matched_len) <= indel_th:
                return
            mm.junc_info = []


# --- chain geometry (utils.cpp:827-887) ---

def is_left_chain(a, b, read_length: int) -> bool:
    """Is chain a on the left side of chain b?"""
    a_beg, b_beg = int(a.rpos[0]), int(b.rpos[0])
    a_end = int(a.rpos[-1] + a.flen[-1] - 1)
    b_end = int(b.rpos[-1] + b.flen[-1] - 1)
    if b_beg > a_end or a_beg > b_end:
        return a_beg < b_beg
    i = j = 0
    best_distance = INF
    best_i = best_j = -1
    while i < a.chain_len and j < b.chain_len:
        bj_beg = int(b.rpos[j])
        ai_end = int(a.rpos[i] + a.flen[i] - 1)
        if ai_end < bj_beg:
            d = bj_beg - ai_end
            if d < best_distance:
                best_distance, best_i, best_j = d, i, j
            i += 1
            continue
        ai_beg = int(a.rpos[i])
        bj_end = int(b.rpos[j] + b.flen[j] - 1)
        if bj_end < ai_beg:
            d = ai_beg - bj_end
            if d < best_distance:
                best_distance, best_i, best_j = d, i, j
            j += 1
            continue
        best_i, best_j = i, j
        break
    common_bp = max(int(a.rpos[best_i]), int(b.rpos[best_j]))
    a_ov_qpos = int(a.qpos[best_i]) + (common_bp - int(a.rpos[best_i]))
    b_ov_qpos = int(b.qpos[best_j]) + (common_bp - int(b.rpos[best_j]))
    if a_ov_qpos < read_length and b_ov_qpos < read_length:
        return a_ov_qpos >= b_ov_qpos
    return a_beg < b_beg
