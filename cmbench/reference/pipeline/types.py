"""Mapping data model: MatchedMate / MatchedRead and the best-mapping
update lattice (reference: src/common.h:260-352, src/common.cpp:147-411)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..config import (CONCRD, CHIBSJ, ORPHAN, NOPROC_NOMATCH, INF)


@dataclasses.dataclass
class JuncInfo:
    beg: int
    end: int
    bp_matched: int


@dataclasses.dataclass
class MatchedMate:
    """One mate's (partial) alignment (common.h:260-307)."""
    spos: int = 0
    epos: int = 0
    qspos: int = 0
    qepos: int = 0
    right_ed: int = 5       # maxEd + 1 by default; caller overrides
    left_ed: int = 5
    middle_ed: int = 5
    sclen_right: int = 0
    sclen_left: int = 0
    matched_len: int = 0
    dir: int = 0
    type: int = ORPHAN
    junc_num: int = 0
    is_concord: bool = False
    left_ok: bool = False
    right_ok: bool = False
    # annotation lookups (lazy)
    looked_up_spos: bool = False
    looked_up_epos: bool = False
    looked_up_gene: bool = False
    exon_ind_spos: int = -1
    exon_ind_epos: int = -1
    exons_spos: Optional[int] = None    # interval index or None
    exons_epos: Optional[int] = None
    gene_info_iv: Optional[int] = None  # gene interval index or None
    junc_info: List[JuncInfo] = dataclasses.field(default_factory=list)

    @classmethod
    def default(cls, max_ed: int) -> "MatchedMate":
        return cls(right_ed=max_ed + 1, left_ed=max_ed + 1,
                   middle_ed=max_ed + 1)

    def set(self, rs, re, qs, qe, d):
        self.spos, self.epos, self.qspos, self.qepos = rs, re, qs, qe
        self.matched_len = (qe - qs + 1) if qe + 1 >= qs else 0
        self.dir = d

    @classmethod
    def from_matched_read(cls, mr: "MatchedRead", r1_2: int, rlen: int,
                          partial: bool) -> "MatchedMate":
        """common.cpp:192-235."""
        mm = cls()
        mm.type = mr.type
        mm.right_ed = 0
        mm.left_ed = 0
        if r1_2 == 1:
            mm.spos, mm.epos = mr.spos_r1, mr.epos_r1
            mm.qspos, mm.qepos = mr.qspos_r1, mr.qepos_r1
            mm.middle_ed = mr.ed_r1
            mm.matched_len = mr.mlen_r1
            mm.dir = 1 if mr.r1_forward else -1
        else:
            mm.spos, mm.epos = mr.spos_r2, mr.epos_r2
            mm.qspos, mm.qepos = mr.qspos_r2, mr.qepos_r2
            mm.middle_ed = mr.ed_r2
            mm.matched_len = mr.mlen_r2
            mm.dir = 1 if mr.r2_forward else -1
        if partial:
            if (mm.qspos - 1) > (rlen - mm.qepos):  # right-side matched
                mm.sclen_left = 0
                mm.sclen_right = rlen - mm.qepos
            else:
                mm.sclen_left = mm.qspos - 1
                mm.sclen_right = 0
        else:
            mm.sclen_left = mm.qspos - 1
            mm.sclen_right = rlen - mm.qepos
        return mm

    def merge_to_right(self, rmm: "MatchedMate", max_ed: int) -> bool:
        """common.cpp:163-189."""
        if self.dir != rmm.dir:
            return False
        self.epos = rmm.epos
        self.qepos = rmm.qepos
        self.middle_ed += self.right_ed + rmm.left_ed
        self.right_ed = rmm.right_ed
        self.matched_len += rmm.matched_len + self.sclen_right + rmm.sclen_left
        self.middle_ed += self.sclen_right + rmm.sclen_left
        self.sclen_right = rmm.sclen_right
        self.right_ok = rmm.right_ok
        self.looked_up_epos = rmm.looked_up_epos
        self.exon_ind_epos = rmm.exon_ind_epos
        return self.left_ed + self.middle_ed + self.right_ed <= max_ed


@dataclasses.dataclass
class MatchedRead:
    """Best mapping of a read pair (common.h:311-352)."""
    spos_r1: int = 0
    spos_r2: int = 0
    epos_r1: int = 0
    epos_r2: int = 0
    qspos_r1: int = 0
    qspos_r2: int = 0
    qepos_r1: int = 0
    qepos_r2: int = 0
    mlen_r1: int = 0
    mlen_r2: int = 0
    r1_forward: bool = True
    r2_forward: bool = True
    ed_r1: int = 5
    ed_r2: int = 5
    type: int = NOPROC_NOMATCH
    tlen: int = INF
    junc_num: int = 0
    gm_compatible: bool = False
    contig_num: int = 0
    genome_spos: int = 0
    chr_r1: str = "-"
    chr_r2: str = "-"
    # touched=False means the record still holds exactly the default() state
    # (lets batch engines skip per-field serialization for fresh reads)
    touched: bool = False

    @classmethod
    def default(cls, max_ed: int) -> "MatchedRead":
        return cls(ed_r1=max_ed + 1, ed_r2=max_ed + 1)

    def go_for_update(self, r1: MatchedMate, r2: MatchedMate, tlen: int,
                      gm_compatible: bool, type_: int) -> bool:
        """common.cpp:362-411 tie-break lattice."""
        if type_ < self.type:
            return True
        if type_ > self.type:
            return False
        if gm_compatible and not self.gm_compatible:
            return True
        if not gm_compatible and self.gm_compatible:
            return False
        ed = (r1.left_ed + r1.middle_ed + r1.right_ed +
              r2.left_ed + r2.middle_ed + r2.right_ed)
        mlen = r1.matched_len + r2.matched_len
        if type_ < CHIBSJ:
            if (self.ed_r1 + self.ed_r2) > ed:
                return True
            if (self.ed_r1 + self.ed_r2) < ed:
                return False
            if self.tlen > tlen:
                return True
            if self.tlen < tlen:
                return False
            if (self.mlen_r1 + self.mlen_r2) < mlen:
                return True
            if (self.mlen_r1 + self.mlen_r2) > mlen:
                return False
        else:
            if (self.mlen_r1 + self.mlen_r2) < mlen:
                return True
            if (self.mlen_r1 + self.mlen_r2) > mlen:
                return False
            if (self.ed_r1 + self.ed_r2) > ed:
                return True
            if (self.ed_r1 + self.ed_r2) < ed:
                return False
        return False

    def update(self, r1: MatchedMate, r2: MatchedMate, chr_: str, shift: int,
               tlen: int, jun_between: int, gm_compatible: bool, type_: int,
               r1_first: bool, contig_num: int = 0) -> bool:
        """common.cpp:286-351 (r1/r2 here are in genome order; r1_first says
        whether the first argument is actually read 1)."""
        if not self.go_for_update(r1, r2, tlen, gm_compatible, type_):
            return False
        self.touched = True
        self.type = type_
        self.chr_r1 = chr_
        self.chr_r2 = chr_
        a, b = (r1, r2) if r1_first else (r2, r1)
        self.spos_r1, self.epos_r1 = a.spos - shift, a.epos - shift
        self.qspos_r1, self.qepos_r1 = a.qspos, a.qepos
        self.mlen_r1 = a.matched_len
        self.ed_r1 = a.left_ed + a.middle_ed + a.right_ed
        self.spos_r2, self.epos_r2 = b.spos - shift, b.epos - shift
        self.qspos_r2, self.qepos_r2 = b.qspos, b.qepos
        self.mlen_r2 = b.matched_len
        self.ed_r2 = b.left_ed + b.middle_ed + b.right_ed
        self.r1_forward = a.dir > 0
        self.r2_forward = b.dir > 0
        self.tlen = tlen
        self.junc_num = jun_between + r1.junc_num + r2.junc_num
        self.gm_compatible = gm_compatible
        self.contig_num = contig_num
        return True

    def update_type(self, type_: int) -> bool:
        if type_ < self.type:
            self.type = type_
            self.touched = True
            return True
        return False


def round_skip(mr: "MatchedRead", seq_len1: int, seq_len2: int,
               scan_level: int) -> bool:
    """Contig-round skip condition (circminer.cpp:386-394): a read whose
    best mapping is already good enough is finalized now and not carried
    into later rounds.  scanLevel 0 skips on any CONCRD; scanLevel 1 only
    on a perfect one (gm-compatible, zero edit distance, full-length
    match on both mates); scanLevel >= 2 never skips."""
    if mr.type != CONCRD:
        return False
    if scan_level == 0:
        return True
    if scan_level == 1:
        return (mr.gm_compatible
                and mr.ed_r1 + mr.ed_r2 == 0
                and mr.mlen_r1 + mr.mlen_r2 == seq_len1 + seq_len2)
    return False
