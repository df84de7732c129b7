"""SAM / PAM mapping output writers (reference: src/output.cpp)."""

from __future__ import annotations

from typing import List, TextIO

from ..config import (CONCRD, CHIORF, CHI2BSJ, CONGEN, CONGNM)
from ..io.fasta import ContigLen
from ..ops.encode import decode_seq
from .types import MatchedRead
from .mapping import ReadRecord

PAIRED = 1 << 0
PROPER = 1 << 1
RUNMAP = 1 << 2
MUNMAP = 1 << 3
RREVER = 1 << 4
MREVER = 1 << 5
FIPAIR = 1 << 6
SIPAIR = 1 << 7

# SAM unmapped-flag gate (output.cpp:125): BSJ classes count as UNMAPPED
_MAPPED_TYPES = lambda t: t <= CHIORF or t == CONGEN or t == CONGNM
# PAM coordinate gate (output.cpp:289-290) additionally prints the BSJ
# classes — pinned by the cross-binary PAM diff against the stub-built
# reference binary (tools/refbuild)
_PAM_TYPES = lambda t: t <= CHI2BSJ or t == CONGEN or t == CONGNM


def set_flag_pe(mr: MatchedRead, first: bool) -> int:
    """output.cpp:118-149."""
    flag = PAIRED
    if mr.type == CONCRD:
        flag |= PROPER
    if not _MAPPED_TYPES(mr.type):
        flag |= RUNMAP | MUNMAP
    if first:
        if not (flag & RUNMAP) and not mr.r1_forward:
            flag |= RREVER
        if not (flag & MUNMAP) and not mr.r2_forward:
            flag |= MREVER
        flag |= FIPAIR
    else:
        if not (flag & MUNMAP) and not mr.r1_forward:
            flag |= MREVER
        if not (flag & RUNMAP) and not mr.r2_forward:
            flag |= RREVER
        flag |= SIPAIR
    return flag


class SamOutput:
    def __init__(self, prefix: str, fmt: str, chr_info: List[ContigLen],
                 append: bool = False):
        """fmt: 'sam' | 'pam' | None."""
        self.fmt = fmt
        self.fh: TextIO = None
        if fmt == "sam":
            self.fh = open(prefix + ".mapping.sam", "a" if append else "w")
            if not append:
                self._header(chr_info)
        elif fmt == "pam":
            self.fh = open(prefix + ".mapping.pam", "a" if append else "w")

    def _header(self, chr_info):
        self.fh.write("@HD\tVN:1.4\tSO:unsorted\n")
        for cl in chr_info:
            self.fh.write(f"@SQ\tSN:{cl.name}\tLN:{cl.len}\n")

    def close(self):
        if self.fh:
            self.fh.close()

    # output.cpp:280-299
    def write_pam_pe(self, rec1: ReadRecord, rec2: ReadRecord):
        mr = rec1.mr
        if _PAM_TYPES(mr.type):
            r1d = "+" if mr.r1_forward else "-"
            r2d = "+" if mr.r2_forward else "-"
            self.fh.write(
                f"{rec1.rname}\t{mr.chr_r1}\t{mr.spos_r1}\t{mr.epos_r1}\t"
                f"{mr.mlen_r1}\t{mr.qspos_r1}\t{mr.qepos_r1}\t{r1d}\t"
                f"{mr.ed_r1}\t{mr.chr_r2}\t{mr.spos_r2}\t{mr.epos_r2}\t"
                f"{mr.mlen_r2}\t{mr.qspos_r2}\t{mr.qepos_r2}\t{r2d}\t"
                f"{mr.ed_r2}\t{mr.tlen}\t{mr.junc_num}\t"
                f"{int(mr.gm_compatible)}\t{mr.type}\n")
        else:
            self.fh.write(f"{rec1.rname}" + "\t*" * 21 + f"\t{mr.type}\n")

    # output.cpp:95-116, 245-256
    def write_sam_se(self, rec: ReadRecord):
        mr = rec.mr
        flag = set_flag_pe(mr, True)
        if flag & RREVER:
            s, q = decode_seq(rec.rcseq), rec.qual[::-1]
        else:
            s, q = decode_seq(rec.seq), rec.qual
        rname = mr.chr_r1 if not (flag & RUNMAP) else "*"
        pos = mr.spos_r1 if not (flag & RUNMAP) else 0
        self.fh.write(f"{rec.rname}\t{flag}\t{rname}\t{pos}\t255\t*\t"
                      f"*\t0\t0\t{s}\t{q}\n")

    # write_pam_rec_se is a stub in the reference (output.cpp:258-260);
    # we emit the mapped-mate half of the PE PAM record instead.
    def write_pam_se(self, rec: ReadRecord):
        mr = rec.mr
        if _MAPPED_TYPES(mr.type):
            r1d = "+" if mr.r1_forward else "-"
            self.fh.write(
                f"{rec.rname}\t{mr.chr_r1}\t{mr.spos_r1}\t{mr.epos_r1}\t"
                f"{mr.mlen_r1}\t{mr.qspos_r1}\t{mr.qepos_r1}\t{r1d}\t"
                f"{mr.ed_r1}\t{mr.type}\n")
        else:
            self.fh.write(f"{rec.rname}" + "\t*" * 9 + f"\t{mr.type}\n")

    # output.cpp:151-278
    def write_sam_pe(self, rec1: ReadRecord, rec2: ReadRecord):
        mr = rec1.mr
        f1 = set_flag_pe(mr, True)
        f2 = set_flag_pe(mr, False)
        if mr.spos_r1 < mr.spos_r2:
            t1, t2 = mr.tlen, -mr.tlen
        else:
            t1, t2 = -mr.tlen, mr.tlen
        if f1 & RUNMAP:
            rname1, rnext2, pos1, pnext2 = "*", "*", 0, 0
            t1 = t2 = 0
        else:
            rname1 = mr.chr_r1
            rnext2 = "=" if mr.chr_r1 == mr.chr_r2 else mr.chr_r1
            pos1, pnext2 = mr.spos_r1, mr.spos_r1
        if f2 & RUNMAP:
            rname2, rnext1, pos2, pnext1 = "*", "*", 0, 0
            t1 = t2 = 0
        else:
            rname2 = mr.chr_r2
            rnext1 = "=" if mr.chr_r1 == mr.chr_r2 else mr.chr_r2
            pos2, pnext1 = mr.spos_r2, mr.spos_r2

        def seq_qual(rec, flag):
            if flag & RREVER:
                return decode_seq(rec.rcseq), rec.qual[::-1]
            return decode_seq(rec.seq), rec.qual

        s1, q1 = seq_qual(rec1, f1)
        s2, q2 = seq_qual(rec2, f2)

        def tags(flag, ed):
            if flag & RUNMAP:
                return f"\tAT:i:{mr.type}\tNM:i:0\tJC:i:0\tTC:i:0"
            return (f"\tAT:i:{mr.type}\tNM:i:{ed}\tJC:i:{mr.junc_num}"
                    f"\tTC:i:{int(mr.gm_compatible)}")

        self.fh.write(f"{rec1.rname}\t{f1}\t{rname1}\t{pos1}\t255\t*\t"
                      f"{rnext1}\t{pnext1}\t{t1}\t{s1}\t{q1}"
                      f"{tags(f1, mr.ed_r1)}\n")
        self.fh.write(f"{rec1.rname}\t{f2}\t{rname2}\t{pos2}\t255\t*\t"
                      f"{rnext2}\t{pnext2}\t{t2}\t{s2}\t{q2}"
                      f"{tags(f2, mr.ed_r2)}\n")
