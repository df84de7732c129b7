"""FASTQ reading/writing and the mapping-state round-trip channel.

Reference: src/fastq_parser.cpp, src/filter.cpp:399-455.  Between mapping
rounds and into the circRNA stage, each read's best-mapping-so-far travels as
a 23-token comment appended to the FASTQ header (FQCOMMENTCNT,
fastq_parser.h:12); this module parses and formats that channel
byte-compatibly with the reference.
"""

from __future__ import annotations

import gzip
import os
from typing import Iterator, Optional, TextIO, Tuple

import numpy as np

from ..config import (Config, CONCRD, DISCRD, CHIORF, CHIBSJ, CHI2BSJ,
                      CONGEN, CONGNM, NOPROC_NOMATCH, INF, DEF_CONTIG_SIZE)
from ..ops.encode import encode_seq, revcomp
from ..pipeline.types import MatchedRead
from ..pipeline.mapping import ReadRecord

FQCOMMENTCNT = 23

_STATEFUL_TYPES = (CONCRD, DISCRD, CHIORF, CHIBSJ, CHI2BSJ, CONGNM, CONGEN)


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def parse_map_comment(tokens, mr: MatchedRead, max_ed: int):
    """fill_map_info (fastq_parser.cpp:203-269)."""
    if len(tokens) != FQCOMMENTCNT:
        # no carried state: the fields set here equal MatchedRead.default(),
        # so the record stays untouched (batch engines use the fast path)
        mr.type = NOPROC_NOMATCH
        mr.tlen = INF
        mr.junc_num = 0
        mr.gm_compatible = False
        return
    mr.touched = True
    mr.type = int(tokens[2])
    if mr.type in _STATEFUL_TYPES:
        mr.genome_spos = int(tokens[1])
        mr.chr_r1 = tokens[3]
        mr.spos_r1 = int(tokens[4])
        mr.epos_r1 = int(tokens[5])
        mr.mlen_r1 = int(tokens[6])
        mr.qspos_r1 = int(tokens[7])
        mr.qepos_r1 = int(tokens[8])
        mr.r1_forward = tokens[9][0] == "+"
        mr.ed_r1 = int(tokens[10])
        mr.chr_r2 = tokens[11]
        mr.spos_r2 = int(tokens[12])
        mr.epos_r2 = int(tokens[13])
        mr.mlen_r2 = int(tokens[14])
        mr.qspos_r2 = int(tokens[15])
        mr.qepos_r2 = int(tokens[16])
        mr.r2_forward = tokens[17][0] == "+"
        mr.ed_r2 = int(tokens[18])
        mr.tlen = int(tokens[19])
        mr.junc_num = int(tokens[20])
        mr.gm_compatible = tokens[21][0] == "1"
        mr.contig_num = int(tokens[22])
    else:
        mr.genome_spos = 0
        mr.chr_r1 = mr.chr_r2 = "-"
        mr.spos_r1 = mr.epos_r1 = mr.mlen_r1 = 0
        mr.qspos_r1 = mr.qepos_r1 = 0
        mr.r1_forward = True
        mr.ed_r1 = max_ed + 1
        mr.spos_r2 = mr.epos_r2 = mr.mlen_r2 = 0
        mr.qspos_r2 = mr.qepos_r2 = 0
        mr.r2_forward = True
        mr.ed_r2 = max_ed + 1
        mr.tlen = INF
        mr.junc_num = 0
        mr.gm_compatible = False
        mr.contig_num = 0


def format_map_comment(mr: MatchedRead, chrloc2conloc=None) -> str:
    """write_read_category comment (filter.cpp:413-445)."""
    if mr.type in _STATEFUL_TYPES:
        con_spos = mr.spos_r1
        gspos = mr.contig_num * DEF_CONTIG_SIZE + con_spos
        if chrloc2conloc is not None:
            _, con_spos, _ = chrloc2conloc(mr.chr_r1, mr.spos_r1, mr.epos_r1)
            gspos = mr.contig_num * DEF_CONTIG_SIZE + con_spos
        elif mr.genome_spos:
            # re-spill of an already-carried record (external sort chunks):
            # keep the original sort key instead of recomputing it from
            # chromosome coordinates without the chr->contig shift
            gspos = mr.genome_spos
        r1d = "+" if mr.r1_forward else "-"
        r2d = "+" if mr.r2_forward else "-"
        return (f" {gspos} {mr.type} "
                f"{mr.chr_r1} {mr.spos_r1} {mr.epos_r1} {mr.mlen_r1} "
                f"{mr.qspos_r1} {mr.qepos_r1} {r1d} {mr.ed_r1} "
                f"{mr.chr_r2} {mr.spos_r2} {mr.epos_r2} {mr.mlen_r2} "
                f"{mr.qspos_r2} {mr.qepos_r2} {r2d} {mr.ed_r2} "
                f"{mr.tlen} {mr.junc_num} {int(mr.gm_compatible)} "
                f"{mr.contig_num}")
    return f" * {mr.type} * * * * * * * * * * * * * * * * * * * *"


class FastqReader:
    """Streaming FASTQ reader producing ReadRecord (+ map-state comment)."""

    def __init__(self, path: str, cfg: Config):
        self.path = path
        self.cfg = cfg
        self.fh: Optional[TextIO] = None

    def __iter__(self) -> Iterator[ReadRecord]:
        with _open(self.path) as fh:
            while True:
                header = fh.readline()
                if not header:
                    return
                header = header.rstrip("\n")
                seq = fh.readline().rstrip("\n")
                fh.readline()  # '+'
                qual = fh.readline().rstrip("\n")
                if not header.startswith("@"):
                    raise ValueError(f"bad FASTQ record in {self.path}")
                tokens = header[1:].split(" ")
                rname = tokens[0]
                if len(rname) >= 2 and rname[-2] == "/":
                    rname = rname[:-2]
                mr = MatchedRead.default(self.cfg.max_ed)
                parse_map_comment(tokens, mr, self.cfg.max_ed)
                codes = encode_seq(seq)
                yield ReadRecord(rname, codes, revcomp(codes), qual,
                                 len(seq), mr)


def read_pairs(path1: str, path2: str, cfg: Config
               ) -> Iterator[Tuple[ReadRecord, ReadRecord]]:
    it1 = iter(FastqReader(path1, cfg))
    it2 = iter(FastqReader(path2, cfg))
    for r1 in it1:
        r2 = next(it2, None)
        if r2 is None:
            raise ValueError("R1/R2 FASTQ length mismatch")
        yield r1, r2


def iter_sorted_remain(r1_path: str, r2_path: str, cfg: Config,
                       internal: bool = False, chunk_pairs: int = 200_000,
                       workdir: str = None):
    """Stream the circ-stage remain FASTQ pair sorted by genome_spos.

    Replaces the reference's GNU ``sort`` subprocess / in-memory fallback
    (process_circ.cpp:127-193): with ``internal`` the whole set is sorted in
    RAM (the -Z flag); otherwise pairs are chunk-sorted and spilled to disk
    remain-files, then streamed back through a k-way heap merge, so memory
    stays bounded by ``chunk_pairs`` regardless of candidate count.
    """
    import heapq
    import itertools
    import shutil
    import tempfile

    # multi-host runs pass per-host shard path lists (host 0 merges all)
    r1_paths = [r1_path] if isinstance(r1_path, str) else list(r1_path)
    r2_paths = [r2_path] if isinstance(r2_path, str) else list(r2_path)
    src = itertools.chain.from_iterable(
        iter_remain_pairs(p1, p2, cfg)
        for p1, p2 in zip(r1_paths, r2_paths))

    # tie-break equal positions by the ORIGINAL global pair ordinal so the
    # merged multi-host stream interleaves shards exactly like the
    # single-host stable sort (support-name order in circ_report is
    # stream-order-dependent; pinned by tests/test_distributed.py)
    def key(pr):
        return (pr[0].mr.genome_spos, getattr(pr[0], "ordinal", 0))

    if internal:
        recs = list(src)
        recs.sort(key=key)
        yield from recs
        return

    first = list(itertools.islice(src, chunk_pairs))
    first.sort(key=key)
    second = list(itertools.islice(src, chunk_pairs))
    if not second:
        # common case: fits in one chunk — no spill
        yield from first
        return

    tmpdir = tempfile.mkdtemp(prefix="circminer_sort_", dir=workdir)
    try:
        n_chunks = 0

        def spill(recs):
            nonlocal n_chunks
            w = RemainWriter(os.path.join(tmpdir, "chunk"), n_chunks)
            for r1, r2 in recs:
                w.write(r1, r2, r1.mr)
            w.close()
            n_chunks += 1
            return w.p1, w.p2

        paths = [spill(first)]
        second.sort(key=key)
        paths.append(spill(second))
        while True:
            chunk = list(itertools.islice(src, chunk_pairs))
            if not chunk:
                break
            chunk.sort(key=key)
            paths.append(spill(chunk))

        streams = [iter_remain_pairs(p1, p2, cfg) for p1, p2 in paths]
        yield from heapq.merge(*streams, key=key)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


class RemainWriter:
    """Writes the next-round / circ-stage 'remain' FASTQ pair
    (filter.cpp:413-455) plus a ``.ord`` sidecar of original global pair
    ordinals (one int per record; not part of the reference format) so a
    multi-host merge can reproduce the single-host tie order."""

    def __init__(self, prefix: str, round_num: int):
        self.p1 = f"{prefix}_{round_num}_remain_R1.fastq"
        self.p2 = f"{prefix}_{round_num}_remain_R2.fastq"
        self.po = f"{prefix}_{round_num}_remain.ord"
        self.f1 = open(self.p1, "w")
        self.f2 = open(self.p2, "w")
        self.fo = open(self.po, "w")
        self._n = 0

    def write(self, rec1: ReadRecord, rec2: ReadRecord, mr: MatchedRead,
              chrloc2conloc=None, seq1: str = None, seq2: str = None):
        from ..ops.encode import decode_seq
        comment = format_map_comment(mr, chrloc2conloc)
        s1 = seq1 if seq1 is not None else decode_seq(rec1.seq)
        s2 = seq2 if seq2 is not None else decode_seq(rec2.seq)
        self.f1.write(f"@{rec1.rname}{comment}\n{s1}\n+\n{rec1.qual}\n")
        self.f2.write(f"@{rec2.rname}{comment}\n{s2}\n+\n{rec2.qual}\n")
        o = getattr(rec1, "ordinal", None)
        if o is None:
            # Multi-host merges tie-break on GLOBAL ordinals; a per-writer
            # local counter silently corrupts that order — warn once.
            if self._n == 0:
                import sys
                sys.stderr.write(
                    "[remain] WARNING: record has no global ordinal; "
                    "falling back to per-writer sequential ordinals "
                    "(multi-host merge tie order not guaranteed)\n")
            o = self._n
        self.fo.write(f"{o}\n")
        self._n += 1

    def close(self):
        self.f1.close()
        self.f2.close()
        self.fo.close()


def iter_remain_pairs(p1: str, p2: str, cfg: Config):
    """Stream a remain FASTQ pair, re-attaching each record's original
    global pair ordinal from the ``.ord`` sidecar (sequential fallback when
    the sidecar is absent — e.g. reference-produced remain files)."""
    import itertools as _it
    po = p1.replace("_R1.fastq", ".ord")
    if os.path.exists(po):
        with open(po) as f:
            ords = [int(x) for x in f]
        # A stale/truncated sidecar would silently truncate the pair
        # stream via zip; chain a counter so exhaustion raises below.
        osrc = _it.chain(iter(ords), _it.repeat(None))
    else:
        ords = None
        osrc = _it.count()
    n = 0
    for (r1, r2), o in zip(zip(FastqReader(p1, cfg), FastqReader(p2, cfg)),
                           osrc):
        if o is None:
            raise RuntimeError(
                f"{po}: .ord sidecar has {len(ords)} lines but the remain "
                f"FASTQ has more records — stale sidecar? delete it to "
                f"fall back to sequential ordinals")
        r1.ordinal = o
        n += 1
        yield r1, r2
    if ords is not None and n != len(ords):
        raise RuntimeError(
            f"{po}: .ord sidecar has {len(ords)} lines but the remain "
            f"FASTQ has {n} records — stale sidecar?")
