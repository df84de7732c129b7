"""GTF parsing into per-contig merged exon/gene tables.

Mirrors GTFParser::load_gtf (reference: src/gene_annotation.cpp:191-399):
- gene/transcript/exon records only; coordinates shifted into packed-contig
  space; records on chromosomes absent from the genome index are dropped.
- consecutive exon records of one transcript yield UniqSeg entries whose
  ``next_exon_beg`` points at the genomically-next exon of that transcript
  (strand-aware; 0 for the transcript's last exon).
- identical (start, end, gene, next_exon_beg) segments from different
  transcripts are merged, accumulating the transcript id list in encounter
  order.
- two contig-length bit masks: ``intronic`` (inside a gene body, outside all
  exons) and ``near_border`` (within max_read_len of an exon boundary).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

import numpy as np

from .fasta import ContigLen, build_shift_maps, chrloc2conloc


@dataclasses.dataclass(frozen=True)
class UniqSegKey:
    """Sort key matches UniqSeg::operator< (common.cpp:110-118)."""
    start: int
    end: int
    gene_id: int
    next_exon_beg: int

    def sort_key(self):
        return (self.start, self.end, self.gene_id, -self.next_exon_beg)


class BitMask:
    """Packed contig-length bitset (1-based positions)."""

    def __init__(self, length: int):
        self.length = length
        self.bits = np.zeros((length + 2 + 7) // 8, dtype=np.uint8)

    def set_range(self, lo: int, hi: int, value: bool):
        """Set positions lo..hi inclusive."""
        lo = max(lo, 0)
        hi = min(hi, self.length + 1)
        if hi < lo:
            return
        idx = np.arange(lo, hi + 1)
        if value:
            np.bitwise_or.at(self.bits, idx >> 3,
                             (np.uint8(1) << (idx & 7).astype(np.uint8)))
        else:
            np.bitwise_and.at(self.bits, idx >> 3,
                              ~(np.uint8(1) << (idx & 7).astype(np.uint8)))

    def get(self, pos):
        pos = np.asarray(pos)
        return (self.bits[pos >> 3] >> (pos & 7).astype(np.uint8)) & 1

    def __getitem__(self, pos):
        return bool(self.get(pos)) if np.isscalar(pos) else self.get(pos)

    def count(self) -> int:
        return int(np.unpackbits(self.bits).sum())


@dataclasses.dataclass
class ContigAnnotationRaw:
    """Parsed GTF state for one packed contig (0-based contig id)."""
    gene_ids: List[str]
    transcript_ids: List[str]
    gene_start: List[int]      # gid2ginfo
    gene_end: List[int]
    # merged exons: key -> ordered transcript id list
    merged_exons: Dict[UniqSegKey, List[int]]
    # merged genes: (start, end) -> first gene_id index (GeneInfo carries the
    # gene_id of the first record with that span; reference common.h:174-183)
    merged_genes: Dict[Tuple[int, int], int]
    near_border: BitMask
    intronic: BitMask


def _parse_attrs(attr_field: str) -> Dict[str, str]:
    out = {}
    for part in attr_field.split(";"):
        part = part.strip()
        if not part:
            continue
        toks = part.replace('"', " ").split()
        if len(toks) >= 2:
            out[toks[0]] = toks[1]
    return out


@dataclasses.dataclass
class GtfRecord:
    """One raw GTF feature line (for eval tooling; gene_annotation.cpp
    parse_gtf_rec:102-143 analog without the contig mapping)."""
    chrom: str
    source: str
    feature: str
    start: int
    end: int
    strand: str
    gid: str
    tid: str
    attrs: Dict[str, str]


def parse_gtf_records(path: str) -> "Iterator[GtfRecord]":
    """Stream raw GTF records (gene/transcript/exon/...)."""
    with open(path) as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            t = line.rstrip("\n").split("\t")
            if len(t) < 9:
                continue
            attrs = _parse_attrs(t[8])
            yield GtfRecord(t[0], t[1], t[2], int(t[3]), int(t[4]), t[6],
                            attrs.get("gene_id", ""),
                            attrs.get("transcript_id", ""), attrs)


def load_gtf(path: str, contig_info: List[ContigLen], n_contigs: int,
             max_read_len: int = 300,
             contig_lengths: List[int] | None = None) -> List[ContigAnnotationRaw]:
    """Parse a GTF into per-contig raw annotation."""
    chr2con, _ = build_shift_maps(contig_info)

    if contig_lengths is None:
        contig_lengths = [0] * n_contigs
        for cl in contig_info:
            cid = cl.contig_id - 1
            contig_lengths[cid] = max(contig_lengths[cid], cl.end_pos)

    per_contig = [
        ContigAnnotationRaw(
            gene_ids=[], transcript_ids=[], gene_start=[], gene_end=[],
            merged_exons={}, merged_genes={},
            near_border=BitMask(contig_lengths[c]),
            intronic=BitMask(contig_lengths[c]),
        )
        for c in range(n_contigs)
    ]

    def add_merged_exon(ca: ContigAnnotationRaw, key: UniqSegKey, tid: int):
        ca.merged_exons.setdefault(key, []).append(tid)

    # exon state machine (reference: gene_annotation.cpp:266-346)
    prev = None  # dict for previous exon record

    def flush_prev():
        # reference flush (gene_annotation.cpp:309-346): forward-strand last
        # exon gets next_exon_beg=0; reverse-strand keeps the value assigned
        # when the record was first seen (its genomic successor).
        nonlocal prev
        if prev is None:
            return
        next_start = 0 if prev["fwd"] else prev["next_start"]
        key = UniqSegKey(prev["start"], prev["end"], prev["gene_id_int"],
                         next_start)
        add_merged_exon(per_contig[prev["chr_id"]], key, prev["trans_id_int"])
        prev = None

    opener = open
    if path.endswith(".gz"):
        import gzip
        opener = gzip.open
    with opener(path, "rt") as f:
        for line in f:
            if line.startswith("#"):
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 9:
                continue
            ftype = fields[2]
            if ftype not in ("gene", "transcript", "exon"):
                continue
            chrname = fields[0]
            start = int(fields[3])
            end = int(fields[4])
            fwd = fields[6] == "+"
            attrs = _parse_attrs(fields[8])

            con, start, end = chrloc2conloc(chr2con, chrname, start, end)
            chr_id = int(con) - 1
            if chr_id < 0 or chr_id >= n_contigs:
                continue  # reference skips without flushing (gene_annotation.cpp:213)
            ca = per_contig[chr_id]

            if ftype == "gene":
                ca.gene_ids.append(attrs.get("gene_id", "-"))
                ca.intronic.set_range(start, end, True)
                ca.gene_start.append(start)
                ca.gene_end.append(end)
                span = (start, end)
                if span not in ca.merged_genes:
                    ca.merged_genes[span] = len(ca.gene_start) - 1

            if ftype == "transcript":
                ca.transcript_ids.append(attrs.get("transcript_id", "-"))

            if ftype == "exon":
                ca.intronic.set_range(start, end, False)
                ca.near_border.set_range(max(0, start - max_read_len),
                                         start - 1, True)
                ca.near_border.set_range(max(0, end - max_read_len + 1),
                                         end, True)

                cur = {
                    "start": start, "end": end, "fwd": fwd,
                    "chr_id": chr_id,
                    "trans_id_int": len(ca.transcript_ids) - 1,
                    "gene_id_int": len(ca.gene_ids) - 1,
                    "next_start": 0, "prev_end": 0,
                }
                if prev is None:
                    prev = cur
                    continue
                # consecutive exon records
                # forward: prev's genomic successor is cur; reverse: cur's
                # genomic successor is prev (exons listed high-to-low).
                if prev["fwd"]:
                    prev["next_start"] = cur["start"]
                else:
                    cur["next_start"] = prev["start"]
                key = UniqSegKey(prev["start"], prev["end"],
                                 prev["gene_id_int"], prev["next_start"])
                add_merged_exon(per_contig[prev["chr_id"]], key,
                                prev["trans_id_int"])
                prev = cur
            else:
                # non-exon record after exon(s): flush pending exon
                flush_prev()

    flush_prev()
    return per_contig
