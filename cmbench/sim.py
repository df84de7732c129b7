"""The benchmark's generator of genomes, annotations and read libraries:
a frozen copy of the port's ``sim.py``.

``make_genome`` draws a random genome with a gene / transcript / exon
annotation (written as FASTA and GTF); ``simulate_reads`` draws paired-end
reads from linear transcripts and from circularised exon runs, whose
fragments cross a back-splice junction."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


BASES = "ACGT"


@dataclasses.dataclass
class SimTranscript:
    tid: str
    gene: str
    exons: List[Tuple[int, int]]  # 1-based inclusive, chromosome coords


@dataclasses.dataclass
class SimGene:
    gid: str
    start: int
    end: int
    strand: str
    transcripts: List[SimTranscript]


@dataclasses.dataclass
class SimGenome:
    chrom: str
    seq: str                     # chromosome sequence (ACGT)
    genes: List[SimGene]

    def write_fasta(self, path: str, width: int = 60, append: bool = False):
        with open(path, "a" if append else "w") as f:
            f.write(f">{self.chrom}\n")
            if width <= 0:
                # single-line record: Gbp-scale writes skip the 52M-iteration
                # python wrap loop (read_fasta handles any line length)
                f.write(self.seq + "\n")
                return
            for i in range(0, len(self.seq), width):
                f.write(self.seq[i:i + width] + "\n")

    def write_gtf(self, path: str, append: bool = False):
        with open(path, "a" if append else "w") as f:
            for g in self.genes:
                attrs = f'gene_id "{g.gid}";'
                f.write(f"{self.chrom}\tsim\tgene\t{g.start}\t{g.end}\t.\t"
                        f"{g.strand}\t.\t{attrs}\n")
                for t in g.transcripts:
                    ts = min(s for s, _ in t.exons)
                    te = max(e for _, e in t.exons)
                    ta = attrs + f' transcript_id "{t.tid}";'
                    f.write(f"{self.chrom}\tsim\ttranscript\t{ts}\t{te}\t.\t"
                            f"{g.strand}\t.\t{ta}\n")
                    exons = t.exons if g.strand == "+" else t.exons[::-1]
                    for i, (s, e) in enumerate(exons):
                        ea = ta + f' exon_number "{i + 1}";'
                        f.write(f"{self.chrom}\tsim\texon\t{s}\t{e}\t.\t"
                                f"{g.strand}\t.\t{ea}\n")


def make_genome(rng: np.random.Generator, length: int = 100_000,
                n_genes: int = 4, exons_per_gene: int = 5,
                exon_len: Tuple[int, int] = (150, 400),
                intron_len: Tuple[int, int] = (200, 800),
                chrom: str = "chr1", dup_frac: float = 0.0,
                gene_prefix: Optional[str] = None,
                n_isoforms: int = 2, bnd_jitter: int = 0) -> SimGenome:
    """``n_isoforms``/``bnd_jitter`` > defaults give Ensembl-density
    annotation: each extra isoform randomly skips middle exons and
    jitters exon boundaries into the flanking introns, which fragments
    the disjoint-interval tree (many state-2/3 continuation intervals
    per exon) the way dense real annotation does — the regime the
    device extension walk must cross (extend.cpp:491-650)."""
    codes = rng.integers(0, 4, size=length, dtype=np.uint8)
    # segmental duplications for realistic seed multiplicity: copy random
    # 1-5 kb windows over random destinations until ~dup_frac of the genome
    # is repeated content
    if dup_frac > 0:
        dup_total = 0
        while dup_total < dup_frac * length:
            dl = int(rng.integers(1000, 5001))
            src = int(rng.integers(0, max(1, length - dl)))
            dst = int(rng.integers(0, max(1, length - dl)))
            codes[dst:dst + dl] = codes[src:src + dl]
            dup_total += dl
    seq = np.frombuffer(b"ACGT", np.uint8)[codes].tobytes().decode()
    genes: List[SimGene] = []
    gene_gap = length // (n_genes + 1)
    pos = gene_gap // 2
    for gi in range(n_genes):
        exons = []
        p = pos
        for ei in range(exons_per_gene):
            el = int(rng.integers(*exon_len))
            exons.append((p, p + el - 1))
            p += el + int(rng.integers(*intron_len))
        if gene_prefix is None:
            gid, t1, t2 = f"G{gi + 1}", f"T{gi + 1}.1", f"T{gi + 1}.2"
        else:
            # genome-wide-unique ids for multi-chromosome simulations
            gid = f"{gene_prefix}{gi + 1}"
            t1, t2 = f"{gid}.T1", f"{gid}.T2"
        strand = "+" if gi % 2 == 0 else "-"
        txs = [SimTranscript(t1, gid, exons)]
        # a second isoform skipping one middle exon
        if exons_per_gene >= 3:
            skip = exons[:1] + exons[2:]
            txs.append(SimTranscript(t2, gid, skip))
        # Ensembl-density extras: random skips + boundary jitter
        for iso in range(2, n_isoforms):
            ex = list(exons)
            if len(ex) >= 3 and rng.random() < 0.7:
                drop = int(rng.integers(1, len(ex) - 1))
                ex = ex[:drop] + ex[drop + 1:]
            if bnd_jitter > 0:
                jex = []
                for (s, e) in ex:
                    if rng.random() < 0.5:
                        s = max(1, s - int(rng.integers(0, bnd_jitter + 1)))
                    if rng.random() < 0.5:
                        e = min(length, e + int(rng.integers(
                            0, bnd_jitter + 1)))
                    jex.append((s, e))
                # keep exons disjoint within the isoform
                ex = []
                for (s, e) in jex:
                    if ex and s <= ex[-1][1]:
                        s = ex[-1][1] + 1
                    if s <= e:
                        ex.append((s, e))
            if ex:
                tname = (f"T{gi + 1}.{iso + 1}" if gene_prefix is None
                         else f"{gid}.T{iso + 1}")
                txs.append(SimTranscript(tname, gid, ex))
        genes.append(SimGene(gid, exons[0][0], exons[-1][1], strand, txs))
        pos += gene_gap
        if exons[-1][1] + gene_gap // 2 > length:
            break
    return SimGenome(chrom, seq, genes)


def transcript_seq(g: SimGenome, t: SimTranscript) -> str:
    return "".join(g.seq[s - 1:e] for s, e in t.exons)


def circular_seq(g: SimGenome, t: SimTranscript, i0: int, i1: int) -> str:
    """Sequence of the circle made of exons i0..i1 (inclusive)."""
    return "".join(g.seq[s - 1:e] for s, e in t.exons[i0:i1 + 1])


_A2C = np.full(256, 0, np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _A2C[_b] = _i
_C2A = np.frombuffer(b"ACGT", np.uint8)


def _mutate(rng, s: str, rate: float) -> str:
    if rate <= 0:
        return s
    a = np.frombuffer(s.encode(), np.uint8)
    hit = rng.random(a.shape[0]) < rate
    n_hit = int(hit.sum())
    if n_hit == 0:
        return s
    c = _A2C[a].copy()
    c[hit] = (c[hit] + rng.integers(1, 4, size=n_hit).astype(np.uint8)) % 4
    return _C2A[c].tobytes().decode()


_COMPLEMENT = str.maketrans("ACGT", "TGCA")


def _revcomp(s: str) -> str:
    """The reverse complement of an ACGT string."""
    return s.translate(_COMPLEMENT)[::-1]


@dataclasses.dataclass
class SimRead:
    name: str
    r1: str
    r2: str
    truth: str  # "linear" | "circ" (a read covers the BSJ) | "circ_mid"
                # (fragment crosses the BSJ but neither read does -> looks
                #  like an inverted-order pair, CHIORF in the reference)
    circ_bp: Optional[Tuple[int, int]] = None  # (spos, epos) chromosome coords


def simulate_reads(rng: np.random.Generator, g: SimGenome, n_linear: int,
                   n_circ: int, read_len: int = 100,
                   frag_len: Tuple[int, int] = (150, 350),
                   err_rate: float = 0.0,
                   name_prefix: str = "") -> Tuple[List[SimRead],
                                                   List[Tuple[int, int]]]:
    """Simulate PE reads; R2 is the reverse complement mate (FR orientation).
    Circular fragments are drawn from a circularized exon run so a subset of
    reads/mates crosses the back-splice junction."""
    reads: List[SimRead] = []
    circ_truth: List[Tuple[int, int]] = []

    all_tx = [(gene, t) for gene in g.genes for t in gene.transcripts]
    tx_seq = {}
    for i in range(n_linear):
        k = int(rng.integers(0, len(all_tx)))
        gene, t = all_tx[k]
        if k not in tx_seq:
            tx_seq[k] = transcript_seq(g, t)
        ts = tx_seq[k]
        fl = int(rng.integers(*frag_len))
        fl = min(fl, len(ts))
        if fl < read_len:
            fl = min(len(ts), read_len)
        start = int(rng.integers(0, len(ts) - fl + 1))
        frag = ts[start:start + fl]
        r1 = _mutate(rng, frag[:read_len], err_rate)
        r2 = _mutate(rng, _revcomp(frag[-read_len:]), err_rate)
        reads.append(SimRead(f"{name_prefix}L{i}", r1, r2, "linear"))

    # circles: use exons 1..3 of each gene's first transcript
    circles = []
    for gene in g.genes:
        t = gene.transcripts[0]
        if len(t.exons) >= 4:
            i0, i1 = 1, 3
        else:
            i0, i1 = 0, len(t.exons) - 1
        cs = circular_seq(g, t, i0, i1)
        bp = (t.exons[i0][0], t.exons[i1][1])
        circles.append((gene, t, i0, i1, cs, bp))

    for i in range(n_circ):
        gene, t, i0, i1, cs, bp = circles[int(rng.integers(0, len(circles)))]
        L = len(cs)
        fl = int(rng.integers(*frag_len))
        fl = min(fl, L)
        if fl < read_len:
            fl = read_len
        # rotate so the fragment crosses the back-splice junction: start
        # near the end of the circle
        start = int(rng.integers(0, L))
        frag = (cs + cs)[start:start + fl]
        r1 = _mutate(rng, frag[:read_len], err_rate)
        r2 = _mutate(rng, _revcomp(frag[-read_len:]), err_rate)
        crosses = start + fl > L
        truth = "linear"
        if crosses:
            # junction offset within the fragment; detectable only when a
            # read covers it with enough flank to anchor a seed on each side
            jpos = L - start
            margin = 18
            in_r1 = margin <= jpos <= read_len - margin
            in_r2 = margin <= jpos - (fl - read_len) <= read_len - margin
            truth = "circ" if (in_r1 or in_r2) else "circ_mid"
        reads.append(SimRead(f"{name_prefix}C{i}", r1, r2, truth,
                             circ_bp=bp if crosses else None))
        if truth == "circ":
            circ_truth.append(bp)
    return reads, sorted(set(circ_truth))


def write_fastq(reads: List[SimRead], r1_path: str, r2_path: str):
    with open(r1_path, "w") as f1, open(r2_path, "w") as f2:
        for r in reads:
            q1 = "I" * len(r.r1)
            q2 = "I" * len(r.r2)
            f1.write(f"@{r.name}\n{r.r1}\n+\n{q1}\n")
            f2.write(f"@{r.name}\n{r.r2}\n+\n{q2}\n")
