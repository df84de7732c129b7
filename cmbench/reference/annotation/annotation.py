"""Flat annotation arrays: disjoint exon/gene interval maps, trans2seg.

Replaces FlatIntervalTree (reference: src/interval_tree_impl.h) with an
O(n log n) boundary decomposition producing the *same* disjoint interval list:
split the covered region at every segment start and every end+1, keep covered
sub-intervals, and list each interval's overlapping segments in UniqSeg sort
order — which is exactly the order the reference's incremental insertion
accumulates them in.

Everything lives in numpy CSR arrays usable from both host orchestration and
(mirrored via jnp) device kernels.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..config import Config, MAXUB, INF
from ..io.gtf import ContigAnnotationRaw, UniqSegKey, BitMask
from ..io.fasta import ContigLen, build_shift_maps


@dataclasses.dataclass
class ContigAnnotation:
    """Per-contig annotation arrays."""
    # disjoint exon intervals (sorted by spos)
    iv_spos: np.ndarray        # uint32[n_iv]
    iv_epos: np.ndarray        # uint32[n_iv]
    iv_max_end: np.ndarray     # uint32[n_iv] aggregates over seg_list
    iv_min_end: np.ndarray
    iv_max_next: np.ndarray
    # CSR: interval -> segments
    iv_seg_off: np.ndarray     # int64[n_iv + 1]
    seg_start: np.ndarray      # uint32[n_seg_ref] (referenced seg instances)
    seg_end: np.ndarray
    seg_next: np.ndarray
    seg_gene: np.ndarray       # int32 gene index
    seg_uid: np.ndarray        # int32 unique merged-exon id (for tid lookup)
    # merged-exon uid -> transcript list CSR
    uid_tid_off: np.ndarray    # int64[n_uid + 1]
    uid_tid: np.ndarray        # int32[]
    # trans2seg CSR: per transcript, states over interval rows
    t2s_off: np.ndarray        # int64[n_trans + 1]
    t2s_state: np.ndarray      # uint8[]
    trans_start_ind: np.ndarray  # int32[n_trans] first interval index
    # disjoint gene intervals
    gv_spos: np.ndarray
    gv_epos: np.ndarray
    gv_seg_off: np.ndarray
    gv_gene_start: np.ndarray  # per referenced gene-seg
    gv_gene_end: np.ndarray
    gv_gene_id: np.ndarray
    # gene id -> info
    gene_start: np.ndarray
    gene_end: np.ndarray
    # names
    gene_ids: List[str]
    transcript_ids: List[str]
    # masks
    near_border: BitMask
    intronic: BitMask

    @property
    def n_intervals(self) -> int:
        return int(self.iv_spos.shape[0])


def _decompose(segs: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Disjoint covered intervals split at all boundaries."""
    if not segs:
        return []
    starts = np.array([s for s, _ in segs], dtype=np.int64)
    ends = np.array([e for _, e in segs], dtype=np.int64)
    bounds = np.unique(np.concatenate([starts, ends + 1]))
    out = []
    # coverage via event counting
    ev = np.zeros(len(bounds), dtype=np.int64)
    si = np.searchsorted(bounds, starts)
    ei = np.searchsorted(bounds, ends + 1)
    np.add.at(ev, si, 1)
    np.add.at(ev, ei, -1)
    cov = np.cumsum(ev)
    for i in range(len(bounds) - 1):
        if cov[i] > 0:
            out.append((int(bounds[i]), int(bounds[i + 1]) - 1))
    return out


def build_contig_annotation(raw: ContigAnnotationRaw,
                            cfg: Config) -> ContigAnnotation:
    # --- merged exons in UniqSeg order ---
    keys = sorted(raw.merged_exons.keys(), key=UniqSegKey.sort_key)
    n_uid = len(keys)
    uid_start = np.array([k.start for k in keys], dtype=np.int64)
    uid_end = np.array([k.end for k in keys], dtype=np.int64)
    uid_next = np.array([k.next_exon_beg for k in keys], dtype=np.int64)
    uid_gene = np.array([k.gene_id for k in keys], dtype=np.int64)
    uid_tid_off = np.zeros(n_uid + 1, dtype=np.int64)
    uid_tid_list = []
    for i, k in enumerate(keys):
        tids = raw.merged_exons[k]
        uid_tid_off[i + 1] = uid_tid_off[i] + len(tids)
        uid_tid_list.extend(tids)
    uid_tid = np.array(uid_tid_list, dtype=np.int32)

    # --- disjoint intervals ---
    if n_uid > 0:
        ivs = _decompose(list(zip(uid_start.tolist(), uid_end.tolist())))
    else:
        ivs = []
    if not ivs:
        # dummy interval (reference: gene_annotation.cpp:368-382)
        ivs = [(MAXUB, MAXUB)]
        iv_segs = [[-1]]
    else:
        iv_segs = None

    iv_spos = np.array([a for a, _ in ivs], dtype=np.uint32)
    iv_epos = np.array([b for _, b in ivs], dtype=np.uint32)
    n_iv = len(ivs)

    iv_seg_off = np.zeros(n_iv + 1, dtype=np.int64)
    seg_rows = []  # (uid,) per referenced instance
    if iv_segs is None:
        # For each interval, overlapping segments in uid (sorted) order.
        # Vectorized sweep: for each uid, the covered interval index range.
        iv_starts = iv_spos.astype(np.int64)
        lo_iv = np.searchsorted(iv_starts, uid_start, side="right") - 1
        hi_iv = np.searchsorted(iv_starts, uid_end, side="right") - 1
        per_iv: List[List[int]] = [[] for _ in range(n_iv)]
        for u in range(n_uid):
            for iv in range(lo_iv[u], hi_iv[u] + 1):
                per_iv[iv].append(u)
        for iv in range(n_iv):
            iv_seg_off[iv + 1] = iv_seg_off[iv] + len(per_iv[iv])
            seg_rows.extend(per_iv[iv])
    else:
        iv_seg_off[1] = 1
        seg_rows = [0]
        # dummy uid tables
        uid_start = np.array([MAXUB], dtype=np.int64)
        uid_end = np.array([MAXUB], dtype=np.int64)
        uid_next = np.array([0], dtype=np.int64)
        uid_gene = np.array([0], dtype=np.int64)
        uid_tid_off = np.array([0, 0], dtype=np.int64)
        uid_tid = np.zeros(0, dtype=np.int32)
        n_uid = 1

    seg_uid = np.array(seg_rows, dtype=np.int32)
    seg_start = uid_start[seg_uid].astype(np.uint32)
    seg_end = uid_end[seg_uid].astype(np.uint32)
    seg_next = uid_next[seg_uid].astype(np.uint32)
    seg_gene = uid_gene[seg_uid].astype(np.int32)

    # per-interval aggregates (reference: interval_tree_impl.h:198-211)
    iv_max_end = np.zeros(n_iv, dtype=np.uint32)
    iv_min_end = np.full(n_iv, np.uint32(1_000_000_000))
    iv_max_next = np.zeros(n_iv, dtype=np.uint32)
    for iv in range(n_iv):
        a, b = iv_seg_off[iv], iv_seg_off[iv + 1]
        if b > a:
            iv_max_end[iv] = seg_end[a:b].max()
            iv_min_end[iv] = seg_end[a:b].min()
            iv_max_next[iv] = seg_next[a:b].max()

    # --- trans2seg (reference: interval_tree_impl.h:186-242) ---
    n_trans = len(raw.transcript_ids)
    t_start = np.full(n_trans, INF, dtype=np.int64)
    t_end = np.zeros(n_trans, dtype=np.int64)
    for iv in range(n_iv):
        for e in range(iv_seg_off[iv], iv_seg_off[iv + 1]):
            u = seg_uid[e]
            if u < 0:
                continue
            for tid in uid_tid[uid_tid_off[u]:uid_tid_off[u + 1]]:
                t_start[tid] = min(t_start[tid], iv)
                t_end[tid] = max(t_end[tid], iv)
    t2s_off = np.zeros(n_trans + 1, dtype=np.int64)
    sizes = np.where(t_start <= t_end, t_end - t_start + 1, 1)
    np.cumsum(sizes, out=t2s_off[1:])
    t2s_state = np.zeros(int(t2s_off[-1]), dtype=np.uint8)
    for iv in range(n_iv):
        for e in range(iv_seg_off[iv], iv_seg_off[iv + 1]):
            u = seg_uid[e]
            if u < 0:
                continue
            if iv_spos[iv] == seg_start[e]:
                state = 1
            elif iv_epos[iv] == seg_end[e]:
                state = 3
            else:
                state = 2
            for tid in uid_tid[uid_tid_off[u]:uid_tid_off[u + 1]]:
                t2s_state[t2s_off[tid] + (iv - t_start[tid])] = state
    trans_start_ind = np.where(t_start <= t_end, t_start, 0).astype(np.int32)

    # --- gene interval map ---
    gspans = sorted(raw.merged_genes.keys())
    g_gid = [raw.merged_genes[s] for s in gspans]
    if gspans:
        givs = _decompose(gspans)
        g_start = np.array([s for s, _ in gspans], dtype=np.int64)
        g_end = np.array([e for _, e in gspans], dtype=np.int64)
        gv_spos = np.array([a for a, _ in givs], dtype=np.uint32)
        gv_epos = np.array([b for _, b in givs], dtype=np.uint32)
        gv_starts64 = gv_spos.astype(np.int64)
        lo_iv = np.searchsorted(gv_starts64, g_start, side="right") - 1
        hi_iv = np.searchsorted(gv_starts64, g_end, side="right") - 1
        per_iv = [[] for _ in range(len(givs))]
        for u in range(len(gspans)):
            for iv in range(lo_iv[u], hi_iv[u] + 1):
                per_iv[iv].append(u)
        gv_seg_off = np.zeros(len(givs) + 1, dtype=np.int64)
        rows = []
        for iv in range(len(givs)):
            gv_seg_off[iv + 1] = gv_seg_off[iv] + len(per_iv[iv])
            rows.extend(per_iv[iv])
        rows = np.array(rows, dtype=np.int64) if rows else np.zeros(0, np.int64)
        gv_gene_start = g_start[rows].astype(np.uint32)
        gv_gene_end = g_end[rows].astype(np.uint32)
        gv_gene_id = np.array([g_gid[r] for r in rows], dtype=np.int32)
    else:
        gv_spos = np.array([MAXUB], dtype=np.uint32)
        gv_epos = np.array([MAXUB], dtype=np.uint32)
        gv_seg_off = np.array([0, 1], dtype=np.int64)
        gv_gene_start = np.array([MAXUB], dtype=np.uint32)
        gv_gene_end = np.array([MAXUB], dtype=np.uint32)
        gv_gene_id = np.array([0], dtype=np.int32)

    return ContigAnnotation(
        iv_spos=iv_spos, iv_epos=iv_epos,
        iv_max_end=iv_max_end, iv_min_end=iv_min_end, iv_max_next=iv_max_next,
        iv_seg_off=iv_seg_off,
        seg_start=seg_start, seg_end=seg_end, seg_next=seg_next,
        seg_gene=seg_gene, seg_uid=seg_uid,
        uid_tid_off=uid_tid_off, uid_tid=uid_tid,
        t2s_off=t2s_off, t2s_state=t2s_state,
        trans_start_ind=trans_start_ind,
        gv_spos=gv_spos, gv_epos=gv_epos, gv_seg_off=gv_seg_off,
        gv_gene_start=gv_gene_start, gv_gene_end=gv_gene_end,
        gv_gene_id=gv_gene_id,
        gene_start=np.array(raw.gene_start, dtype=np.uint32),
        gene_end=np.array(raw.gene_end, dtype=np.uint32),
        gene_ids=raw.gene_ids, transcript_ids=raw.transcript_ids,
        near_border=raw.near_border, intronic=raw.intronic,
    )


class AnnotationDB:
    """All contigs + coordinate shift maps; the GTFParser equivalent."""

    def __init__(self, contigs: List[ContigAnnotation],
                 contig_info: List[ContigLen]):
        self.contigs = contigs
        self.contig_info = contig_info
        self.chr2con, self.con2chr = build_shift_maps(contig_info)

    @classmethod
    def from_gtf(cls, gtf_path: str, contig_info: List[ContigLen],
                 n_contigs: int, cfg: Config,
                 contig_lengths: List[int] | None = None) -> "AnnotationDB":
        from ..io.gtf import load_gtf
        raw = load_gtf(gtf_path, contig_info, n_contigs,
                       max_read_len=cfg.max_read_len,
                       contig_lengths=contig_lengths)
        return cls([build_contig_annotation(r, cfg) for r in raw], contig_info)

    # --- interval lookups (reference: interval_tree_impl.h:136-182) ---

    def find_ind(self, c: int, pos: int) -> Tuple[Optional[int], int]:
        """Return (interval index or None, raw ind) like find_ind."""
        ca = self.contigs[c]
        if pos < int(ca.iv_spos[0]):
            return None, -1
        ind = int(np.searchsorted(ca.iv_spos, pos, side="right")) - 1
        if ind < 0 or int(ca.iv_epos[ind]) < pos:
            return None, ind
        return ind, ind

    def get_location_overlap_ind(self, c: int, pos: int):
        """(interval index or None, ind); None also when seg list empty."""
        ind_ok, ind = self.find_ind(c, pos)
        if ind_ok is None:
            return None, ind
        ca = self.contigs[c]
        if ca.iv_seg_off[ind_ok + 1] == ca.iv_seg_off[ind_ok]:
            return None, ind
        return ind_ok, ind

    def gene_overlap(self, c: int, pos: int) -> Optional[int]:
        """Gene-interval index containing pos, else None."""
        ca = self.contigs[c]
        if pos < int(ca.gv_spos[0]):
            return None
        ind = int(np.searchsorted(ca.gv_spos, pos, side="right")) - 1
        if ind < 0 or int(ca.gv_epos[ind]) < pos:
            return None
        if ca.gv_seg_off[ind + 1] == ca.gv_seg_off[ind]:
            return None
        return ind

    def interval_segs(self, c: int, iv: int) -> range:
        ca = self.contigs[c]
        return range(int(ca.iv_seg_off[iv]), int(ca.iv_seg_off[iv + 1]))

    def seg_tids(self, c: int, e: int) -> np.ndarray:
        """Transcript ids of the referenced segment instance e."""
        ca = self.contigs[c]
        u = int(ca.seg_uid[e])
        if u < 0:
            return np.zeros(0, dtype=np.int32)
        return ca.uid_tid[ca.uid_tid_off[u]:ca.uid_tid_off[u + 1]]

    def interval_tids(self, c: int, iv: int) -> np.ndarray:
        """All transcript ids over an interval's seg list (with duplicates,
        reference order: same_transcript collects them per segment)."""
        parts = [self.seg_tids(c, e) for e in self.interval_segs(c, iv)]
        if not parts:
            return np.zeros(0, dtype=np.int32)
        return np.concatenate(parts)

    def trans2seg_state(self, c: int, tid: int, row: int) -> int:
        """trans2seg[c][tid][row]; 0 when out of range."""
        ca = self.contigs[c]
        off = ca.t2s_off[tid]
        size = ca.t2s_off[tid + 1] - off
        if row < 0 or row >= size:
            return 0
        return int(ca.t2s_state[off + row])

    def trans2seg_len(self, c: int, tid: int) -> int:
        ca = self.contigs[c]
        return int(ca.t2s_off[tid + 1] - ca.t2s_off[tid])

    def get_trans_start_ind(self, c: int, tid: int) -> int:
        return int(self.contigs[c].trans_start_ind[tid])

    # --- upper bound for chaining (reference: gene_annotation.h:123-133,
    #     gene_annotation.cpp:464-533) ---
    def get_upper_bound(self, c: int, spos: int, mlen: int, rlen: int,
                        max_ed: int):
        """Returns (max_lpos_lim, max_exon_end, ol_interval_or_None)."""
        ca = self.contigs[c]
        if not ca.near_border[spos]:
            return spos + rlen + max_ed, 0, None
        return self.get_upper_bound_lookup(c, spos, mlen, rlen, max_ed)

    def get_upper_bound_lookup(self, c: int, spos: int, mlen: int, rlen: int,
                               max_ed: int):
        ca = self.contigs[c]
        iv, raw_ind = self.find_ind(c, spos)
        epos = spos + mlen - 1
        if iv is not None and ca.iv_seg_off[iv] == ca.iv_seg_off[iv + 1]:
            iv = None  # empty seg list counts as not found (gene_annotation.cpp:475)
        if iv is None:
            # intronic: bounded by next interval start
            nxt = raw_ind + 1
            if nxt >= ca.n_intervals:
                max_end = MAXUB
            else:
                max_end = int(ca.iv_spos[nxt]) - 1
            if max_end < epos:
                return 0, max_end, None
            return min(spos + rlen + max_ed, max_end - mlen + 1), max_end, None

        if epos > int(ca.iv_epos[iv]):
            max_end = 0
            min_end = int(1e9)
            max_next = 0
            for e in self.interval_segs(c, iv):
                if int(ca.seg_end[e]) >= epos:
                    max_end = max(max_end, int(ca.seg_end[e]))
                    min_end = min(min_end, int(ca.seg_end[e]))
                    max_next = max(max_next, int(ca.seg_next[e]))
        else:
            max_end = int(ca.iv_max_end[iv])
            min_end = int(ca.iv_min_end[iv])
            max_next = int(ca.iv_max_next[iv])

        if max_end > 0 and max_end >= epos:
            if min_end < rlen + epos and max_next != 0:
                return max_next + mlen - 1, max_end, iv
            return max_end - mlen + 1, max_end, iv
        return 0, 0, None
