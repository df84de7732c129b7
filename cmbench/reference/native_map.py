"""Paired-end mapping on the host C++ engines: the native executor of the
port's pipeline (``chain_exec="native"``, ``extend_exec="native"``), one
contig, no per-read trace.  Every batch is encoded as 4 rows a pair (r1,
rc(r1), r2, rc(r2)), looked up by ``NativeSeeder``, gathered and chained by
``NativeChainer`` in occupancy buckets and finished by ``NativeFilter``,
which writes each pair's MatchedRead."""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np

from .config import Config
from .ops.chain_native import NativeChainer
from .ops.filter_native import NativeFilter
from .ops.seed_native import NativeSeeder
from .pipeline.types import MatchedRead


def encode_pairs(recs, max_read_len: int):
    """int8 [4n, max_read_len] codes and int32 [4n] lengths."""
    seqs = np.zeros((4 * len(recs), max_read_len), dtype=np.int8)
    lens = np.zeros(4 * len(recs), dtype=np.int32)
    for i, (r1, r2) in enumerate(recs):
        for o, s in enumerate((r1.seq, r1.rcseq, r2.seq, r2.rcseq)):
            seqs[4 * i + o, :len(s)] = s
            lens[4 * i + o] = len(s)
    return seqs, lens


class NativeMapper:
    """The host engines of one single-contig index."""

    def __init__(self, db, gi, cfg: Config, batch_size: int = 4096):
        if len(gi.contigs) != 1:
            raise ValueError("the reference maps single-contig genomes")
        self.cfg = cfg
        self.batch = batch_size
        ci = gi.contigs[0]
        self.seeder = NativeSeeder(ci, cfg)
        self.chainer = NativeChainer(db.contigs[0], cfg)
        self.filter = NativeFilter(db, 0, ci.codes, cfg)

    def _caps(self) -> List[int]:
        caps = [c for c in self.cfg.seed_buckets if c <= self.cfg.seed_lim]
        if not caps or caps[-1] < self.cfg.seed_lim:
            caps = list(caps) + [self.cfg.seed_lim]
        return caps

    def _buckets(self, cnt):
        maxocc = cnt.max(axis=1) if cnt.shape[1] > 0 else \
            np.zeros(len(cnt), np.int32)
        prev = 0
        for cap in self._caps():
            rows = np.nonzero((maxocc <= cap) & (maxocc > prev))[0] \
                if prev else np.nonzero(maxocc <= cap)[0]
            prev = cap
            if len(rows):
                yield cap, rows

    def map_batch(self, recs) -> None:
        cfg = self.cfg
        seqs, lens = encode_pairs(recs, cfg.max_read_len)
        qpos, start, cnt, high = self.seeder.lookup(seqs, lens)
        qpos = np.maximum(qpos, 0)
        R, NL = 4 * len(recs), cfg.n_kmer_lists
        parts = []
        for cap, rows in self._buckets(cnt):
            pos_b = self.seeder.gather(start[rows],
                                       np.minimum(cnt[rows], cap), cap)
            parts.append((rows, *self.chainer.chain_batch(
                pos_b, cnt[rows], qpos[rows], lens[rows])))
        cmax = max([1] + [int(cn.max()) for *_, cn in parts if len(cn)])
        rp_f = np.zeros((R, cmax, NL), np.int32)
        qp_f = np.zeros((R, cmax, NL), np.int32)
        cl_f = np.zeros((R, cmax), np.int32)
        sc_f = np.zeros((R, cmax), np.float64)
        cn_f = np.zeros(R, np.int32)
        for rows, rp, qp, cl, sc, cn in parts:
            rp_f[rows] = rp[:, :cmax]
            qp_f[rows] = qp[:, :cmax]
            cl_f[rows] = cl[:, :cmax]
            sc_f[rows] = sc[:, :cmax]
            cn_f[rows] = cn
        nf = self.filter
        default_row = NativeFilter.mr_to_state(MatchedRead.default(cfg.max_ed),
                                               nf.chr_names)
        mr_state = np.tile(default_row, (len(recs), 1))
        for i, (r1, _) in enumerate(recs):
            if r1.mr.touched:
                mr_state[i] = NativeFilter.mr_to_state(r1.mr, nf.chr_names)
        mr_state = np.ascontiguousarray(mr_state)
        nf.filter_pe(seqs, lens, rp_f, qp_f, cl_f, sc_f, cn_f, high,
                     mr_state)
        for i, (r1, _) in enumerate(recs):
            NativeFilter.state_to_mr(mr_state[i], r1.mr, nf.chr_names)

    def map_pairs(self, pairs: Iterable[Tuple[object, object]]) -> int:
        """Map every pair in batches of ``batch_size``; returns the count."""
        n, buf = 0, []
        for pr in pairs:
            buf.append(pr)
            if len(buf) >= self.batch:
                self.map_batch(buf)
                n += len(buf)
                buf = []
        if buf:
            self.map_batch(buf)
            n += len(buf)
        return n
