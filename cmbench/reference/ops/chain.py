"""Host half of seed chaining, free of JAX.

A copy of the numpy/Python part of ``circminer_tpu/ops/chain.py``: the
``Chain`` record, ``check_junction_host``, the ``chain_seeds_host`` oracle
(reference chain.cpp:28-298) and ``extract_kbest``.  The original module
imports jax at module level for its batched device DP, which the port has
in ``ops/chain_device.py``; the host modules (``pipeline/mapping.py``,
``pipeline/circ.py``, ``ops/chain_native.py``) import ``Chain`` from here.
The functions are kept source-identical to the original (pinned by
tests/test_torch_selfcontained.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..config import Config, INF

REWARD_COEF = 2e4   # chain.cpp:10
PENALTY_COEF = 0.1  # chain.cpp:11


@dataclasses.dataclass
class Chain:
    """One chain: fragments as (rpos, qpos, len) triples, plus score."""
    rpos: np.ndarray
    qpos: np.ndarray
    flen: np.ndarray
    score: float

    @property
    def chain_len(self) -> int:
        return int(self.rpos.shape[0])


def check_junction_host(s1: int, s2: int, db, contig: int, iv: Optional[int],
                        kmer: int, read_dist: int, max_ed: int):
    """Port of check_junction (chain.cpp:28-64). Returns (ok, trans_dist)."""
    if iv is None:
        return False, INF
    e1 = s1 + kmer - 1
    if s2 <= e1:
        return False, INF
    ca = db.contigs[contig]
    trans_dist2intron = -1
    trans_dist = INF
    for e in db.interval_segs(contig, iv):
        e12end = int(ca.seg_end[e]) - e1
        beg2s2 = s2 - int(ca.seg_next[e])
        # 2nd kmer entirely inside the immediate intron
        if 0 <= e12end < read_dist and beg2s2 + kmer < 0:
            trans_dist2intron = s2 - e1 - 1
        if e12end < 0 or beg2s2 < 0:
            continue
        trans_dist = e12end + beg2s2
        if abs(trans_dist - read_dist) <= max_ed:
            return True, trans_dist
    if trans_dist2intron != -1:
        return True, trans_dist2intron
    return False, INF


def chain_seeds_host(seq_len: int, qpos: np.ndarray, seed_pos: List[np.ndarray],
                     cfg: Config, db=None, contig: int = 0,
                     kmer: Optional[int] = None, shift: int = 0) -> List[Chain]:
    """Host oracle for both kbest variants.

    qpos: int array per k-mer list (slot) — query start positions.
    seed_pos: per slot, ascending reference positions (may be empty).
    db/contig: annotation for junction gating (None disables lookups, as if
    never near a border).
    kmer/shift: overrides for the circ-stage variant (chain.cpp:310-539).
    """
    k = kmer if kmer is not None else cfg.kmer
    kmer_cnt = len(seed_pos)
    # drop empty lists at the back (chain.cpp:112-116)
    while kmer_cnt >= 1 and len(seed_pos[kmer_cnt - 1]) <= 0:
        kmer_cnt -= 1
    if kmer_cnt <= 0:
        return []

    dp_score = [np.full(len(seed_pos[ii]), float(k)) for ii in range(kmer_cnt)]
    dp_prev = [np.full((len(seed_pos[ii]), 2), -1, dtype=np.int64)
               for ii in range(kmer_cnt)]

    # score -> list of (score, ii, i) events, insertion-ordered, capped
    score2chain: dict = {}

    max_best = cfg.max_chain_len

    for ii in range(kmer_cnt - 2, -1, -1):
        cur_pos = seed_pos[ii]
        if len(cur_pos) == 0:
            continue
        read_remain = seq_len - int(qpos[ii]) - k
        lb_ind = [0] * kmer_cnt
        for i in range(len(cur_pos)):
            seg_start = int(cur_pos[i])
            seg_end = seg_start + k - 1
            max_lpos_lim = None  # lazily computed (chain.cpp:141,162-166)
            max_exon_end = 0
            ol_iv = None
            for jj in range(ii + 1, kmer_cnt):
                nxt = seed_pos[jj]
                if len(nxt) == 0 or lb_ind[jj] >= len(nxt):
                    continue
                if seg_start + cfg.max_intron < int(nxt[lb_ind[jj]]):
                    continue
                while lb_ind[jj] < len(nxt) and int(nxt[lb_ind[jj]]) <= seg_start:
                    lb_ind[jj] += 1
                if lb_ind[jj] >= len(nxt):
                    continue
                if max_lpos_lim is None:
                    if db is not None:
                        max_lpos_lim, max_exon_end, ol_iv = db.get_upper_bound(
                            contig, seg_start, k, read_remain, cfg.max_ed)
                    else:
                        max_lpos_lim = seg_start + read_remain + cfg.max_ed
                        max_exon_end, ol_iv = 0, None

                distr = int(qpos[jj]) - int(qpos[ii]) - k
                read_dist = distr

                j = lb_ind[jj]
                while j < len(nxt) and int(nxt[j]) <= max_lpos_lim:
                    pj = int(nxt[j])
                    if max_exon_end == 0 or (pj + k - 1) <= max_exon_end:
                        genome_dist = pj - seg_end - 1
                    else:
                        genome_dist = INF
                    if abs(genome_dist - read_dist) <= cfg.max_ed:
                        distt = genome_dist
                    else:
                        ok, td = check_junction_host(
                            seg_start, pj, db, contig, ol_iv, k, read_dist,
                            cfg.max_ed)
                        if ok:
                            distt = td
                        else:
                            j += 1
                            continue
                    beta = PENALTY_COEF * (max(distr, distt) - min(distr, distt))
                    temp_score = dp_score[jj][j] + REWARD_COEF * k - beta
                    if temp_score > dp_score[ii][i]:
                        dp_score[ii][i] = temp_score
                        dp_prev[ii][i] = (jj, j)
                        lst = score2chain.setdefault(temp_score, [])
                        if len(lst) < max_best:
                            lst.append((temp_score, ii, i))
                    j += 1

    # backtrack (chain.cpp:234-281)
    chains: List[Chain] = []
    repeats = set()
    scores_desc = sorted(score2chain.keys(), reverse=True)
    best_score = scores_desc[0] if scores_desc else float(k)

    for sc in scores_desc:
        for (ev_score, ii0, i0) in score2chain[sc]:
            if len(chains) >= max_best:
                break
            spos = int(seed_pos[ii0][i0])
            if ev_score < best_score and spos in repeats:
                continue
            rp, qp = [], []
            ii, i = ii0, i0
            first = True
            while ii != -1:
                rp.append(shift + int(seed_pos[ii][i]))
                qp.append(int(qpos[ii]))
                if not first:
                    repeats.add(rp[-1])
                first = False
                ii, i = int(dp_prev[ii][i][0]), int(dp_prev[ii][i][1])
            chains.append(Chain(
                rpos=np.array(rp, dtype=np.int64),
                qpos=np.array(qp, dtype=np.int64),
                flen=np.full(len(rp), k, dtype=np.int64),
                score=float(ev_score),
            ))

    # single-fragment fallback (chain.cpp:283-298)
    if not chains:
        for ii in range(kmer_cnt - 1, -1, -1):
            for i in range(len(seed_pos[ii])):
                if len(chains) >= max_best:
                    break
                chains.append(Chain(
                    rpos=np.array([shift + int(seed_pos[ii][i])], dtype=np.int64),
                    qpos=np.array([int(qpos[ii])], dtype=np.int64),
                    flen=np.array([k], dtype=np.int64),
                    score=float(dp_score[ii][i]),
                ))
    return chains


def extract_kbest(dp10: np.ndarray, back: np.ndarray, pos: np.ndarray,
                  qpos: np.ndarray, cnt: np.ndarray, cfg: Config,
                  k: Optional[int] = None, shift: int = 0) -> List[Chain]:
    """Host k-best extraction from device DP results (one read).

    Near-faithful: uses final cell scores in the reference's event order
    (score desc, then list desc, then index asc) with backtrack repeat
    suppression; stale improvement events are not replayed.
    """
    k = k if k is not None else cfg.kmer
    NL, S = pos.shape
    valid = (np.arange(S)[None, :] < np.asarray(cnt)[:, None]) & (back >= 0)
    ls, ss = np.nonzero(valid)
    order = np.lexsort((ss, -ls, -dp10[ls, ss]))
    cells = [(-int(dp10[ls[i], ss[i]]), -int(ls[i]), int(ss[i]))
             for i in order]
    chains: List[Chain] = []
    repeats = set()
    best10 = -cells[0][0] if cells else 10 * k
    for negsc, negl, s0 in cells:
        if len(chains) >= cfg.max_chain_len:
            break
        l0 = -negl
        spos = int(pos[l0, s0])
        if -negsc < best10 and spos in repeats:
            continue
        rp, qp = [], []
        l, s = l0, s0
        first = True
        while l != -1:
            rp.append(shift + int(pos[l, s]))
            qp.append(int(qpos[l]))
            if not first:
                repeats.add(rp[-1])
            first = False
            b = int(back[l, s])
            if b < 0:
                break
            l, s = b // S, b % S
        chains.append(Chain(
            rpos=np.array(rp, dtype=np.int64),
            qpos=np.array(qp, dtype=np.int64),
            flen=np.full(len(rp), k, dtype=np.int64),
            score=(-negsc) / 10.0,
        ))
    if not chains:
        # single-fragment fallback, lists descending (chain.cpp:283-298)
        last = NL - 1
        while last >= 0 and cnt[last] <= 0:
            last -= 1
        for l in range(last, -1, -1):
            for s in range(int(cnt[l])):
                if len(chains) >= cfg.max_chain_len:
                    break
                chains.append(Chain(
                    rpos=np.array([shift + int(pos[l, s])], dtype=np.int64),
                    qpos=np.array([int(qpos[l])], dtype=np.int64),
                    flen=np.array([k], dtype=np.int64),
                    score=float(dp10[l, s]) / 10.0,
                ))
    return chains
