"""Alignment kernels: banded edit distance, X-drop score DP, wrappers.

Host oracle, faithful to the reference (src/align.cpp):
- global_alignment / global_banded_alignment[_reverse]  (align.cpp:166-509)
- global_one_side_banded_alignment                      (align.cpp:219-252)
- global_banded_alignment_drop (X-drop, anti-diagonal)  (align.cpp:254-390)
- EditDist/Drop local_alignment_{right,left}[_sc]       (align.cpp:556-723)

Sequences are int8 code arrays (A0 C1 G2 T3 N4); a mismatch is any unequal
code pair (N never equals anything, incl. itself — mirrors the ASCII
diff table where 'N' maps to mismatch, align.cpp:739-760).

Scores follow the reference: edit matrix (0 match / 1 mismatch / 1 indel),
drop matrix (+1 match / -3 mismatch / -3 indel / x-drop 8) as set in
circminer.cpp:74-75.

The batched device kernels live in pallas_align.py / align_device.py.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

DPTINF = 10_000_000  # align.cpp:12


@dataclasses.dataclass
class AlignCandid:
    """align.h:123-153; score = -sclen - 2*ed unless given."""
    ed: int
    sclen: int
    indel: int
    score: int = None

    def __post_init__(self):
        if self.score is None:
            self.score = -1 * self.sclen - 2 * self.ed

    def better_than(self, r: "AlignCandid") -> bool:
        if self.score != r.score:
            return self.score > r.score
        if self.ed != r.ed:
            return self.ed < r.ed
        return abs(self.indel) < abs(r.indel)

    def update(self, r: "AlignCandid"):
        if r.better_than(self):
            self.ed, self.sclen, self.indel, self.score = \
                r.ed, r.sclen, r.indel, r.score


@dataclasses.dataclass
class ScoreMat:
    mat: int = 1
    mis: int = -3
    ind: int = -3
    xd: int = 8


def _diff(a: np.ndarray, b: np.ndarray):
    """Mismatch indicator; N (code 4) never matches."""
    return ((a != b) | (a >= 4) | (b >= 4)).astype(np.int64)


def global_alignment(s, t) -> np.ndarray:
    """Full edit-distance DP matrix (align.cpp:166-188)."""
    n, m = len(s), len(t)
    dp = np.zeros((n + 1, m + 1), dtype=np.int64)
    dp[:, 0] = np.arange(n + 1)
    dp[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        sub = dp[i - 1, :-1] + _diff(s[i - 1], t)
        # row-wise: need sequential for left dependency
        row = dp[i]
        prev = dp[i - 1]
        for j in range(1, m + 1):
            row[j] = min(sub[j - 1], prev[j] + 1, row[j - 1] + 1)
    return dp


def global_banded_alignment(s, t, w: int) -> np.ndarray:
    """Banded edit-distance DP (align.cpp:395-450). Returns dp with DPTINF
    outside the band. Falls back to full DP for tiny inputs as the
    reference does."""
    n, m = len(s), len(t)
    if w < 0 or n <= 2 * w or m <= w:
        return global_alignment(s, t)
    dp = np.full((n + 1, m + 1), DPTINF, dtype=np.int64)
    dp[:w + 1, 0] = np.arange(w + 1)
    dp[0, :w + 1] = np.arange(w + 1)
    for j in range(1, m + 1):
        lo = max(1, j - w)
        hi = min(j + w, n)
        for i in range(lo, hi + 1):
            dp[i, j] = min(dp[i - 1, j - 1] + _diff(s[i - 1:i], t[j - 1:j])[0],
                           dp[i - 1, j] + 1, dp[i, j - 1] + 1)
    return dp


def global_banded_alignment_reverse(s, t, w: int) -> np.ndarray:
    """Same DP on reversed strings (align.cpp:453-509)."""
    return global_banded_alignment(s[::-1], t[::-1], w)


def global_one_side_banded_alignment(s, t, w: int) -> int:
    """One-sided band: m = n + w, no complex indels (align.cpp:219-252).
    Returns dp[n][m]."""
    n, m = len(s), len(t)
    if w < 0 or n <= w:
        return int(global_alignment(s, t)[n, m])
    dp = np.full((n + 1, m + 1), DPTINF, dtype=np.int64)
    dp[0, :w + 1] = np.arange(w + 1)
    for i in range(1, n + 1):
        for j in range(i, min(i + w, m) + 1):
            best = dp[i - 1, j - 1] + _diff(s[i - 1:i], t[j - 1:j])[0]
            if dp[i - 1, j] + 1 < best:
                best = dp[i - 1, j] + 1
            if j >= 1 and dp[i, j - 1] + 1 < best:
                best = dp[i, j - 1] + 1
            dp[i, j] = best
    return int(dp[n, m])


def global_banded_alignment_drop(s, t, w: int, sm: ScoreMat
                                 ) -> Tuple[int, int, int]:
    """X-drop banded score DP over anti-diagonals (align.cpp:254-390).
    Returns (best_score, on_s, on_t)."""
    n, m = len(s), len(t)
    dpx = np.full((n + 1, m + 1), -DPTINF, dtype=np.int64)
    for i in range(min(w, n) + 1):
        dpx[i, 0] = i * sm.ind
    for j in range(min(w, m) + 1):
        dpx[0, j] = j * sm.ind
    on_s = on_t = 0
    if m <= 0 or n <= 0:
        return 0, 0, 0

    pre_optimum = 0
    cur_optimum = 0
    lb, ub = 1, 1
    pre_ub = 0
    best_i = best_j = 0
    for k in range(2, m + n + 1):
        new_ub = -1
        for i in range(lb, ub + 1):
            j = k - i
            if j < 1 or j > m or i > n:
                continue
            sub = sm.mat if (s[i - 1] == t[j - 1] and s[i - 1] < 4) else sm.mis
            val = max(dpx[i - 1, j - 1] + sub,
                      dpx[i - 1, j] + sm.ind,
                      dpx[i, j - 1] + sm.ind)
            dpx[i, j] = val
            if val >= cur_optimum:
                cur_optimum = val
                best_i, best_j = i, j
            if val + sm.xd < pre_optimum:
                dpx[i, j] = -DPTINF
            if dpx[i, j] > -DPTINF:
                new_ub = i
        lb_t = k - lb
        if lb_t == m or (k > w and (k - w) % 2 == 0):
            lb += 1
        if ub < n and (k <= w or (k > w and (k - w) % 2 == 1)):
            ub += 1
        if (pre_ub == -1 and new_ub == -1) or lb > ub:
            break
        pre_ub = new_ub
        pre_optimum = max(pre_optimum, cur_optimum)
    return int(dpx[best_i, best_j]), best_i, best_j


# --- wrappers (align.cpp:556-723) -------------------------------------------

def local_alignment_right(s, t, w: int, max_ed: int, max_sc: int
                          ) -> Tuple[int, int, int]:
    """(ed, indel, align_score); prefix-on-s, global-on-t
    (align.cpp:556-576)."""
    n, m = len(s), len(t)
    dp = global_banded_alignment(s, t, w)
    best = AlignCandid(max_ed + 1, max_sc + 1, w + 1)
    for i in range(max(0, m - w), min(m + w, n) + 1):
        if dp[i, m] <= max_ed:
            best.update(AlignCandid(int(dp[i, m]), 0, m - i))
    return best.ed, best.indel, -best.ed


def local_alignment_left(s, t, w: int, max_ed: int, max_sc: int
                         ) -> Tuple[int, int, int]:
    n, m = len(s), len(t)
    dp = global_banded_alignment_reverse(s, t, w)
    best = AlignCandid(max_ed + 1, max_sc + 1, w + 1)
    for i in range(max(0, m - w), min(m + w, n) + 1):
        if dp[i, m] <= max_ed:
            best.update(AlignCandid(int(dp[i, m]), 0, m - i))
    return best.ed, best.indel, -best.ed


def edit_local_alignment_right_sc(s, t, w: int, max_ed: int, max_sc: int
                                  ) -> Tuple[int, int, int, int]:
    """EditDistAlignment::local_alignment_right_sc (align.cpp:602-633).
    Returns (ed, sclen, indel, align_score)."""
    n, m = len(s), len(t)
    max_sclen = min(max_sc, m)
    dp = global_banded_alignment(s, t, w)
    best = AlignCandid(max_ed + 1, max_sc + 1, w + 1)
    for j in range(m, m - max_sclen - 1, -1):
        for i in range(max(0, j - w), min(j + w, n) + 1):
            if dp[i, j] <= max_ed:
                best.update(AlignCandid(int(dp[i, j]), m - j, j - i))
    if m <= max_ed:
        best.update(AlignCandid(m, 0, 0))
    score = m - best.sclen - 2 * best.ed
    return best.ed, best.sclen, best.indel, score


def edit_local_alignment_left_sc(s, t, w: int, max_ed: int, max_sc: int
                                 ) -> Tuple[int, int, int, int]:
    n, m = len(s), len(t)
    max_sclen = min(max_sc, m)
    dp = global_banded_alignment_reverse(s, t, w)
    best = AlignCandid(max_ed + 1, max_sc + 1, w + 1)
    for j in range(m, m - max_sclen - 1, -1):
        for i in range(max(0, j - w), min(j + w, n) + 1):
            if dp[i, j] <= max_ed:
                best.update(AlignCandid(int(dp[i, j]), m - j, j - i))
    if m <= max_ed:
        best.update(AlignCandid(m, 0, 0))
    score = m - best.sclen - 2 * best.ed
    return best.ed, best.sclen, best.indel, score


def drop_local_alignment_right_sc(s, t, w: int, max_ed: int, max_sc: int,
                                  sm: ScoreMat = ScoreMat()
                                  ) -> Tuple[int, int, int, int]:
    """DropAlignment::local_alignment_right_sc (align.cpp:669-692).
    Returns (ed, sclen, indel, align_score)."""
    n, m = len(s), len(t)
    score, on_s, on_t = global_banded_alignment_drop(s, t, w, sm)
    ed = (sm.mat * max(on_s, on_t) - score) // (sm.mat - sm.mis)
    indel_cnt = on_t - on_s
    clip = m - on_t
    best = AlignCandid(max_ed + 1, max(max_sc, m) + 1, w + 1, 0)
    if ed <= max_ed:
        best.update(AlignCandid(ed, clip, indel_cnt, score))
    return best.ed, best.sclen, best.indel, score


def drop_local_alignment_left_sc(s, t, w: int, max_ed: int, max_sc: int,
                                 sm: ScoreMat = ScoreMat()
                                 ) -> Tuple[int, int, int, int]:
    """align.cpp:694-723 — same on reversed strings; note the reference
    uses set() (unconditional) rather than update()."""
    n, m = len(s), len(t)
    score, on_s, on_t = global_banded_alignment_drop(s[::-1], t[::-1], w, sm)
    ed = (sm.mat * max(on_s, on_t) - score) // (sm.mat - sm.mis)
    indel_cnt = on_t - on_s
    clip = m - on_t
    best = AlignCandid(max_ed + 1, max(m, max_sc) + 1, w + 1, 0)
    if ed <= max_ed:
        best = AlignCandid(ed, clip, indel_cnt, score)
    return best.ed, best.sclen, best.indel, score


def hamming_distance(s, t, max_ed: int) -> int:
    """align.cpp:30-40 (early exit at max_ed semantics preserved by caller)."""
    n = min(len(s), len(t))
    d = _diff(s[:n], t[:n])
    cs = np.cumsum(d)
    if len(cs) and cs[-1] > max_ed:
        # first prefix where ed exceeds max_ed (reference returns early)
        idx = int(np.argmax(cs > max_ed))
        return int(cs[idx])
    return int(cs[-1]) if len(cs) else 0
