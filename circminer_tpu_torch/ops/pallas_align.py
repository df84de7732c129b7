"""Batched X-drop and edit+soft-clip alignment DPs: plain torch versions and
the wrappers of their CUDA kernels.

Counterpart of ``circminer_tpu/ops/pallas_align.py``.  The reference runs
both DPs as an anti-diagonal wavefront over a whole [B, I] batch (scan twins
``xdrop_scan_ref`` / ``edit_sc_scan_ref`` and the Pallas kernels
``_xdrop_kernel`` / ``_edit_sc_kernel``, which compute the same bits).

  * ``xdrop_scan`` / ``edit_sc_scan``: the plain torch versions, written as
    the reference's roll-based wavefront (diagonal k holds cells (i, k-i)).
    They run on any device; the CPU tests hold them against the JAX scan
    twins and the Pallas kernels in interpret mode.
  * ``xdrop_rows`` / ``edit_sc_batch``: the wrappers.  A CPU tensor goes
    through the plain version; a CUDA tensor launches the hand-written
    kernel in ``csrc/align_kernels.cu`` (or raises).  There is no fallback
    from the kernel to the plain version.  ``xdrop_batch`` splits
    ``xdrop_rows``' [B, 3] rows into columns.

Inputs: s, t int8 [B, L] (L <= I, rows zero-padded), n, m int32 [B] with
n, m <= L.  All arithmetic is int32, as in the reference (x64 is off there).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import _ext

NEG = -(10 ** 7)   # mirrors align.cpp DPTINF magnitude
POS = 10 ** 7

_i32 = torch.int32


def _pad_rows(x: torch.Tensor, I: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, I - x.shape[1])).to(torch.int8)


def _iota(B: int, I: int, device) -> torch.Tensor:
    return torch.arange(I, dtype=_i32, device=device).expand(B, I)


def _last_diag(n: torch.Tensor, m: torch.Tensor, I: int) -> int:
    """Last diagonal worth sweeping: past k = max(n + m) no cell of any item
    is valid or in band, so no output can change (exact, not a heuristic)."""
    if n.numel() == 0:
        return 1
    return min(2 * I - 1, int((n + m).max()))


def _diff_diag(s_pad, t_rev, k, I):
    """Mismatch mask of diagonal k: cell i compares s[i-1] with t[j-1],
    j = k - i, via two uniform rolls (t_rev[:, I-1-x] = t[x]).  Valid only
    where 1 <= i and 1 <= j <= m (callers mask the rest)."""
    s_elem = torch.roll(s_pad, 1, dims=1)
    t_elem = torch.roll(t_rev, k - I, dims=1)
    return (s_elem != t_elem) | (s_elem >= 4) | (t_elem >= 4)


# --------------------------------------------------------------------------
# banded edit distance + online soft-clip candidate scan
# --------------------------------------------------------------------------

def _edit_candidate_key(dp, i_vec, k, n, m, w, max_ed, max_sclen):
    """Packed int32 AlignCandid preference key of the cells of diagonal k:
    score desc, ed asc, |indel| asc, j desc, i asc; 0 = no candidate."""
    j_vec = k - i_vec
    ed = dp
    sclen = m[:, None] - j_vec
    indel = j_vec - i_vec
    score = m[:, None] - sclen - 2 * ed
    ok = ((ed <= max_ed) & (sclen >= 0) & (sclen <= max_sclen[:, None])
          & (j_vec >= m[:, None] - max_sclen[:, None]) & (j_vec >= 0)
          & (j_vec <= m[:, None]) & (i_vec >= 0) & (i_vec <= n[:, None])
          & ((i_vec - j_vec).abs() <= w))
    # fields of non-candidate cells are zeroed before packing, so the shifts
    # never overflow int32 (the reference masks after packing)
    score = torch.where(ok, score + 512, 0)
    ed = torch.where(ok, ed, 31)
    indel = torch.where(ok, indel, 15)
    j_c = torch.where(ok, j_vec, 0)
    i_c = torch.where(ok, i_vec, 31)
    key = ((score << 21) | ((31 - ed) << 16) | ((15 - indel.abs()) << 12)
           | (j_c << 5) | (31 - torch.clamp(i_c, max=31)))
    return torch.where(ok, key, 0)


def _decode_candidate(key, best_i, best_j, n, m, w, max_ed, max_sc):
    """Back out (ed, sclen, indel) from the winning cell."""
    has = key > 0
    sclen = torch.where(has, m - best_j, max_sc + 1)
    indel = torch.where(has, best_j - best_i, w + 1)
    score_part = (key >> 21) - 512
    ed = torch.where(has, torch.div(m - sclen - score_part, 2,
                                    rounding_mode="floor"), max_ed + 1)
    return has, ed, sclen, indel


def _take_better(key, k, best_key, best_i, best_j):
    kmax, karg = torch.max(key, dim=1)      # first (smallest i) maximum
    karg = karg.to(_i32)
    better = kmax > best_key
    return (torch.where(better, kmax, best_key),
            torch.where(better, karg, best_i),
            torch.where(better, k - karg, best_j))


def edit_sc_scan(s: torch.Tensor, t: torch.Tensor, n: torch.Tensor,
                 m: torch.Tensor, *, w: int, max_ed: int, max_sc: int,
                 I: int = 128) -> Tuple[torch.Tensor, ...]:
    """Plain torch banded edit DP + soft-clip scan (the reference's
    ``edit_sc_scan_ref``; oracle edit_local_alignment_right_sc,
    align.cpp:602-667; callers pre-reverse for the left side).

    Returns (ed, sclen, indel, score) int32 [B].  Valid where n > 2w and
    m > w (the banded regime)."""
    B = s.shape[0]
    dev = s.device
    n = n.to(_i32)
    m = m.to(_i32)
    s_pad = _pad_rows(s, I)
    t_rev = torch.flip(_pad_rows(t, I), dims=(1,))
    i_vec = _iota(B, I, dev)
    max_sclen = torch.clamp(m, max=max_sc)

    d2 = torch.where(i_vec == 0, 0, POS).to(_i32)                  # k = 0
    d1 = torch.where((i_vec <= 1) & (i_vec <= n[:, None])
                     & ((1 - i_vec) <= m[:, None]), 1, POS).to(_i32)  # k = 1
    best_key = torch.zeros(B, dtype=_i32, device=dev)
    best_i = torch.zeros(B, dtype=_i32, device=dev)
    best_j = torch.zeros(B, dtype=_i32, device=dev)
    # the seed diagonals' cells can be soft-clip candidates too
    for k0, d0 in ((0, d2), (1, d1)):
        key0 = _edit_candidate_key(d0, i_vec, k0, n, m, w, max_ed, max_sclen)
        best_key, best_i, best_j = _take_better(key0, k0, best_key, best_i,
                                                best_j)

    for k in range(2, _last_diag(n, m, I) + 1):
        mis = _diff_diag(s_pad, t_rev, k, I).to(_i32)
        diag = torch.roll(d2, 1, dims=1) + mis                     # (i-1, j-1)
        up = torch.roll(d1, 1, dims=1) + 1                         # (i-1, j)
        left = d1 + 1                                              # (i, j-1)
        dp = torch.minimum(diag, torch.minimum(up, left))
        j_vec = k - i_vec
        # boundary: dp[i][0] = i (i <= w), dp[0][j] = j (j <= w)
        dp = torch.where((j_vec == 0) & (i_vec <= w), i_vec, dp)
        dp = torch.where((i_vec == 0) & (j_vec <= w) & (j_vec >= 0), j_vec, dp)
        valid = ((i_vec >= 0) & (i_vec <= n[:, None]) & (j_vec >= 0)
                 & (j_vec <= m[:, None]) & ((i_vec - j_vec).abs() <= w))
        dp = torch.where(valid, dp, POS)
        key = _edit_candidate_key(dp, i_vec, k, n, m, w, max_ed, max_sclen)
        best_key, best_i, best_j = _take_better(key, k, best_key, best_i,
                                                best_j)
        d2, d1 = d1, dp

    has, ed, sclen, indel = _decode_candidate(
        best_key, best_i, best_j, n, m, w, max_ed, max_sc)
    # oracle tail: if m <= max_ed, the candidate (m, 0, 0) competes
    tail_key = _tail_key(m)
    tail_better = (m <= max_ed) & (tail_key > best_key)
    ed = torch.where(tail_better, m, ed)
    sclen = torch.where(tail_better, 0, sclen)
    indel = torch.where(tail_better, 0, indel)
    score = m - sclen - 2 * ed
    return ed, sclen, indel, score


def _tail_key(m: torch.Tensor) -> torch.Tensor:
    """The reference's int32 tail-candidate key, packed in int64 and wrapped
    to int32 exactly as the reference's int32 shifts wrap."""
    m64 = m.to(torch.int64)
    k64 = ((((512 - m64) << 21) | ((31 - m64) << 16) | (15 << 12)
            | (m64 << 5) | 31) & 0xFFFFFFFF)
    return torch.where(k64 >= 2 ** 31, k64 - 2 ** 32, k64).to(_i32)


# --------------------------------------------------------------------------
# X-drop anti-diagonal score DP (align.cpp:254-390)
# --------------------------------------------------------------------------

def xdrop_scan(s: torch.Tensor, t: torch.Tensor, n: torch.Tensor,
               m: torch.Tensor, *, w: int, mat: int, mis: int, ind: int,
               xd: int, I: int = 128) -> Tuple[torch.Tensor, ...]:
    """Plain torch global_banded_alignment_drop, batched (the reference's
    ``xdrop_scan_ref``): the reference's lb/ub band trajectory, the
    ``val >= cur_optimum`` last-wins best update (largest i), the X-drop
    prune against the previous diagonal's optimum, and the dead-band stop.

    Returns (best_score, on_s, on_t) int32 [B]."""
    B = s.shape[0]
    dev = s.device
    n = n.to(_i32)
    m = m.to(_i32)
    s_pad = _pad_rows(s, I)
    t_rev = torch.flip(_pad_rows(t, I), dims=(1,))
    i_vec = _iota(B, I, dev)
    wn = torch.clamp(n, max=w)[:, None]
    wm = torch.clamp(m, max=w)[:, None]

    d2 = torch.where(i_vec == 0, 0, NEG).to(_i32)                   # (0, 0)
    d1 = torch.where((i_vec <= 1) & (i_vec <= wn) & ((1 - i_vec) <= wm),
                     ind, NEG).to(_i32)                             # k = 1
    z = torch.zeros(B, dtype=_i32, device=dev)
    lb, ub = z + 1, z + 1
    pre_ub, pre_opt, cur_opt = z, z, z
    best_i, best_j, best_v = z, z, z
    alive = (n > 0) & (m > 0)
    neg = torch.full_like(i_vec, NEG)
    minus1 = torch.full_like(i_vec, -1)

    for k in range(2, _last_diag(n, m, I) + 1):
        mismatch = _diff_diag(s_pad, t_rev, k, I)
        sub = torch.where(mismatch, mis, mat).to(_i32)
        diag = torch.roll(d2, 1, dims=1) + sub
        up = torch.roll(d1, 1, dims=1) + ind
        left = d1 + ind
        val = torch.maximum(diag, torch.maximum(up, left))
        j_vec = k - i_vec
        in_band = ((i_vec >= lb[:, None]) & (i_vec <= ub[:, None])
                   & (j_vec >= 1) & (j_vec <= m[:, None])
                   & (i_vec <= n[:, None]) & alive[:, None])
        val = torch.where(in_band, val, neg)
        # boundary columns (j = 0 / i = 0) feed only cells with i, j <= w
        new_d = torch.where((j_vec == 0) & (i_vec <= wn), ind * i_vec, val)
        new_d = torch.where((i_vec == 0) & (j_vec >= 0) & (j_vec <= wm),
                            ind * j_vec, new_d)

        # best update: last wins over cells with val >= cur_opt, i ascending
        vmax = val.max(dim=1).values
        upd = (vmax >= cur_opt) & alive
        att = (val == vmax[:, None]) & in_band
        i_att = torch.where(att, i_vec, minus1).max(dim=1).values
        cur_opt = torch.where(upd, vmax, cur_opt)
        best_i = torch.where(upd, i_att, best_i)
        best_j = torch.where(upd, k - i_att, best_j)
        best_v = torch.where(upd, vmax, best_v)

        # X-drop prune against the previous diagonal's optimum
        pruned = torch.where(val + xd < pre_opt[:, None], neg, val)
        new_d = torch.where(in_band, pruned, new_d)
        surv = in_band & (pruned > NEG)
        new_ub = torch.where(surv, i_vec, minus1).max(dim=1).values

        # band trajectory (align.cpp:358-372); (k - w) parity only for k > w
        odd = (k - w) % 2 == 1 if k > w else False
        lb2 = torch.where((k - lb == m) | (k > w and not odd), lb + 1, lb)
        ub2 = torch.where((ub < n) & (k <= w or odd), ub + 1, ub)
        dead = ((pre_ub == -1) & (new_ub == -1)) | (lb2 > ub2)
        pre_ub = torch.where(alive, new_ub, pre_ub)
        pre_opt = torch.where(alive, torch.maximum(pre_opt, cur_opt), pre_opt)
        lb = torch.where(alive, lb2, lb)
        ub = torch.where(alive, ub2, ub)
        alive = alive & ~dead
        d2, d1 = d1, new_d

    empty = (n <= 0) | (m <= 0)
    return (torch.where(empty, 0, best_v), torch.where(empty, 0, best_i),
            torch.where(empty, 0, best_j))


# --------------------------------------------------------------------------
# wrappers: plain version on the CPU, the CUDA kernel on the card
# --------------------------------------------------------------------------

def xdrop_rows(s, t, n, m, *, w: int, mat: int, mis: int, ind: int,
               xd: int, I: int = 128):
    """(best_score, on_s, on_t) as the rows of one int32 [B, 3] tensor;
    CUDA tensors run the ``xdrop`` kernel of csrc/align_kernels.cu, whose
    own output this is."""
    if not s.is_cuda:
        return torch.stack(xdrop_scan(s, t, n, m, w=w, mat=mat, mis=mis,
                                      ind=ind, xd=xd, I=I), dim=1)
    return _ext.launch("xdrop", s, t, n, m, None, 3, I,
                       (w, mat, mis, ind, xd))


def xdrop_batch(s, t, n, m, *, w: int, mat: int, mis: int, ind: int,
                xd: int, I: int = 128):
    """(best_score, on_s, on_t) int32 [B]: ``xdrop_rows``' columns."""
    return xdrop_rows(s, t, n, m, w=w, mat=mat, mis=mis, ind=ind, xd=xd,
                      I=I).unbind(1)


def edit_sc_batch(s, t, n, m, *, w: int, max_ed: int, max_sc: int,
                  I: int = 128):
    """(ed, sclen, indel, score) int32 [B]; CUDA tensors run the
    ``edit_sc`` kernel of csrc/align_kernels.cu."""
    if not s.is_cuda:
        return edit_sc_scan(s, t, n, m, w=w, max_ed=max_ed, max_sc=max_sc,
                            I=I)
    out = _ext.launch("edit_sc", s, t, n, m, None, 4, I,
                      (w, max_ed, max_sc))
    return out[:, 0], out[:, 1], out[:, 2], out[:, 3]


# host-facing wrap-up: drop_local_*_sc arithmetic (align.cpp:669-723)
def drop_local_sc_batch(score, on_s, on_t, m, *, mat, mis, w, max_ed,
                        max_sc, left: bool):
    """Vectorized AlignCandid wrap-up for a batch of X-drop results."""
    score = np.asarray(score).astype(np.int64)
    on_s = np.asarray(on_s).astype(np.int64)
    on_t = np.asarray(on_t).astype(np.int64)
    m = np.asarray(m).astype(np.int64)
    mx = np.maximum(on_s, on_t)
    ed = (mat * mx - score) // (mat - mis)
    indel = on_t - on_s
    clip = m - on_t
    ok = ed <= max_ed
    if not left:
        # the right side goes through AlignCandid::update against a
        # score-0 sentinel (align.cpp:683-688): negative-score candidates
        # are rejected; the left side sets unconditionally (align.cpp:713)
        ok = ok & (score >= 0)
    out_ed = np.where(ok, ed, max_ed + 1)
    out_sclen = np.where(ok, clip, np.maximum(max_sc, m) + 1)
    out_indel = np.where(ok, indel, w + 1)
    return out_ed, out_sclen, out_indel, score
