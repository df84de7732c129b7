"""Batched device alignment service for the wave extension engine (torch).

Counterpart of ``circminer_tpu/ops/align_device.py``: a whole *wave* of
alignment requests (the tuples the per-read generators of
``pipeline/extend.py`` yield) is answered with one fused
dispatch per B-row chunk instead of one scalar DP per candidate.

Kind -> DP family (each a hand-written CUDA kernel on the card):
  edit_sc_r / edit_sc_l   -> edit_sc   (left = reversed inputs)
  drop_sc_r / drop_sc_l   -> xdrop + drop_local_sc_batch wrap-up
  end_r / end_l           -> edit_end  (candidates on column j == m)
  one_side                -> one_side  (per-item band width)

Requests outside the kernels' banded regime are answered by the scalar
host aligner (``InlineAlignService``), with the same routing as the
reference, so ``n_device`` / ``n_host`` match it request for request.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
from torch.profiler import record_function

from . import _ext
from . import align as al
from .pallas_align import (POS, _diff_diag, _iota, _last_diag, _pad_rows,
                           drop_local_sc_batch, edit_sc_batch, edit_sc_scan,
                           xdrop_batch, xdrop_scan)

_i32 = torch.int32


# --------------------------------------------------------------------------
# banded edit DP, candidates on the j == m column (local_alignment_right)
# --------------------------------------------------------------------------

def edit_end_scan(s: torch.Tensor, t: torch.Tensor, n: torch.Tensor,
                  m: torch.Tensor, *, w: int, max_ed: int, I: int = 128):
    """Plain torch local_alignment_right (align.cpp:556-576; the
    reference's ``edit_end_scan_ref``): banded edit DP, then the best
    AlignCandid on column j == m — ed asc, |indel| asc, smallest i on ties.

    Returns (ed, indel) int32 [B]; no candidate -> (max_ed+1, w+1).  Valid in
    the banded regime (n > 2w, m > w)."""
    B = s.shape[0]
    dev = s.device
    n = n.to(_i32)
    m = m.to(_i32)
    s_pad = _pad_rows(s, I)
    t_rev = torch.flip(_pad_rows(t, I), dims=(1,))
    i_vec = _iota(B, I, dev)

    d2 = torch.where(i_vec == 0, 0, POS).to(_i32)
    d1 = torch.where((i_vec <= 1) & (i_vec <= n[:, None])
                     & ((1 - i_vec) <= m[:, None]), 1, POS).to(_i32)
    # banded regime => m > w >= 0: column-m candidates first appear at k = m
    best_key = torch.zeros(B, dtype=_i32, device=dev)
    best_ed = torch.full((B,), max_ed + 1, dtype=_i32, device=dev)
    best_indel = torch.full((B,), w + 1, dtype=_i32, device=dev)
    minus1 = torch.full_like(i_vec, -1)

    for k in range(2, _last_diag(n, m, I) + 1):
        mis = _diff_diag(s_pad, t_rev, k, I).to(_i32)
        diag = torch.roll(d2, 1, dims=1) + mis
        up = torch.roll(d1, 1, dims=1) + 1
        left = d1 + 1
        dp = torch.minimum(diag, torch.minimum(up, left))
        j_vec = k - i_vec
        dp = torch.where((j_vec == 0) & (i_vec <= w), i_vec, dp)
        dp = torch.where((i_vec == 0) & (j_vec <= w) & (j_vec >= 0), j_vec, dp)
        valid = ((i_vec >= 0) & (i_vec <= n[:, None]) & (j_vec >= 0)
                 & (j_vec <= m[:, None]) & ((i_vec - j_vec).abs() <= w))
        dp = torch.where(valid, dp, POS)
        # exactly one cell per diagonal sits on column m: i = k - m
        on_m = valid & (j_vec == m[:, None]) & (dp <= max_ed)
        cell_ed = torch.where(on_m, max_ed - dp, minus1).max(dim=1).values
        has = cell_ed >= 0
        ed = max_ed - cell_ed
        indel = m - (k - m)  # AlignCandid(dp[i][m], 0, m - i)
        # strict > keeps the earlier (smaller i) candidate on exact ties;
        # the radix is sized from (max_ed, w) so no config saturates it
        key = ((max_ed - ed) * (w + 2)
               + (w + 1 - torch.clamp(indel.abs(), max=w + 1)))
        better = has & (key > best_key)
        best_key = torch.where(better, key, best_key)
        best_ed = torch.where(better, ed, best_ed)
        best_indel = torch.where(better, indel, best_indel)
        d2, d1 = d1, dp
    return best_ed, best_indel


# --------------------------------------------------------------------------
# one-sided banded edit DP, per-item band width (align.cpp:219-252)
# --------------------------------------------------------------------------

def one_side_scan(s: torch.Tensor, t: torch.Tensor, n: torch.Tensor,
                  m: torch.Tensor, wv: torch.Tensor, *, I: int = 128):
    """Plain torch global_one_side_banded_alignment (the reference's
    ``one_side_scan_ref``): band j - i in [0, wv], boundary dp[0][j] = j
    (j <= wv); returns dp[n][m] (POS when the band never reaches (n, m)).
    Valid when n > wv and m > wv."""
    B = s.shape[0]
    dev = s.device
    n = n.to(_i32)
    m = m.to(_i32)
    wv = wv.to(_i32)
    s_pad = _pad_rows(s, I)
    t_rev = torch.flip(_pad_rows(t, I), dims=(1,))
    i_vec = _iota(B, I, dev)
    top = torch.minimum(wv, m)[:, None]
    hi = torch.minimum(i_vec + wv[:, None], m[:, None])
    minus1 = torch.full_like(i_vec, -1)

    d2 = torch.where(i_vec == 0, 0, POS).to(_i32)                   # (0, 0)
    d1 = torch.where((i_vec == 0) & (wv[:, None] >= 1) & (m[:, None] >= 1),
                     1, POS).to(_i32)                               # (0, 1)
    out = torch.full((B,), POS, dtype=_i32, device=dev)
    out = torch.where((n == 0) & (m == 0), 0, out)
    out = torch.where((n + m == 1) & (n == 0) & (wv >= 1) & (m == 1), 1, out)

    for k in range(2, _last_diag(n, m, I) + 1):
        mis = _diff_diag(s_pad, t_rev, k, I).to(_i32)
        diag = torch.roll(d2, 1, dims=1) + mis
        up = torch.roll(d1, 1, dims=1) + 1
        left = d1 + 1
        dp = torch.minimum(diag, torch.minimum(up, left))
        j_vec = k - i_vec
        dp = torch.where((i_vec == 0) & (j_vec >= 0) & (j_vec <= top),
                         j_vec, dp)
        valid = ((i_vec >= 0) & (i_vec <= n[:, None]) & (j_vec >= i_vec)
                 & (j_vec <= hi))
        dp = torch.where(valid, dp, POS)
        val = torch.where(i_vec == n[:, None], dp, minus1).max(dim=1).values
        out = torch.where(n + m == k, val, out)
        d2, d1 = d1, dp
    return out


# --------------------------------------------------------------------------
# wrappers: plain version on the CPU, the CUDA kernel on the card
# --------------------------------------------------------------------------

def edit_end_batch(s, t, n, m, *, w: int, max_ed: int, I: int = 128):
    """(ed, indel) int32 [B]; CUDA tensors run the ``edit_end`` kernel."""
    if not s.is_cuda:
        return edit_end_scan(s, t, n, m, w=w, max_ed=max_ed, I=I)
    out = edit_end_rows(s, t, n, m, w=w, max_ed=max_ed, I=I)
    return out[:, 0], out[:, 1]


def edit_end_rows(s, t, n, m, *, w: int, max_ed: int, I: int = 128):
    """``edit_end_batch``'s (ed, indel) as the rows of one int32 [B, 2]
    tensor, the kernel's own output on a CUDA tensor."""
    if not s.is_cuda:
        return torch.stack(edit_end_scan(s, t, n, m, w=w, max_ed=max_ed,
                                         I=I), dim=1)
    return _ext.launch("edit_end", s, t, n, m, None, 2, I, (w, max_ed))


def one_side_batch(s, t, n, m, wv, *, w: int, I: int = 128):
    """dp[n][m] int32 [B]; CUDA tensors run the ``one_side`` kernel.  w
    bounds every row's band: wv must lie in [0, w] (the kernel sizes its
    window from w and traps on a row outside it; a CPU tensor raises)."""
    if not s.is_cuda:
        if wv.numel() and not 0 <= int(wv.min()) <= int(wv.max()) <= w:
            raise ValueError(f"one_side: wv must lie in [0, {w}], got "
                             f"[{int(wv.min())}, {int(wv.max())}]")
        return one_side_scan(s, t, n, m, wv, I=I)
    return _ext.launch("one_side", s, t, n, m, wv, 1, I, (w,))[:, 0]


# --------------------------------------------------------------------------
# fused whole-wave dispatch: every DP family over one packed buffer
# --------------------------------------------------------------------------

def _wave_stack(e, x, nd, o):
    return torch.stack([*e, *x, *nd, o], dim=1)


def wave_all_scan(s, t, n, m, wv, *, w, max_ed, max_sc, mat, mis, ind, xd,
                  I: int = 128):
    """Plain torch version of ``wave_all_batch``."""
    return _wave_stack(
        edit_sc_scan(s, t, n, m, w=w, max_ed=max_ed, max_sc=max_sc, I=I),
        xdrop_scan(s, t, n, m, w=w, mat=mat, mis=mis, ind=ind, xd=xd, I=I),
        edit_end_scan(s, t, n, m, w=w, max_ed=max_ed, I=I),
        one_side_scan(s, t, n, m, wv, I=I))


def wave_all_batch(s, t, n, m, wv, *, w, max_ed, max_sc, mat, mis, ind, xd,
                   I: int = 128):
    """All four DP families over one packed [B, L] wave, as ONE int32
    [B, 10] tensor (the reference's ``wave_all_batch_ref`` layout):

        [e_ed, e_sclen, e_indel, e_score, x_score, x_on_s, x_on_t,
         n_ed, n_indel, o_ed]

    Each row's caller reads only its own kind's columns.  On the card this
    is the four CUDA kernels; on the CPU their plain versions."""
    with record_function("cm.wave_all"):
        return _wave_stack(
            edit_sc_batch(s, t, n, m, w=w, max_ed=max_ed, max_sc=max_sc,
                          I=I),
            xdrop_batch(s, t, n, m, w=w, mat=mat, mis=mis, ind=ind, xd=xd,
                        I=I),
            edit_end_batch(s, t, n, m, w=w, max_ed=max_ed, I=I),
            one_side_batch(s, t, n, m, wv, w=w, I=I))


# --------------------------------------------------------------------------
# the wave service
# --------------------------------------------------------------------------

class DeviceAlignService:
    """Answers alignment-request waves with batched device dispatches.

    ``solve`` (scalar) delegates to the inline host service; ``solve_batch``
    routes in-regime requests to one fused ``wave_all_batch`` per B-row
    chunk on ``device`` and the rest to the host aligner."""

    I = 128   # padded DP extent; covers reads <= 120 + band
    B = 1024  # fixed dispatch rows (shorter waves pad, longer ones chunk)

    def __init__(self, cfg, sm: al.ScoreMat = None, *, device):
        from ..pipeline.extend import InlineAlignService
        self.cfg = cfg
        self.device = torch.device(device)
        self.sm = sm if sm is not None else al.ScoreMat()
        self.inline = InlineAlignService(cfg, self.sm)
        self.n_dispatch = 0
        self.n_device = 0
        self.n_host = 0

    def solve(self, req):
        return self.inline.solve(req)

    def solve_batch(self, reqs: List[tuple]) -> List[tuple]:
        """Answer one mixed-kind wave in request order: one fused device
        dispatch and one [B, 10] int32 fetch per B-row chunk; out-of-regime
        shapes go to the scalar host aligner."""
        out = [None] * len(reqs)
        dev = []
        for idx, r in enumerate(reqs):
            if self._in_regime(r):
                dev.append(idx)
            else:
                out[idx] = self.inline.solve(r)
        self.n_host += len(reqs) - len(dev)
        self.n_device += len(dev)
        c, sm = self.cfg, self.sm
        for chunk in self._chunks(dev):
            # rows = the chunk's own size: no compile cache to keep warm, so
            # a short wave is not padded to B
            B = len(chunk)
            s_buf = np.zeros((B, self.I - 1), np.int8)
            t_buf = np.zeros((B, self.I - 1), np.int8)
            n = np.zeros(B, np.int32)
            m = np.zeros(B, np.int32)
            wv = np.zeros(B, np.int32)
            kinds: List[str] = []
            for r_i, idx in enumerate(chunk):
                req = reqs[idx]
                kind = req[0]
                s, t = req[1], req[2]
                if kind in ("edit_sc_l", "drop_sc_l", "end_l"):
                    s, t = s[::-1], t[::-1]
                if kind == "one_side":
                    wv[r_i] = req[3]
                n[r_i], m[r_i] = len(s), len(t)
                s_buf[r_i, :len(s)] = s
                t_buf[r_i, :len(t)] = t
                kinds.append(kind)
            d = self.device
            blob = wave_all_batch(
                torch.from_numpy(s_buf).to(d), torch.from_numpy(t_buf).to(d),
                torch.from_numpy(n).to(d), torch.from_numpy(m).to(d),
                torch.from_numpy(wv).to(d), w=c.band_width, max_ed=c.max_ed,
                max_sc=c.max_sc, mat=sm.mat, mis=sm.mis, ind=sm.ind, xd=sm.xd,
                I=self.I).cpu().numpy()
            self.n_dispatch += 1
            # X-drop wrap-up arithmetic, vectorized per side
            drop_res = {}
            for side, left in (("drop_sc_r", False), ("drop_sc_l", True)):
                rows = [r_i for r_i, k in enumerate(kinds) if k == side]
                if not rows:
                    continue
                rr = np.array(rows)
                ed, sclen, indel, scr = drop_local_sc_batch(
                    blob[rr, 4], blob[rr, 5], blob[rr, 6], m[rr],
                    mat=sm.mat, mis=sm.mis, w=c.band_width, max_ed=c.max_ed,
                    max_sc=c.max_sc, left=left)
                for j, r_i in enumerate(rows):
                    drop_res[r_i] = (int(ed[j]), int(sclen[j]),
                                     int(indel[j]), int(scr[j]))
            for r_i, idx in enumerate(chunk):
                k = kinds[r_i]
                row = blob[r_i]
                if k in ("edit_sc_r", "edit_sc_l"):
                    out[idx] = (int(row[0]), int(row[1]), int(row[2]),
                                int(row[3]))
                elif k in ("drop_sc_r", "drop_sc_l"):
                    out[idx] = drop_res[r_i]
                elif k in ("end_r", "end_l"):
                    out[idx] = (int(row[7]), int(row[8]), -int(row[7]))
                else:  # one_side
                    out[idx] = int(row[9])
        return out

    def _in_regime(self, req) -> bool:
        """True when the request's shapes fall inside the kernels' banded
        regime; outside it the oracle falls back to full DP
        (align.cpp:397-399) and the scalar host aligner answers."""
        kind, s, t = req[0], req[1], req[2]
        if len(s) >= self.I or len(t) >= self.I:
            return False
        w = self.cfg.band_width
        if kind in ("edit_sc_r", "edit_sc_l", "end_r", "end_l"):
            return len(s) > 2 * w and len(t) > w
        if kind in ("drop_sc_r", "drop_sc_l"):
            return True
        if kind == "one_side":
            # the one_side kernel's window is sized from w: a wider band
            # goes to the host aligner
            ws = req[3]
            return 0 <= ws <= w and len(s) > ws and len(t) > ws
        raise ValueError(f"unknown align request kind {kind!r}")

    def _chunks(self, idxs):
        for c0 in range(0, len(idxs), self.B):
            yield idxs[c0:c0 + self.B]

    def warm(self):
        """Run one wave of every kind at the fixed dispatch shape (on the
        card this builds and loads the kernels before the timed region).
        Sequences of length I-1 keep every kind in the device regime."""
        o = np.ones(self.I - 1, np.int8)
        reqs = [(k, o, o) for k in ("edit_sc_r", "edit_sc_l", "drop_sc_r",
                                    "drop_sc_l", "end_r", "end_l")]
        reqs.append(("one_side", o, o, min(1, self.cfg.band_width)))
        self.solve_batch(reqs)
