"""The band-local recurrences of the four CUDA kernels, transcribed to
numpy and held against the port's plain versions.

The kernels (``circminer_tpu_torch/csrc/align_kernels.cu``) keep, per
anti-diagonal k, only a window of Wp = G * CPT slots (slot q holds cell
i = a_k + q, j = k - i) instead of the whole I = 128 extent, where G lanes
of CPT cells each serve one item (``_ext.band_layout``):

  * ``edit_end``, ``edit_sc``: a_k = ceil((k - w) / 2) - 1, so the band
    cells |i - j| <= w sit in slots 1 .. w + 1;
  * ``one_side``: the same a_k at the launch's bound w, so each row's band
    0 <= j - i <= wv (wv <= w) sits in slots 1 .. w // 2 + 1;
  * ``xdrop``: a_k = lb_k - 1, so the live band [lb, ub] sits from slot 1
    and the boundary cells (0, k), (k, 0) with k <= w fall in the window.

a_k moves by 0 or 1 per diagonal (delta): the previous two diagonals and the
s / t codes are shifted by delta slots after each diagonal, so that cell q
reads its (i - 1) neighbours at slot q - 1 and its (i) neighbour at q, and
one new s or t code enters per diagonal.  This module runs exactly that
indexing, vectorised over the items, beside the full-extent recurrence,
and asserts at every diagonal that (1) every full-extent value outside the
window is NEG / POS (the window invariant), (2) the window equals the full
extent inside it, and (3) the shifted codes are s[i - 1] and t[j - 1] at
every live cell.  Its outputs must equal the port's plain ``xdrop_scan``,
``edit_sc_scan``, ``edit_end_scan`` and ``one_side_scan`` bit for bit at
every band width the kernels take.
"""

import numpy as np
import pytest
import torch

from chip_smoke import kernel_inputs
from circminer_tpu_torch.ops import _ext
from circminer_tpu_torch.ops.align import ScoreMat
from circminer_tpu_torch.ops.align_device import edit_end_scan, one_side_scan
from circminer_tpu_torch.ops.pallas_align import (NEG, POS, edit_sc_scan,
                                                  xdrop_scan)

I = 128
WIDTHS = [0, 1, 2, 3, 5, 8, 31, 127]
SM = ScoreMat()
MAX_ED, MAX_SC = 4, 7


def _codes(s, t):
    # N (>= 4) never matches: s codes it 4, t codes it 5
    return (np.where(s >= 4, 4, s).astype(np.int32),
            np.where(t >= 4, 5, t).astype(np.int32))


def _take(row_codes, idx):
    """codes[b, idx[b, q]] with the index clamped into the row (cells whose
    index falls outside are never live, so any code will do there)."""
    L = row_codes.shape[1]
    return np.take_along_axis(row_codes, np.clip(idx, 0, max(L - 1, 0)),
                              axis=1) if L else np.zeros(idx.shape, np.int32)


def _shift(x, delta, fill):
    """Re-anchor a window by delta in {0, 1}: x'[q] = x[q + delta]."""
    up = np.concatenate([x[:, 1:], np.full((x.shape[0], 1), fill,
                                           x.dtype)], axis=1)
    return np.where(delta[:, None] == 1, up, x)


def _full_step(d2, d1, sc, tc, k, better, add_sub, add_gap):
    """One diagonal of the full-extent recurrence (cells i = 0 .. I-1),
    neighbours (i - 1) on k - 2 and k - 1 and (i) on k - 1; boundary and
    band masks are the caller's."""
    B = d2.shape[0]
    i = np.arange(I)[None, :].repeat(B, 0)
    j = k - i
    sv = _take(sc, i - 1)
    tv = _take(tc, j - 1)
    fill = d2[:, :1] * 0 + (NEG if better is np.maximum else POS)
    d2m = np.concatenate([fill, d2[:, :-1]], axis=1)
    d1m = np.concatenate([fill, d1[:, :-1]], axis=1)
    v = better(d2m + add_sub(sv != tv), better(d1m, d1) + add_gap)
    return i, j, v


def _parity_windows(s, t, n, m, w, one_sided, init, rule):
    """The band-local recurrence of the kernels whose window starts at
    a_k = ceil((k - w) / 2) - 1 (edit_end, edit_sc, one_side), beside the
    full-extent one.  ``init(k, i)`` gives the seed diagonals k = 0, 1;
    ``rule(i, j, v)`` applies the boundary cells and the band mask and
    returns (values, band mask).  Yields (k, p, N, band) per diagonal, the
    window's cells i = p, their values and mask, after asserting the window
    invariant, the window against the full extent, the shifted codes, and
    that slot 0 is never in band (a one-lane item does not compute it)."""
    B = s.shape[0]
    G, CPT = _ext.band_layout(w, one_sided)
    Wp = G * CPT
    wa = min(w, 2 * I - 2)
    sc, tc = _codes(s, t)
    q = np.arange(Wp)[None, :]
    full_i = np.arange(I)[None, :].repeat(B, 0)
    f2, f1 = init(0, full_i), init(1, full_i)
    a = np.full(B, -((wa - 2) // 2) - 1)    # ceil((k - w) / 2) - 1, k = 2
    P, PP = init(1, a[:, None] + q), init(0, a[:, None] + q)
    S = _take(sc, a[:, None] + q - 1)
    T = _take(tc, 2 - a[:, None] - q - 1)
    for k in range(2, int(np.minimum(2 * I - 1, n + m).max(initial=1)) + 1):
        # full extent, as the plain version computes it
        i, j, v = _full_step(f2, f1, sc, tc, k, np.minimum,
                             lambda x: x.astype(np.int64), 1)
        full, _ = rule(i, j, v)

        # the window, indexed as the kernel indexes it
        p = a[:, None] + q
        jj = k - p
        PPm = np.concatenate([np.full((B, 1), POS), PP[:, :-1]], axis=1)
        Pm = np.concatenate([np.full((B, 1), POS), P[:, :-1]], axis=1)
        nv = np.minimum(PPm + (S != T), np.minimum(Pm, P) + 1)
        N, band = rule(p, jj, nv)
        band &= (p >= 0) & (p <= I - 1)
        N = np.where(band, N, POS)

        live = band & (p >= 1) & (jj >= 1)
        assert (S[live] == _take(sc, p - 1)[live]).all()
        assert (T[live] == _take(tc, jj - 1)[live]).all()
        assert not band[:, 0].any(), k
        inside = (full_i >= p[:, :1]) & (full_i <= p[:, -1:])
        assert (full[~inside] == POS).all(), k          # window invariant
        pos = np.clip(p, 0, I - 1)
        in_ext = (p >= 0) & (p <= I - 1)
        assert (np.take_along_axis(full, pos, 1)[in_ext] == N[in_ext]).all()
        yield k, p, N, band

        # re-anchor for k + 1: one new s code (delta = 1) or t code
        delta = np.full(B, int((k - wa) % 2 == 0))
        new_s = _take(sc, (a + Wp - 1 + delta - 1)[:, None])[:, 0]
        new_t = _take(tc, (k + 1 - a - 1)[:, None])[:, 0]
        S = np.where(delta[:, None] == 1, np.concatenate(
            [S[:, 1:], new_s[:, None]], axis=1), S)
        T = np.where(delta[:, None] == 1, T, np.concatenate(
            [new_t[:, None], T[:, :-1]], axis=1))
        PP, P = _shift(P, delta, POS), _shift(N, delta, POS)
        a = a + delta
        f2, f1 = f1, full


def _edit_windows(s, t, n, m, w):
    """The banded edit DP of edit_end / edit_sc: |i - j| <= w, boundary
    dp[i][0] = i and dp[0][j] = j up to w."""
    def init(k, i):                          # the seed diagonals k = 0, 1
        if k == 0:
            return np.where(i == 0, 0, POS)
        return np.where((i >= 0) & (i <= 1) & (i <= n[:, None])
                        & (1 - i <= m[:, None]), 1, POS)

    def rule(i, j, v):
        v = np.where((j == 0) & (i <= w), i, v)
        v = np.where((i == 0) & (j >= 0) & (j <= w), j, v)
        band = (i >= 0) & (i <= n[:, None]) & (j >= 0) & (j <= m[:, None]) \
            & (np.abs(i - j) <= w)
        return np.where(band, v, POS), band
    return _parity_windows(s, t, n, m, w, False, init, rule)


def edit_end_band(s, t, n, m, w, max_ed):
    """The edit_end kernel's band-local recurrence; returns (ed, indel)."""
    B = s.shape[0]
    best_key = np.zeros(B, np.int64)
    best_ed = np.full(B, max_ed + 1)
    best_indel = np.full(B, w + 1)
    for k, p, N, band in _edit_windows(s, t, n, m, w):
        # the one cell on column m
        on_m = band & (k - p == m[:, None]) & (N <= max_ed)
        ce = np.where(on_m, max_ed - N, -1).max(axis=1)
        ed = max_ed - ce
        indel = m - (k - m)
        key = (max_ed - ed) * (w + 2) + (w + 1 - np.minimum(np.abs(indel),
                                                             w + 1))
        better = (ce >= 0) & (key > best_key)
        best_key = np.where(better, key, best_key)
        best_ed = np.where(better, ed, best_ed)
        best_indel = np.where(better, indel, best_indel)
    return best_ed, best_indel


def _pack32(*fields):
    """(value, shift) fields OR-ed into an int32 key as the reference's
    int32 shifts compose it (wrapping), returned as int64."""
    key = np.zeros(np.broadcast(*(v for v, _ in fields)).shape, np.int64)
    for v, sh in fields:
        key |= (np.asarray(v, np.int64) << sh) & 0xFFFFFFFF
    return np.where(key >= 1 << 31, key - (1 << 32), key)


def _sc_key(dp, i, j):
    return _pack32((j - 2 * dp + 512, 21), (31 - dp, 16),
                   (15 - np.abs(j - i), 12), (j, 5),
                   (31 - np.minimum(i, 31), 0))


def edit_sc_band(s, t, n, m, w, max_ed, max_sc):
    """The edit_sc kernel's band-local recurrence: every cell with dp <=
    max_ed and j >= m - min(max_sc, m) offered in ascending i, diagonal
    after diagonal, to a strict-greater running best (the kernel's one-lane
    rule); returns (ed, sclen, indel, score)."""
    B = s.shape[0]
    jmin = m - np.minimum(max_sc, m)
    best = [np.zeros(B, np.int64) for _ in range(3)]    # key, i, j

    def offer(ok, key, i, j):
        gt = ok & (key > best[0])
        for x, v in zip(best, (key, i, j)):
            x[:] = np.where(gt, v, x)

    # the seed diagonals: (0, 0) = 0, then (0, 1) and (1, 0) = 1
    offer((0 <= max_ed) & (jmin <= 0), _sc_key(0, 0, 0), 0, 0)
    offer((m >= 1) & (1 <= max_ed) & (jmin <= 1) & (w >= 1),
          _sc_key(1, 0, 1), 0, 1)
    offer((n >= 1) & (1 <= max_ed) & (jmin <= 0) & (w >= 1),
          _sc_key(1, 1, 0), 1, 0)
    for k, p, N, _ in _edit_windows(s, t, n, m, w):
        for c in range(p.shape[1]):
            i, d = p[:, c], N[:, c]
            offer((d <= max_ed) & (k - i >= jmin), _sc_key(d, i, k - i), i,
                  k - i)
    key, bi, bj = best
    has = key > 0
    sclen = np.where(has, m - bj, max_sc + 1)
    indel = np.where(has, bj - bi, w + 1)
    ed = np.where(has, (m - sclen - ((key >> 21) - 512)) >> 1, max_ed + 1)
    # oracle tail: if m <= max_ed, the candidate (m, 0, 0) competes
    tail = (m <= max_ed) & (_pack32((512 - m, 21), (31 - m, 16), (15, 12),
                                    (m, 5), (31, 0)) > key)
    ed = np.where(tail, m, ed)
    sclen = np.where(tail, 0, sclen)
    indel = np.where(tail, 0, indel)
    return ed, sclen, indel, m - sclen - 2 * ed


def one_side_band(s, t, n, m, wv, w):
    """The one_side kernel's band-local recurrence (window anchored at the
    bound w, each row's band 0 <= j - i <= wv <= w masked inside it);
    returns dp[n][m], read on diagonal n + m (POS off the band)."""
    assert ((wv >= 0) & (wv <= w)).all()
    top = np.minimum(wv, m)[:, None]

    def init(k, i):
        if k == 0:
            return np.where(i == 0, 0, POS)
        return np.where((i == 0) & (wv[:, None] >= 1) & (m[:, None] >= 1),
                        1, POS)

    def rule(i, j, v):
        v = np.where((i == 0) & (j >= 0) & (j <= top), j, v)
        band = (i >= 0) & (i <= n[:, None]) & (j >= i) \
            & (j <= np.minimum(i + wv[:, None], m[:, None]))
        return np.where(band, v, POS), band

    res = np.full(s.shape[0], POS, np.int64)
    res = np.where((n == 0) & (m == 0), 0, res)
    res = np.where((n == 0) & (m == 1) & (wv >= 1), 1, res)
    for k, p, N, _ in _parity_windows(s, t, n, m, w, True, init, rule):
        at = np.where(p == n[:, None], N, POS).min(axis=1)
        res = np.where(n + m == k, at, res)
    return res


def xdrop_band(s, t, n, m, w, mat, mis, ind, xd):
    """The xdrop kernel's band-local recurrence; returns (score, on_s,
    on_t) and the diagonal each item stopped at."""
    B = s.shape[0]
    G, CPT = _ext.band_layout(w)
    Wp = G * CPT
    sc, tc = _codes(s, t)
    q = np.arange(Wp)[None, :]
    wn, wm = np.minimum(n, w), np.minimum(m, w)
    kend = np.minimum(2 * I - 1, n + m)

    def init(k, i):
        if k == 0:
            return np.where(i == 0, 0, NEG)
        return np.where((i >= 0) & (i <= 1) & (i <= wn[:, None])
                        & (1 - i <= wm[:, None]), ind, NEG)

    full_i = np.arange(I)[None, :].repeat(B, 0)
    f2, f1 = init(0, full_i), init(1, full_i)
    lb, ub = np.ones(B, np.int64), np.ones(B, np.int64)
    pre_ub = np.zeros(B, np.int64)
    pre_opt = np.zeros(B, np.int64)
    cur_opt = np.zeros(B, np.int64)
    best = np.zeros((3, B), np.int64)
    alive = (n > 0) & (m > 0)
    stop = kend.copy()
    a = lb - 1
    P, PP = init(1, a[:, None] + q), init(0, a[:, None] + q)
    S = _take(sc, a[:, None] + q - 1)
    T = _take(tc, 2 - a[:, None] - q - 1)
    for k in range(2, int(kend.max(initial=1)) + 1):
        act = alive & (k <= kend)
        if not act.any():
            break
        sub = (lambda x: np.where(x, mis, mat))
        i, j, val = _full_step(f2, f1, sc, tc, k, np.maximum, sub, ind)
        fband = (i >= lb[:, None]) & (i <= ub[:, None]) & (j >= 1) \
            & (j <= m[:, None]) & (i <= n[:, None]) & act[:, None]
        val = np.where(fband, val, NEG)
        fd = np.where((j == 0) & (i <= wn[:, None]), ind * i, val)
        fd = np.where((i == 0) & (j >= 0) & (j <= wm[:, None]), ind * j, fd)
        fd = np.where(fband & (val + xd < pre_opt[:, None]), NEG, fd)

        p = a[:, None] + q
        jj = k - p
        PPm = np.concatenate([np.full((B, 1), NEG), PP[:, :-1]], axis=1)
        Pm = np.concatenate([np.full((B, 1), NEG), P[:, :-1]], axis=1)
        v = np.maximum(PPm + np.where(S != T, mis, mat),
                       np.maximum(Pm, P) + ind)
        band = (p >= lb[:, None]) & (p <= ub[:, None]) & (jj >= 1) \
            & (jj <= m[:, None]) & (p <= n[:, None]) & (p <= I - 1)
        v = np.where(band, v, NEG)
        N = np.where((jj == 0) & (p <= wn[:, None]), ind * p, v)
        N = np.where((p == 0) & (jj >= 0) & (jj <= wm[:, None]), ind * jj, N)
        pruned = np.where(v + xd < pre_opt[:, None], NEG, v)
        N = np.where(band, pruned, N)

        live = band & act[:, None]
        assert (S[live] == _take(sc, p - 1)[live]).all()
        assert (T[live] == _take(tc, jj - 1)[live]).all()
        inside = (full_i >= p[:, :1]) & (full_i <= p[:, -1:])
        ok = act[:, None] & ~inside
        assert (fd[ok] == NEG).all(), k                  # window invariant
        pos = np.clip(p, 0, I - 1)
        in_ext = act[:, None] & (p <= I - 1)
        assert (np.take_along_axis(fd, pos, 1)[in_ext] == N[in_ext]).all()

        # (value, i) max: the largest i among the maxima
        pk = np.where(band, v, NEG) * (1 << 32) + np.maximum(p, 0)
        top = pk.max(axis=1)
        vmax, i_att = top >> 32, top & 0xffffffff
        upd = act & (vmax >= cur_opt)
        cur_opt = np.where(upd, vmax, cur_opt)
        best = np.where(upd, np.stack([vmax, i_att, k - i_att]), best)
        new_ub = np.where(band & (pruned > NEG), p, -1).max(axis=1)
        odd = (k - w) % 2 == 1 if k > w else False
        lb2 = np.where((k - lb == m) | (k > w and not odd), lb + 1, lb)
        ub2 = np.where((ub < n) & (k <= w or odd), ub + 1, ub)
        dead = ((pre_ub == -1) & (new_ub == -1)) | (lb2 > ub2)
        pre_ub = np.where(act, new_ub, pre_ub)
        pre_opt = np.where(act, np.maximum(pre_opt, cur_opt), pre_opt)
        delta = np.where(act, lb2 - lb, 0)
        lb, ub = np.where(act, lb2, lb), np.where(act, ub2, ub)
        stop = np.where(act & dead, k, stop)
        alive = alive & ~(act & dead)

        new_s = _take(sc, (a + Wp - 1 + delta - 1)[:, None])[:, 0]
        new_t = _take(tc, (k + 1 - a - 1)[:, None])[:, 0]
        S = np.where(delta[:, None] == 1, np.concatenate(
            [S[:, 1:], new_s[:, None]], axis=1), S)
        T = np.where(delta[:, None] == 1, T, np.concatenate(
            [new_t[:, None], T[:, :-1]], axis=1))
        PP, P = _shift(P, delta, NEG), _shift(N, delta, NEG)
        a = a + delta
        f2, f1 = f1, np.where(act[:, None], fd, f1)
    empty = (n <= 0) | (m <= 0)
    return tuple(np.where(empty, 0, x) for x in best), stop


def _inputs(w, seed, B=40):
    """chip_smoke.kernel_inputs kinds at band w, plus edge rows: n or m = 0,
    n + m = 2I - 2, all-N rows, and X-drop items that die early."""
    rng = np.random.default_rng(seed)
    s, t, n, m, _ = kernel_inputs(rng, B, max(w, 1))
    L = s.shape[1]
    edge = [(0, 5), (7, 0), (0, 0), (L, L), (L, L), (90, 90), (100, 100),
            (100, 100)]
    for b, (nn, mm) in enumerate(edge):
        s[b], t[b] = 0, 0
        s[b, :nn] = rng.integers(0, 4, size=nn)
        t[b, :mm] = s[b, :mm]
        n[b], m[b] = nn, mm
    t[3, 60] = (t[3, 60] + 1) % 4                 # one mismatch mid-way
    s[5, :n[5]], t[5, :m[5]] = 4, 4                # all N
    s[6, :100] = (t[6, :100] + 1) % 4              # all mismatches: dies
    s[7, 10:100] = (s[7, 10:100] + 2) % 4          # dies after a good start
    return s, t, n, m


def _plain(fn, s, t, n, m, **kw):
    out = fn(*(torch.from_numpy(x) for x in (s, t, n, m)), **kw)
    return tuple(x.numpy() for x in out)


@pytest.mark.parametrize("w", WIDTHS)
def test_edit_end_band_equals_plain(w):
    s, t, n, m = _inputs(w, seed=100 + w)
    got = edit_end_band(s, t, n, m, w, MAX_ED)
    want = _plain(edit_end_scan, s, t, n, m, w=w, max_ed=MAX_ED)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)


@pytest.mark.parametrize("w", WIDTHS)
def test_xdrop_band_equals_plain(w):
    s, t, n, m = _inputs(w, seed=200 + w)
    got, stop = xdrop_band(s, t, n, m, w, SM.mat, SM.mis, SM.ind, SM.xd)
    want = _plain(xdrop_scan, s, t, n, m, w=w, mat=SM.mat, mis=SM.mis,
                  ind=SM.ind, xd=SM.xd)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)
    # the rows built to die stop well before n + m
    assert (stop[6:8] < 40).all(), stop[6:8]


@pytest.mark.parametrize("w", WIDTHS)
def test_edit_sc_band_equals_plain(w):
    s, t, n, m = _inputs(w, seed=300 + w)
    got = edit_sc_band(s, t, n, m, w, MAX_ED, MAX_SC)
    want = _plain(edit_sc_scan, s, t, n, m, w=w, max_ed=MAX_ED,
                  max_sc=MAX_SC)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)


@pytest.mark.parametrize("w", WIDTHS)
def test_one_side_band_equals_plain(w):
    """Per-row bands over [0, w], both ends included, in the layout of w."""
    s, t, n, m = _inputs(w, seed=400 + w)
    wv = np.random.default_rng(w).integers(0, w + 1, size=len(n))
    wv[0::4], wv[1::4] = w, 0
    wv = wv.astype(np.int32)
    got = one_side_band(s, t, n, m, wv, w)
    want = one_side_scan(*(torch.from_numpy(x) for x in (s, t, n, m, wv)))
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("w", WIDTHS)
def test_band_layout_covers_the_window(w):
    """G lanes of CPT cells hold at least the w + 2 window slots (w // 2 + 2
    for one_side's one-sided band); G divides the warp, and the layout
    depends on w alone."""
    for one_sided, slots in ((False, w + 2), (True, w // 2 + 2)):
        G, CPT = _ext.band_layout(w, one_sided)
        assert G * CPT >= min(slots, 2 * I) and 32 % G == 0
        assert G == 1 or CPT == 8
    assert _ext.band_layout(w, True)[0] <= _ext.band_layout(w)[0]
