"""Frozen copies of the port's plain torch code that the work counts run to
learn how much work the data asks for (how far a walk goes, which pair
cells a grid fills, what a sort keeps live): the walk's lane set-up, pool
and scan, phase 2's pair grid with the left-chain walk, the chain
prelude's junction tables, the k-best extraction, their helpers and the
field lists they index by.

Copied from ``circminer_tpu_torch/ops/`` (``chain_device.py``,
``device_finish.py``, ``device_full.py``, ``device_walk.py``) with the
relative imports taken out, so that a change to the program leaves the
benchmark's bounds as they are.  ``cmbench/tests/test_cmbench_work.py``
holds the counts made with them equal to ``chip_smoke.py``'s.
"""

from types import SimpleNamespace
from typing import NamedTuple

import torch

# circminer_tpu_torch/config.py
INF = int(1e9)
MAXDISCRDTLEN = 20000


_i32 = torch.int32


def _junction_tables(ol_iv, iv_nseg, seg_end, seg_next, seg_pad: int,
                     seg_compact: bool = False):
    """The junction tables of the cells' intervals, as the reference's
    prelude gathers them: (sep, snp, pv), [M, P, b] views of [B, M, P]
    gathers (pv: segment p < the interval's count, for a cell with an
    interval); padded row gathers, or one column at a time
    (``seg_compact``)."""
    n_iv = seg_end.shape[0]
    dev = ol_iv.device
    has_iv = ol_iv >= 0
    iv_cc = torch.clamp(ol_iv, 0, n_iv - 1).long()
    nseg_cc = iv_nseg[iv_cc]                                     # [B, M]
    if seg_compact:
        sep = torch.stack([seg_end[:, p][iv_cc] for p in range(seg_pad)],
                          dim=-1)                                # [B, M, P]
        snp = torch.stack([seg_next[:, p][iv_cc] for p in range(seg_pad)],
                          dim=-1)
    else:
        sep, snp = seg_end[iv_cc], seg_next[iv_cc]               # [B, M, P]
    pv = (has_iv[:, :, None]
          & (torch.arange(seg_pad, dtype=_i32, device=dev)[None, None, :]
             < nseg_cc[:, :, None]))                             # [B, M, P]
    return tuple(x.permute(1, 2, 0) for x in (sep, snp, pv))


_NEG = -(2 ** 29)


def extract_kbest_device_staged(dp10, back, pos, qpos, cnt, *, k: int,
                                C: int, iters: int = 48, upto: str = "full"):
    """The plain version of ``extract_kbest_device``, on any device, with
    the reference's stage cut points: upto in ("sort", "walks", "emit",
    "assemble", "full")."""
    R, NL, S = dp10.shape
    M = NL * S
    dev = dp10.device
    dpf = dp10.reshape(R, M)
    backf = back.reshape(R, M)
    posf = pos.reshape(R, M)
    l_of = torch.arange(NL, device=dev).repeat_interleave(S)        # [M]
    s_of = torch.arange(S, dtype=_i32, device=dev).repeat(NL)
    validf = (s_of[None, :] < cnt[:, l_of]) & (backf >= 0)

    best10 = torch.where(validf, dpf, _NEG).amax(dim=1)              # [R]
    # the pick order is static (picks never change dp): sort every cell by
    # (score desc, list desc, index asc).  The secondary key is unique per
    # cell, so one int64 composite key gives the reference's two-key sort.
    sec = l_of.to(_i32) * S + (S - 1 - s_of)                          # [M]
    neg_dp = torch.where(validf, -dpf, -_NEG).to(torch.int64)
    key = neg_dp * M + (M - 1 - sec).to(torch.int64)[None, :]
    sorted_idx = torch.argsort(key, dim=1).to(_i32)
    n_valid = validf.sum(dim=1, dtype=_i32)                           # [R]
    if upto == "sort":
        return sorted_idx, n_valid

    T = iters
    # ---- from here the row dimension R is last ------------------------
    heads_T = sorted_idx[:, :T].T                                     # [T, R]
    dpf_T, backf_T, posf_T = dpf.T, backf.T, posf.T                   # [M, R]
    qposf_T = qpos[:, l_of].T

    # ---- walks of every candidate (at most NL fragments) --------------
    # every visited index is a valid flat cell (a head or a backpointer),
    # so each step is a row gather of the [M, R] tables
    cur = heads_T.long()
    active = torch.ones((T, R), dtype=torch.bool, device=dev)
    wpos_f, wqp_f, wact_f = [], [], []
    sc_T = torch.gather(dpf_T, 0, cur)
    for _ in range(NL):
        wpos_f.append(torch.gather(posf_T, 0, cur))
        wqp_f.append(torch.gather(qposf_T, 0, cur))
        wact_f.append(active)
        nxt = torch.gather(backf_T, 0, cur)
        active = active & (nxt >= 0)
        cur = torch.where(active, nxt.long(), cur)
    clen_T = torch.stack(wact_f).sum(dim=0, dtype=_i32)               # [T, R]
    hp_T = wpos_f[0]
    if upto == "walks":
        return wpos_f, wqp_f, clen_T, hp_T

    # ---- serial emission (repeat suppression is order-dependent) ------
    # coll[t', t] = head_pos(t) appears among the NON-head fragments of
    # candidate t' (chain.cpp:266-270's repeat set, for every possible
    # emitter at once); is_rep(t) = any(emitted & coll[:, t]).
    coll = torch.zeros((T, T, R), dtype=torch.bool, device=dev)
    for f in range(1, NL):
        coll |= ((wpos_f[f][:, None, :] == hp_T[None, :, :])
                 & wact_f[f][:, None, :])
    cn = torch.zeros((R,), dtype=_i32, device=dev)
    emitted = torch.zeros((T, R), dtype=torch.bool, device=dev)
    for t in range(T):
        is_rep = (emitted & coll[:, t]).any(dim=0)                    # [R]
        emit = (t < n_valid) & ~((sc_T[t] < best10) & is_rep) & (cn < C)
        emitted[t] = emit
        cn = cn + emit.to(_i32)
    if upto == "emit":
        return cn, emitted.T

    # ---- assembly: slot c <- the c-th emitted pick ---------------------
    ranke = torch.cumsum(emitted, dim=0, dtype=_i32) - 1              # [T, R]
    iota_c = torch.arange(C, dtype=_i32, device=dev)[:, None, None]   # [C,1,1]
    sel = emitted[None, :, :] & (ranke[None, :, :] == iota_c)          # [C,T,R]

    def pick_reduce(v_T):
        return torch.where(sel, v_T[None, :, :], 0).sum(dim=1, dtype=_i32)

    slot_valid = iota_c[:, 0, :] < cn[None, :]                         # [C, R]
    out_rpos_cf, out_qp_cf = [], []
    for f in range(NL):
        sel_wa = (pick_reduce(wact_f[f].to(_i32)) != 0) & slot_valid
        out_rpos_cf.append(torch.where(sel_wa, pick_reduce(wpos_f[f]), 0))
        out_qp_cf.append(torch.where(sel_wa, pick_reduce(wqp_f[f]), 0))
    out_clen_c = torch.where(slot_valid, pick_reduce(clen_T), 0)       # [C, R]
    out_sc_c = torch.where(slot_valid, pick_reduce(sc_T), 0)

    incomplete = (n_valid > iters) & (cn < C)
    if upto == "assemble":
        return (torch.stack(out_rpos_cf, 1), torch.stack(out_qp_cf, 1),
                out_clen_c, out_sc_c, cn, incomplete)

    # ---- single-fragment fallback (chain.cpp:283-298): lists desc, s asc
    fb_needed = cn == 0                                                # [R]
    perm = ((NL - 1 - torch.arange(NL, device=dev))[:, None] * S
            + torch.arange(S, device=dev)[None, :]).reshape(M)        # [M]
    # validity (in-count, not event) in perm order, [M, R]
    v_sf_T = s_of[perm][:, None] < cnt[:, l_of[perm]].T
    rank_fb = torch.cumsum(v_sf_T, dim=0, dtype=_i32) - 1
    take = v_sf_T & (rank_fb < C)
    selfb = take[None, :, :] & (rank_fb[None, :, :] == iota_c)        # [C,M,R]

    def fb_reduce(v_T):
        return torch.where(selfb, v_T[perm][None, :, :], 0).sum(
            dim=1, dtype=_i32)

    fb_rpos, fb_qp, fb_sc = fb_reduce(posf_T), fb_reduce(qposf_T), \
        fb_reduce(dpf_T)
    n_fb = torch.clamp(v_sf_T.sum(dim=0, dtype=_i32), max=C)

    fbm = fb_needed[None, :]                                           # [1, R]
    out_rpos_cf[0] = torch.where(fbm, fb_rpos, out_rpos_cf[0])
    out_qp_cf[0] = torch.where(fbm, fb_qp, out_qp_cf[0])
    for f in range(1, NL):
        out_rpos_cf[f] = torch.where(fbm, 0, out_rpos_cf[f])
        out_qp_cf[f] = torch.where(fbm, 0, out_qp_cf[f])
    fb_len = (iota_c[:, 0, :] < n_fb[None, :]).to(_i32)
    out_clen_c = torch.where(fbm, fb_len, out_clen_c)
    out_sc_c = torch.where(fbm, fb_sc, out_sc_c)
    cn = torch.where(fb_needed, n_fb, cn)

    # ---- back to [R, C, NL] / [R, C] -----------------------------------
    out_rpos = torch.stack(out_rpos_cf, dim=1).permute(2, 0, 1).contiguous()
    out_qp = torch.stack(out_qp_cf, dim=1).permute(2, 0, 1).contiguous()
    return (out_rpos, out_qp, out_clen_c.T.contiguous(),
            out_sc_c.T.contiguous(), cn, incomplete)


DEF_PANNO = 1 << 5      # annotation padding overflow on pair intervals


DEF_UNION = 1 << 6      # candidate pair count > P_MAX


def _full(shape, value, like, dtype=_i32):
    return torch.full(shape, value, dtype=dtype, device=like.device)


def _last(arr, idx):
    """arr[..., idx[...]] along the last axis; idx already in range."""
    return torch.gather(arr, -1, idx.long()[..., None])[..., 0]


def _along(arr, idx, dim):
    """take_along_axis(arr, idx expanded to arr's trailing dims, dim), for
    in-range idx of shape arr.shape[:dim] + (P,)."""
    ix = idx.long().reshape(*idx.shape, *([1] * (arr.ndim - idx.ndim)))
    return torch.gather(arr, dim,
                        ix.expand(*idx.shape, *arr.shape[idx.ndim:]))


def _mate_rows(dev):
    """Rows of a pair's four (r1, rc(r1), r2, rc(r2)) for its forward mate
    chains [0, 2] and reverse mate chains [3, 1], made on the device (a
    host-made constant would be a synchronising copy)."""
    two = torch.arange(2, device=dev)
    return 2 * two, 3 - 2 * two


def _gather_window(codes, start0, length, width, reverse=False):
    """codes int8 [G]; start0 int32 [...] (0-based), length [...].
    Returns int8 [..., width] (127 beyond length or out of bounds, so
    padding never equals a real base); reverse=True yields the window
    reversed (for the *_l request kinds)."""
    G = codes.shape[0]
    io = torch.arange(width, dtype=_i32, device=codes.device)
    if reverse:
        idx = start0[..., None] + (length[..., None] - 1 - io)
    else:
        idx = start0[..., None] + io
    inside = (io < length[..., None]) & (idx >= 0) & (idx < G)
    return torch.where(inside, codes[torch.clamp(idx, 0, G - 1).long()],
                       127).to(torch.int8)


def _compact(active_flat, limit):
    """active [S] bool -> (pool->flat gather index [limit], n_active,
    overflow flat mask [S]).  Pool slot j is the first flat position where
    the active-rank cumsum reaches j+1; pool rows >= n_active gather an
    arbitrary valid slot, which ``_scatter_pool`` discards."""
    S = active_flat.shape[0]
    rank1 = torch.cumsum(active_flat, dim=0, dtype=_i32)   # 1-based at active
    n_active = torch.clamp(rank1[-1], max=limit)
    probe = torch.arange(1, limit + 1, dtype=_i32, device=rank1.device)
    inv = torch.searchsorted(rank1, probe, side="left", out_int32=True)
    inv = torch.clamp(inv, max=S - 1)
    over = active_flat & (rank1 > limit)
    return inv, n_active, over


def _scatter_pool(vals, inv, n_active, flat_size):
    """Scatter pool results back to flat slots; rows >= n_active all go to
    one sink slot past the end, which is dropped (their order there does
    not matter)."""
    limit = inv.shape[0]
    live = torch.arange(limit, device=inv.device) < n_active
    safe = torch.where(live, inv, flat_size).long()
    out = torch.zeros((flat_size + 1,), dtype=vals.dtype, device=vals.device)
    out[safe] = vals
    return out[:flat_size]


DP_KEYS = ("ed", "sclen", "indel", "score")


def _tids_intersect(fa, iv_a, iv_b):
    """same_transcript2 non-emptiness: any shared tid (order-free)."""
    ok = (iv_a >= 0) & (iv_b >= 0)
    n = fa.iv_tids.shape[0] - 1
    ta = fa.iv_tids[torch.clamp(iv_a, 0, n).long()]
    tb = fa.iv_tids[torch.clamp(iv_b, 0, n).long()]
    eq = (ta[..., :, None] == tb[..., None, :]) & (ta[..., :, None] >= 0)
    return ok & eq.flatten(-2).any(dim=-1)


def _seg_valid(ad, ivc, width):
    return torch.arange(width, device=ivc.device) < ad.iv_nseg[ivc][..., None]


def _same_gene_span(ad, fa, iv, s, e):
    """utils.cpp:617-627: [s, e] inside any gene of iv's seg list."""
    ivc = torch.clamp(iv, 0, fa.seg_gene_p.shape[0] - 1).long()
    g = fa.seg_gene_p[ivc]                               # [..., SP]
    pv = _seg_valid(ad, ivc, g.shape[-1]) & (g >= 0)
    gc = torch.clamp(g, 0, fa.gene_start.shape[0] - 1).long()
    hit = pv & (fa.gene_start[gc] <= s[..., None]) \
        & (e[..., None] <= fa.gene_end[gc])
    return (iv >= 0) & hit.any(dim=-1)


def _is_left_chain(a_rp, a_qp, a_len, b_rp, b_qp, b_len, read_len, NL, k):
    """utils.cpp:827-887 merge walk, vectorized over [...].  Fragment
    tensors [..., NL]; flen == k."""
    a_beg, b_beg = a_rp[..., 0], b_rp[..., 0]
    a_end = _last(a_rp, torch.clamp(a_len - 1, 0, NL - 1)) + k - 1
    b_end = _last(b_rp, torch.clamp(b_len - 1, 0, NL - 1)) + k - 1
    separated = (b_beg > a_end) | (a_beg > b_end)

    shp = a_beg.shape
    i = _full(shp, 0, a_rp)
    j = _full(shp, 0, a_rp)
    bd = _full(shp, INF, a_rp)
    bi = _full(shp, -1, a_rp)
    bj = _full(shp, -1, a_rp)
    done = _full(shp, False, a_rp, torch.bool)
    for _ in range(2 * NL):
        on = ~done & (i < a_len) & (j < b_len)
        ai_beg = _last(a_rp, torch.clamp(i, 0, NL - 1))
        ai_end = ai_beg + k - 1
        bj_beg = _last(b_rp, torch.clamp(j, 0, NL - 1))
        bj_end = bj_beg + k - 1
        c1 = on & (ai_end < bj_beg)
        d1 = bj_beg - ai_end
        imp1 = c1 & (d1 < bd)
        c2 = on & ~c1 & (bj_end < ai_beg)
        d2 = ai_beg - bj_end
        imp2 = c2 & (d2 < bd)
        ov = on & ~c1 & ~c2
        bd = torch.where(imp1, d1, torch.where(imp2, d2, bd))
        hit = imp1 | imp2 | ov
        bi = torch.where(hit, i, bi)
        bj = torch.where(hit, j, bj)
        i = torch.where(c1, i + 1, i)
        j = torch.where(c2, j + 1, j)
        done = done | ov | ~on
    bic = torch.clamp(bi, 0, NL - 1)
    bjc = torch.clamp(bj, 0, NL - 1)
    a_bp = _last(a_rp, bic)
    b_bp = _last(b_rp, bjc)
    common_bp = torch.maximum(a_bp, b_bp)
    a_ov = _last(a_qp, bic) + (common_bp - a_bp)
    b_ov = _last(b_qp, bjc) + (common_bp - b_bp)
    both_in = (a_ov < read_len) & (b_ov < read_len) & (bi >= 0)
    return torch.where(separated, a_beg < b_beg,
                       torch.where(both_in, a_ov >= b_ov, a_beg < b_beg))


def _is_left_chain_plain(rp4, qp4, clen4, lens4, pi, pj, *, k):
    """Whether each pair slot's forward-mate chain is the left one
    (the reference's call at circminer_tpu/ops/device_full.py:993): rp4,
    qp4 int32 [B, 4, KB1, NL] the chains' fragments, clen4 int32
    [B, 4, KB1] their lengths, lens4 int32 [B, 4] the reads', pi / pj
    int32 [B, 2, P] the slot's forward chain in row ``_mate_rows``'
    frows[o] and reverse chain in vrows[o]: the two chains gathered, then
    ``_is_left_chain``.  Returns bool [B, 2, P]."""
    NL = rp4.shape[3]
    frows, vrows = _mate_rows(pi.device)

    def chain(x, rows, idx):
        return _along(x[:, rows], idx, 2)
    read_len = lens4[:, frows][..., None].expand(pi.shape)
    return _is_left_chain(
        chain(rp4, frows, pi), chain(qp4, frows, pi),
        chain(clen4, frows, pi), chain(rp4, vrows, pj),
        chain(qp4, vrows, pj), chain(clen4, vrows, pj), read_len, NL, k)


SF_NAMES = ("r0", "q0", "lastq", "lastr", "remain_beg", "remain_end",
            "pos_l", "pos_r", "iv_l", "iv_r", "exon_len_l", "exon_len_r",
            "covered_l", "covered_r", "wxL", "wxR", "walkL_inb", "walkR_inb",
            "genL_inb", "genR_inb", "mid_dp", "clen")


SF_BOOL = ("covered_l", "covered_r", "wxL", "wxR", "walkL_inb",
           "walkR_inb", "genL_inb", "genR_inb")


SF_DP = [(side, var, f) for side in (0, 1) for var in (0, 1)
         for f in DP_KEYS]


SF_INT = tuple(n for n in SF_NAMES if n not in SF_BOOL)


MATE_INT = SF_INT + tuple(f"dp{side}{var}_{f}" for side, var, f in SF_DP) \
    + ("seq_len", "arow")


class PairGrid(NamedTuple):
    """``pair_grid``'s outputs over B reads, their 2 orientations, KB1
    chains a mate and P pair slots."""
    grid_b: torch.Tensor   # bool [3, B, 2, KB1, KB1]: same_tr, sgf, sgr
    tlen_g: torch.Tensor   # int32 [B, 2, KB1, KB1]
    valid: torch.Tensor    # bool [2, B, 2, KB1]: fvalid, rvalid
    slot_i: torch.Tensor   # int32 [4, B, 2, P]: pcell, p_tlen, p_fiv, p_riv
    # bool [5, B, 2, P]: pvalid, p_same_tr, p_sgf, p_sgr, fwd_left
    slot_b: torch.Tensor
    n_union: torch.Tensor  # int32 [B, 2]
    mate_i: torch.Tensor   # int32 [2, len(MATE_INT), B, 2, P]: l, r mate
    mate_b: torch.Tensor   # bool [2, len(SF_BOOL), B, 2, P]
    defer: torch.Tensor    # int32 [B]


def _pair_grid_plain(sf_i, sf_b, rp4, qp4, cn4, lens4, defer, iv_tids,
                     iv_ntid, iv_nseg_true, iv_nseg, seg_gene_p, gene_start,
                     gene_end, *, k, P, SEG_PAD):
    """The plain version of ``pair_grid``: the reference's grid, rank,
    ``grid_at``, ``side_fields``, ``_is_left_chain`` and ``sel``, then the
    outputs stacked as the kernel writes them."""
    B, _, KB1, _ = rp4.shape
    dev = rp4.device
    P_MAX = P
    NIV = iv_tids.shape[0]
    ad = SimpleNamespace(iv_nseg=iv_nseg)
    fa = SimpleNamespace(iv_tids=iv_tids, seg_gene_p=seg_gene_p,
                         gene_start=gene_start, gene_end=gene_end)

    def st(name):
        return sf_i[..., SF_INT.index(name)]
    frows, vrows = _mate_rows(dev)
    # grid tensors [B, 2, KB1, KB1] (i = fwd chain, j = rev chain)
    kb = torch.arange(KB1, device=dev)
    fvalid = kb[None, None, :, None] < cn4[:, frows][..., None, None]
    rvalid = kb[None, None, None, :] < cn4[:, vrows][..., None, None]
    grid = (B, 2, KB1, KB1)
    fs = st("r0")[:, frows][..., :, None].expand(grid)
    rs = st("r0")[:, vrows][..., None, :].expand(grid)
    fe = (st("lastr") + k)[:, frows][..., :, None].expand(grid)
    re_ = (st("lastr") + k)[:, vrows][..., None, :].expand(grid)
    tlen_g = torch.where(fs < rs, re_ - fs, fe - rs)
    f_iv = st("iv_l")[:, frows][..., :, None].expand(grid)
    r_iv = st("iv_l")[:, vrows][..., None, :].expand(grid)
    gv = fvalid & rvalid
    same_tr = gv & _tids_intersect(fa, f_iv, r_iv)
    sgf = gv & _same_gene_span(ad, fa, f_iv, rs, re_)
    sgr = gv & _same_gene_span(ad, fa, r_iv, fs, fe)
    union = gv & (same_tr | sgf | sgr | (tlen_g <= MAXDISCRDTLEN))
    # annotation padding overflows on pair-relevant intervals -> defer
    ST_PAD = iv_tids.shape[1]

    def pad_over(iv):
        c = torch.clamp(iv, 0, NIV - 1).long()
        return (iv >= 0) & ((iv_ntid[c] > ST_PAD)
                            | (iv_nseg_true[c] > SEG_PAD))
    over_anno = union & (pad_over(f_iv) | pad_over(r_iv))
    defer = defer | DEF_PANNO * over_anno.reshape(B, -1).any(dim=1).to(_i32)

    # rank union pairs in (i, j) row-major order -> P_MAX slots
    uflat = union.reshape(B, 2, KB1 * KB1)
    rank = torch.cumsum(uflat, dim=-1, dtype=_i32) - 1
    n_union = uflat.sum(dim=-1, dtype=_i32)                   # [B, 2]
    defer = defer | DEF_UNION * (n_union > P_MAX).any(dim=1).to(_i32)
    slot_of = torch.where(uflat & (rank < P_MAX), rank, P_MAX).long()
    # inverse: pair slot -> grid cell; discarded cells go to the sink slot
    # P_MAX, which is dropped
    cell_ids = torch.arange(KB1 * KB1, dtype=_i32, device=dev).expand(
        B, 2, KB1 * KB1)
    inv = torch.zeros((B, 2, P_MAX + 1), dtype=_i32, device=dev)
    inv[torch.arange(B, device=dev)[:, None, None],
        torch.arange(2, device=dev)[None, :, None], slot_of] = cell_ids
    pcell = inv[:, :, :P_MAX]                                 # [B, 2, P]
    pvalid = torch.arange(P_MAX, device=dev)[None, None, :] \
        < n_union[..., None]
    pi = pcell // KB1
    pj = pcell % KB1

    def grid_at(g):
        return torch.gather(g.reshape(B, 2, KB1 * KB1), -1, pcell.long())

    p_same_tr = grid_at(same_tr) & pvalid
    p_sgf = grid_at(sgf) & pvalid
    p_sgr = grid_at(sgr) & pvalid
    p_tlen = grid_at(tlen_g)
    p_fiv = grid_at(f_iv)
    p_riv = grid_at(r_iv)

    def side_fields(idx, rows):
        g = _along(sf_i[:, rows], idx, 2)                 # [B, 2, P, F]
        gb = _along(sf_b[:, rows], idx, 2)
        out = {name: g[..., fi] for fi, name in enumerate(MATE_INT[:-2])}
        out.update((name, gb[..., fi]) for fi, name in enumerate(SF_BOOL))
        out["seq_len"] = lens4[:, rows][..., None].expand(B, 2, P_MAX)
        # absolute seqs row of this mate (walk-engine query windows)
        out["arow"] = (torch.arange(B, dtype=_i32, device=dev)[:, None, None]
                       * 4 + rows.to(_i32)[None, :, None]).expand(
            B, 2, P_MAX)
        return out
    fm = side_fields(pi, frows)   # fwd mate  [B, 2, P]
    vm = side_fields(pj, vrows)   # rev mate

    # is_left_chain on the pair's chains (fwd vs rev), fwd read length
    fwd_left = _is_left_chain_plain(rp4, qp4, st("clen"), lens4, pi, pj, k=k)

    def sel(c, a, b):
        return {kk: torch.where(c, a[kk], b[kk]) for kk in a}

    lm_c = sel(fwd_left, fm, vm)   # l-mate chain bundle
    rm_c = sel(fwd_left, vm, fm)
    mates = (lm_c, rm_c)
    return PairGrid(
        torch.stack([same_tr, sgf, sgr]), tlen_g,
        torch.stack([fvalid[..., 0], rvalid[..., 0, :]]),
        torch.stack([pcell, p_tlen, p_fiv, p_riv]),
        torch.stack([pvalid, p_same_tr, p_sgf, p_sgr, fwd_left]), n_union,
        torch.stack([torch.stack([m[n] for n in MATE_INT]) for m in mates]),
        torch.stack([torch.stack([m[n] for n in SF_BOOL]) for m in mates]),
        defer)


WK_SCAN, WK_PMID, WK_PTRAIL, WK_PEND, WK_PENDND, WK_DONE = 0, 1, 2, 3, 4, 5


EV_KEYS = ("kind", "xpos", "aux", "ed", "indel", "sclen", "score")


EV_NF = len(EV_KEYS)       # aux: exlen (middle kinds) or covered (end kinds)


WS_KEYS = ("i_abs", "xpos", "exlen", "covered", "first", "stat", "pend_iv",
           "pend_xpos", "pend_exlen", "pend_cov", "pend_rr", "remref")


SLOT_KEYS = ("tstart", "toff", "tlen")


LANE_KEYS = ("is_left", "qlen", "pos")


STW = 8   # packed transcript lanes per walk; more common tids defer


MAP_NONE, MAP_OVER = -1, -2


class WalkInit(NamedTuple):
    """The walk's lanes and carried state (``walk_init``)."""
    inv: torch.Tensor       # int32 [WPP], pool lane -> flat [4N] slot
    n_act: torch.Tensor     # int32 0-d, live lanes
    over: torch.Tensor      # bool [4N], active past the WPP lanes
    act: torch.Tensor       # bool [STW, WPP], the packed common tids
    p_live: torch.Tensor    # bool [WPP]
    over_tid: torch.Tensor  # bool [WPP], more common tids than STW
    ws: torch.Tensor        # int32 [len(WS_KEYS), STW, WPP]
    slot: torch.Tensor      # int32 [len(SLOT_KEYS), STW, WPP]
    lane: torch.Tensor      # int32 [len(LANE_KEYS), WPP]
    prow: torch.Tensor      # int32 [len(PROW_KEYS), WPP]
    events: torch.Tensor    # int32 [STW, EW, EV_NF, WPP], zeros
    nev: torch.Tensor       # int32 [STW, WPP], zeros


class WalkPool(NamedTuple):
    """One wave's two DP pools (``walk_pool``): MID for the middle and
    trailing DPs (edit_end, tiny_dp), END for the end DPs (xdrop).  A pool
    row holds a leader, the first slot of a lane with its geometry; row j
    is the leader of rank j + 1 in slot-major flat order; rows past n
    gather flat STW * WPP - 1."""
    m_win: torch.Tensor     # int8 [2, MIDP, I - 1]: query, reference
    m_rows: torch.Tensor    # int32 [len(POOL_ROWS), MIDP]: remq, exlen, inv
    m_tiny: torch.Tensor    # bool [MIDP], the rows tiny_dp takes
    e_win: torch.Tensor     # int8 [2, ENDP, I - 1]: reference, query
    e_rows: torch.Tensor    # int32 [len(POOL_ROWS), ENDP]: rr, need, inv
    n: torch.Tensor         # int32 [2], live rows of MID and END
    maps: torch.Tensor      # int32 [2, STW, WPP], each lane's row or code


def _walk_init_plain(act4, pos4, len4, aiv4, row4, qs04, fiv, riv, iv_epos,
                     iv_tids, trans_start, t2s_off, *, left4, band, EW,
                     WPP):
    """The plain version of ``walk_init``: torch ops over every lane."""

    dev = act4.device
    N = fiv.shape[0]
    ST = iv_tids.shape[1]
    NIV = iv_epos.shape[0]
    NT = trans_start.shape[0]

    inv, n_act, over = _compact(act4.reshape(-1), WPP)   # pool -> flat4 idx
    inv_l = inv.long()

    def gp(x4):
        return x4.reshape(-1)[inv_l]                     # [WPP]

    p_pos, p_len, p_aiv = gp(pos4), gp(len4), gp(aiv4)
    p_row, p_qs0 = gp(row4), gp(qs04)
    fam = inv // N
    p_left = torch.zeros_like(fam, dtype=torch.bool)
    for f, left in enumerate(left4):
        if left:
            p_left |= fam == f
    p_live = torch.arange(WPP, dtype=_i32, device=dev) < n_act
    lane_n = (inv % N).long()                            # pair slot of lane
    p_fiv = fiv[lane_n]
    p_riv = riv[lane_n]

    # ---- per-tid init ([ST, WPP]) -------------------------------------
    fivc = torch.clamp(p_fiv, 0, NIV - 1).long()
    rivc = torch.clamp(p_riv, 0, NIV - 1).long()
    tids = iv_tids[fivc].T                               # [ST, WPP]
    tr = iv_tids[rivc].T
    memb = (tids[:, None, :] == tr[None, :, :]).any(dim=1)
    act = p_live[None, :] & (tids >= 0) & memb

    # ---- pack active tids to STW slots (order-preserving); lanes with
    # more common tids than STW defer ----------------------------------
    stw = min(ST, STW)
    rank1_t = torch.cumsum(act, dim=0, dtype=_i32)       # [ST, WPP]
    n_tid = rank1_t[-1]
    over_tid = p_live & (n_tid > stw)
    t_io_f = torch.arange(ST, dtype=_i32, device=dev)[:, None]
    pack = torch.stack(
        [torch.where(act & (rank1_t == j + 1), t_io_f, ST).amin(dim=0)
         for j in range(stw)], dim=0)                    # [STW, WPP]
    tids = torch.gather(tids, 0, torch.clamp(pack, 0, ST - 1).long())
    act = (pack < ST) & ~over_tid[None, :]

    tc = torch.clamp(tids, 0, NT - 1).long()
    tstart = trans_start[tc]
    toff = t2s_off[tc]
    tlen = t2s_off[tc + 1] - toff

    aivc = torch.clamp(p_aiv, 0, NIV - 1).long()
    anchor_rem = iv_epos[aivc] - p_pos                   # right-walk exon_len

    shp = act.shape
    is_left = p_left[None, :].expand(shp)
    zero = torch.zeros(shp, dtype=_i32, device=dev)
    st0 = dict(
        i_abs=torch.where(is_left, p_aiv[None, :], p_aiv[None, :] + 1),
        xpos=p_pos[None, :].expand(shp),
        exlen=torch.where(is_left, 0, anchor_rem[None, :].expand(shp)),
        covered=zero, first=is_left.to(_i32),           # left first_seg
        stat=torch.where(act, WK_SCAN, WK_DONE).to(_i32),
        remref=(p_len + band)[None, :].expand(shp))
    ws = torch.stack([st0.get(k, zero) for k in WS_KEYS])
    # events [ST, EW, EV_NF, WPP]; slot e = the lane's e-th emission
    return WalkInit(
        inv=inv, n_act=n_act, over=over, act=act, p_live=p_live,
        over_tid=over_tid, ws=ws, slot=torch.stack([tstart, toff, tlen]),
        lane=torch.stack([p_left.to(_i32), p_len, p_pos]),
        prow=torch.stack([p_row, p_qs0]),
        events=torch.zeros((stw, EW, EV_NF, WPP), dtype=_i32, device=dev),
        nev=zero.clone())


def _pool_map(lead, inv, n, over):
    """Each lane's code in a pool: its leader's pool row, MAP_OVER where
    the leader's rank passed the pool, MAP_NONE off the pool (what
    ``_scatter_pool`` and the gather by leader read: 0 then)."""
    ST, WPP = lead.shape
    rows = torch.arange(1, inv.shape[0] + 1, dtype=_i32, device=inv.device)
    row = _scatter_pool(rows, inv, n, ST * WPP).reshape(ST, WPP) - 1
    over2 = torch.gather(over.reshape(ST, WPP), 0, lead)
    return torch.where(over2, MAP_OVER, torch.gather(row, 0, lead))


def _walk_pool_plain(ws, lane, prow, seqsf, genome, *, L, band, MIDP, ENDP,
                     I=128):
    """The plain version of ``walk_pool``: torch ops over every slot."""

    _, ST, WPP = ws.shape
    dev = ws.device
    RL = seqsf.shape[0]
    stat, pend_xpos, pend_exlen, pend_cov, pend_rr = (
        ws[WS_KEYS.index(k)] for k in ("stat", "pend_xpos", "pend_exlen",
                                       "pend_cov", "pend_rr"))
    p_left, p_len = lane[0] != 0, lane[1]
    p_row, p_qs0 = prow.unbind(0)
    io = torch.arange(I - 1, dtype=_i32, device=dev)
    t_io = torch.arange(ST, dtype=_i32, device=dev)

    def dedup(mask, fields):
        """Lanes of one pair side with the same walk geometry: only the
        first (the leader) enters the pool; the others read its result."""
        eq = mask[:, None, :] & mask[None, :, :]
        for f in fields:
            eq = eq & (f[:, None, :] == f[None, :, :])
        lead = torch.where(eq, t_io[None, :, None], ST).amin(dim=1)
        lead = torch.where(mask, lead, t_io[:, None])
        return lead.long(), mask & (lead == t_io[:, None])

    # ---- middle / trailing DP pool (edit_end) ---------------------
    m_act = (stat == WK_PMID) | (stat == WK_PTRAIL)
    m_lead, m_uniq = dedup(m_act, (pend_xpos, pend_exlen, pend_cov))
    m_inv, m_n, m_over = _compact(m_uniq.reshape(-1), MIDP)
    m_inv_l = m_inv.long()
    lane_m = (m_inv % WPP).long()
    ml = p_left[lane_m]
    m_xpos = pend_xpos.reshape(-1)[m_inv_l]
    m_exlen = pend_exlen.reshape(-1)[m_inv_l]
    m_cov = pend_cov.reshape(-1)[m_inv_l]
    m_qlen = p_len[lane_m]
    m_remq = torch.minimum(m_exlen + band, m_qlen - m_cov)
    m_row = p_row[lane_m]
    m_qs0 = p_qs0[lane_m]
    # q window: right [qs0+cov, qs0+cov+remq) forward; left
    # [qs0+qlen-cov-remq, qs0+qlen-cov) reversed (extend.py:534-535)
    qi_f = m_row[:, None] * L + (m_qs0 + m_cov)[:, None] + io[None, :]
    qi_r = m_row[:, None] * L \
        + (m_qs0 + m_qlen - m_cov - m_remq)[:, None] \
        + (m_remq[:, None] - 1 - io[None, :])
    qi = torch.where(ml[:, None], qi_r, qi_f)
    q_win = torch.where(io[None, :] < m_remq[:, None],
                        seqsf[torch.clamp(qi, 0, RL - 1).long()], 127)
    r_f = _gather_window(genome, m_xpos, m_exlen, I - 1)
    r_r = _gather_window(genome, m_xpos - m_exlen - 1, m_exlen, I - 1,
                         reverse=True)
    r_win = torch.where(ml[:, None], r_r, r_f)
    # the rows the tiny DP takes (align.py:88-90)
    m_tiny = (m_remq <= 2 * band) | (m_exlen <= band)

    # ---- end DP pool (xdrop) ---------------------------------------
    e_act = stat == WK_PEND
    e_lead, e_uniq = dedup(e_act, (pend_xpos, pend_cov, pend_rr))
    e_inv, e_n, e_over = _compact(e_uniq.reshape(-1), ENDP)
    e_inv_l = e_inv.long()
    lane_e = (e_inv % WPP).long()
    el = p_left[lane_e]
    e_xpos = pend_xpos.reshape(-1)[e_inv_l]
    e_cov = pend_cov.reshape(-1)[e_inv_l]
    e_rr = pend_rr.reshape(-1)[e_inv_l]
    e_need = p_len[lane_e] - e_cov
    e_row = p_row[lane_e]
    e_qs0 = p_qs0[lane_e]
    # q: right [qs0+cov, qs0+cov+need) forward; left [qs0, qs0+need)
    # reversed (the host end DP uses qseq[:qseq_len - covered])
    eq_f = e_row[:, None] * L + (e_qs0 + e_cov)[:, None] + io[None, :]
    eq_r = e_row[:, None] * L + e_qs0[:, None] \
        + (e_need[:, None] - 1 - io[None, :])
    eqi = torch.where(el[:, None], eq_r, eq_f)
    t_q = torch.where(io[None, :] < e_need[:, None],
                      seqsf[torch.clamp(eqi, 0, RL - 1).long()], 127)
    er_f = _gather_window(genome, e_xpos, e_rr, I - 1)
    er_r = _gather_window(genome, e_xpos - e_rr - 1, e_rr, I - 1,
                          reverse=True)
    s_e = torch.where(el[:, None], er_r, er_f)
    return WalkPool(
        m_win=torch.stack([q_win, r_win]),
        m_rows=torch.stack([m_remq, m_exlen, m_inv]), m_tiny=m_tiny,
        e_win=torch.stack([s_e, t_q]),
        e_rows=torch.stack([e_rr, e_need, e_inv]),
        n=torch.stack([m_n, e_n]),
        maps=torch.stack([_pool_map(m_lead, m_inv, m_n, m_over),
                          _pool_map(e_lead, e_inv, e_n, e_over)]))


def _walk_scan_plain(ws, slot, lane, iv_spos, iv_epos, t2s_state, *, KSCAN,
                     G):
    """The plain version of ``walk_scan``: KSCAN steps as torch ops over
    the whole [STW, WPP] state."""
    (i_abs, xpos, exlen, covered, first, stat, pend_iv, pend_xpos,
     pend_exlen, pend_cov, pend_rr, remref) = ws.unbind(0)
    first = first != 0
    tstart, toff, tlen = slot.unbind(0)
    shp = i_abs.shape
    is_left = (lane[0] != 0)[None, :].expand(shp)
    qlen_b = lane[1][None, :].expand(shp)
    pos_b = lane[2][None, :].expand(shp)
    iend = tstart + tlen - 1                             # right scan end
    istop = tstart                                       # left scan floor
    NIV = iv_spos.shape[0]
    NS = t2s_state.shape[0]

    def t2s_at(iv_abs):
        row = iv_abs - tstart
        ok = (row >= 0) & (row < tlen)
        st = t2s_state[torch.clamp(toff + row, 0, NS - 1).long()]
        return torch.where(ok, st.to(_i32), 0)

    for _ in range(KSCAN):
        on = stat == WK_SCAN
        need = qlen_b - covered
        ivc = torch.clamp(i_abs, 0, NIV - 1).long()
        ivs = iv_spos[ivc]
        ive = iv_epos[ivc]
        ivl = ive - ivs + 1
        stt = t2s_at(i_abs)

        # LEFT accumulate (host order: accumulate, break, flush;
        # extend.py:497-510)
        l_on = on & is_left
        ended_l = l_on & (i_abs < istop)
        l_go = l_on & ~ended_l
        nz = l_go & (stt != 0)
        new_exlen = torch.where(nz & first, pos_b - ivs,
                                torch.where(nz & ~first, exlen + ivl,
                                            exlen))
        xpos = torch.where(nz & ~first & (exlen == 0), ive + 1, xpos)
        first = torch.where(nz, False, first)
        # RIGHT: the break check precedes the state read (:384-386)
        r_on = on & ~is_left
        ended_r = r_on & (i_abs > iend)
        r_go = r_on & ~ended_r
        brk_r = r_go & (exlen >= need)
        exlen = torch.where(l_go, new_exlen, exlen)
        brk_l = l_go & (exlen >= need)

        ended = ended_l | ended_r
        brk = brk_l | brk_r

        # terminal transitions (trailing / end / done)
        trail_geo = ended & (exlen > 0) & (exlen < need)
        t_inb = torch.where(is_left,
                            (xpos - exlen >= 1) & (xpos - 1 <= G),
                            (xpos + 1 >= 1) & (xpos + exlen <= G))
        to_trail = trail_geo & t_inb
        # ref-OOB trailing: the host middle fails -> no event
        end_geo = (ended | brk) & ~trail_geo & (covered < qlen_b) \
            & (exlen >= need)
        rr2 = torch.minimum(remref, exlen)
        # rr2 can go negative after several indel-bearing flushes
        # (extend.py:421/545): the host's genome.get(_, len < 0) gives
        # None -> no DP, but consec is set
        e_inb = (rr2 >= 0) & torch.where(
            is_left, (xpos - rr2 >= 1) & (xpos - 1 <= G),
            (xpos + 1 >= 1) & (xpos + rr2 <= G))
        to_end = end_geo & e_inb
        to_endnd = end_geo & ~e_inb      # consec candidate, no DP
        to_done = (ended | brk) & ~to_trail & ~to_end & ~to_endnd

        # in-loop state-1 flush
        go = (l_go | r_go) & ~brk
        flush = go & (stt == 1) & (exlen > 0)
        m_inb = torch.where(is_left,
                            (xpos - exlen >= 1) & (xpos - 1 <= G),
                            (xpos + 1 >= 1) & (xpos + exlen <= G))
        to_mid = flush & m_inb
        mid_oob = flush & ~m_inb         # host: the walk fails

        stat = torch.where(
            to_trail, WK_PTRAIL, torch.where(
                to_end, WK_PEND, torch.where(
                    to_endnd, WK_PENDND, torch.where(
                        to_mid, WK_PMID, torch.where(
                            to_done | mid_oob, WK_DONE, stat)))))
        moved = to_mid | to_trail | to_end | to_endnd
        pend_iv = torch.where(to_mid, i_abs, pend_iv)
        pend_xpos = torch.where(moved, xpos, pend_xpos)
        pend_exlen = torch.where(to_mid | to_trail, exlen, pend_exlen)
        pend_cov = torch.where(moved, covered, pend_cov)
        pend_rr = torch.where(to_end, rr2, pend_rr)

        # plain scan advance; a right empty flush sets rspos =
        # iv_spos - 1, then the state-1 interval accumulates
        # (extend.py:420-428)
        adv = go & (stt != 1)
        r_empty = go & ~is_left & (stt == 1) & (exlen == 0)
        l_empty = go & is_left & (stt == 1) & (exlen == 0)
        acc_r = (adv | r_empty) & ~is_left & (stt != 0)
        exlen = torch.where(acc_r, exlen + ivl, exlen)
        xpos = torch.where(r_empty, ivs - 1, xpos)
        step_f = (adv | r_empty) & ~is_left
        step_b = (adv | l_empty) & is_left
        i_abs = torch.where(step_f, i_abs + 1,
                            torch.where(step_b, i_abs - 1, i_abs))
    return torch.stack([i_abs, xpos, exlen, covered, first.to(_i32), stat,
                        pend_iv, pend_xpos, pend_exlen, pend_cov, pend_rr,
                        remref])


KEYS = ("pos", "ed", "sclen", "indel", "qcov", "score")


FOLD_OUT = KEYS + ("consec", "defer")
