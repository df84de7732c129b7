"""Operations and bytes of the port's hand-written kernels, counted from
their inputs: the yardstick of ``hand_kernels_roofline``.

A frozen copy of ``chip_smoke.py``'s counts (phase 7 and the kernel
phases), so that a later change to the smoke leaves the benchmark's
bounds as they are.  Each count is what the inputs need, whatever kernel
computes it: each input byte read once and each output byte written once,
and the int32 operations of the work the data asks for.  Where a count
depends on the data (a walk that ends early, a sort's live rows), it runs
a frozen copy of the port's plain torch version of the kernel
(``frozen.py``) on the inputs.

``bounds`` (the DP kernels, launched through ``_ext.launch``) and
``tensor_kernel_bound`` (the ``launch_tensors`` kernels) turn a count into
a bound in ms: bytes over HBM bandwidth against operations over the int32
ALU peak, whichever is longer.
"""

WALK_KERNELS = ("walk_fold", "tiny_dp", "walk_scan")


# the walk's lane set-up and wave body (csrc/walk_wave.cu)
WAVE_KERNELS = ("walk_init", "walk_pool", "walk_commit")


# the chain stage's two ends: the prelude's cells and the k-best extraction
END_KERNELS = ("chain_cells", "extract_kbest")


# phase 2's extend wrap-up and the same wrap-up on the leftover extends
EXTEND_KERNELS = ("extend_core", "extend_leftover")


# phase 2's per-read pair work: the grid, its slots, the chain order and
# the l/r-mate bundles
PAIR_KERNELS = ("pair_grid",)


DP_KERNELS = ("xdrop", "edit_sc", "edit_end", "one_side")


# H100 SXM peaks at 700 W (NVIDIA's data sheet): HBM3 bandwidth, and int32
# ALU throughput = 132 SMs x 64 INT32 lanes x the 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12


CLOCK_HZ = 1.98e9


INT32_OPS_PER_S = 132 * 64 * CLOCK_HZ


# int32 operations one DP cell needs at least: edit cells compare the bases,
# add the diagonal, take two mins and add the gap (5), edit_end tests the
# column (6), edit_sc packs and keeps its candidate key (12); an X-drop cell
# selects its substitution score, adds, takes two maxes and adds the gap
# (6), prunes (8) and keeps the running (value, i) max (9)
CELL_OPS = {"xdrop": 9, "edit_sc": 12, "edit_end": 6, "one_side": 5}
# dependent int32 operations per anti-diagonal (the next diagonal cannot
# start before they are done), each ~4 cycles of latency: the cell
# recurrence (add, min/max, add, min/max, the band mask) and, for X-drop and
# edit_sc, the diagonal's max that the next diagonal's prune or candidate
# test reads
CHAIN_OPS = {"xdrop": 12, "edit_sc": 12, "edit_end": 6, "one_side": 6}
CHAIN_CYCLES_PER_OP = 4


def xdrop_live(s, t, n, m, w, sm, I=128):
    """Per item, the in-band cells the X-drop DP visits and the diagonal it
    stops at (its dead band, or n + m): the band-local recurrence in numpy
    (window of w + 2 slots from lb - 1, as the kernel keeps it)."""
    import numpy as np
    B = s.shape[0]
    L = max(s.shape[1], 1)
    sc = np.where(s >= 4, 4, s).astype(np.int64)
    tc = np.where(t >= 4, 5, t).astype(np.int64)
    NEG = -10 ** 7
    W = min(w, 2 * I - 2) + 2
    q = np.arange(W)[None, :]
    wn, wm = np.minimum(n, w), np.minimum(m, w)
    kend = np.minimum(2 * I - 1, n + m)
    lb, ub = np.ones(B, np.int64), np.ones(B, np.int64)
    pre_ub, pre_opt, cur_opt = (np.zeros(B, np.int64) for _ in range(3))
    alive = (n > 0) & (m > 0)
    cells, stop = np.zeros(B, np.int64), np.where(alive, kend, 0)
    a = lb - 1
    P = np.where((q <= 1) & (q <= wn[:, None]) & (1 - q <= wm[:, None]),
                 sm.ind, NEG)
    PP = np.where(q == 0, 0, NEG).repeat(B, axis=0)
    rows = np.arange(B)[:, None]
    for k in range(2, int(kend.max(initial=1)) + 1):
        act = alive & (k <= kend)
        if not act.any():
            break
        p = a[:, None] + q
        j = k - p
        sv = sc[rows, np.clip(p - 1, 0, L - 1)] if s.shape[1] else 0
        tv = tc[rows, np.clip(j - 1, 0, L - 1)] if s.shape[1] else 0
        PPm = np.concatenate([np.full((B, 1), NEG), PP[:, :-1]], axis=1)
        Pm = np.concatenate([np.full((B, 1), NEG), P[:, :-1]], axis=1)
        v = np.maximum(PPm + np.where(sv != tv, sm.mis, sm.mat),
                       np.maximum(Pm, P) + sm.ind)
        band = (p >= np.maximum(lb, k - m)[:, None]) & (p <= np.minimum(
            np.minimum(ub, k - 1), np.minimum(n, I - 1))[:, None])
        N = np.where((j == 0) & (p <= wn[:, None]), sm.ind * p, NEG)
        N = np.where((p == 0) & (j >= 0) & (j <= wm[:, None]), sm.ind * j, N)
        pruned = np.where(v + sm.xd < pre_opt[:, None], NEG, v)
        N = np.where(band, pruned, N)
        cells += np.where(act, band.sum(axis=1), 0)
        vmax = np.where(band, v, NEG).max(axis=1)
        cur_opt = np.where(act & (vmax >= cur_opt), vmax, cur_opt)
        new_ub = np.where(band & (pruned > NEG), p, -1).max(axis=1)
        odd = (k - w) % 2 == 1 if k > w else False
        lb2 = np.where((k - lb == m) | (k > w and not odd), lb + 1, lb)
        ub2 = np.where((ub < n) & (k <= w or odd), ub + 1, ub)
        dead = ((pre_ub == -1) & (new_ub == -1)) | (lb2 > ub2)
        pre_ub = np.where(act, new_ub, pre_ub)
        pre_opt = np.where(act, np.maximum(pre_opt, cur_opt), pre_opt)
        delta = np.where(act, lb2 - lb, 0)[:, None] == 1
        lb, ub = np.where(act, lb2, lb), np.where(act, ub2, ub)
        stop = np.where(act & dead, k, stop)
        alive = alive & ~(act & dead)
        shift = (lambda x: np.where(delta, np.concatenate(
            [x[:, 1:], np.full((B, 1), NEG)], axis=1), x))
        PP, P = shift(P), shift(N)
        a = a + delta[:, 0]
    return cells, stop


def work(name, s, t, n, m, wv, w, sm):
    """(DP cells these inputs need, diagonals of the longest item)."""
    import numpy as np
    if name == "xdrop":
        cells, stop = xdrop_live(s, t, n, m, w, sm)
        return int(cells.sum()), int(stop.max(initial=0))
    i = np.arange(128)[None, :]     # cells (i, j), i <= n, j <= m, in band
    if name == "one_side":
        lo, hi = i, np.minimum(i + wv[:, None], m[:, None])
    else:
        lo, hi = np.maximum(0, i - w), np.minimum(i + w, m[:, None])
    per_row = np.where(i <= n[:, None], np.maximum(0, hi - lo + 1), 0)
    return int(per_row.sum()), int(np.minimum(255, n + m).max(initial=0))


def bounds(name, B, L, ncols, cells, diags):
    """(bound ms, what sets it, chain floor ms): bytes each input read once
    and each output written once over HBM bandwidth, against the cells'
    int32 operations over the ALU peak; the floor is the longest item's
    diagonals times one diagonal's dependent chain."""
    nbytes = B * (2 * L + 4 * 2 + 4 * ncols) + (4 * B if name == "one_side"
                                                else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = cells * CELL_OPS[name] / INT32_OPS_PER_S * 1e3
    floor = diags * CHAIN_OPS[name] * CHAIN_CYCLES_PER_OP / CLOCK_HZ * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", floor)


# a floor of the fold's int32 operations per (read, pair step): its masks
# and selects (~40) and the gates of its eight guarded updates (~60)
FOLD_STEP_OPS = 100


def chain_dp_work(posf, qposf, validf, ub, mee, e1, ol_iv, iv_nseg, seg_end,
                  seg_next, *, NL, S, k, max_ed, max_intron, **_):
    """int32 operations the chain DP needs on these inputs, counted as the
    kernel does its work: 2 per cell for its list's first maximum (compare
    and select), 3 per invalid source cell (its candidate from the later
    lists' maximum: add, compare, select); per valid source cell and later
    list 2 per target for the maxIntron minimum, then 3 where that gate is
    closed (the list's maximum) or else 8 per target (the candidate's add,
    compare and select, the base gates), 8 per target past the base gates
    (the gap distance and gate) and 6 per junction segment scanned (those
    with pv_e, up to the first that accepts, where the gap gate failed and
    pjv > e1)."""
    import torch
    from .frozen import _junction_tables
    sep_c, snp_c, pv_c = _junction_tables(ol_iv, iv_nseg, seg_end, seg_next,
                                          seg_end.shape[1])
    b, P = posf.shape[0], sep_c.shape[1]
    pos_T, v_T, ub_T, mee_T, e1_T = posf.T, validf.T, ub.T, mee.T, e1.T
    src = slice(0, (NL - 1) * S)
    ops = 2 * b * NL * S + 3 * int((~v_T[src]).sum())
    for l in range(NL - 1):
        sl = slice(l * S, (l + 1) * S)
        pi, v_l = pos_T[sl][:, None, :], v_T[sl][:, None, :]
        ub_l, mee_l, e1_l = (x[sl][:, None, :] for x in (ub_T, mee_T, e1_T))
        for j in range(l + 1, NL):
            pjv = pos_T[j * S:(j + 1) * S][None]
            rd = qposf[:, j * S] - qposf[:, l * S] - k
            minpos = torch.where(pjv > pi, pjv, 2 ** 31 - 1).amin(
                dim=1, keepdim=True)
            gate = v_l & (minpos <= pi + max_intron)
            ops += 2 * S * int(v_l.sum()) + 3 * int((v_l & ~gate).sum()) \
                + 8 * S * int(gate.sum())
            base = (gate & v_T[j * S:(j + 1) * S][None] & (pjv > pi)
                    & (pjv <= ub_l))
            gd = pjv - pi - k
            g_ok = ((mee_l == 0) | ((pjv + k - 1) <= mee_l)) \
                & ((gd - rd).abs() <= max_ed)
            need = base & ~g_ok & (pjv > e1_l)
            ops += 8 * int(base.sum())
            for p in range(P):
                e12 = sep_c[sl, p:p + 1] - e1_l
                beg = pjv - snp_c[sl, p:p + 1]
                take = need & pv_c[sl, p:p + 1] & (e12 >= 0)
                ops += 6 * int(take.sum())
                need = need & ~(take & (beg >= 0)
                                & ((e12 + beg - rd).abs() <= max_ed))
    return ops


def chain_dp_bytes(posf, qposf, validf, ub, mee, e1, ol_iv, iv_nseg,
                   seg_end, seg_next, *, NL, S, **_):
    """Bytes the chain DP must move on these inputs, each read once: the
    position and valid bit of every cell, one query offset per list and
    the two int32 outputs; for a valid source cell (lists 0 .. NL-2) its
    three bounds and its interval; and for each interval that such a cell
    reads, its segment count, the segment ends below the count and the
    next-exon starts where some reading cell has e12end = sep - e1 >= 0.
    Nothing else enters the result."""
    import torch
    b, M = posf.shape
    P = seg_end.shape[1]
    vs = validf[:, :(NL - 1) * S]
    cell_iv = ol_iv[:, :(NL - 1) * S][vs]
    cell_e1 = e1[:, :(NL - 1) * S][vs]
    has = cell_iv >= 0
    iv, e1v = cell_iv[has].long(), cell_e1[has]
    pv = torch.arange(P, device=posf.device)[None, :] < iv_nseg[iv][:, None]
    e_ok = pv & (seg_end[iv] - e1v[:, None] >= 0)
    need = torch.zeros((seg_end.shape[0], P, 2), dtype=torch.int32,
                       device=posf.device)
    need[:, :, 0].index_put_((iv,), pv.to(torch.int32), accumulate=True)
    need[:, :, 1].index_put_((iv,), e_ok.to(torch.int32), accumulate=True)
    return (b * M * (4 + 1) + b * NL * 4 + 2 * b * M * 4
            + int(vs.sum()) * 4 * 4 + 4 * int(torch.unique(iv).numel())
            + 4 * int((need > 0).sum()))


# floors of the walk kernels' int32 operations: per event the fold reads
# (its kind tests, two bound tests with their sums, the candidate's five
# sums and the update rule's compares and selects), per DP cell of the
# tiny DP (the mismatch test, three sums, two minima, the column mask),
# and per scan step (two gathers' clamps, the accumulate, the break, the
# five window tests, the status chain and the advance)
FOLD_EVENT_OPS = 30


TINY_CELL_OPS = 8


SCAN_STEP_OPS = 60


def walk_work(name, args, kw):
    """(bytes, int32 ops) that a walk kernel needs on these inputs, each
    input read once and each output written once.  walk_fold: every pool
    row's inv and n_act, then for each live lane of the family its scalars
    and the events of its active transcripts; tiny_dp: every row's tiny
    bit and answer; a fallback row's lengths and the bases and cells
    inside them, another row's banded answer; walk_scan: the state in and
    out,
    the constants, the annotation's tables, and the steps taken while a
    slot scans (counted by running the plain version one step at a
    time)."""
    import torch
    from . import frozen as dw
    if name == "walk_fold":
        (events, act, inv, n_act, p_live, _, _, _, ed_th, _) = args
        N = ed_th.shape[0]
        ST, WPP = act.shape
        EW = events.shape[0] // ST
        rows = torch.arange(WPP, device=inv.device) < n_act
        mine = rows & (inv // N == kw["fam"]) & p_live
        n_ev = EW * int((act & mine[None, :]).sum())
        nbytes = WPP * 4 + 4 + int(mine.sum()) * (18 + ST) \
            + n_ev * dw.EV_NF * 4 + len(dw.FOLD_OUT) * N * 4
        return nbytes, n_ev * FOLD_EVENT_OPS
    if name == "tiny_dp":
        s, t, n, m, tiny, banded = args
        nn = torch.clamp(n[tiny], 0, kw["NM"])
        mm = torch.clamp(m[tiny], 0, kw["MM"])
        B, nf = s.shape[0], int(tiny.sum())
        word = 4 * (2 if kw["end"] else 1)
        nbytes = B + B * word + (B - nf) * word + nf * 8 \
            + int(nn.sum()) + int(mm.sum())
        return nbytes, TINY_CELL_OPS * int((nn.long() * mm.long()).sum())
    ws, slot, lane, iv_spos, iv_epos, t2s = args
    steps, cur = 0, ws
    for _ in range(kw["KSCAN"]):
        steps += int((cur[dw.WS_KEYS.index("stat")] == dw.WK_SCAN).sum())
        cur = dw._walk_scan_plain(cur, *args[1:], KSCAN=1, G=kw["G"])
    nbytes = 2 * ws.numel() * 4 + slot.numel() * 4 + lane.numel() * 4 \
        + 2 * iv_spos.numel() * 4 + t2s.numel()
    return nbytes, steps * SCAN_STEP_OPS


# floors of the extend kernels' int32 operations: per extend of a slot
# (extend_one's compares, selects and wrapped sums)
EXT_EXTEND_OPS = 60


def extend_work(name, args, kw):
    """(bytes, int32 ops) that an extend kernel needs on these inputs, each
    input the kernel reads read once and each output written once.
    extend_core: every slot's scalars, flags and genomic DP, wx's walk
    flag, the walk DP where it can be taken and the fold's eight rows and
    overflow bit where the lane is active; its four outputs.
    extend_leftover: per chain both sides' position, length, flag and
    genomic DP, est_mid, and both sides' outputs."""
    import torch
    if name == "extend_core":
        (pos, _, _, _, has_tids, _, _, covered, wx, walk_inb, gen_inb,
         *rest) = args
        act = rest[10][kw["fam"]]
        n = pos.numel()
        walk_ok = covered & torch.where(wx, walk_inb, gen_inb)
        n_wdp = int((wx & walk_ok & has_tids).sum())
        n_act = int(act.sum())
        nbytes = n * (6 * 4 + 5 + 4 * 4) + int(wx.sum()) + n_wdp * 16 \
            + n_act * (8 * 4 + 1) + n * (1 + 4 + 6 * 4 + 1)
        return nbytes, n * EXT_EXTEND_OPS
    n = args[2].numel()
    return n * (5 * 4 + 2 + 2 * 4 * 4 + 2 * (1 + 4 + 6 * 4)), \
        2 * n * EXT_EXTEND_OPS


# floors of pair_grid's int32 operations: per grid cell (validity, tlen,
# union, the rank's share), per tid compare and per segment of the
# gene-span tests, per slot (its fields, the walk's ends and overlap), per
# step of the merge walk, per bundle field written
PG_CELL_OPS = 20


PG_TID_OPS = 2


PG_GENE_OPS = 4


PG_SLOT_OPS = 30


PG_STEP_OPS = 10


PG_FIELD_OPS = 2


def pair_walks(rp4, clen4, pcell, *, k):
    """Replay ``_is_left_chain``'s merge walk on every slot of these
    inputs as ``pair_grid``'s kernel runs it (a separated pair reads only
    its chains' ends): per slot its forward and reverse chain's flat index
    into [B * 4 * KB1], whether they are separated, the furthest fragment
    each walk reads, the overlap's fragments (bi, bj) and the walk's steps,
    each [B * 2 * P]."""
    import torch
    from .frozen import INF
    dev = pcell.device
    B, _, KB1, NL = rp4.shape
    P = pcell.shape[2]
    n = pcell.numel()
    b = torch.arange(B, device=dev).view(B, 1, 1)
    o = torch.arange(2, device=dev).view(1, 2, 1)
    pi, pj = (pcell // KB1).reshape(-1), (pcell % KB1).reshape(-1)
    ca = ((b * 4 + 2 * o) * KB1).expand(B, 2, P).reshape(-1) + pi
    cb = ((b * 4 + 3 - 2 * o) * KB1).expand(B, 2, P).reshape(-1) + pj
    pos, clen = rp4.reshape(-1, NL), clen4.reshape(-1)
    A, Bf, alen, blen = pos[ca], pos[cb], clen[ca], clen[cb]

    def at(x, idx):
        return x.gather(1, idx.clamp(0, NL - 1).long()[:, None])[:, 0]
    km1 = k - 1
    a_end, b_end = at(A, alen - 1) + km1, at(Bf, blen - 1) + km1
    apart = (Bf[:, 0] > a_end) | (A[:, 0] > b_end)
    i, j, reach_a, reach_b, steps = (
        torch.zeros(n, dtype=torch.int32, device=dev) for _ in range(5))
    bd = torch.full((n,), INF, dtype=torch.int32, device=dev)
    bi, bj = (torch.full((n,), -1, dtype=torch.int32, device=dev)
              for _ in range(2))
    go = ~apart
    for _ in range(2 * NL):
        go &= (i < alen) & (j < blen)
        ai, bjv = at(A, i), at(Bf, j)
        reach_a = torch.where(go, torch.maximum(reach_a, i), reach_a)
        reach_b = torch.where(go, torch.maximum(reach_b, j), reach_b)
        steps += go.int()
        a_first = ai + km1 < bjv
        b_first = ~a_first & (bjv + km1 < ai)
        d = torch.where(a_first, bjv - (ai + km1), ai - (bjv + km1))
        take = go & (((a_first | b_first) & (d < bd)) | ~(a_first | b_first))
        bd = torch.where(go & (a_first | b_first) & (d < bd), d, bd)
        bi, bj = torch.where(take, i, bi), torch.where(take, j, bj)
        i, j = i + (go & a_first), j + (go & b_first)
        go &= a_first | b_first
    return ca, cb, apart, reach_a, reach_b, bi, bj, steps


def pair_grid_bytes(sf_i, sf_b, rp4, qp4, cn4, lens4, defer, iv_tids,
                    iv_ntid, iv_nseg_true, iv_nseg, seg_gene_p, gene_start,
                    gene_end, *, k, P, SEG_PAD):
    """The bytes ``pair_grid`` needs on these inputs, each read once and
    each output written once: every field and flag of the chains that
    some slot takes (a bundle's fields), r0 and lastr of every other chain
    (the grid's tlen), iv_l of every other valid chain; of each slot
    chain its first and last position and, where its pair is not
    separated, the positions the merge walk reaches and the overlap's
    query offset (``pair_walks``); cn4, lens4 and defer; each distinct
    interval of a valid chain on an interval, its tid list, counts and
    segment genes, and each distinct gene those name; every output."""
    import torch
    from . import frozen as df
    B, _, KB1, NL = rp4.shape
    NI, NB = sf_i.shape[3], sf_b.shape[3]
    NIV, ST = iv_tids.shape
    SP, NG = seg_gene_p.shape[1], gene_start.shape[0]
    pcell = df._pair_grid_plain(
        sf_i, sf_b, rp4, qp4, cn4, lens4, defer, iv_tids, iv_ntid,
        iv_nseg_true, iv_nseg, seg_gene_p, gene_start, gene_end, k=k, P=P,
        SEG_PAD=SEG_PAD).slot_i[0]
    ca, cb, apart, reach_a, reach_b, bi, bj, _ = pair_walks(
        rp4, sf_i[..., df.SF_INT.index("clen")], pcell, k=k)
    n_ch = B * 4 * KB1
    used = torch.zeros(n_ch, dtype=torch.bool, device=rp4.device)
    used[ca], used[cb] = True, True
    valid = (torch.arange(KB1, device=rp4.device)[None, None, :]
             < cn4[:, :, None]).reshape(-1)
    iv = sf_i[..., df.SF_INT.index("iv_l")].reshape(-1)
    n_used = int(used.sum())
    sf_bytes = n_used * (4 * NI + NB) + (n_ch - n_used) * 8 \
        + int((valid & ~used).sum()) * 4
    # the walks' positions (each distinct chain's first to its furthest
    # reach, and its last) and the overlaps' query offsets
    clen = sf_i[..., df.SF_INT.index("clen")].reshape(-1)
    last = (clen - 1).clamp(0, NL - 1)
    reach = torch.zeros(n_ch, dtype=torch.int32, device=rp4.device)
    near = ~apart
    for c, r in ((ca, reach_a), (cb, reach_b)):
        reach.scatter_reduce_(0, c[near], r[near], "amax")
    n_pos = int(((reach + 1 + (last > reach)) * used).sum())
    offs = torch.cat([ca[near] * NL + bi[near].clamp(0, NL - 1),
                      cb[near] * NL + bj[near].clamp(0, NL - 1)])
    n_q = int(torch.unique(offs).numel())
    # the annotation rows of valid chains on intervals, and their genes
    ivs = torch.unique(iv[valid & (iv >= 0)].clamp(0, NIV - 1))
    g = seg_gene_p[ivs.long()]
    named = (torch.arange(SP, device=g.device)[None, :]
             < iv_nseg[ivs.long()][:, None]) & (g >= 0)
    n_gene = int(torch.unique(g[named].clamp(0, NG - 1)).numel())
    anno = ivs.numel() * (4 * ST + 12 + 4 * SP) + n_gene * 8
    KK, S = KB1 * KB1, B * 2 * P
    outs = B * 2 * KK * (3 + 4) + B * 2 * KB1 * 2 + S * (4 * 4 + 5) \
        + B * 2 * 4 + 2 * S * (4 * len(df.MATE_INT) + NB) + B * 4
    return sf_bytes + 4 * (n_pos + n_q) + B * (16 + 16 + 4) + anno + outs


def pair_grid_work(sf_i, sf_b, rp4, qp4, cn4, lens4, defer, iv_tids,
                   iv_ntid, iv_nseg_true, iv_nseg, seg_gene_p, gene_start,
                   gene_end, *, k, P, SEG_PAD):
    """int32 operations ``pair_grid`` needs on these inputs: per cell
    PG_CELL_OPS; per valid cell of two chains on intervals the reference's
    ST^2 tid compares, per valid cell side on an interval its SP segment
    tests; per slot PG_SLOT_OPS and PG_STEP_OPS a step of its merge walk;
    per bundle field PG_FIELD_OPS."""
    import torch
    from . import frozen as df
    B, _, KB1, NL = rp4.shape
    ST, SP = iv_tids.shape[1], seg_gene_p.shape[1]
    kb = torch.arange(KB1, device=rp4.device)
    rows = torch.tensor([[0, 3], [2, 1]], device=rp4.device)  # (fr, vr)
    cn = cn4[:, rows]                                     # [B, 2, 2]
    iv = sf_i[..., df.SF_INT.index("iv_l")][:, rows]      # [B, 2, 2, KB1]
    on = (kb < cn[..., None]) & (iv >= 0)
    ok = (kb < cn[..., None])
    f_on, v_on = on[:, :, 0, :, None], on[:, :, 1, None, :]
    gv = ok[:, :, 0, :, None] & ok[:, :, 1, None, :]
    n_tid = int((gv & f_on & v_on).sum())
    n_gene = int((gv & f_on).sum() + (gv & v_on).sum())
    pcell = df._pair_grid_plain(
        sf_i, sf_b, rp4, qp4, cn4, lens4, defer, iv_tids, iv_ntid,
        iv_nseg_true, iv_nseg, seg_gene_p, gene_start, gene_end, k=k, P=P,
        SEG_PAD=SEG_PAD).slot_i[0]
    steps = pair_walks(rp4, sf_i[..., df.SF_INT.index("clen")], pcell,
                       k=k)[-1]
    S = B * 2 * P
    return (B * 2 * KB1 * KB1 * PG_CELL_OPS + n_tid * ST * ST * PG_TID_OPS
            + n_gene * SP * PG_GENE_OPS + S * PG_SLOT_OPS
            + int(steps.sum()) * PG_STEP_OPS
            + 2 * S * (len(df.MATE_INT) + len(df.SF_BOOL)) * PG_FIELD_OPS)


# floors of the wave kernels' int32 operations: per flag of a compaction
# (its test, count and rank), per compare of a lane's common-tid membership
# (ST x ST a lane) and per word a lane's set-up writes; per (slot, lane)
# the status tests (walk_pool's two pool tests, walk_commit's kind tests);
# per compare of the pools' dedup (a pending slot against each earlier
# pending slot of its lane in its pool) and per window byte; per pending
# (slot, lane) of the commit (the _drop_wrap sums and selects, the event
# and the commit's updates)
WAVE_FLAG_OPS = 4


WAVE_MEMB_OPS = 2


WAVE_TEST_OPS = 4


WAVE_DEDUP_OPS = 4


WAVE_BYTE_OPS = 4


WAVE_COMMIT_OPS = 40


def wave_work(name, args, kw):
    """(bytes, int32 ops) that a wave kernel needs on these inputs: each
    input word that its function reads counted once, each output written
    once (the plain version's outputs give the sizes and the sets that
    depend on the data).  walk_init: the [4N] flags; of each distinct flat
    slot a lane gathers, its five table words; of each distinct pair, its
    two anchors; of each distinct anchor interval, its tid list; of each
    distinct anchor interval of a lane, its end; of each distinct (tstart,
    toff, tlen) a slot takes, three transcript words.  walk_pool: every
    slot's status; the three geometry fields of each slot in a pool (a
    row's leader reads its own again) and of flat S - 1 where dead rows
    gather it; the four lane words of each distinct lane a pool row
    gathers; the window bytes inside each distinct gathered row's
    lengths.  walk_commit: the state; the MID map where the status pends
    a middle or trailing DP, the END map where it pends an end DP; the
    side of each lane that reads an end DP or commits a middle one; of
    each distinct pool row read, its (ed, indel), or its (score, on_s,
    on_t) and need; of each distinct interval a right middle commit
    reads, its start and end; the count, the new count and the event of
    each slot that emits."""
    import torch
    from . import frozen as dw

    def distinct(x):
        return int(torch.unique(x).numel())

    def out_bytes(tensors):
        return sum(x.numel() * x.element_size() for x in tensors)
    if name == "walk_init":
        act4, aiv4, fiv, riv, iv_tids = (args[0], args[3], args[6],
                                         args[7], args[9])
        N, (NIV, ST) = fiv.shape[0], iv_tids.shape
        out = dw._walk_init_plain(*args, **kw)
        flat = torch.unique(out.inv.long())
        pairs = torch.unique(flat % N)
        ivs = distinct(torch.cat([fiv[pairs], riv[pairs]]).clamp(0, NIV - 1))
        aivs = distinct(aiv4.reshape(-1)[flat].clamp(0, NIV - 1))
        trans = torch.unique(out.slot.reshape(len(dw.SLOT_KEYS), -1),
                             dim=1).shape[1]
        nbytes = act4.numel() + flat.numel() * 5 * 4 \
            + pairs.numel() * 2 * 4 + ivs * ST * 4 + aivs * 4 \
            + trans * 3 * 4 + out_bytes(out)
        ops = act4.numel() * WAVE_FLAG_OPS \
            + int(out.n_act) * ST * ST * WAVE_MEMB_OPS \
            + out.nev.numel() * (len(dw.WS_KEYS) + 10)
        return nbytes, ops
    ws = args[0]
    _, STW_, WPP = ws.shape
    S = STW_ * WPP
    stat = ws[dw.WS_KEYS.index("stat")]
    m_in = (stat == dw.WK_PMID) | (stat == dw.WK_PTRAIL)
    e_in = stat == dw.WK_PEND
    if name == "walk_pool":
        out = dw._walk_pool_plain(*args, **kw)
        W = out.m_win.shape[2]
        inside, flats, dead = 0, [], False
        for rows, n in ((out.m_rows, out.n[0]), (out.e_rows, out.n[1])):
            P = rows.shape[1]
            # the live rows' leaders, and row n once for the dead rows
            keep = torch.arange(P, device=ws.device) <= n
            inside += int((torch.clamp(rows[:2], 0, W) * keep).sum())
            flats.append(rows[2][keep])
            dead |= int(n) < P
        pending = (m_in | e_in).reshape(-1)
        geometry = int(pending.sum()) + int(dead and not bool(pending[-1]))
        lanes = distinct(torch.cat(flats) % WPP)
        nbytes = S * 4 + geometry * 3 * 4 + lanes * 4 * 4 + inside \
            + out_bytes(out)
        earlier = 0
        for m in (m_in.int(), e_in.int()):
            earlier += int(((torch.cumsum(m, 0) - m) * m).sum())
        ops = S * WAVE_TEST_OPS + earlier * WAVE_DEDUP_OPS \
            + (out.m_win.numel() + out.e_win.numel()) * WAVE_BYTE_OPS
        return nbytes, ops
    maps, lane, iv_spos = args[1], args[5], args[6]
    m_map, e_map = maps.unbind(0)
    pendnd = stat == dw.WK_PENDND
    mid = (stat == dw.WK_PMID) & (m_map != dw.MAP_OVER)
    emit = (m_in & (m_map != dw.MAP_OVER)) | (e_in & (e_map != dw.MAP_OVER)) \
        | pendnd
    left = lane[dw.LANE_KEYS.index("is_left")] != 0
    sided = int(((e_in & (e_map >= 0)) | mid).any(0).sum())
    pend_iv = ws[dw.WS_KEYS.index("pend_iv")]
    ivs = distinct(pend_iv[mid & ~left[None, :]].clamp(
        0, iv_spos.shape[0] - 1))
    nbytes = 2 * ws.numel() * 4 + int((m_in | e_in).sum()) * 4 + sided * 4 \
        + distinct(m_map[m_in & (m_map >= 0)]) * 2 * 4 \
        + distinct(e_map[e_in & (e_map >= 0)]) * 4 * 4 + ivs * 2 * 4 \
        + int(emit.sum()) * (dw.EV_NF + 2) * 4
    ops = S * WAVE_TEST_OPS \
        + int((m_in | e_in | pendnd).sum()) * WAVE_COMMIT_OPS
    return nbytes, ops


# floors of the chain ends' int32 operations: per cell of chain_cells (its
# valid bit, the bit lookup, the bounds' sums, minima and selects), per
# bisect step (the load's compare and the halving) and per segment scanned
# (a compare, three selects); per cell of extract_kbest (its event test and
# key), per compare of a comparison sort of a row's M keys, per walked
# fragment (two loads, the back-pointer test), per repeat test of the
# emission (a fragment's length and position compares), per output word
CC_CELL_OPS = 40


CC_BISECT_OPS = 3


CC_SEGMENT_OPS = 4


EX_CELL_OPS = 6


EX_SORT_OPS = 2


EX_FRAGMENT_OPS = 6


EX_REPEAT_OPS = 4


def chain_cells_work(pos, cnt, qpos, seq_len, nb_bits, iv_spos, iv_epos,
                     iv_max_end, iv_min_end, iv_max_next, iv_nseg, seg_end,
                     seg_next, *, seg_pad, k, **_):
    """(bytes, int32 ops) that chain_cells needs on these inputs: each
    cell's position in and six words out (validf a byte), the per-list
    count and query offset, each read length; the bitmap bytes, the
    intervals (six words: the cell's and the next one's start) and the
    segments (of intervals whose k-mer crosses the end) that some cell
    reads, each once; the operations per cell, per bisect step taken
    (counted by running the bisect on these positions) and per segment
    scanned."""
    import torch
    B, NL, S = pos.shape
    n_iv = iv_spos.shape[0]
    p = pos.reshape(-1).long()
    pb = torch.clamp(p, 0, nb_bits.numel() * 8 - 1) >> 3
    lo = torch.zeros_like(p)
    hi = torch.full_like(p, n_iv)
    steps = 0
    while bool((lo < hi).any()):
        act = lo < hi
        steps += int(act.sum())
        mid = (lo + hi) >> 1
        right = iv_spos[torch.clamp(mid, 0, n_iv - 1)].long() <= p
        lo = torch.where(act & right, mid + 1, lo)
        hi = torch.where(act & ~right, mid, hi)
    iv = torch.clamp(lo - 1, min=0)
    ivs = torch.unique(torch.cat([iv, lo[lo < n_iv]]))
    cross = ((p + k - 1) > iv_epos[iv].long())
    nseg = torch.clamp(iv_nseg[iv].long(), 0, seg_pad)
    seg_ivs = torch.unique(iv[cross])
    seg_words = int(torch.clamp(iv_nseg[seg_ivs].long(), 0, seg_pad).sum())
    cells = B * NL * S
    nbytes = cells * (4 + 5 * 4 + 1) + B * NL * 8 + B * 4 \
        + int(torch.unique(pb).numel()) + 6 * 4 * int(ivs.numel()) \
        + 2 * 4 * seg_words
    ops = cells * CC_CELL_OPS + steps * CC_BISECT_OPS \
        + int(nseg[cross].sum()) * CC_SEGMENT_OPS
    return nbytes, ops


def extract_kbest_work(dp10, back, pos, qpos, cnt, *, C, iters, **_):
    """(bytes, int32 ops) that extract_kbest needs on these inputs: each
    row's scores, back pointers, counts and query offsets in (every cell's
    event bit and key), the positions of the cells its walks and its
    fallback read, the outputs out; the operations per cell, a comparison
    sort's M log2 M compares a row (not the kernel's M^2 ranks), per walked
    fragment and per repeat test (counted by running the plain version's
    walks and emission on these inputs), per output word."""
    import math
    import torch
    from .frozen import extract_kbest_device_staged
    R, NL, S = dp10.shape
    M = NL * S
    kw = dict(k=0, C=C, iters=iters)
    sidx, nv = extract_kbest_device_staged(dp10, back, pos, qpos, cnt,
                                           upto="sort", **kw)
    cn, emitted = extract_kbest_device_staged(dp10, back, pos, qpos, cnt,
                                              upto="emit", **kw)
    T = min(iters, M)
    live = torch.arange(T, device=dp10.device)[None, :] < nv[:, None]
    cur = sidx[:, :T].long()
    bk = back.reshape(R, M).long()
    act = live.clone()
    frags = 0
    lens = torch.zeros((R, T), dtype=torch.long, device=dp10.device)
    for _ in range(NL):
        frags += int(act.sum())
        lens += act
        nxt = torch.gather(bk, 1, cur)
        act = act & (nxt >= 0)
        cur = torch.where(act, nxt, cur)
    # a pick below the row's best score, taken while fewer than C were
    # emitted, tests the non-head fragments of the picks emitted before it
    dpf = dp10.reshape(R, M)
    l_of = torch.arange(M, device=dp10.device) // S
    ev = (torch.arange(M, device=dp10.device) % S < cnt[:, l_of]) & (bk >= 0)
    best = torch.where(ev, dpf, -2 ** 29).amax(dim=1, keepdim=True)
    below = torch.gather(dpf, 1, sidx[:, :T].long()) < best
    frag = torch.where(emitted[:, :T], lens - 1, 0)
    n_before = torch.cumsum(emitted[:, :T].long(), dim=1) \
        - emitted[:, :T].long()
    tested = live & below & (n_before < C)
    tests = int(torch.where(tested, torch.cumsum(frag, dim=1) - frag,
                            0).sum())
    fallback = int((cn == 0).sum())
    out_words = R * (2 * C * NL + 2 * C + 1)
    nbytes = R * M * 8 + R * NL * 8 + 4 * frags + 8 * C * fallback \
        + 4 * out_words + R
    ops = R * M * EX_CELL_OPS \
        + R * M * max(1, math.ceil(math.log2(M))) * EX_SORT_OPS \
        + frags * EX_FRAGMENT_OPS + tests * EX_REPEAT_OPS + out_words
    return nbytes, ops


def tensor_kernel_bound(name, args, kw):
    """(bound ms, what sets it, int32 ops): the bytes these inputs need,
    each read once and each output written once, over HBM bandwidth,
    against the operations over the ALU peak.  The fold reads one
    orientation's half of the pairs."""
    if name == "chain_dp":
        nbytes = chain_dp_bytes(*args, **kw)
        ops = chain_dp_work(*args, **kw)
    elif name == "chain_cells":
        nbytes, ops = chain_cells_work(*args, **kw)
    elif name == "extract_kbest":
        nbytes, ops = extract_kbest_work(*args, **kw)
    elif name in WALK_KERNELS:
        nbytes, ops = walk_work(name, args, kw)
    elif name in WAVE_KERNELS:
        nbytes, ops = wave_work(name, args, kw)
    elif name in EXTEND_KERNELS:
        nbytes, ops = extend_work(name, args, kw)
    elif name == "pair_grid":
        nbytes, ops = pair_grid_bytes(*args, **kw), pair_grid_work(*args,
                                                                    **kw)
    else:
        mr, pairs = args[0], args[1]
        B, _, P, F = pairs.shape
        nbytes = B * (20 * 4 + P * F * 4 + 4 + P * 4 * 4 + 2 + 20 * 4 + 6 * 4)
        ops = B * P * FOLD_STEP_OPS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", ops)
