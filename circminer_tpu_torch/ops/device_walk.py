"""Multi-exon transcript extension walks on the torch device (counterpart of
``circminer_tpu/ops/device_walk.py``).

The host walk (pipeline/extend.py ``_extend_right_trans_g`` /
``_extend_left_trans_g``, src/extend.cpp:491-650 and :708-875) visits a
transcript's exons one disjoint interval at a time, alternating annotation
scans with banded middle DPs (``local_alignment_right/left``,
src/align.cpp:556-600) and one terminal X-drop end DP per transcript.  The
device form runs every walk of the fused step at once:

* **lanes**: every (extend family, pair slot, common transcript) that needs
  a walk is a lane of a ``[ST, WPP]`` pool (families: l-mate-left,
  r-mate-left, r-mate-right, l-mate-right), pool index last.
* **speculation**: which intervals a walk visits and where its DPs land
  depend only on the annotation and earlier DP indels, never on the
  extend's bound (lb/ub) or error budget (ed_th), which can only abort it.
  So all four families walk together through ``EW`` waves (scan up to
  ``KSCAN`` intervals -> pooled middle DPs -> pooled end DPs -> commit), and
  the bound / ed_th gates are replayed afterwards per family
  (``walk_fold``), once each extend's bound is known.
* **events**: a lane emits at most one best-update event per wave; the fold
  replays them in (tid, event) order, the host's sequential best fold.

The walk's lanes are set up by the ``walk_init`` kernels; each wave's
interval scan is the ``walk_scan`` kernel, its two deduplicated DP pools
and their windows the ``walk_pool`` kernels, its middle DPs the
``edit_end`` kernel (with the ``tiny_dp`` kernel on the pool's fallback
rows), its end DPs the ``xdrop`` kernel, and its commit the
``walk_commit`` kernel (csrc/walk.cu, csrc/walk_wave.cu); each family's
fold is the ``walk_fold`` kernel.  On CPU tensors, their plain versions.
Budget overflows (more than EW DPs per lane, scans past EW*KSCAN intervals,
exhausted pools, more than STW = 8 common transcripts) raise the read's
DEF_EXTWALK bit, and the read replays on the host: results are exact or
absent.  The budgets are the caller's (the pipeline's ``_full_statics``),
whose middle-DP pool may exceed the reference's: it then defers fewer
reads than the reference, and finishes the others alike.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _ext
from .align_device import edit_end_rows
from .pallas_align import POS, xdrop_rows

_i32 = torch.int32

# lane status codes
WK_SCAN, WK_PMID, WK_PTRAIL, WK_PEND, WK_PENDND, WK_DONE = 0, 1, 2, 3, 4, 5
# event kinds
EVK_NONE, EVK_MID, EVK_TRAIL, EVK_END, EVK_ENDND = 0, 1, 2, 3, 4
# event record fields (the enums of csrc/walk.cu follow these orders)
EV_KEYS = ("kind", "xpos", "aux", "ed", "indel", "sclen", "score")
EV_NF = len(EV_KEYS)       # aux: exlen (middle kinds) or covered (end kinds)
# the scan state carried across waves, int32 [len(WS_KEYS), STW, WPP]
# (first as 0 / 1), and the scan's constants per (slot, lane) and per lane
WS_KEYS = ("i_abs", "xpos", "exlen", "covered", "first", "stat", "pend_iv",
           "pend_xpos", "pend_exlen", "pend_cov", "pend_rr", "remref")
SLOT_KEYS = ("tstart", "toff", "tlen")
LANE_KEYS = ("is_left", "qlen", "pos")
STW = 8   # packed transcript lanes per walk; more common tids defer

NEG_SCORE = -(10 ** 9)


def _col(x, idx):
    """x[r, idx[r]] for a [R, C] table and in-range int32 idx [R]."""
    return torch.gather(x, 1, idx.long()[:, None])[:, 0]


# --------------------------------------------------------------------------
# middle-DP pool: local_alignment_right semantics for every shape
# --------------------------------------------------------------------------

def _tiny_end(s, t, n, m, *, w, max_ed, NM, MM):
    """Full (unbanded) edit DP + the column-m candidate scan for the tiny
    shapes where the oracle's banded DP falls back to full DP
    (align.py:88-90: n <= 2w or m <= w; both dims are then <= 2w).
    Candidate order: ed asc, |indel| asc, smallest i first (align.py:
    184-188, AlignCandid.update with strict better_than)."""
    B = s.shape[0]
    dev = s.device
    j_io = torch.arange(MM + 1, dtype=_i32, device=dev)[None, :]
    row = torch.where(j_io <= m[:, None], j_io.expand(B, MM + 1), POS)
    best_key = torch.zeros((B,), dtype=_i32, device=dev)
    best_ed = torch.full((B,), max_ed + 1, dtype=_i32, device=dev)
    best_indel = torch.full((B,), w + 1, dtype=_i32, device=dev)
    m_c = torch.clamp(m, 0, MM)

    def upd_cand(i, rowv, bk, be, bi):
        dmv = _col(rowv, m_c)
        indel = m - i
        ok = (i <= n) & (indel.abs() <= w) & (dmv <= max_ed)
        key = ((max_ed - dmv) * (w + 2)
               + (w + 1 - torch.clamp(indel.abs(), max=w + 1)))
        better = ok & (key > bk)
        return (torch.where(better, key, bk), torch.where(better, dmv, be),
                torch.where(better, indel, bi))

    best_key, best_ed, best_indel = upd_cand(0, row, best_key, best_ed,
                                             best_indel)
    for i in range(1, NM + 1):
        si = s[:, i - 1]
        prev = row
        cols = [torch.where(i <= n, i, POS).to(_i32)]
        for j in range(1, MM + 1):
            tj = t[:, j - 1]
            mis = ((si != tj) | (si >= 4) | (tj >= 4)).to(_i32)
            v = torch.minimum(prev[:, j - 1] + mis,
                              torch.minimum(prev[:, j] + 1, cols[j - 1] + 1))
            cols.append(torch.where((i <= n) & (j <= m), v, POS))
        row = torch.where((i <= n)[:, None], torch.stack(cols, dim=1), prev)
        best_key, best_ed, best_indel = upd_cand(i, row, best_key, best_ed,
                                                 best_indel)
    return best_ed, best_indel


# the widest tiny-DP row the kernel takes: MM + 1 words for each of 32
# threads in 48 KB of shared memory (csrc/walk.cu::tiny_shape); the pools
# pass MM <= I - 1 = 127
TINY_MM_MAX = 48 * 1024 // (4 * 32) - 1


def tiny_dp(s, t, n, m, tiny, banded, *, NM: int, MM: int, w: int = 0,
            max_ed: int = 0, end: bool):
    """The full (unbanded) edit DP of the tiny fallback shapes on the rows
    of a pool that fall back to it: s int8 [B, Ls >= NM], t int8 [B, Lt >=
    MM], n, m int32 [B], each clamped to NM / MM; tiny bool [B], the
    fallback rows; banded int32, the banded kernel's answers, [B, 2] (end)
    or [B].  Returns a tensor like banded: on the tiny rows, end=True:
    ``_tiny_end``'s (ed, indel); end=False: ``_tiny_global``'s dp[n][m];
    banded's row on every other row.  On a CPU tensor its plain version
    (``_tiny_dp_plain``); on a CUDA tensor the ``tiny_dp`` kernel
    (csrc/walk.cu), or a raise."""
    kw = dict(NM=NM, MM=MM, w=w, max_ed=max_ed, end=end)
    if not s.is_cuda:
        return _tiny_dp_plain(s, t, n, m, tiny, banded, **kw)
    B = s.shape[0]
    if s.shape[1] < NM or t.shape[1] < MM:
        raise ValueError(f"tiny_dp reads NM = {NM} / MM = {MM} bases of "
                         f"rows of {s.shape[1]} / {t.shape[1]}")
    if MM > TINY_MM_MAX:
        raise ValueError(f"tiny_dp takes rows of at most {TINY_MM_MAX} "
                         f"columns, got MM = {MM}")
    out = torch.empty_like(banded)
    if B == 0:
        return out
    _ext.launch_tensors("tiny_dp",
                        tiny_dp_args(s, t, n, m, tiny, banded, out, end=end),
                        (B, s.shape[1], t.shape[1], NM, MM, w, max_ed,
                         int(end)))
    return out


def tiny_dp_args(s, t, n, m, tiny, banded, out, *, end: bool):
    """The (tensor, dtype, shape) arguments of the ``tiny_dp`` kernel, in
    its order."""
    B = s.shape[0]
    res = (B, 2) if end else (B,)
    return [(s, torch.int8, (B, s.shape[1])), (t, torch.int8, (B, t.shape[1])),
            (n, _i32, (B,)), (m, _i32, (B,)), (tiny, torch.bool, (B,)),
            (banded, _i32, res), (out, _i32, res)]


def _tiny_dp_plain(s, t, n, m, tiny, banded, *, NM, MM, w=0, max_ed=0, end):
    """The plain version of ``tiny_dp``: ``_tiny_end`` or ``_tiny_global``
    on the first NM / MM columns and the clamped lengths of every row, then
    the pool's select of the tiny rows."""
    sn, tm = s[:, :NM], t[:, :MM]
    nc, mc = torch.clamp(n, max=NM), torch.clamp(m, max=MM)
    if not end:
        from .device_full import _tiny_global
        return torch.where(tiny, _tiny_global(sn, tm, nc, mc, NM, MM),
                           banded)
    ed, indel = _tiny_end(sn, tm, nc, mc, w=w, max_ed=max_ed, NM=NM, MM=MM)
    return torch.where(tiny[:, None], torch.stack([ed, indel], dim=1),
                       banded)


def _end_dp_pool(s, t, n, m, *, w, max_ed, I):
    """Pooled local_alignment_right (the ``end_r/end_l`` request kind):
    ``_end_dp_rows`` with the fallback shapes (n <= 2w or m <= w, which
    bounds both dims by 2w) as its tiny rows.  Returns (ed, indel); the
    request's score is -ed (align.py:188)."""
    n, m = n.to(_i32).contiguous(), m.to(_i32).contiguous()
    s, t = s.contiguous(), t.contiguous()
    tiny = (n <= 2 * w) | (m <= w)
    return _end_dp_rows(s, t, n, m, tiny, w=w, max_ed=max_ed, I=I).unbind(1)


def _end_dp_rows(s, t, n, m, tiny, *, w, max_ed, I):
    """(ed, indel) int32 [B, 2] of a middle-DP pool: the ``edit_end``
    kernel for the banded regime, the tiny full DP (``tiny_dp``) on the
    rows of the fallback mask tiny."""
    banded = edit_end_rows(s, t, n, m, w=w, max_ed=max_ed, I=I)
    TN = max(8, 2 * w + 2)
    return tiny_dp(s, t, n, m, tiny, banded, NM=TN, MM=TN, w=w,
                   max_ed=max_ed, end=True)


# --------------------------------------------------------------------------
# the speculative walk waves
# --------------------------------------------------------------------------

# the pool's per-lane rows beside LANE_KEYS, int32 [len(PROW_KEYS), WPP]
PROW_KEYS = ("row", "qs0")
# a pool's int32 rows [len(POOL_ROWS), P]: its DP's two lengths (MID: the
# query's remq and the reference's exlen; END: the reference's rr and the
# query's need), then the flat [STW, WPP] index the row was gathered from
POOL_ROWS = ("n", "m", "inv")
# a lane's code in a pool map: the leader's pool row (>= 0), or none
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


def walk_waves(act4, pos4, len4, aiv4, row4, qs04, left4, fiv, riv,
               seqsf, L, genome, ad, fa, *, band, max_ed, max_sc,
               mat, mis, ind, xd, EW, KSCAN, WPP, MIDP, ENDP, I=128):
    """Run the walks of all four extend families together.

    act4/pos4/len4/aiv4/row4/qs04: [4, N] lane tables (N = flattened B*2*P
    pair slots; row4 = absolute seqs row, qs04 = query-window base offset
    within the row); left4: per-family left/right flags; fiv/riv: [N] pair
    anchor intervals defining the common-transcript set (pair_chains order,
    utils.cpp:322-352: f_iv's tid list filtered by membership in r_iv's,
    duplicates kept).

    One ``walk_init``, then per wave ``walk_scan`` -> ``walk_pool`` -> the
    pooled DPs (edit_end + tiny_dp on MID, xdrop on END) -> ``walk_commit``.
    Returns the pooled event tensor + metadata for ``walk_fold``."""
    N = fiv.reshape(-1).shape[0]
    G = genome.shape[0]
    mp = max(MIDP) if isinstance(MIDP, (tuple, list)) else MIDP
    ep = max(ENDP) if isinstance(ENDP, (tuple, list)) else ENDP
    wi = walk_init(act4, pos4, len4, aiv4, row4, qs04, fiv.reshape(-1),
                   riv.reshape(-1), ad.iv_epos, fa.iv_tids, fa.trans_start,
                   fa.t2s_off, left4=tuple(left4), band=band, EW=EW, WPP=WPP)
    ws, events, nev = wi.ws, wi.events, wi.nev
    for _ in range(EW):
        ws = walk_scan(ws, wi.slot, wi.lane, ad.iv_spos, ad.iv_epos,
                       fa.t2s_state, KSCAN=KSCAN, G=G)
        pool = walk_pool(ws, wi.lane, wi.prow, seqsf, genome, L=L,
                         band=band, MIDP=mp, ENDP=ep, I=I)
        q_win, r_win = pool.m_win.unbind(0)
        remq, exlen, _ = pool.m_rows.unbind(0)
        md = _end_dp_rows(q_win, r_win, remq, exlen, pool.m_tiny, w=band,
                          max_ed=max_ed, I=I)
        s_e, t_q = pool.e_win.unbind(0)
        rr, need, _ = pool.e_rows.unbind(0)
        xres = xdrop_rows(s_e, t_q, rr, need, w=band, mat=mat, mis=mis,
                          ind=ind, xd=xd, I=I)
        ws = walk_commit(ws, pool.maps, md, xres, pool.e_rows, wi.lane,
                         ad.iv_spos, ad.iv_epos, events, nev, mat=mat,
                         mis=mis, band=band, max_ed=max_ed, max_sc=max_sc)
    lane_defer = ((ws[WS_KEYS.index("stat")] != WK_DONE) & wi.act).any(
        dim=0) | wi.over_tid                                     # [WPP]
    ST = wi.act.shape[0]
    return dict(events=events.reshape(ST * EW, EV_NF, WPP), act=wi.act,
                inv=wi.inv, n_act=wi.n_act, over=wi.over,
                lane_defer=lane_defer, p_pos=wi.lane[2], p_len=wi.lane[1],
                p_live=wi.p_live, N=N, ST=ST, EW=EW, WPP=WPP)


def walk_init(act4, pos4, len4, aiv4, row4, qs04, fiv, riv, iv_epos,
              iv_tids, trans_start, t2s_off, *, left4, band: int, EW: int,
              WPP: int):
    """The walk's lanes and initial state (the reference's lane set-up
    before its wave loop): the [4, N] lane tables' active slots compacted
    into WPP lanes, each lane's common transcripts (f_iv's tids that r_iv
    also lists, fiv / riv int32 [N]) packed in order into STW = min(ST, 8)
    slots, the scan state, the slot and lane constants and zeroed events.
    Returns a ``WalkInit``.  On a CPU tensor its plain version
    (``_walk_init_plain``); on a CUDA tensor the ``walk_init`` kernel
    (csrc/walk_wave.cu), or a raise."""
    kw = dict(left4=tuple(left4), band=band, EW=EW, WPP=WPP)
    if not act4.is_cuda:
        return _walk_init_plain(act4, pos4, len4, aiv4, row4, qs04, fiv, riv,
                                iv_epos, iv_tids, trans_start, t2s_off, **kw)
    N = fiv.shape[0]
    NIV, ST = iv_tids.shape
    STW_ = min(ST, STW)
    if N == 0 or NIV == 0 or ST == 0:
        raise ValueError(f"walk_init takes N, NIV and ST above 0, got {N}, "
                         f"{NIV}, {ST}")
    if act4.data_ptr() % 16:          # the kernel reads 16 flags at a time
        act4 = act4.clone()
    dev = act4.device
    i32, b8 = _i32, torch.bool
    out = WalkInit(
        inv=torch.empty((WPP,), dtype=i32, device=dev),
        n_act=torch.empty((), dtype=i32, device=dev),
        over=torch.empty((4 * N,), dtype=b8, device=dev),
        act=torch.empty((STW_, WPP), dtype=b8, device=dev),
        p_live=torch.empty((WPP,), dtype=b8, device=dev),
        over_tid=torch.empty((WPP,), dtype=b8, device=dev),
        ws=torch.empty((len(WS_KEYS), STW_, WPP), dtype=i32, device=dev),
        slot=torch.empty((len(SLOT_KEYS), STW_, WPP), dtype=i32,
                         device=dev),
        lane=torch.empty((len(LANE_KEYS), WPP), dtype=i32, device=dev),
        prow=torch.empty((len(PROW_KEYS), WPP), dtype=i32, device=dev),
        events=torch.empty((STW_, EW, EV_NF, WPP), dtype=i32, device=dev),
        nev=torch.empty((STW_, WPP), dtype=i32, device=dev))
    _ext.launch_tensors(
        "walk_init", walk_init_args(act4, pos4, len4, aiv4, row4, qs04, fiv,
                                    riv, iv_epos, iv_tids, trans_start,
                                    t2s_off, out),
        (N, WPP, STW_, ST, iv_epos.shape[0], trans_start.shape[0], EW, band,
         sum(1 << f for f, left in enumerate(left4) if left)))
    return out


def walk_init_args(act4, pos4, len4, aiv4, row4, qs04, fiv, riv, iv_epos,
                   iv_tids, trans_start, t2s_off, out):
    """The (tensor, dtype, shape) arguments of the ``walk_init`` kernel,
    in their order; ``out`` a ``WalkInit``."""
    N = fiv.shape[0]
    STW_, EW, WPP = out.events.shape[0], out.events.shape[1], \
        out.events.shape[3]
    i32, b8 = _i32, torch.bool
    NT = trans_start.shape[0]
    return [(act4, b8, (4, N)), *((x, i32, (4, N)) for x in (
        pos4, len4, aiv4, row4, qs04)), (fiv, i32, (N,)), (riv, i32, (N,)),
        (iv_epos, i32, (iv_epos.shape[0],)),
        (iv_tids, i32, tuple(iv_tids.shape)), (trans_start, i32, (NT,)),
        (t2s_off, i32, (NT + 1,)), (out.inv, i32, (WPP,)),
        (out.n_act, i32, ()), (out.over, b8, (4 * N,)),
        (out.act, b8, (STW_, WPP)), (out.p_live, b8, (WPP,)),
        (out.over_tid, b8, (WPP,)),
        (out.ws, i32, (len(WS_KEYS), STW_, WPP)),
        (out.slot, i32, (len(SLOT_KEYS), STW_, WPP)),
        (out.lane, i32, (len(LANE_KEYS), WPP)),
        (out.prow, i32, (len(PROW_KEYS), WPP)),
        (out.events, i32, (STW_, EW, EV_NF, WPP)),
        (out.nev, i32, (STW_, WPP))]


def _walk_init_plain(act4, pos4, len4, aiv4, row4, qs04, fiv, riv, iv_epos,
                     iv_tids, trans_start, t2s_off, *, left4, band, EW,
                     WPP):
    """The plain version of ``walk_init``: torch ops over every lane."""
    from .device_full import _compact

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


def walk_pool(ws, lane, prow, seqsf, genome, *, L: int, band: int,
              MIDP: int, ENDP: int, I: int = 128):
    """One wave's DP pools from the scan state ws int32 [len(WS_KEYS), STW,
    WPP]: the lanes pending a middle or trailing DP (MID) and an end DP
    (END), each deduplicated across a lane's slots by geometry (MID:
    pend_xpos, pend_exlen, pend_cov; END: pend_xpos, pend_cov, pend_rr),
    compacted in slot-major order into MIDP / ENDP rows, and their query
    (seqsf int8 [RL], rows of L bases) and reference (genome int8 [G])
    windows of I - 1 bases gathered.  lane int32 [len(LANE_KEYS), WPP],
    prow int32 [len(PROW_KEYS), WPP].  Returns a ``WalkPool``.  On a CPU
    tensor its plain version (``_walk_pool_plain``); on a CUDA tensor the
    ``walk_pool`` kernel (csrc/walk_wave.cu), or a raise."""
    kw = dict(L=L, band=band, MIDP=MIDP, ENDP=ENDP, I=I)
    if not ws.is_cuda:
        return _walk_pool_plain(ws, lane, prow, seqsf, genome, **kw)
    _, STW_, WPP = ws.shape
    if STW_ > STW or STW_ * WPP == 0 or min(MIDP, ENDP) <= 0:
        raise ValueError(f"walk_pool takes 1-{STW} slots of lanes and pools "
                         f"of rows, got {STW_} x {WPP} into {MIDP} / {ENDP}")
    W = I - 1
    dev = ws.device
    out = WalkPool(
        m_win=torch.empty((2, MIDP, W), dtype=torch.int8, device=dev),
        m_rows=torch.empty((len(POOL_ROWS), MIDP), dtype=_i32, device=dev),
        m_tiny=torch.empty((MIDP,), dtype=torch.bool, device=dev),
        e_win=torch.empty((2, ENDP, W), dtype=torch.int8, device=dev),
        e_rows=torch.empty((len(POOL_ROWS), ENDP), dtype=_i32, device=dev),
        n=torch.empty((2,), dtype=_i32, device=dev),
        maps=torch.empty((2, STW_, WPP), dtype=_i32, device=dev))
    _ext.launch_tensors(
        "walk_pool", walk_pool_args(ws, lane, prow, seqsf, genome, out),
        (STW_, WPP, seqsf.shape[0], genome.shape[0], L, band, MIDP, ENDP, W))
    return out


def walk_pool_args(ws, lane, prow, seqsf, genome, out):
    """The (tensor, dtype, shape) arguments of the ``walk_pool`` kernel, in
    their order; ``out`` a ``WalkPool``."""
    _, STW_, WPP = ws.shape
    _, MIDP, W = out.m_win.shape
    ENDP = out.e_win.shape[1]
    i32, i8 = _i32, torch.int8
    return [(ws, i32, (len(WS_KEYS), STW_, WPP)),
            (lane, i32, (len(LANE_KEYS), WPP)),
            (prow, i32, (len(PROW_KEYS), WPP)),
            (seqsf, i8, (seqsf.shape[0],)), (genome, i8, (genome.shape[0],)),
            (out.m_win, i8, (2, MIDP, W)),
            (out.m_rows, i32, (len(POOL_ROWS), MIDP)),
            (out.m_tiny, torch.bool, (MIDP,)), (out.e_win, i8, (2, ENDP, W)),
            (out.e_rows, i32, (len(POOL_ROWS), ENDP)), (out.n, i32, (2,)),
            (out.maps, i32, (2, STW_, WPP))]


def _pool_map(lead, inv, n, over):
    """Each lane's code in a pool: its leader's pool row, MAP_OVER where
    the leader's rank passed the pool, MAP_NONE off the pool (what
    ``_scatter_pool`` and the gather by leader read: 0 then)."""
    from .device_full import _scatter_pool
    ST, WPP = lead.shape
    rows = torch.arange(1, inv.shape[0] + 1, dtype=_i32, device=inv.device)
    row = _scatter_pool(rows, inv, n, ST * WPP).reshape(ST, WPP) - 1
    over2 = torch.gather(over.reshape(ST, WPP), 0, lead)
    return torch.where(over2, MAP_OVER, torch.gather(row, 0, lead))


def _walk_pool_plain(ws, lane, prow, seqsf, genome, *, L, band, MIDP, ENDP,
                     I=128):
    """The plain version of ``walk_pool``: torch ops over every slot."""
    from .device_full import _compact, _gather_window

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


def walk_commit(ws, maps, md, xres, e_rows, lane, iv_spos, iv_epos, events,
                nev, *, mat: int, mis: int, band: int, max_ed: int,
                max_sc: int):
    """One wave's commit on the scan state ws int32 [len(WS_KEYS), STW,
    WPP]: each lane reads its leader's pooled results through ``maps``
    (``walk_pool``): md int32 [MIDP, 2], the middle DPs' (ed, indel) after
    tiny_dp; xres int32 [ENDP, 3], the end DPs' (score, on_s, on_t), with
    _drop_wrap for the lane's side on e_rows' need.  A lane whose leader
    overflowed its pool keeps its pending status; every other pending lane
    writes its one event of the wave into events int32 [STW, EW, EV_NF,
    WPP] at slot clamp(nev, 0, EW - 1) and advances nev int32 [STW, WPP],
    both in place; a middle DP moves the scan on.  Returns the new state,
    a tensor like ws.  On a CPU tensor its plain version
    (``_walk_commit_plain``); on a CUDA tensor the ``walk_commit`` kernel
    (csrc/walk_wave.cu), or a raise."""
    kw = dict(mat=mat, mis=mis, band=band, max_ed=max_ed, max_sc=max_sc)
    if not ws.is_cuda:
        return _walk_commit_plain(ws, maps, md, xres, e_rows, lane, iv_spos,
                                  iv_epos, events, nev, **kw)
    if mat - mis <= 0:
        raise ValueError(f"walk_commit divides by mat - mis > 0, got "
                         f"{mat} - {mis}")
    out = torch.empty_like(ws)
    _, STW_, WPP = ws.shape
    if STW_ * WPP == 0:
        return out
    _ext.launch_tensors(
        "walk_commit", walk_commit_args(ws, maps, md, xres, e_rows, lane,
                                        iv_spos, iv_epos, events, nev, out),
        (STW_, WPP, events.shape[1], md.shape[0], xres.shape[0],
         iv_spos.shape[0], mat, mis, band, max_ed, max_sc))
    return out


def walk_commit_args(ws, maps, md, xres, e_rows, lane, iv_spos, iv_epos,
                     events, nev, ws_out):
    """The (tensor, dtype, shape) arguments of the ``walk_commit`` kernel,
    in its order."""
    _, STW_, WPP = ws.shape
    EW = events.shape[1]
    MIDP, ENDP = md.shape[0], xres.shape[0]
    NIV = iv_spos.shape[0]
    shp = (len(WS_KEYS), STW_, WPP)
    i32 = _i32
    return [(ws, i32, shp), (maps, i32, (2, STW_, WPP)), (md, i32, (MIDP, 2)),
            (xres, i32, (ENDP, 3)), (e_rows, i32, (len(POOL_ROWS), ENDP)),
            (lane, i32, (len(LANE_KEYS), WPP)), (iv_spos, i32, (NIV,)),
            (iv_epos, i32, (NIV,)), (events, i32, (STW_, EW, EV_NF, WPP)),
            (nev, i32, (STW_, WPP)), (ws_out, i32, shp)]


def _walk_commit_plain(ws, maps, md, xres, e_rows, lane, iv_spos, iv_epos,
                       events, nev, *, mat, mis, band, max_ed, max_sc):
    """The plain version of ``walk_commit``: torch ops over every slot."""
    from .device_full import _drop_wrap

    (i_abs, xpos, exlen, covered, first, stat, pend_iv, pend_xpos,
     pend_exlen, pend_cov, pend_rr, remref) = ws.unbind(0)
    _, ST, WPP = ws.shape
    EW = events.shape[1]
    NIV = iv_spos.shape[0]
    ew_io = torch.arange(EW, dtype=_i32, device=ws.device)
    is_left = (lane[0] != 0)[None, :].expand(ST, WPP)
    zero = torch.zeros((ST, WPP), dtype=_i32, device=ws.device)
    m_map, e_map = maps.unbind(0)

    def pooled(vals, code):
        return torch.where(code >= 0, vals[torch.clamp(code, min=0).long()],
                           0)

    md_ed_f, md_in_f = (pooled(v, m_map) for v in md.unbind(1))
    xsc, xon_s, xon_t = xres.unbind(1)
    e_need, e_inv = e_rows[1], e_rows[2]
    el = lane[0][(e_inv % WPP).long()] != 0
    wrap = dict(mat=mat, mis=mis, w=band, max_ed=max_ed, max_sc=max_sc)
    dl = _drop_wrap(xsc, xon_s, xon_t, e_need, left=True, **wrap)
    dr = _drop_wrap(xsc, xon_s, xon_t, e_need, left=False, **wrap)
    e_ed_f, e_scl_f, e_ind_f, e_scr_f = (
        pooled(torch.where(el, a, b), e_map) for a, b in zip(dl, dr))

    # pool-overflow lanes keep their pending status: they retry in the
    # next wave's pool and defer if still unresolved at the end
    # (duplicates inherit their leader's overflow)
    m_over2, e_over2 = m_map == MAP_OVER, e_map == MAP_OVER

    # ---- commit: one emit per wave (kinds exclude each other) -------
    mid_c = (stat == WK_PMID) & ~m_over2
    tr_c = (stat == WK_PTRAIL) & ~m_over2
    end_c = (stat == WK_PEND) & ~e_over2
    endnd_c = stat == WK_PENDND
    any_c = mid_c | tr_c | end_c | endnd_c
    is_end_ev = end_c | endnd_c
    kind_v = torch.where(mid_c, EVK_MID, torch.where(
        tr_c, EVK_TRAIL, torch.where(end_c, EVK_END, EVK_ENDND))).to(_i32)
    aux_v = torch.where(is_end_ev, pend_cov, pend_exlen)
    ed_v = torch.where(end_c, e_ed_f,
                       torch.where(endnd_c, zero, md_ed_f))
    in_v = torch.where(end_c, e_ind_f,
                       torch.where(endnd_c, zero, md_in_f))
    scl_v = torch.where(end_c, e_scl_f, zero)
    scr_v = torch.where(end_c, e_scr_f,
                        torch.where(endnd_c, zero, -md_ed_f))
    upd = torch.stack([kind_v, pend_xpos, aux_v, ed_v, in_v, scl_v,
                       scr_v], dim=1)                # [ST, NF, WPP]
    sel = (ew_io[None, :, None]
           == torch.clamp(nev, 0, EW - 1)[:, None, :]) & any_c[:, None, :]
    events.copy_(torch.where(sel[:, :, None, :], upd[:, None, :, :], events))
    nev.copy_(torch.where(any_c, nev + 1, nev))

    # middle commit: covered/remref advance + rescan positioning
    covered = torch.where(mid_c, covered + pend_exlen - md_in_f, covered)
    remref = torch.where(mid_c, remref - pend_exlen, remref)
    pivc = torch.clamp(pend_iv, 0, NIV - 1).long()
    piv_len = iv_epos[pivc] - iv_spos[pivc] + 1
    # right: rspos = iv_spos[pend]-1, exlen = len(pend), i = pend+1
    # (extend.py:421-428); left: exlen = 0, i = pend-1 (:545-547)
    xpos = torch.where(mid_c & ~is_left, iv_spos[pivc] - 1, xpos)
    exlen = torch.where(mid_c & ~is_left, piv_len,
                        torch.where(mid_c & is_left, 0, exlen))
    i_abs = torch.where(mid_c & ~is_left, pend_iv + 1,
                        torch.where(mid_c & is_left, pend_iv - 1, i_abs))
    stat = torch.where(mid_c, WK_SCAN,
                       torch.where(tr_c | end_c | endnd_c, WK_DONE, stat))
    return torch.stack([i_abs, xpos, exlen, covered, first, stat, pend_iv,
                        pend_xpos, pend_exlen, pend_cov, pend_rr, remref])


# --------------------------------------------------------------------------
# the interval scan of a wave
# --------------------------------------------------------------------------

def walk_scan(ws, slot, lane, iv_spos, iv_epos, t2s_state, *, KSCAN: int,
              G: int):
    """Up to KSCAN interval-scan steps of every (transcript slot, lane) of
    the walk (the reference's ``scan_step`` in ``fori_loop(0, KSCAN)``).
    ws int32 [len(WS_KEYS), STW, WPP], the carried state; slot int32
    [len(SLOT_KEYS), STW, WPP]; lane int32 [len(LANE_KEYS), WPP]; the
    annotation's iv_spos / iv_epos int32 [NIV] and t2s_state uint8 [NS]; G
    the genome's length.  Returns the new state, a tensor like ws.  On a
    CPU tensor its plain version (``_walk_scan_plain``); on a CUDA tensor
    the ``walk_scan`` kernel (csrc/walk.cu), or a raise."""
    if not ws.is_cuda:
        return _walk_scan_plain(ws, slot, lane, iv_spos, iv_epos, t2s_state,
                                KSCAN=KSCAN, G=G)
    out = torch.empty_like(ws)
    _, STW, WPP = ws.shape
    if STW * WPP == 0:
        return out
    _ext.launch_tensors(
        "walk_scan", walk_scan_args(ws, slot, lane, iv_spos, iv_epos,
                                    t2s_state, out),
        (STW, WPP, iv_spos.shape[0], t2s_state.shape[0], G, KSCAN))
    return out


def walk_scan_args(ws, slot, lane, iv_spos, iv_epos, t2s_state, ws_out):
    """The (tensor, dtype, shape) arguments of the ``walk_scan`` kernel, in
    its order."""
    _, STW, WPP = ws.shape
    shp = (len(WS_KEYS), STW, WPP)
    return [(ws, _i32, shp), (slot, _i32, (len(SLOT_KEYS), STW, WPP)),
            (lane, _i32, (len(LANE_KEYS), WPP)),
            (iv_spos, _i32, (iv_spos.shape[0],)),
            (iv_epos, _i32, (iv_spos.shape[0],)),
            (t2s_state, torch.uint8, (t2s_state.shape[0],)),
            (ws_out, _i32, shp)]


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


# --------------------------------------------------------------------------
# the per-family fold: replay events against (ed_th, bound)
# --------------------------------------------------------------------------

KEYS = ("pos", "ed", "sclen", "indel", "qcov", "score")
# the kernel's limits: a pool lane's transcripts on one thread each, each
# thread holding its events (csrc/walk.cu FOLD_T, 2 * FOLD_EW); walk_waves
# passes ST <= STW
FOLD_ST_MAX, FOLD_EW_MAX = 8, 8
# the rows of the fold's int32 [len(FOLD_OUT), N] output (the enum FoldOut
# of csrc/walk.cu)
FOLD_OUT = KEYS + ("consec", "defer")


def fold_result(rows, over, fam: int, shp):
    """(best dict, consec, defer), each of shape ``shp``, of family
    ``fam``'s fold rows (``walk_fold_rows``) and the walk's [4N] pool
    overflow mask ``over``."""
    out = rows.reshape(len(FOLD_OUT), *shp)
    best = dict(zip(KEYS, out.unbind(0)))
    return best, out[6] != 0, (out[7] != 0) | over.reshape(4, *shp)[fam]


def walk_fold_rows(wk, fam: int, ed_th, bound, *, max_ed, max_sc, band,
                   left: bool):
    """Replay one extend family's events in (tid, event) order against that
    extend's actual ed_th / bound (both [B, 2, P]; the reference's
    ``walk_fold``): the fold as ``walk_fold_lanes`` returns it, int32
    [len(FOLD_OUT), N] over the flat pair slots (phase 2's extend_core
    reads these rows as they are; ``fold_result`` splits them)."""
    return walk_fold_lanes(
        wk["events"], wk["act"], wk["inv"], wk["n_act"], wk["p_live"],
        wk["p_pos"], wk["p_len"], wk["lane_defer"], ed_th.reshape(-1),
        bound.reshape(-1), fam=fam, left=left, max_ed=max_ed,
        max_sc=max_sc, band=band)


def walk_fold_lanes(events, act, inv, n_act, p_live, p_pos, p_len,
                    lane_defer, ed_th, bound, *, fam: int, left: bool,
                    max_ed: int, max_sc: int, band: int):
    """The fold of family ``fam`` (the reference's ``walk_fold`` loop, then
    its scatter to pair slots): events int32 [ST * EW, EV_NF, WPP]; act
    bool [ST, WPP]; inv int32 [WPP] (pool row -> flat 4N slot), n_act
    int32 0-d; p_live, lane_defer bool [WPP]; p_pos, p_len int32 [WPP];
    ed_th, bound int32 [N].  Returns int32 [len(FOLD_OUT), N]: each slot
    of the family the best fields, consec and defer (0 / 1) of its live
    lane, zeros elsewhere.  On a CPU tensor its plain version
    (``_walk_fold_plain``); on a CUDA tensor the ``walk_fold`` kernel
    (csrc/walk.cu; ST <= FOLD_ST_MAX, EW <= FOLD_EW_MAX), or a raise."""
    kw = dict(fam=fam, left=left, max_ed=max_ed, max_sc=max_sc, band=band)
    if not events.is_cuda:
        return _walk_fold_plain(events, act, inv, n_act, p_live, p_pos,
                                p_len, lane_defer, ed_th, bound, **kw)
    N = ed_th.shape[0]
    ST, WPP = act.shape
    EW = events.shape[0] // max(ST, 1)
    if ST > FOLD_ST_MAX or EW > FOLD_EW_MAX:
        raise ValueError(f"walk_fold takes at most {FOLD_ST_MAX} transcripts "
                         f"of {FOLD_EW_MAX} events a lane, got {ST} of {EW}")
    out = torch.zeros((len(FOLD_OUT), N), dtype=_i32, device=events.device)
    if WPP * N * ST == 0:
        return out
    _ext.launch_tensors(
        "walk_fold", walk_fold_args(events, act, inv, n_act, p_live, p_pos,
                                    p_len, lane_defer, ed_th, bound, out),
        (WPP, N, fam, int(left), ST, EW, max_ed, max_sc, band))
    return out


def walk_fold_args(events, act, inv, n_act, p_live, p_pos, p_len,
                   lane_defer, ed_th, bound, out):
    """The (tensor, dtype, shape) arguments of the ``walk_fold`` kernel, in
    its order."""
    ST, WPP = act.shape
    N = ed_th.shape[0]
    EW = events.shape[0] // max(ST, 1)
    i32, b8 = _i32, torch.bool
    return [(events, i32, (ST * EW, EV_NF, WPP)), (act, b8, (ST, WPP)),
            (inv, i32, (WPP,)), (n_act, i32, ()), (p_live, b8, (WPP,)),
            (p_pos, i32, (WPP,)), (p_len, i32, (WPP,)),
            (lane_defer, b8, (WPP,)), (ed_th, i32, (N,)),
            (bound, i32, (N,)), (out, i32, (len(FOLD_OUT), N))]


def _walk_fold_plain(events, act, inv, n_act, p_live, p_pos, p_len,
                     lane_defer, ed_th, bound, *, fam, left, max_ed, max_sc,
                     band):
    """The plain version of ``walk_fold_lanes``: the fold's ST * EW steps as
    torch ops over every pool lane, then ``_scatter_pool``."""
    from .device_full import _scatter_pool

    N = ed_th.shape[0]
    ST = act.shape[0]
    EW = events.shape[0] // ST
    lane_n = (inv % N).long()
    mine = ((inv // N) == fam) & p_live
    eth = ed_th[lane_n]
    bnd = bound[lane_n]
    pos, qlen = p_pos, p_len
    zero = torch.zeros_like(pos)

    # initial best: extend.py:609/663 best.set(pos, edth+1, len+1, w+1, 0, 0)
    best = dict(zip(KEYS, (pos, eth + 1, qlen + 1,
                           torch.full_like(pos, band + 1), zero, zero)))
    curr0 = dict(zip(KEYS, (bnd, zero, zero, zero, zero,
                            torch.full_like(pos, NEG_SCORE))))
    consec = torch.zeros(pos.shape, dtype=torch.bool, device=pos.device)
    curr, alive = curr0, None

    for s in range(ST * EW):
        if s % EW == 0:                                  # next transcript
            curr = curr0
            alive = act[s // EW] & mine
        kind, xp, aux, ed, indel, sclen, scr = events[s].unbind(0)

        is_mid = (kind == EVK_MID) | (kind == EVK_TRAIL)
        bound_bad = (xp < bnd + aux) if left else (xp + aux > bnd)
        m_act = alive & is_mid & ~bound_bad              # aux = exon_len
        alive = alive & ~(is_mid & bound_bad)
        succ = m_act & (curr["ed"] + ed <= eth)
        alive = alive & ~(is_mid & ~succ)
        c_mid = dict(pos=xp - aux if left else xp + aux, ed=curr["ed"] + ed,
                     sclen=zero, indel=curr["indel"] - indel,
                     qcov=curr["qcov"] + aux - indel, score=scr)
        curr = {k: torch.where(succ, c_mid[k], curr[k]) for k in KEYS}
        best = _fold_update_dir(best, curr, succ, max_ed, max_sc, left)
        alive = alive & ~(kind == EVK_TRAIL)

        is_end = (kind == EVK_END) | (kind == EVK_ENDND)
        need = qlen - aux                                # aux = covered
        e_bad = (xp < bnd + need) if left else (xp + need > bnd)
        ok_geo = alive & is_end & ~e_bad
        consec = consec | (ok_geo & (xp == pos))
        dp_ok = ok_geo & (kind == EVK_END) \
            & (curr["ed"] + ed <= eth) & (sclen <= max_sc) \
            & (need - sclen >= sclen)
        c_end = dict(pos=xp - need + indel if left else xp + need - indel,
                     ed=curr["ed"] + ed, sclen=sclen,
                     indel=curr["indel"] + indel, qcov=curr["qcov"] + need,
                     score=scr)
        curr = {k: torch.where(dp_ok, c_end[k], curr[k]) for k in KEYS}
        best = _fold_update_score(best, curr, dp_ok, left)
        alive = alive & ~is_end

    rows = [best[k] for k in KEYS] + [consec, lane_defer & mine]
    vals = torch.stack([torch.where(mine, v.to(_i32), 0) for v in rows])
    out = torch.stack([_scatter_pool(v, inv, n_act, 4 * N) for v in vals])
    return out[:, fam * N:(fam + 1) * N]


def _fold_update_dir(best, cand, mask, max_ed, max_sc, left):
    """AlignRes.update_right/left (_update_dir, extend.py:165-187)."""
    gt = cand["qcov"] > best["qcov"]
    lt = cand["qcov"] < best["qcov"]
    ok_lim = (cand["ed"] <= max_ed) & (cand["sclen"] <= max_sc)
    take_gt = gt & ok_lim & (2 * (cand["ed"] - best["ed"])
                             < (cand["qcov"] - best["qcov"]))
    take_lt = lt & ok_lim & (2 * (best["ed"] - cand["ed"])
                             >= (best["qcov"] - cand["qcov"]))
    pos_better = (cand["pos"] > best["pos"]) if left \
        else (cand["pos"] < best["pos"])
    eq = ~gt & ~lt
    same_ed = cand["ed"] == best["ed"]
    take_eq = eq & ((cand["ed"] < best["ed"])
                    | (same_ed & (cand["sclen"] < best["sclen"]))
                    | (same_ed & (cand["sclen"] == best["sclen"])
                       & pos_better))
    take = mask & (take_gt | take_lt | take_eq)
    return {k: torch.where(take, cand[k], best[k]) for k in best}


def _fold_update_score(best, cand, mask, left):
    """AlignRes.update_by_score_right/left (extend.py:153-162)."""
    pos_better = (cand["pos"] > best["pos"]) if left \
        else (cand["pos"] < best["pos"])
    better = (best["score"] < cand["score"]) | (
        (best["score"] == cand["score"]) & pos_better)
    take = mask & better
    return {k: torch.where(take, cand[k], best[k]) for k in best}
