"""The fused mapping step on the torch device (the ``gpu-full`` executor;
counterpart of ``circminer_tpu/ops/device_full.py``).

One call runs seed lookup -> gather -> chain DP -> k-best extraction ->
chain pairing -> extension -> the category decision lattice, and the only
device-to-host payload is the final MatchedRead state, an int32
[B, MRF + 1] tensor (20 fields and the defer bitmask, 84 B per pair): the
batched form of src/filter.cpp:124-395 + src/extend.cpp:37-432 +
src/utils.cpp:22-320, where the reference walks one read at a time.

Scope and exactness: rows whose work fits the fixed structural budgets are
finished here with results bit-identical to the host pipeline; every other
row raises a DEFER cause bit (``DEFER_CAUSES``) and is replayed through the
host C++ path, so the output is always exact.  The budgets, the defer bits
and the int32 arithmetic are the reference's, so the port finishes and
defers exactly the reads the reference does, with one exception: the DP
pools gather windows of ``I - 1`` bases, and the reference cuts a longer
row to that (a 150-bp read can end one base short); the port defers the
read instead (``DEF_EXTENT``).

Extension DPs are compacted: every potential DP site (middle-gap one-sided
DPs, per-chain end / genomic X-drop DPs) is a fixed slot; active slots are
packed into one pool per DP family, solved by one call of its kernel
(``one_side`` and ``xdrop`` on CUDA tensors; their plain versions on CPU
tensors), and scattered back.  Multi-exon walks run in ``ops/device_walk``.

Each stage of the step runs inside a ``torch.profiler.record_function``
span named ``cm.<stage>`` (no cost unless a profiler is recording), so a
profile of the map attributes device time to the stages.

Reference semantics written out explicitly: every gather index is clamped
into range before use (JAX clamps, torch would raise), the pool scatters
write their discarded rows to one sink slot that is then dropped, and every
intermediate stays int32.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

import torch
from torch.profiler import record_function

from ..config import (CONCRD, DISCRD, CHIORF, CHIBSJ, CHI2BSJ, CONGEN,
                      CHIFUS, CONGNM, OEA2, CANDID, OEANCH, ORPHAN,
                      NOPROC_MANYHIT, NOPROC_NOMATCH, INF, MAXDISCRDTLEN,
                      LARIAT2BEGTH)
from . import _ext
from .align_device import one_side_batch
from .device_walk import FOLD_OUT, KEYS, fold_result, tiny_dp
from .pallas_align import POS, xdrop_batch

_i32 = torch.int32
NEG_SCORE = -INF
I32MAX = 2 ** 31 - 1  # device stand-in for MAXUB (positions < 2^31)

MRF = 20  # field count, layout = ops/filter_native.py MR_FIELDS

# defer-cause bits: the fused step returns an int32 bitmask per read
# (0 = finished on the device); the pipeline histograms them
DEF_OCC = 1 << 0        # seed occupancy > cap
DEF_EXTRACT = 1 << 1    # k-best extraction incomplete (> EX_ITERS events)
DEF_NCHAIN = 1 << 2     # more chains than KB budget
DEF_OSPOOL = 1 << 3     # one-sided DP pool overflow
DEF_XDPOOL = 1 << 4     # x-drop DP pool overflow
DEF_PANNO = 1 << 5      # annotation padding overflow on pair intervals
DEF_UNION = 1 << 6      # candidate pair count > P_MAX
DEF_EXTWALK = 1 << 7    # multi-exon extension walk
DEF_MMANNO = 1 << 8     # annotation padding overflow on final coords
DEF_SCTIE = 1 << 9      # orientation score tie (f64 hazard)
DEF_TLENWALK = 1 << 10  # calc_tlen walk > W_MAX intervals
DEF_CTPOOL = 1 << 11    # calc_tlen pool overflow
DEF_EXTENT = 1 << 12    # a DP row longer than the pools' windows (I - 1)

DEFER_CAUSES = ["occ", "extract", "nchain", "ospool", "xdpool", "panno",
                "union", "extwalk", "mmanno", "sctie", "tlenwalk",
                "ctpool", "extent"]

MR_KEYS = ("type", "spos_r1", "epos_r1", "qspos_r1", "qepos_r1", "mlen_r1",
           "ed_r1", "r1_fwd", "spos_r2", "epos_r2", "qspos_r2", "qepos_r2",
           "mlen_r2", "ed_r2", "r2_fwd", "tlen", "junc", "gm", "chr",
           "contig")


# --------------------------------------------------------------------------
# small device helpers
# --------------------------------------------------------------------------

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


def _bisect_le(sorted_arr, x):
    """Index of the last element <= x (or -1); sorted_arr int32 [N],
    non-decreasing (both callers' arrays are by construction), x int32
    [...].  One searchsorted: the reference's bisect loop finds the same
    index on a non-decreasing array.  An empty array raises, as the
    reference's gather does."""
    if sorted_arr.shape[0] == 0:
        raise ValueError("_bisect_le needs a non-empty sorted array")
    return torch.searchsorted(sorted_arr, x.contiguous(), right=True,
                              out_int32=True) - 1


def _overlap_ind(ad, fa, pos):
    """get_location_overlap_ind (annotation.py:273-291): returns
    (iv or -1, raw ind).  iv == -1 also when the seg list is empty."""
    n_iv = ad.iv_spos.shape[0]
    raw = _bisect_le(ad.iv_spos, pos)
    c = torch.clamp(raw, 0, n_iv - 1).long()
    ok = (raw >= 0) & (ad.iv_epos[c] >= pos) & (fa.iv_nseg_true[c] > 0)
    return torch.where(ok, raw, -1), raw


def _bit(bits, pos):
    p = torch.clamp(pos, 0, bits.shape[0] * 8 - 1)
    return ((bits[(p >> 3).long()].to(_i32) >> (p & 7)) & 1).bool()


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


def _tiny_global(s, t, n, m, NMAX, MMAX):
    """Full (unbanded) edit DP for tiny shapes (the oracle's n <= w
    fallback, ops/align.py:112-114).  s [B, NMAX], t [B, MMAX]."""
    B = s.shape[0]
    j_io = torch.arange(MMAX + 1, dtype=_i32, device=s.device)[None, :]
    row = torch.where(j_io <= m[:, None], j_io.expand(B, MMAX + 1), POS)
    for i in range(1, NMAX + 1):
        si = s[:, i - 1]
        prev = row
        cols = [torch.where(i <= n, i, POS).to(_i32)]            # dp[i][0]
        for j in range(1, MMAX + 1):
            tj = t[:, j - 1]
            mis = ((si != tj) | (si >= 4) | (tj >= 4)).to(_i32)
            v = torch.minimum(prev[:, j - 1] + mis,
                              torch.minimum(prev[:, j] + 1, cols[j - 1] + 1))
            cols.append(torch.where((i <= n) & (j <= m), v, POS))
        row = torch.where((i <= n)[:, None], torch.stack(cols, dim=1), row)
    return _last(row, torch.clamp(m, 0, MMAX))


def _one_side_pool(s, t, n, m, wv, I, *, w):
    """Exact global_one_side_banded_alignment over a packed pool, for every
    shape the oracle covers (align.py:108-125): n > w -> the ``one_side``
    kernel, n <= w -> the full tiny DP (``tiny_dp``, ``_tiny_global``'s
    4 x 8; w <= 3, m = n + w <= n + 3).  Every
    row's wv must lie in [0, w], the kernel's bound."""
    n, m = n.to(_i32).contiguous(), m.to(_i32).contiguous()
    wv = wv.to(_i32).contiguous()
    s, t = s.contiguous(), t.contiguous()
    banded = one_side_batch(s, t, n, m, wv, w=w, I=I)
    return tiny_dp(s, t, n, m, n <= wv, banded, NM=4, MM=8, end=False)


def _drop_wrap(score, on_s, on_t, m, *, mat, mis, w, max_ed, max_sc, left):
    """Device form of pallas_align.drop_local_sc_batch (align.cpp:669-723)."""
    mx = torch.maximum(on_s, on_t)
    ed = torch.div(mat * mx - score, mat - mis, rounding_mode="floor")
    indel = on_t - on_s
    clip = m - on_t
    ok = ed <= max_ed
    if not left:
        ok = ok & (score >= 0)
    out_ed = torch.where(ok, ed, max_ed + 1)
    out_sclen = torch.where(ok, clip, torch.clamp(m, min=max_sc) + 1)
    out_indel = torch.where(ok, indel, w + 1)
    return out_ed, out_sclen, out_indel, score


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


# --------------------------------------------------------------------------
# AlignRes algebra (extend.py:123-187) in struct-of-arrays form
# --------------------------------------------------------------------------

def _ares(pos, ed, sclen, indel, qcov, score):
    return dict(pos=pos, ed=ed, sclen=sclen, indel=indel, qcov=qcov,
                score=score)


def _ares_where(c, a, b):
    return {k: torch.where(c, a[k], b[k]) for k in a}


def _upd_by_score(best, cand, left: bool):
    """update_by_score_right/left (extend.py:152-160): returns
    (updated_best, did_update)."""
    pos_better = (cand["pos"] > best["pos"]) if left \
        else (cand["pos"] < best["pos"])
    better = (best["score"] < cand["score"]) | (
        (best["score"] == cand["score"]) & pos_better)
    return _ares_where(better, cand, best), better


# --------------------------------------------------------------------------
# one-sided extension core (extend.py extend_left_g/extend_right_g)
# --------------------------------------------------------------------------

def _extend_core(pos, length, ed_th, bound, has_tids, iv_ok, exon_len,
                 walk_dp, walk_ok, gen_dp, gen_ok, *, left: bool,
                 max_sc: int, band: int, eng=None):
    """All inputs [N] vectors; *_dp dicts with ed/sclen/indel/score.
    walk_ok/gen_ok: the DP ran (window in genome bounds).  Returns
    (ok, new_pos, best, defer).  Mirrors extend.cpp:285-432.

    The covered-first-interval regime (the anchor exon covers the whole
    remain window, so one pooled DP serves every tid) is handled inline;
    multi-exon walks arrive through ``eng``, the walk engine's folded
    result.  With eng=None (the leftover chain-level extends, which pass no
    transcripts) those lanes defer.  `bound` is lb (left) / ub (right)."""
    orig = pos
    zero = torch.zeros_like(pos)
    best = _ares(pos, ed_th + 1, length + 1, torch.full_like(pos, band + 1),
                 zero, zero)
    covered = iv_ok & (exon_len >= length)
    walk_active = has_tids & iv_ok & (length > 0)
    if eng is None:
        defer = walk_active & ~covered
    else:
        defer = eng["active"] & eng["defer"]
    # gate (extend.cpp:403/510): bound check decides walk DP vs fallback
    gate_ok = (pos >= bound + length) if left else (pos + length <= bound)
    do_walk = walk_active & covered & gate_ok
    consecutive = do_walk
    # walk end-DP acceptance (_extend_*_end_g, curr.ed = 0)
    w_gate = do_walk & walk_ok & (walk_dp["ed"] <= ed_th) \
        & (walk_dp["sclen"] <= max_sc) \
        & ((length - walk_dp["sclen"]) >= walk_dp["sclen"])
    new_p = (pos - length + walk_dp["indel"]) if left \
        else (pos + length - walk_dp["indel"])
    curr = _ares(new_p, walk_dp["ed"], walk_dp["sclen"], walk_dp["indel"],
                 torch.where(w_gate, length, 0), walk_dp["score"])
    upd, _ = _upd_by_score(best, curr, left)
    best = _ares_where(w_gate, upd, best)
    if eng is not None:
        ea = eng["active"]
        best = _ares_where(ea, eng["best"], best)
        consecutive = consecutive | (ea & eng["consec"])

    # wrap-up stage 1 (extend.cpp:316-324)
    st1 = best["ed"] <= ed_th
    p1 = (best["pos"] + best["sclen"]) if left \
        else (best["pos"] - best["sclen"])
    pos_out = torch.where(st1, p1, orig)
    ret1 = st1 & (best["qcov"] >= length) & (best["sclen"] <= max_sc)
    ok_out = ret1
    done = ret1

    # intron retention / plain genomic (extend.cpp:326-341)
    g_try = ~done & ~consecutive & gen_ok & (length > 0)
    g_gate = g_try & (gen_dp["ed"] <= ed_th) & (gen_dp["sclen"] <= max_sc)
    gp = (orig - length + gen_dp["indel"]) if left \
        else (orig + length - gen_dp["indel"])
    cur2 = _ares(gp, gen_dp["ed"], gen_dp["sclen"], gen_dp["indel"],
                 torch.where(g_gate, length, 0), gen_dp["score"])
    upd2, took2 = _upd_by_score(best, cur2, left)
    g_hit = g_gate & took2
    best = _ares_where(g_hit, upd2, best)
    gpos = (orig - length + gen_dp["indel"] + gen_dp["sclen"]) if left \
        else (orig + length - gen_dp["indel"] - gen_dp["sclen"])
    pos_out = torch.where(g_hit, gpos, pos_out)
    ok_out = ok_out | g_hit
    done = done | g_hit

    # tail wrap-up (extend.cpp:343-356)
    z = ~done & (best["qcov"] <= 0)
    pos_out = torch.where(z, orig, pos_out)
    best = _ares_where(z, _ares(pos_out, zero, zero, zero, zero,
                                torch.full_like(pos, NEG_SCORE)), best)
    qrem = length - best["qcov"]
    sc_fit = ~done & (qrem + best["sclen"] <= max_sc)
    best = _ares_where(
        sc_fit, _ares(pos_out, best["ed"], best["sclen"] + qrem,
                      best["indel"], length, best["score"]), best)
    ok_out = ok_out | sc_fit
    done = done | sc_fit
    ok_out = torch.where(~done, (best["qcov"] >= length)
                         & (best["ed"] <= ed_th), ok_out)
    # remain == 0: untouched best, ok (extend.py:637,666)
    triv = length <= 0
    ok_out = ok_out | triv
    pos_out = torch.where(triv, orig, pos_out)
    best = _ares_where(triv, _ares(torch.broadcast_to(bound, pos.shape),
                                   zero, zero, zero, zero,
                                   torch.full_like(pos, NEG_SCORE)), best)
    defer = defer & (length > 0)
    return ok_out, pos_out, best, defer


def _extend_core_flat(pos, length, ed_th, bound, has_tids, iv_ok, exon_len,
                      walk_dp, walk_ok, gen_dp, gen_ok, eng=None, **kw):
    """_extend_core on flattened operands (the core is elementwise)."""
    shp = pos.shape

    def f(x):
        return torch.broadcast_to(x, shp).reshape(-1)

    def fd(d):
        return {kk: f(v) for kk, v in d.items()}

    if eng is not None:
        eng = dict(active=f(eng["active"]), best=fd(eng["best"]),
                   consec=f(eng["consec"]), defer=f(eng["defer"]))
    ok, p, best, df = _extend_core(f(pos), f(length), f(ed_th), f(bound),
                                   f(has_tids), f(iv_ok), f(exon_len),
                                   fd(walk_dp), f(walk_ok), fd(gen_dp),
                                   f(gen_ok), eng=eng, **kw)
    return (ok.reshape(shp), p.reshape(shp),
            {kk: v.reshape(shp) for kk, v in best.items()}, df.reshape(shp))


# the four fields of an end / genomic DP result, in the kernel's order
DP_KEYS = ("ed", "sclen", "indel", "score")


def extend_core(pos, length, ed_th, bound, has_tids, iv, exon_len, covered,
                wx, walk_inb, gen_inb, g_ed, g_sclen, g_indel, g_score, w_ed,
                w_sclen, w_indel, w_score, fold, over, act, *, fam: int,
                left: bool, max_sc: int, band: int):
    """One extend family of phase 2 (``_extend_core`` with the walk
    engine's fold, extend.cpp:285-432; the reference's run_side,
    circminer_tpu/ops/device_full.py:1060-1085) over the [B, 2, P] pair
    slots, reading the side bundle's fields as they are: pos, length,
    ed_th, bound, iv, exon_len int32 and has_tids, covered, wx, walk_inb,
    gen_inb bool [B, 2, P]; g_* / w_* the genomic and walk end DPs' four
    DP_KEYS fields, int32 [B, 2, P] each; fold the family's ``walk_fold``
    output, int32 [len(FOLD_OUT), B * 2 * P]; over bool [4 * B * 2 * P]
    and act bool [4, B, 2, P] the walk's pool overflow and lane masks.
    Returns (ok bool [B, 2, P], pos int32 [B, 2, P], best int32
    [len(KEYS), B, 2, P], defer bool [B, 2, P]).  On a CPU tensor its plain version
    (``_extend_core_plain``); on a CUDA tensor the ``extend_core`` kernel
    (csrc/extend.cu), or a raise."""
    ins = (pos, length, ed_th, bound, has_tids, iv, exon_len, covered, wx,
           walk_inb, gen_inb, g_ed, g_sclen, g_indel, g_score, w_ed, w_sclen,
           w_indel, w_score, fold, over, act)
    kw = dict(fam=fam, left=left, max_sc=max_sc, band=band)
    if not pos.is_cuda:
        return _extend_core_plain(*ins, **kw)
    dev, shp = pos.device, pos.shape
    ok = torch.empty(shp, dtype=torch.bool, device=dev)
    pos_out = torch.empty(shp, dtype=_i32, device=dev)
    best = torch.empty((len(KEYS), *shp), dtype=_i32, device=dev)
    defer = torch.empty(shp, dtype=torch.bool, device=dev)
    N = pos.numel()
    if N:
        _ext.launch_tensors(
            "extend_core", extend_core_args(*ins, ok, pos_out, best, defer),
            (N, fam, int(left), max_sc, band))
    return ok, pos_out, best, defer


def extend_core_args(pos, length, ed_th, bound, has_tids, iv, exon_len,
                     covered, wx, walk_inb, gen_inb, g_ed, g_sclen, g_indel,
                     g_score, w_ed, w_sclen, w_indel, w_score, fold, over,
                     act, ok, pos_out, best, defer):
    """The (tensor, dtype, shape) arguments of the ``extend_core`` kernel,
    in its order."""
    shp = tuple(pos.shape)
    N = pos.numel()
    i32, b8 = _i32, torch.bool
    return [(pos, i32, shp), (length, i32, shp), (ed_th, i32, shp),
            (bound, i32, shp), (has_tids, b8, shp), (iv, i32, shp),
            (exon_len, i32, shp), (covered, b8, shp), (wx, b8, shp),
            (walk_inb, b8, shp), (gen_inb, b8, shp),
            *((x, i32, shp) for x in (g_ed, g_sclen, g_indel, g_score, w_ed,
                                       w_sclen, w_indel, w_score)),
            (fold, i32, (len(FOLD_OUT), N)), (over, b8, (4 * N,)),
            (act, b8, (4, *shp)), (ok, b8, shp), (pos_out, i32, shp),
            (best, i32, (len(KEYS), *shp)), (defer, b8, shp)]


def _extend_core_plain(pos, length, ed_th, bound, has_tids, iv, exon_len,
                       covered, wx, walk_inb, gen_inb, g_ed, g_sclen,
                       g_indel, g_score, w_ed, w_sclen, w_indel, w_score,
                       fold, over, act, *, fam, left, max_sc, band):
    """The plain version of ``extend_core``: the walk DP picked by wx, the
    fold's rows as the engine's result, then ``_extend_core_flat``, its
    best stacked in KEYS order."""
    shp = pos.shape
    gen = dict(zip(DP_KEYS, (g_ed, g_sclen, g_indel, g_score)))
    walk = _ares_where(wx, dict(zip(DP_KEYS, (w_ed, w_sclen, w_indel,
                                              w_score))), gen)
    walk_ok = covered & torch.where(wx, walk_inb, gen_inb)
    best, consec, defer = fold_result(fold, over, fam, shp)
    eng = dict(active=act[fam], best=best, consec=consec, defer=defer)
    ok, pos_out, best, defer = _extend_core_flat(
        pos, length, ed_th, bound, has_tids, iv >= 0, exon_len, walk,
        walk_ok, gen, gen_inb, eng=eng, left=left, max_sc=max_sc, band=band)
    return ok, pos_out, torch.stack([best[kk] for kk in KEYS]), defer


def extend_leftover(rp4, qp4, pos_r, remain_end, est_mid, genL_inb,
                    genR_inb, dp_ed, dp_sclen, dp_indel, dp_score, *,
                    max_ed: int, max_sc: int, band: int):
    """The leftover chain-level extends (extend.cpp:131-213; the
    reference's two ``_extend_core_flat`` calls in device_full_finish,
    circminer_tpu/ops/device_full.py:1353-1370) over the [B, 4, KB1]
    chains: the left extend from pos_l = rp4[..., 0] over remain_beg =
    qp4[..., 0] against lb 0, then the right one from pos_r over
    remain_end against ub I32MAX, whose ed_th is what the left one left
    of max_ed - est_mid.  Neither passes transcripts (has_tids false), so
    each reads only its genomic DP (side s, variant 0 of the phase-1 DP
    fields dp_* int32 [B, 4, KB1, 2, 2]) and its genL_inb / genR_inb.
    Returns (ok bool [2, B, 4, KB1], pos int32 [2, B, 4, KB1], best int32
    [2, len(KEYS), B, 4, KB1]), left then right.  On a CPU tensor its plain
    version (``_extend_leftover_plain``); on a CUDA tensor the
    ``extend_leftover`` kernel (csrc/extend.cu), or a raise."""
    kw = dict(max_ed=max_ed, max_sc=max_sc, band=band)
    if not pos_r.is_cuda:
        return _extend_leftover_plain(rp4, qp4, pos_r, remain_end, est_mid,
                                      genL_inb, genR_inb, dp_ed, dp_sclen,
                                      dp_indel, dp_score, **kw)
    dev, shp = pos_r.device, pos_r.shape
    ok = torch.empty((2, *shp), dtype=torch.bool, device=dev)
    pos = torch.empty((2, *shp), dtype=_i32, device=dev)
    best = torch.empty((2, len(KEYS), *shp), dtype=_i32, device=dev)
    N = pos_r.numel()
    if N:
        _ext.launch_tensors(
            "extend_leftover", extend_leftover_args(
                rp4, qp4, pos_r, remain_end, est_mid, genL_inb, genR_inb,
                dp_ed, dp_sclen, dp_indel, dp_score, ok, pos, best),
            (N, rp4.shape[-1], max_ed, max_sc, band))
    return ok, pos, best


def extend_leftover_args(rp4, qp4, pos_r, remain_end, est_mid, genL_inb,
                         genR_inb, dp_ed, dp_sclen, dp_indel, dp_score, ok,
                         pos, best):
    """The (tensor, dtype, shape) arguments of the ``extend_leftover``
    kernel, in its order."""
    shp = tuple(pos_r.shape)
    i32, b8 = _i32, torch.bool
    return [(rp4, i32, (*shp, rp4.shape[-1])),
            (qp4, i32, (*shp, rp4.shape[-1])), (pos_r, i32, shp),
            (remain_end, i32, shp), (est_mid, i32, shp),
            (genL_inb, b8, shp), (genR_inb, b8, shp),
            *((x, i32, (*shp, 2, 2))
              for x in (dp_ed, dp_sclen, dp_indel, dp_score)),
            (ok, b8, (2, *shp)), (pos, i32, (2, *shp)),
            (best, i32, (2, len(KEYS), *shp))]


def _extend_leftover_plain(rp4, qp4, pos_r, remain_end, est_mid, genL_inb,
                           genR_inb, dp_ed, dp_sclen, dp_indel, dp_score, *,
                           max_ed, max_sc, band):
    """The plain version of ``extend_leftover``: the reference's two
    ``_extend_core_flat`` calls.  With has_tids false neither reads iv_ok
    or exon_len (no walk is active), so both pass false and 0."""
    shp = pos_r.shape
    dev = pos_r.device
    no = torch.zeros(shp, dtype=torch.bool, device=dev)
    zero = torch.zeros(shp, dtype=_i32, device=dev)
    dps = (dp_ed, dp_sclen, dp_indel, dp_score)
    gl = {f: x[..., 0, 0] for f, x in zip(DP_KEYS, dps)}
    gr = {f: x[..., 1, 0] for f, x in zip(DP_KEYS, dps)}
    kw = dict(max_sc=max_sc, band=band)
    lok, spos, bl, _ = _extend_core_flat(
        rp4[..., 0], qp4[..., 0], max_ed - est_mid, zero, no, no, zero, gl,
        no, gl, genL_inb, left=True, **kw)
    rok, epos, br, _ = _extend_core_flat(
        pos_r, remain_end, max_ed - est_mid - bl["ed"],
        torch.full(shp, I32MAX, dtype=_i32, device=dev), no, no, zero, gr,
        no, gr, genR_inb, left=False, **kw)
    return (torch.stack([lok, rok]), torch.stack([spos, epos]),
            torch.stack([torch.stack([b[kk] for kk in KEYS])
                         for b in (bl, br)]))


# --------------------------------------------------------------------------
# mr-state algebra (types.py MatchedRead.update / go_for_update)
# --------------------------------------------------------------------------

def _mm_ed(mm):
    return mm["led"] + mm["med"] + mm["red"]


def _go_for_update(mr, sm, lm, tlen, gm, type_, *, bsj_order):
    """common.cpp:362-411; mr dict of [B] vectors."""
    ed = _mm_ed(sm) + _mm_ed(lm)
    mlen = sm["mlen"] + lm["mlen"]
    mr_ed = mr["ed_r1"] + mr["ed_r2"]
    mr_ml = mr["mlen_r1"] + mr["mlen_r2"]
    lt = type_ < mr["type"]
    gt = type_ > mr["type"]
    eq = ~lt & ~gt
    mr_gm = mr["gm"] != 0
    gm_win = gm & ~mr_gm
    gm_lose = ~gm & mr_gm
    if bsj_order:   # type_ >= CHIBSJ: mlen first, then ed
        rest = (mr_ml < mlen) | (~(mr_ml > mlen) & (mr_ed > ed))
    else:
        k2_win = mr["tlen"] > tlen
        k2_lose = mr["tlen"] < tlen
        rest = (mr_ed > ed) | (~(mr_ed < ed) & (
            k2_win | (~k2_lose & (mr_ml < mlen))))
    return lt | (eq & (gm_win | (~gm_win & ~gm_lose & rest)))


def _mr_update(mr, sm, lm, chr_idx, shift, tlen, jun, gm, type_, r1_sm,
               contig_num, apply_mask):
    """common.cpp:286-351: conditional best-mapping update."""
    bsj = _go_for_update(mr, sm, lm, tlen, gm, type_, bsj_order=True)
    lin = _go_for_update(mr, sm, lm, tlen, gm, type_, bsj_order=False)
    go = torch.where(type_ >= CHIBSJ, bsj, lin) & apply_mask
    a = {k: torch.where(r1_sm, sm[k], lm[k]) for k in sm}
    b = {k: torch.where(r1_sm, lm[k], sm[k]) for k in sm}
    new = dict(
        type=type_, chr=chr_idx,
        spos_r1=a["spos"] - shift, epos_r1=a["epos"] - shift,
        qspos_r1=a["qspos"], qepos_r1=a["qepos"], mlen_r1=a["mlen"],
        ed_r1=_mm_ed(a),
        spos_r2=b["spos"] - shift, epos_r2=b["epos"] - shift,
        qspos_r2=b["qspos"], qepos_r2=b["qepos"], mlen_r2=b["mlen"],
        ed_r2=_mm_ed(b),
        r1_fwd=(a["dir"] > 0).to(_i32), r2_fwd=(b["dir"] > 0).to(_i32),
        tlen=tlen, junc=jun, gm=gm.to(_i32),
        contig=torch.full_like(mr["contig"], contig_num))
    return {k: torch.where(go, new[k], mr[k]) for k in mr}


def _mr_update_type(mr, type_, apply_mask):
    out = dict(mr)
    out["type"] = torch.where((type_ < mr["type"]) & apply_mask, type_,
                              mr["type"])
    return out


# --------------------------------------------------------------------------
# annotation relations on padded device tensors (utils.cpp:322-664)
# --------------------------------------------------------------------------

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


def _same_gene_iv(ad, fa, iv_a, iv_b):
    """utils.cpp:605-615: shared gene id between two interval seg lists."""
    n = fa.seg_gene_p.shape[0] - 1
    ca = torch.clamp(iv_a, 0, n).long()
    cb = torch.clamp(iv_b, 0, n).long()
    ga, gb = fa.seg_gene_p[ca], fa.seg_gene_p[cb]
    pa = _seg_valid(ad, ca, ga.shape[-1]) & (ga >= 0)
    pb = _seg_valid(ad, cb, gb.shape[-1]) & (gb >= 0)
    eq = (ga[..., :, None] == gb[..., None, :]) & pa[..., :, None] \
        & pb[..., None, :]
    return (iv_a >= 0) & (iv_b >= 0) & eq.flatten(-2).any(dim=-1)


def _same_exon(ad, fa, iv_a, iv_b):
    """Identical (start, end) seg across the two lists (common.cpp:128)."""
    n = fa.seg_start_p.shape[0] - 1
    ca = torch.clamp(iv_a, 0, n).long()
    cb = torch.clamp(iv_b, 0, n).long()
    sa, ea = fa.seg_start_p[ca], ad.seg_end[ca]
    sb, eb = fa.seg_start_p[cb], ad.seg_end[cb]
    pa = _seg_valid(ad, ca, sa.shape[-1])
    pb = _seg_valid(ad, cb, sb.shape[-1])
    eq = ((sa[..., :, None] == sb[..., None, :])
          & (ea[..., :, None] == eb[..., None, :])
          & pa[..., :, None] & pb[..., None, :])
    return (iv_a >= 0) & (iv_b >= 0) & eq.flatten(-2).any(dim=-1)


def _calc_tlen(ad, fa, sm_iv_e, sm_ind_e, sm_epos, sm_mlen,
               lm_iv_s, lm_ind_s, lm_spos, lm_mlen, *, W_MAX: int):
    """utils.cpp:53-113 over [B] vectors.  Returns (tlen, intron_num,
    defer); defer when a walk exceeds W_MAX intervals.  All ST candidate
    transcripts and all W_MAX walk steps evaluate in one [ST, W_MAX, B]
    pass; the first-transcript-wins minimum is a first-occurrence argmin."""
    dev = sm_iv_e.device
    NIV = ad.iv_spos.shape[0]
    ST = fa.iv_tids.shape[1]
    NT = fa.trans_start.shape[0]
    NS = fa.t2s_state.shape[0]
    ivc = torch.clamp(sm_iv_e, 0, NIV - 1).long()
    tids_T = fa.iv_tids[ivc].T                            # [ST, B]
    defer0 = (sm_iv_e >= 0) & (fa.iv_ntid[ivc] > ST)

    tc = torch.clamp(tids_T, 0, NT - 1).long()
    act = (sm_iv_e[None, :] >= 0) & (tids_T >= 0)
    start_ind = fa.trans_start[tc]                        # [ST, B]
    start_ti = sm_ind_e[None, :] - start_ind
    off = fa.t2s_off[tc]
    t2s_len = fa.t2s_off[tc + 1] - off
    end_ti = lm_ind_s[None, :] - start_ind
    st_end = torch.where(
        (end_ti >= 0) & (end_ti < t2s_len),
        fa.t2s_state[torch.clamp(off + end_ti, 0, NS - 1).long()].to(_i32),
        0)
    act = act & (start_ti >= 0) & (lm_ind_s[None, :] >= start_ind) \
        & (end_ti < t2s_len) & (st_end != 0)
    same_iv = start_ti == end_ti
    tl_same = (lm_spos - sm_epos + 1)[None, :]
    nsteps = end_ti - start_ti - 1
    defer = defer0 | (act & ~same_iv & (nsteps > W_MAX)).any(dim=0)

    # the walk start_ti+1 .. end_ti-1 over [ST, W_MAX, B]; the visited
    # interval (and its length) depends only on kk, not on the transcript
    kk = torch.arange(W_MAX, dtype=_i32, device=dev)
    this_iv = torch.clamp(sm_ind_e[None, :] + 1 + kk[:, None], 0,
                          NIV - 1).long()                 # [W, B]
    ivlen = ad.iv_epos[this_iv] - ad.iv_spos[this_iv] + 1
    kk3 = kk[None, :, None]
    on = act[:, None, :] & ~same_iv[:, None, :] & (kk3 < nsteps[:, None, :])
    row = start_ti[:, None, :] + 1 + kk3
    ok_row = on & (row >= 0) & (row < t2s_len[:, None, :])
    stt = torch.where(
        ok_row, fa.t2s_state[torch.clamp(off[:, None, :] + row, 0,
                                         NS - 1).long()].to(_i32), 0)
    has = on & (stt != 0)
    tl_walk = torch.where(has, ivlen[None, :, :], 0).sum(dim=1, dtype=_i32)
    # intron count = number of zero-state runs in the active prefix
    z = on & (stt == 0)
    zprev = torch.cat([torch.zeros_like(z[:, :1, :]), z[:, :-1, :]], dim=1)
    inn = (z & ~zprev).sum(dim=1, dtype=_i32)             # [ST, B]

    tl0 = (ad.iv_epos[ivc] - sm_epos + 1)[None, :]
    lmc = torch.clamp(lm_iv_s, 0, NIV - 1).long()
    tl = tl0 + tl_walk + (lm_spos - ad.iv_spos[lmc] + 1)[None, :]
    tlen_t = torch.where(same_iv, tl_same, tl)
    inn_t = torch.where(same_iv, 0, inn)

    min_tlen = torch.where(act, tlen_t, INF).amin(dim=0)  # [B]
    hit = act & (tlen_t == min_tlen[None, :]) & (min_tlen[None, :] < INF)
    iota_t = torch.arange(ST, dtype=_i32, device=dev)[:, None]
    first = torch.where(hit, iota_t, ST).amin(dim=0)      # [B]
    best_in = torch.where(iota_t == first[None, :], inn_t, 0).sum(
        dim=0, dtype=_i32)
    found = min_tlen < INF
    tlen = torch.where(found, min_tlen + sm_mlen - 1 + lm_mlen - 1, -1)
    return tlen, best_in, defer


# --------------------------------------------------------------------------
# phase 1: chain-level geometry and the two compacted DP pools
# --------------------------------------------------------------------------

def _phase1(seqs, lens, hh, rp, qp, cl, sc10, cn, inc, mr_in,
            genome, ad, fa, *, k, max_ed, max_sc, band,
            KB, OS_POOL, XD_POOL, mat, mis, ind, xd, I=128):
    """Chain-level geometry + the one-sided (``one_side``) and X-drop
    (``xdrop``) pools.  Returns the staging dict of the later phases."""
    R4, L = seqs.shape
    B = R4 // 4
    dev = seqs.device
    NL = rp.shape[2]
    NLm1 = NL - 1
    G = genome.shape[0]
    KB1 = cl.shape[1]          # KB + 1
    rp4 = rp.reshape(B, 4, KB1, NL)
    qp4 = qp.reshape(B, 4, KB1, NL)
    cl4 = cl.reshape(B, 4, KB1)
    sc4 = sc10.reshape(B, 4, KB1)
    cn4 = cn.reshape(B, 4)
    hh4 = hh.reshape(B, 4)
    lens4 = lens.reshape(B, 4)
    seqsf = seqs.reshape(-1)    # [4B * L]

    # defer is an int32 cause bitmask (DEFER_CAUSES); nonzero -> the read
    # replays on the host path
    defer = (DEF_EXTRACT * inc.reshape(B, 4).any(dim=1).to(_i32)
             | DEF_NCHAIN * (cn4 > KB).any(dim=1).to(_i32))

    # ---- chain-level geometry ----------------------------------------
    ci = torch.arange(KB1, device=dev)[None, None, :]
    valid = ci < cn4[:, :, None]                                # [B,4,KB1]
    clen = cl4
    q0 = qp4[..., 0]
    r0 = rp4[..., 0]
    last_i = torch.clamp(clen - 1, 0, NL - 1)
    lastq = _last(qp4, last_i)
    lastr = _last(rp4, last_i)
    remain_beg = q0
    remain_end = lens4[:, :, None] - (lastq + k)
    pos_l = r0
    pos_r = lastr + k - 1
    iv_l, _ = _overlap_ind(ad, fa, pos_l)
    iv_r, _ = _overlap_ind(ad, fa, pos_r)
    NIV = ad.iv_spos.shape[0]
    exon_len_l = torch.where(
        iv_l >= 0, pos_l - ad.iv_spos[torch.clamp(iv_l, 0, NIV - 1).long()],
        0)
    exon_len_r = torch.where(
        iv_r >= 0, ad.iv_epos[torch.clamp(iv_r, 0, NIV - 1).long()] - pos_r,
        0)
    genL_len = remain_beg + band
    genR_len = remain_end + band
    # genome.get bounds (1-based; extend.py:197-200)
    genL_inb = (pos_l - genL_len >= 1) & (pos_l - 1 <= G)
    genR_inb = (pos_r + 1 >= 1) & (pos_r + genR_len <= G)
    walkL_len = torch.minimum(genL_len, exon_len_l)
    walkR_len = torch.minimum(genR_len, exon_len_r)
    covered_l = (iv_l >= 0) & (exon_len_l >= remain_beg)
    covered_r = (iv_r >= 0) & (exon_len_r >= remain_end)
    wxL = covered_l & (walkL_len < genL_len) & (remain_beg > 0)
    wxR = covered_r & (walkR_len < genR_len) & (remain_end > 0)
    walkL_inb = (pos_l - walkL_len >= 1) & (pos_l - 1 <= G)
    walkR_inb = (pos_r + 1 >= 1) & (pos_r + walkR_len <= G)

    # ---- middle gaps: one-sided DPs (calc_middle_ed, extend.py:228-256)
    qn, rn = qp4[..., 1:], rp4[..., 1:]
    qprev, rprev = qp4[..., :NLm1], rp4[..., :NLm1]
    frag_ok = valid[..., None] & (
        torch.arange(NLm1, device=dev)[None, None, None, :]
        < (clen - 1)[..., None])
    gqlen = qn - (qprev + k)
    gdiff = (rn - rprev) - (qn - qprev)
    g_need = frag_ok & (gqlen > 0) & (gdiff.abs() <= band)
    grlen = torch.clamp(gqlen + gdiff, min=0)
    grs0 = rprev + k - 1                   # 0-based ref window start
    g_inb = (rprev + k >= 1) & (grs0 + grlen <= G)
    grlen_eff = torch.where(g_inb, grlen, 0)
    gswap = gdiff < 0
    gw = gdiff.abs()
    gqs = qprev + k                        # in-row query offset
    # estimate_middle_error (utils.cpp:35-49)
    est_c = torch.where(
        (gqlen > 0) & frag_ok,
        torch.where(gdiff == 0, 1,
                    torch.where((gdiff > 0) & (gdiff <= band), gdiff,
                                torch.where((gdiff < 0) & (-gdiff <= band),
                                            -gdiff, 0))), 0)
    est_mid = est_c.sum(dim=-1, dtype=_i32)                    # [B,4,KB1]

    # one_side pool
    os_inv, os_n, os_over = _compact(g_need.reshape(-1), OS_POOL)
    defer = defer | DEF_OSPOOL * os_over.reshape(B, -1).any(dim=1).to(_i32)
    os_l = os_inv.long()

    def flat_g(x):
        return x.reshape(-1)[os_l]

    p_row = os_inv // (KB1 * NLm1)                 # row in [0, 4B)
    p_qs, p_qlen = flat_g(gqs), flat_g(gqlen)
    p_rs0, p_rlen = flat_g(grs0), flat_g(grlen_eff)
    # pool rows past os_n gather an arbitrary slot (_compact), whose |gdiff|
    # the band does not bound: the g_need mask keeps every gathered width
    # in one_side's bound [0, band]; _scatter_pool drops those rows
    p_w = flat_g(torch.where(g_need, gw, 0))
    p_swap = flat_g(gswap)
    io = torch.arange(I - 1, dtype=_i32, device=dev)
    qidx = p_row[:, None] * L + p_qs[:, None] + io[None, :]
    q_win = torch.where(io[None, :] < p_qlen[:, None],
                        seqsf[torch.clamp(qidx, 0, R4 * L - 1).long()], 127)
    r_win = _gather_window(genome, p_rs0, p_rlen, I - 1)
    s_buf = torch.where(p_swap[:, None], r_win, q_win)
    t_buf = torch.where(p_swap[:, None], q_win, r_win)
    n_os = torch.where(p_swap, p_rlen, p_qlen)
    m_os = torch.where(p_swap, p_qlen, p_rlen)
    os_res_pool = _one_side_pool(s_buf, t_buf, n_os, m_os, p_w, I, w=band)
    gap_res = _scatter_pool(os_res_pool, os_inv, os_n,
                            B * 4 * KB1 * NLm1).reshape(B, 4, KB1, NLm1)
    contrib = torch.where(g_need, gap_res, 0)
    csum = torch.cumsum(contrib, dim=-1, dtype=_i32)
    exceeded = (csum > max_ed).any(dim=-1)
    mid_dp = torch.where(exceeded, max_ed + 1,
                         torch.clamp(csum[..., -1], max=max_ed + 1))
    mid_dp = torch.where(clen > 0, mid_dp, 0)     # chain_len == 0 -> 0

    # a DP row past the pools' windows of I - 1 bases would be cut: a
    # needed gap's query or reference, or a chain end's reference of
    # remain + band bases (its genomic X-drop row, and the bound of every
    # walk row from that end)
    long_row = (g_need & (torch.maximum(gqlen, grlen) > I - 1)).any(dim=-1) \
        | (valid & (torch.maximum(remain_beg, remain_end) > I - 1 - band))
    defer = torch.where(long_row.reshape(B, -1).any(dim=1),
                        defer | DEF_EXTENT, defer)

    # ---- end/genomic X-drop pool (extend.py:556-623 + wrappers) ------
    # slots [B,4,KB1,2(side: 0=left 1=right),2(var: 0=genomic 1=walk)]
    act_gl = valid & (remain_beg > 0) & genL_inb
    act_gr = valid & (remain_end > 0) & genR_inb
    act_wl = valid & wxL & walkL_inb
    act_wr = valid & wxR & walkR_inb
    xa = torch.stack([torch.stack([act_gl, act_wl], dim=-1),
                      torch.stack([act_gr, act_wr], dim=-1)], dim=-2)
    # per-slot ref window (0-based start, len) and q window (row offset/len)
    rs0_l = torch.stack([pos_l - genL_len - 1, pos_l - walkL_len - 1], -1)
    rlen_l = torch.stack([genL_len, walkL_len], dim=-1)
    rs0_r = torch.stack([pos_r, pos_r], dim=-1)
    rlen_r = torch.stack([genR_len, walkR_len], dim=-1)
    x_rs0 = torch.stack([rs0_l, rs0_r], dim=-2)
    x_rlen = torch.stack([rlen_l, rlen_r], dim=-2)
    x_qs = torch.stack([torch.zeros_like(remain_beg),
                        lens4[:, :, None] - remain_end], dim=-1)
    x_qlen = torch.stack([remain_beg, remain_end], dim=-1)
    x_left = torch.zeros((B, 4, KB1, 2, 2), dtype=torch.bool, device=dev)
    x_left[..., 0, :] = True

    xd_inv, xd_n, xd_over = _compact(xa.reshape(-1), XD_POOL)
    defer = defer | DEF_XDPOOL * xd_over.reshape(B, -1).any(dim=1).to(_i32)
    xd_l = xd_inv.long()
    shp5 = (B, 4, KB1, 2, 2)

    def flat_x(x):
        return torch.broadcast_to(x, shp5).reshape(-1)[xd_l]

    xrow = xd_inv // (KB1 * 4)
    xqs = flat_x(x_qs[..., None])
    xqlen = flat_x(x_qlen[..., None])
    xrs0, xrlen, xleft = flat_x(x_rs0), flat_x(x_rlen), flat_x(x_left)
    # s = ref window, t = q window; left kinds reversed (align_device)
    r_fwd = _gather_window(genome, xrs0, xrlen, I - 1)
    r_rev = _gather_window(genome, xrs0, xrlen, I - 1, reverse=True)
    s_x = torch.where(xleft[:, None], r_rev, r_fwd)
    qi_f = xrow[:, None] * L + xqs[:, None] + io[None, :]
    qi_r = xrow[:, None] * L + xqs[:, None] + (xqlen[:, None] - 1
                                               - io[None, :])
    in_q = io[None, :] < xqlen[:, None]
    q_f = torch.where(in_q, seqsf[torch.clamp(qi_f, 0, R4 * L - 1).long()],
                      127)
    q_r = torch.where(in_q, seqsf[torch.clamp(qi_r, 0, R4 * L - 1).long()],
                      127)
    t_x = torch.where(xleft[:, None], q_r, q_f)
    xsc, xon_s, xon_t = xdrop_batch(s_x.contiguous(), t_x.contiguous(),
                                    xrlen.contiguous(), xqlen.contiguous(),
                                    w=band, mat=mat, mis=mis, ind=ind,
                                    xd=xd, I=I)
    wrap = dict(mat=mat, mis=mis, w=band, max_ed=max_ed, max_sc=max_sc)
    dl = _drop_wrap(xsc, xon_s, xon_t, xqlen, left=True, **wrap)
    dr = _drop_wrap(xsc, xon_s, xon_t, xqlen, left=False, **wrap)
    dp_ed, dp_scl, dp_ind, dp_scr = (
        _scatter_pool(torch.where(xleft, a, b), xd_inv, xd_n,
                      B * 4 * KB1 * 4).reshape(shp5)
        for a, b in zip(dl, dr))

    return dict(
        B=B, NL=NL, KB1=KB1, valid=valid, clen=clen, q0=q0, r0=r0,
        lastq=lastq, lastr=lastr, remain_beg=remain_beg,
        remain_end=remain_end, pos_l=pos_l, pos_r=pos_r, iv_l=iv_l,
        iv_r=iv_r, exon_len_l=exon_len_l, exon_len_r=exon_len_r,
        covered_l=covered_l, covered_r=covered_r, wxL=wxL, wxR=wxR,
        walkL_inb=walkL_inb, walkR_inb=walkR_inb, genL_inb=genL_inb,
        genR_inb=genR_inb, est_mid=est_mid, mid_dp=mid_dp,
        dp=(dp_ed, dp_scl, dp_ind, dp_scr), defer=defer,
        cn4=cn4, hh4=hh4, lens4=lens4,
        rp4=rp4, qp4=qp4, sc4=sc4, mr_in=mr_in,
    )


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


# --------------------------------------------------------------------------
# phase 2: pair-union table + paired extension
# --------------------------------------------------------------------------

SF_NAMES = ("r0", "q0", "lastq", "lastr", "remain_beg", "remain_end",
            "pos_l", "pos_r", "iv_l", "iv_r", "exon_len_l", "exon_len_r",
            "covered_l", "covered_r", "wxL", "wxR", "walkL_inb", "walkR_inb",
            "genL_inb", "genR_inb", "mid_dp", "clen")
SF_BOOL = ("covered_l", "covered_r", "wxL", "wxR", "walkL_inb",
           "walkR_inb", "genL_inb", "genR_inb")
SF_DP = [(side, var, f) for side in (0, 1) for var in (0, 1)
         for f in DP_KEYS]
# pair_grid's per-chain stacks: the int fields (csrc/pair_grid.cu's SfInt),
# then the DP fields in SF_DP's order; the flags in SF_BOOL's.  A mate
# bundle's int fields add the read length and the absolute seqs row.
SF_INT = tuple(n for n in SF_NAMES if n not in SF_BOOL)
MATE_INT = SF_INT + tuple(f"dp{side}{var}_{f}" for side, var, f in SF_DP) \
    + ("seq_len", "arow")
PAIR_SMEM_MAX = 232448     # a CUDA block's opt-in shared memory on sm_90


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


def pair_grid_smem(KB1, NL, ST, SP, P):
    """Bytes of shared memory ``pair_grid``'s kernel stages for a read
    (csrc/pair_grid.cu's pg_smem)."""
    words = 4 * KB1 * (len(MATE_INT) - 2 + 2 * NL + ST + 2 * SP + 3) \
        + ((2 * P + 12 + 3) & ~3)
    nbytes = 4 * KB1 * (len(SF_BOOL) + SP + 1) + 2 * KB1 * KB1 + 2 * P
    return (4 * words + nbytes + 15) // 16 * 16


def pair_grid(sf_i, sf_b, rp4, qp4, cn4, lens4, defer, iv_tids, iv_ntid,
              iv_nseg_true, iv_nseg, seg_gene_p, gene_start, gene_end, *,
              k: int, P: int, SEG_PAD: int):
    """Phase 2's per-read pair work (the reference's ``_phase2``,
    circminer_tpu/ops/device_full.py:861-1000): the [B, 2, KB1, KB1] pair
    grid (i a forward-mate chain in ``_mate_rows``' frows[o], j a
    reverse-mate chain in vrows[o]), its union ranked in row-major order
    into P slots (DEF_UNION past P, DEF_PANNO for a union cell on an
    interval whose lists overflow their pads), the slots' fields,
    ``_is_left_chain`` on each slot's two chains and the l-mate / r-mate
    bundles it selects.  sf_i int32 [B, 4, KB1, len(SF_INT) + 16] and
    sf_b bool [B, 4, KB1, len(SF_BOOL)] the chains' fields; rp4, qp4 int32
    [B, 4, KB1, NL]; cn4, lens4 int32 [B, 4]; defer int32 [B]; the
    annotation's iv_tids [NIV, ST], iv_ntid, iv_nseg_true, iv_nseg [NIV],
    seg_gene_p [NIV, SP], gene_start, gene_end [NG], int32; SEG_PAD the
    annotation's segment pad.  Returns a ``PairGrid``.  On a CPU tensor
    its plain version (``_pair_grid_plain``); on a CUDA tensor the
    ``pair_grid`` kernel (csrc/pair_grid.cu), or a raise."""
    ins = (sf_i, sf_b, rp4, qp4, cn4, lens4, defer, iv_tids, iv_ntid,
           iv_nseg_true, iv_nseg, seg_gene_p, gene_start, gene_end)
    if not sf_i.is_cuda:
        return _pair_grid_plain(*ins, k=k, P=P, SEG_PAD=SEG_PAD)
    B, _, KB1, NL = rp4.shape
    NIV, ST = iv_tids.shape
    SP, NG = seg_gene_p.shape[1], gene_start.shape[0]
    if min(KB1, NL, P, NIV, ST, SP, NG) < 1:
        raise ValueError(f"pair_grid needs non-empty dimensions, got KB1 "
                         f"{KB1}, NL {NL}, P {P}, NIV {NIV}, ST {ST}, SP "
                         f"{SP}, NG {NG}")
    smem = pair_grid_smem(KB1, NL, ST, SP, P)
    if smem > PAIR_SMEM_MAX:
        raise ValueError(f"pair_grid stages {smem} B a read (KB1 {KB1}, NL "
                         f"{NL}, ST {ST}, SP {SP}, P {P}), above a block's "
                         f"{PAIR_SMEM_MAX} B of shared memory")
    if any(x.data_ptr() % 16 for x in (sf_i, sf_b, rp4, qp4)):
        raise ValueError("pair_grid stages sf_i, sf_b, rp4 and qp4 as "
                         "16-byte words: each must start on a 16-byte "
                         "boundary")
    dev, b8 = sf_i.device, torch.bool

    def empty(shape, dtype=_i32):
        return torch.empty(shape, dtype=dtype, device=dev)
    out = PairGrid(
        empty((3, B, 2, KB1, KB1), b8), empty((B, 2, KB1, KB1)),
        empty((2, B, 2, KB1), b8), empty((4, B, 2, P)),
        empty((5, B, 2, P), b8), empty((B, 2)),
        empty((2, len(MATE_INT), B, 2, P)),
        empty((2, len(SF_BOOL), B, 2, P), b8), empty((B,)))
    if B:
        _ext.launch_tensors("pair_grid", pair_grid_args(*ins, *out),
                            (B, KB1, NL, P, k, NIV, ST, SP, SEG_PAD, NG))
    return out


def pair_grid_args(sf_i, sf_b, rp4, qp4, cn4, lens4, defer, iv_tids,
                   iv_ntid, iv_nseg_true, iv_nseg, seg_gene_p, gene_start,
                   gene_end, grid_b, tlen_g, valid, slot_i, slot_b, n_union,
                   mate_i, mate_b, defer_out):
    """The (tensor, dtype, shape) arguments of the ``pair_grid`` kernel, in
    its order."""
    B, _, KB1, NL = rp4.shape
    NIV, ST = iv_tids.shape
    P = slot_i.shape[3]
    i32, b8 = _i32, torch.bool
    return [(sf_i, i32, (B, 4, KB1, len(MATE_INT) - 2)),
            (sf_b, b8, (B, 4, KB1, len(SF_BOOL))),
            (rp4, i32, (B, 4, KB1, NL)), (qp4, i32, (B, 4, KB1, NL)),
            (cn4, i32, (B, 4)), (lens4, i32, (B, 4)), (defer, i32, (B,)),
            (iv_tids, i32, (NIV, ST)), (iv_ntid, i32, (NIV,)),
            (iv_nseg_true, i32, (NIV,)), (iv_nseg, i32, (NIV,)),
            (seg_gene_p, i32, (NIV, seg_gene_p.shape[1])),
            (gene_start, i32, gene_start.shape),
            (gene_end, i32, gene_start.shape),
            (grid_b, b8, (3, B, 2, KB1, KB1)), (tlen_g, i32, (B, 2, KB1, KB1)),
            (valid, b8, (2, B, 2, KB1)), (slot_i, i32, (4, B, 2, P)),
            (slot_b, b8, (5, B, 2, P)), (n_union, i32, (B, 2)),
            (mate_i, i32, (2, len(MATE_INT), B, 2, P)),
            (mate_b, b8, (2, len(SF_BOOL), B, 2, P)), (defer_out, i32, (B,))]


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


def pair_grid_operands(st, ad, fa):
    """``pair_grid``'s tensors from phase 1's staging dict and the
    annotation: the chains' int fields and DP fields stacked in SF_INT,
    SF_DP order, their flags in SF_BOOL order, the fragments, counts,
    read lengths and defer words, and the annotation's tables."""
    B, KB1 = st["B"], st["KB1"]
    sf_i = torch.cat([torch.stack([st[name] for name in SF_INT], dim=-1),
                      torch.stack(st["dp"], dim=-1).reshape(B, 4, KB1, -1)],
                     dim=-1)
    sf_b = torch.stack([st[name] for name in SF_BOOL], dim=-1)
    return (sf_i, sf_b, st["rp4"], st["qp4"], st["cn4"], st["lens4"],
            st["defer"], fa.iv_tids, fa.iv_ntid, fa.iv_nseg_true, ad.iv_nseg,
            fa.seg_gene_p, fa.gene_start, fa.gene_end)


def _phase2(st, ad, fa, seqs, genome, *, k, max_ed, max_sc, band, P_MAX,
            KB, mat, mis, ind, xd, EW, KSCAN, WPP, MIDP, ENDP,
            upto="full"):
    """Pair-union table + pair-level paired extension (filter.cpp:485-551
    + extend.cpp:37-125) over [B, 2, P_MAX].  Multi-exon extension walks
    run through the walk engine (ops/device_walk.py).  upto in ("p2_grid",
    "p2_gath", "p2_walk", "p2_ext") returns the reference's state at that
    cut point instead."""
    from .device_walk import walk_fold_rows, walk_waves

    B = st["B"]
    dev = seqs.device
    NIV, SEG_PAD = ad.iv_spos.shape[0], ad.seg_end.shape[1]

    # the pair grid, its slots, the chain order and the l/r-mate bundles
    # (the reference's :875-1000) in one kernel
    pg = pair_grid(*pair_grid_operands(st, ad, fa), k=k, P=P_MAX,
                   SEG_PAD=SEG_PAD)
    same_tr, sgf, sgr = pg.grid_b.unbind(0)
    tlen_g, n_union, defer = pg.tlen_g, pg.n_union, pg.defer
    fvalid, rvalid = pg.valid.unbind(0)
    fvalid, rvalid = fvalid[..., None], rvalid[..., None, :]
    pcell, p_tlen, p_fiv, p_riv = pg.slot_i.unbind(0)
    pvalid, p_same_tr, p_sgf, p_sgr, fwd_left = pg.slot_b.unbind(0)
    if upto == "p2_grid":
        union = fvalid & rvalid & (same_tr | sgf | sgr
                                   | (tlen_g <= MAXDISCRDTLEN))
        return dict(union=union, same_tr=same_tr, sgf=sgf, sgr=sgr,
                    tlen_g=tlen_g, pvalid=pvalid, pcell=pcell, defer=defer)
    lm_c, rm_c = ({**dict(zip(MATE_INT, mi.unbind(0))),
                   **dict(zip(SF_BOOL, mb.unbind(0)))}
                  for mi, mb in zip(pg.mate_i.unbind(0), pg.mate_b.unbind(0)))

    # extend_both_mates (extend.cpp:37-125)
    l_mid, r_mid = lm_c["mid_dp"], rm_c["mid_dp"]
    success = (l_mid <= max_ed) & (r_mid <= max_ed)
    has_tids = p_same_tr

    if upto == "p2_gath":
        # the forward and reverse mates, from the l/r-mate bundles
        out = dict(defer=defer, fwd_left=fwd_left)
        for kk in ("r0", "q0", "mid_dp", "clen", "dp00_ed", "dp11_score"):
            out["f_" + kk] = torch.where(fwd_left, lm_c[kk], rm_c[kk])
            out["v_" + kk] = torch.where(fwd_left, rm_c[kk], lm_c[kk])
        return out

    # ---- the walk engine: speculative multi-exon walks (extend families
    # 0=l-left 1=r-left 2=r-right 3=l-right, the host extend order
    # extend.cpp:87-95)
    eng_base = pvalid & success & p_same_tr

    def eng_mask(mc, left_side):
        if left_side:
            return eng_base & (mc["iv_l"] >= 0) & (mc["remain_beg"] > 0) \
                & ~mc["covered_l"]
        return eng_base & (mc["iv_r"] >= 0) & (mc["remain_end"] > 0) \
            & ~mc["covered_r"]

    zero3 = torch.zeros((B, 2, P_MAX), dtype=_i32, device=dev)
    act4 = torch.stack([eng_mask(lm_c, True), eng_mask(rm_c, True),
                        eng_mask(rm_c, False), eng_mask(lm_c, False)])
    pos4 = torch.stack([lm_c["pos_l"], rm_c["pos_l"], rm_c["pos_r"],
                        lm_c["pos_r"]])
    len4 = torch.stack([lm_c["remain_beg"], rm_c["remain_beg"],
                        rm_c["remain_end"], lm_c["remain_end"]])
    aiv4 = torch.stack([lm_c["iv_l"], rm_c["iv_l"], rm_c["iv_r"],
                        lm_c["iv_r"]])
    row4 = torch.stack([lm_c["arow"], rm_c["arow"], rm_c["arow"],
                        lm_c["arow"]])
    qs04 = torch.stack([zero3, zero3, rm_c["seq_len"] - rm_c["remain_end"],
                        lm_c["seq_len"] - lm_c["remain_end"]])
    with record_function("cm.walk_waves"):
        wk = walk_waves(act4.reshape(4, -1), pos4.reshape(4, -1),
                        len4.reshape(4, -1), aiv4.reshape(4, -1),
                        row4.reshape(4, -1), qs04.reshape(4, -1),
                        [True, True, False, False], p_fiv, p_riv,
                        seqs.reshape(-1), seqs.shape[1], genome, ad, fa,
                        band=band, max_ed=max_ed, max_sc=max_sc, mat=mat,
                        mis=mis, ind=ind, xd=xd, EW=EW, KSCAN=KSCAN,
                        WPP=WPP, MIDP=MIDP, ENDP=ENDP)
    if upto == "p2_walk":
        return dict(defer=defer, ev=wk["events"], ldef=wk["lane_defer"])

    def run_side(mc, side_left, bound, ed_th, fam):
        with record_function("cm.walk_fold"):
            fold = walk_fold_rows(wk, fam, ed_th, bound, max_ed=max_ed,
                                  max_sc=max_sc, band=band, left=side_left)
        s, tag = (0, "L") if side_left else (1, "R")
        side = tag.lower()
        length = mc["remain_beg"] if side_left else mc["remain_end"]
        ok, pos, best, defer = extend_core(
            mc["pos_" + side], length, ed_th, bound, has_tids,
            mc["iv_" + side], mc["exon_len_" + side], mc["covered_" + side],
            mc["wx" + tag], mc[f"walk{tag}_inb"], mc[f"gen{tag}_inb"],
            *(mc[f"dp{s}{v}_{f}"] for v in (0, 1) for f in DP_KEYS), fold,
            wk["over"], act4,
            fam=fam, left=side_left, max_sc=max_sc, band=band)
        return ok, pos, dict(zip(KEYS, best.unbind(0))), defer

    MINLB = zero3
    MAXUBv = torch.full((B, 2, P_MAX), I32MAX, dtype=_i32, device=dev)
    llok, l_spos, l_bl, dfa = run_side(lm_c, True, MINLB, max_ed - l_mid, 0)
    lerr1 = l_mid + l_bl["ed"]
    rlok, r_spos, r_bl, dfb = run_side(rm_c, True, l_spos, max_ed - r_mid, 1)
    rerr1 = r_mid + r_bl["ed"]
    rrok, r_epos, r_br, dfc = run_side(rm_c, False, MAXUBv, max_ed - rerr1,
                                       2)
    rerr = rerr1 + r_br["ed"]
    lrok, l_epos, l_br, dfd = run_side(lm_c, False, r_epos, max_ed - lerr1,
                                       3)
    lerr = lerr1 + l_br["ed"]
    if upto == "p2_ext":
        return dict(defer=defer, l_spos=l_spos, r_spos=r_spos,
                    l_epos=l_epos, r_epos=r_epos, llok=llok, rrok=rrok,
                    success=success)
    pair_live = pvalid & success
    defer_p = pair_live & (dfa | dfb | dfc | dfd)
    defer = defer | DEF_EXTWALK * defer_p.reshape(B, -1).any(dim=1).to(_i32)

    def mk_mm(mc, spos, epos, mid, bl, br, lok, rok, err, dirv):
        seq_len = mc["seq_len"]
        l_clip = torch.where(lok, bl["sclen"], mc["remain_beg"] - bl["qcov"])
        r_clip = torch.where(rok, br["sclen"], mc["remain_end"] - br["qcov"])
        # update_match_mate_info (utils.cpp:22-32)
        conc = lok & rok & (err <= max_ed) & (br["sclen"] <= max_sc) \
            & (bl["sclen"] <= max_sc)
        typ = torch.where(conc, CONCRD,
                          torch.where(lok | rok, CANDID, ORPHAN)).to(_i32)
        # is_concord2 outcome when the OTHER mate's middle fails
        fullcov = (mc["clen"] >= 2) \
            & ((mc["lastq"] + k - mc["q0"]) >= seq_len)
        edge = (mc["q0"] == 0) | ((mc["lastq"] + k) == seq_len)
        ic2_type = torch.where(fullcov, CONCRD,
                               torch.where(edge, CANDID, ORPHAN)).to(_i32)
        return dict(spos=spos, epos=epos, qspos=1 + l_clip,
                    qepos=seq_len - r_clip, mlen=seq_len - l_clip - r_clip,
                    scl_l=bl["sclen"], scl_r=br["sclen"], led=bl["ed"],
                    med=mid, red=br["ed"],
                    l_ok=lok & (bl["sclen"] <= max_sc),
                    r_ok=rok & (br["sclen"] <= max_sc),
                    type=typ, ic2_type=ic2_type, dir=dirv)

    # dir: fwd mate +1, rev mate -1 (mapping.py:130-132); the l/r-mate
    # bundles carry it via the fwd_left selection
    one = torch.ones((B, 2, P_MAX), dtype=_i32, device=dev)
    lmm = mk_mm(lm_c, l_spos, l_epos, l_mid, l_bl, l_br, llok, lrok, lerr,
                torch.where(fwd_left, one, -one))
    rmm = mk_mm(rm_c, r_spos, r_epos, r_mid, r_bl, r_br, rlok, rrok, rerr,
                torch.where(fwd_left, -one, one))

    # overlap lookups on the final mm coordinates (utils.cpp:667-695)
    for mm in (lmm, rmm):
        mm["iv_s"], mm["ind_s"] = _overlap_ind(ad, fa, mm["spos"])
        mm["iv_e"], mm["ind_e"] = _overlap_ind(ad, fa, mm["epos"])

        def seg_over(iv):
            c = torch.clamp(iv, 0, NIV - 1).long()
            return (iv >= 0) & (fa.iv_nseg_true[c] > SEG_PAD)
        over = success & (seg_over(mm["iv_s"]) | seg_over(mm["iv_e"]))
        defer = defer | DEF_MMANNO * (over & pvalid).reshape(B, -1).any(
            dim=1).to(_i32)

    return dict(pvalid=pvalid, same_tr=p_same_tr, sgf=p_sgf, sgr=p_sgr,
                tlen_g=p_tlen, fiv=p_fiv, riv=p_riv, fwd_left=fwd_left,
                success=success, lmm=lmm, rmm=rmm, defer=defer,
                grid_same_tr=same_tr, grid_sgf=sgf, grid_sgr=sgr,
                grid_tlen=tlen_g, grid_fvalid=fvalid, grid_rvalid=rvalid,
                n_union=n_union)


# --------------------------------------------------------------------------
# decision rules (utils.cpp:157-320), vectorized over [B]
# --------------------------------------------------------------------------

def _update_rule(mr, sm, lm, chr_idx, shift, tlen, jun, gm, type_, r1_sm,
                 contig_num, mask):
    if not torch.is_tensor(type_):
        type_ = torch.full_like(tlen, type_)
    return _mr_update(mr, sm, lm, chr_idx, shift, tlen, jun, gm, type_,
                      r1_sm, contig_num, mask)


def _conc_expl(mr, sm, lm, pre, chr_idx, shift, r1_sm, mp_type, mask,
               *, max_tlen, contig_num):
    """concordant_explanation (utils.cpp:157-213).  The pair-pure pieces
    (same-exon test, the calc_tlen transcript walk) come precomputed over
    all pairs in ``pre`` (``_pair_precompute``)."""
    ok0 = mask & (sm["spos"] <= lm["spos"])
    on_cdna = ((sm["iv_s"] >= 0) & (sm["iv_e"] >= 0) & (lm["iv_s"] >= 0)
               & (lm["iv_e"] >= 0))
    tlen_a = lm["spos"] - sm["epos"] - 1 + lm["mlen"] + sm["mlen"]
    zero = torch.zeros_like(tlen_a)
    fb = torch.zeros_like(ok0)
    near = (tlen_a <= max_tlen) | (tlen_a <= MAXDISCRDTLEN)
    args = (r1_sm, contig_num)

    b1_no = (sm["iv_s"] < 0) | (lm["iv_s"] < 0)
    mr = _update_rule(mr, sm, lm, chr_idx, shift, tlen_a, zero, fb, CONGNM,
                      *args, ok0 & b1_no & near)
    tlen_b = lm["spos"] + lm["mlen"] - sm["spos"]
    typ_b = torch.where(mp_type == 0, CONCRD, CONGEN).to(_i32)
    mr = _update_rule(mr, sm, lm, chr_idx, shift, tlen_b, zero, on_cdna,
                      torch.where(tlen_b <= max_tlen, typ_b, DISCRD), *args,
                      ok0 & ~b1_no & pre["se"])

    b2_no = (sm["iv_e"] < 0) | (lm["iv_s"] < 0)
    mr = _update_rule(mr, sm, lm, chr_idx, shift, tlen_a, zero, fb, CONGNM,
                      *args, ok0 & b2_no & near)
    tl, inn = pre["ct_tl"], pre["ct_inn"]
    u2b = ok0 & ~b2_no
    defer = u2b & pre["ct_df"]
    good = (tl >= 0) & (tl <= max_tlen)
    mr = _update_rule(mr, sm, lm, chr_idx, shift, tl, inn, on_cdna, typ_b,
                      *args, u2b & good)
    mr = _update_rule(mr, sm, lm, chr_idx, shift,
                      torch.where(tl < 0, tlen_a, tl),
                      torch.where(tl < 0, zero, inn), on_cdna, DISCRD, *args,
                      u2b & ~good)
    return mr, defer


def _same_gene_mm(ad, fa, a, b):
    return (a["iv_s"] >= 0) & _same_gene_span(ad, fa, a["iv_s"], b["spos"],
                                              b["epos"])


def _lariat(ad, fa, sm, lm):
    """_lariat_ciRNA (utils.cpp:250-252, categories.py:324-335)."""
    NIV = ad.iv_epos.shape[0]
    ok = _bit(fa.intr_bits, sm["spos"]) & _bit(fa.intr_bits, lm["spos"]) \
        & (sm["ind_s"] >= 0) & (lm["ind_e"] >= 0) \
        & (sm["ind_s"] == lm["ind_e"])
    gap = sm["spos"] - ad.iv_epos[torch.clamp(sm["ind_s"], 0,
                                              NIV - 1).long()]
    return ok & (gap <= LARIAT2BEGTH)


def _check_chimeric(mr, sm, lm, pre, chr_idx, shift, r1_sm, mask, *,
                    contig_num):
    ok = mask & (mr["type"] != CONCRD) & (sm["iv_s"] >= 0) \
        & (lm["iv_s"] >= 0) & pre["sg_iv"] & (sm["spos"] < lm["spos"])
    tl = lm["epos"] - sm["spos"] + 1
    return _update_rule(mr, sm, lm, chr_idx, shift, tl, torch.zeros_like(tl),
                        torch.zeros_like(ok), CHIORF, r1_sm, contig_num, ok)


def _check_bsj(mr, sm, lm, pre, chr_idx, shift, r1_sm, mask, *,
               contig_num):
    ok = mask & (mr["type"] != CONCRD) & (mr["type"] != DISCRD) \
        & sm["r_ok"] & lm["l_ok"]
    tl = lm["epos"] - sm["spos"] + 1
    return _update_rule(mr, sm, lm, chr_idx, shift, tl, torch.zeros_like(tl),
                        torch.zeros_like(ok), CHIBSJ, r1_sm, contig_num,
                        ok & pre["bsj_hit"])


def _check_2bsj(mr, sm, lm, pre, chr_idx, shift, r1_sm, mask, *,
                contig_num):
    ok = mask & (mr["type"] >= CHI2BSJ) & (sm["spos"] <= lm["spos"])
    ok = ok & ~(sm["r_ok"] & lm["r_ok"] & (sm["spos"] != lm["spos"]))
    ok = ok & ~(sm["l_ok"] & lm["l_ok"] & (sm["epos"] != lm["epos"]))
    ok = ok & ~(sm["l_ok"] & lm["r_ok"])
    tl = lm["epos"] - sm["spos"] + 1
    return _update_rule(mr, sm, lm, chr_idx, shift, tl, torch.zeros_like(tl),
                        torch.zeros_like(ok), CHI2BSJ, r1_sm, contig_num,
                        ok & pre["bsj_hit"])


def _pair_precompute(ad, fa, lmm, rmm, need, *, W_MAX, CT_POOL):
    """Everything the decision rules need that does not depend on the
    running mr state, over all [B, 2, P_MAX] pairs at once; calc_tlen runs
    over a compacted pool of the pairs that need it."""
    sm, lm = lmm, rmm
    pre = {"se": _same_exon(ad, fa, sm["iv_s"], lm["iv_s"])}
    sg_iv = _same_gene_iv(ad, fa, sm["iv_s"], lm["iv_s"])
    pre["sg_iv"] = sg_iv
    ivnull = (sm["iv_s"] < 0) | (lm["iv_s"] < 0)
    gm_hit = _same_gene_mm(ad, fa, sm, lm) | _same_gene_mm(ad, fa, lm, sm)
    pre["bsj_hit"] = torch.where(ivnull, gm_hit | _lariat(ad, fa, sm, lm),
                                 sg_iv)
    shp = sm["iv_s"].shape
    nflat = need.reshape(-1)
    inv, n_act, over = _compact(nflat, CT_POOL)
    inv_l = inv.long()

    def gp(x):
        return x.reshape(-1)[inv_l]

    tl_p, inn_p, df_p = _calc_tlen(ad, fa, gp(sm["iv_e"]), gp(sm["ind_e"]),
                                   gp(sm["epos"]), gp(sm["mlen"]),
                                   gp(lm["iv_s"]), gp(lm["ind_s"]),
                                   gp(lm["spos"]), gp(lm["mlen"]),
                                   W_MAX=W_MAX)
    NFLT = nflat.shape[0]
    pre["ct_tl"] = _scatter_pool(tl_p, inv, n_act, NFLT).reshape(shp)
    pre["ct_inn"] = _scatter_pool(inn_p, inv, n_act, NFLT).reshape(shp)
    pre["ct_df"] = _scatter_pool(df_p.to(_i32), inv, n_act,
                                 NFLT).reshape(shp) != 0
    pre["ct_over"] = over.reshape(shp)
    return pre


# --------------------------------------------------------------------------
# public entry
# --------------------------------------------------------------------------

MM_USED = ("spos", "epos", "qspos", "qepos", "mlen", "led", "med", "red",
           "dir", "tfinal", "iv_s", "iv_e", "l_ok", "r_ok")

# the mr fold's pair steps (``mr_pair_fold``): the per-pair fields of both
# orientations, packed int32 [B, 2, P_MAX, len(PAIR_KEYS)] (bools as 0 / 1)
# once per finish; each orientation's own pair tables, int32 [B, P_MAX,
# len(ORIENT_KEYS)]; the carries out, int32 [B, len(FOLD_AUX)].  The enums
# of csrc/mr_fold.cu follow these orders.
PRE_KEYS = ("se", "sg_iv", "bsj_hit", "ct_tl", "ct_inn", "ct_df")
PAIR_KEYS = (tuple("l_" + kk for kk in MM_USED)
             + tuple("r_" + kk for kk in MM_USED) + PRE_KEYS
             + ("success", "fwd_left"))
_PAIR_BOOL = {"l_l_ok", "l_r_ok", "r_l_ok", "r_r_ok", "se", "sg_iv",
              "bsj_hit", "ct_df", "success", "fwd_left"}
ORIENT_KEYS = ("act", "mp_type", "chr", "shift")
FOLD_AUX = ("stopped", "min1", "min2", "r1g", "r2g", "defer_o")


def _at_o(arr, o_idx):
    """arr [B, 2, ...] -> [B, ...] at each read's orientation."""
    return _along(arr, o_idx[:, None], 1)[:, 0]


def _pack_pairs(lmm, rmm, pre_all, success, fwd_left):
    """Every per-pair field the fold reads, int32 [B, 2, P_MAX, NPF] in
    PAIR_KEYS order."""
    cols = ([lmm[kk] for kk in MM_USED] + [rmm[kk] for kk in MM_USED]
            + [pre_all[kk] for kk in PRE_KEYS] + [success, fwd_left])
    return torch.stack([c.to(_i32) for c in cols], dim=-1)


def mr_pair_fold(mr, pairs, o_t, orient, live, stopped, *, max_tlen: int,
                 contig_num: int, scan_level: int):
    """The P_MAX pair steps of one orientation of the mr fold (the
    reference's ``pair_body``, circminer_tpu/ops/device_full.py:1510).

    mr int32 [B, MRF]; pairs int32 [B, 2, P_MAX, NPF] (``_pack_pairs``);
    o_t int32 [B]; orient int32 [B, P_MAX, NOF] (ORIENT_KEYS); live,
    stopped bool [B].  Returns (mr int32 [B, MRF], aux int32 [B, 6] in
    FOLD_AUX order).  On a CPU tensor its plain version
    (``_mr_pair_fold_plain``); on a CUDA tensor the ``mr_pair_fold``
    kernel (csrc/mr_fold.cu), or a raise."""
    kw = dict(max_tlen=max_tlen, contig_num=contig_num,
              scan_level=scan_level)
    if not mr.is_cuda:
        return _mr_pair_fold_plain(mr, pairs, o_t, orient, live, stopped,
                                   **kw)
    B, _, P, _ = pairs.shape
    mr_out = torch.empty((B, MRF), dtype=_i32, device=mr.device)
    aux = torch.empty((B, len(FOLD_AUX)), dtype=_i32, device=mr.device)
    if B == 0:
        return mr_out, aux
    _ext.launch_tensors(
        "mr_pair_fold", mr_pair_fold_args(mr, pairs, o_t, orient, live,
                                          stopped, mr_out, aux),
        (B, P, max_tlen, contig_num, scan_level))
    return mr_out, aux


def mr_pair_fold_args(mr, pairs, o_t, orient, live, stopped, mr_out, aux):
    """The (tensor, dtype, shape) arguments of the ``mr_pair_fold`` kernel,
    in its order."""
    B, _, P, _ = pairs.shape
    i32 = _i32
    return [(mr, i32, (B, MRF)), (pairs, i32, (B, 2, P, len(PAIR_KEYS))),
            (o_t, i32, (B,)), (orient, i32, (B, P, len(ORIENT_KEYS))),
            (live, torch.bool, (B,)), (stopped, torch.bool, (B,)),
            (mr_out, i32, (B, MRF)), (aux, i32, (B, len(FOLD_AUX)))]


def _mr_pair_fold_plain(mr_in, pairs, o_t, orient, live, stopped, *,
                        max_tlen, contig_num, scan_level):
    """The plain version of ``mr_pair_fold``: the fold's loop over pairs as
    torch ops, reading pair p of each read's orientation as row p."""
    B, _, P_MAX, _ = pairs.shape
    dev = mr_in.device
    at = _at_o(pairs, o_t)                                 # [B, P, NPF]
    col = {kk: (at[..., i] != 0) if kk in _PAIR_BOOL else at[..., i]
           for i, kk in enumerate(PAIR_KEYS)}
    mr = {kk: mr_in[:, i] for i, kk in enumerate(MR_KEYS)}
    fl = col["fwd_left"]
    r1_fwd_flag = o_t == 0
    r1_sm = torch.where(fl, r1_fwd_flag[:, None], ~r1_fwd_flag[:, None])

    def const(v):
        return torch.full((B,), v, dtype=_i32, device=dev)

    # every per-pair tensor as [P, B]: the fold reads pair p as row p
    lmm_T = {kk: col["l_" + kk].T for kk in MM_USED}
    rmm_T = {kk: col["r_" + kk].T for kk in MM_USED}
    pre_T = {kk: col[kk].T for kk in PRE_KEYS}
    fl_T, act_T = fl.T, (orient[..., 0] != 0).T
    succ_T = col["success"].T
    mp_T, chr_T, sh_T, rs_T = (orient[..., 1].T, orient[..., 2].T,
                               orient[..., 3].T, r1_sm.T)

    min1 = const(ORPHAN)
    min2 = const(ORPHAN)
    r1g = torch.zeros((B,), dtype=torch.bool, device=dev)
    r2g = torch.zeros((B,), dtype=torch.bool, device=dev)
    defer_o = torch.zeros((B,), dtype=torch.bool, device=dev)
    for p in range(P_MAX):
        lm_p = {kk: v[p] for kk, v in lmm_T.items()}
        rm_p = {kk: v[p] for kk, v in rmm_T.items()}
        pre_p = {kk: v[p] for kk, v in pre_T.items()}
        flp = fl_T[p]
        pact = act_T[p] & live & ~stopped
        succ = pact & succ_T[p]
        r1t = torch.where(flp, lm_p["tfinal"], rm_p["tfinal"])
        r2t = torch.where(flp, rm_p["tfinal"], lm_p["tfinal"])
        cc = succ & flp & (r1t == CONCRD) & (r2t == CONCRD)
        bsj_m = succ & (((r1t == CANDID) & (r2t == CONCRD))
                        | ((r1t == CONCRD) & (r2t == CANDID)))
        b2_m = succ & (r1t == CANDID) & (r2t == CANDID)
        chim = succ & ~flp & (r1t == CONCRD) & (r2t == CONCRD)
        rule = (lm_p, rm_p, pre_p, chr_T[p], sh_T[p], rs_T[p])
        mr, df_ce = _conc_expl(
            mr, lm_p, rm_p, pre_p, chr_T[p], sh_T[p], rs_T[p], mp_T[p],
            cc, max_tlen=max_tlen, contig_num=contig_num)
        defer_o = defer_o | (cc & df_ce)
        if scan_level == 0:
            stopped = stopped | (cc & (mr["type"] == CONCRD))
        mr = _check_chimeric(mr, *rule, chim, contig_num=contig_num)
        mr = _check_bsj(mr, *rule, bsj_m, contig_num=contig_num)
        mr = _check_2bsj(mr, *rule, b2_m, contig_num=contig_num)
        min1 = torch.where(pact, torch.minimum(min1, r1t), min1)
        min2 = torch.where(pact, torch.minimum(min2, r2t), min2)
        on1 = torch.where(flp, lm_p["iv_s"], rm_p["iv_s"]) >= 0
        on1 |= torch.where(flp, lm_p["iv_e"], rm_p["iv_e"]) >= 0
        on2 = torch.where(flp, rm_p["iv_s"], lm_p["iv_s"]) >= 0
        on2 |= torch.where(flp, rm_p["iv_e"], lm_p["iv_e"]) >= 0
        r1g = torch.where(pact, succ & on1, r1g)
        r2g = torch.where(pact, succ & on2, r2g)
    aux = torch.stack([x.to(_i32) for x in (stopped, min1, min2, r1g, r2g,
                                            defer_o)], dim=1)
    return torch.stack([mr[kk].to(_i32) for kk in MR_KEYS], dim=1), aux


def device_full_finish(seqs, lens, hh, rp, qp, cl, sc10, cn, inc, mr_in,
                       genome, ad, fa, *, k, max_ed, max_sc, band,
                       max_tlen, scan_level, contig_num, KB, P_MAX, W_MAX,
                       OS_POOL, XD_POOL, mat, mis, ind, xd, I=128,
                       CT_POOL=None, EW=4, KSCAN=16, WPP=None, MIDP=None,
                       ENDP=None, upto="full"):
    """The finish from extracted chains on.  Returns (mr_out int32
    [B, MRF], defer int32 [B]).  upto in ("phase1", "lo", "p2_grid",
    "p2_gath", "p2_walk", "p2_ext", "phase2", "pre", "full") returns the
    reference's intermediate state at that cut point (a dict of tensors,
    and defer)."""
    R4 = seqs.shape[0]
    if CT_POOL is None:
        CT_POOL = 4 * (R4 // 4)
    if WPP is None:
        WPP = max(512, 2 * (R4 // 4))
    if MIDP is None:
        MIDP = max(256, R4 // 8)
    if ENDP is None:
        ENDP = max(256, R4 // 4)
    with record_function("cm.phase1"):
        st = _phase1(seqs, lens, hh, rp, qp, cl, sc10, cn, inc, mr_in,
                     genome, ad, fa, k=k, max_ed=max_ed, max_sc=max_sc,
                     band=band, KB=KB, OS_POOL=OS_POOL, XD_POOL=XD_POOL,
                     mat=mat, mis=mis, ind=ind, xd=xd, I=I)
    B, KB1 = st["B"], st["KB1"]
    dev = seqs.device
    if upto == "phase1":
        return {kk: v for kk, v in st.items()
                if isinstance(v, torch.Tensor)}, st["defer"]

    # ---- leftover chain-level extends (extend.cpp:131-213) -----------
    with record_function("cm.leftover_extend"):
        lo_ok, lo_pos, lo_best = extend_leftover(
            st["rp4"], st["qp4"], st["pos_r"], st["remain_end"],
            st["est_mid"], st["genL_inb"], st["genR_inb"], *st["dp"],
            max_ed=max_ed, max_sc=max_sc, band=band)
        lo_lok, lo_rok = lo_ok.unbind(0)
        lo_spos, lo_epos = lo_pos.unbind(0)
        lo_bl, lo_br = (dict(zip(KEYS, b.unbind(0)))
                        for b in lo_best.unbind(0))
        # is_concord short-circuit (utils.cpp:116-132)
        fullcov = (st["clen"] >= 2) & ((st["lastq"] + k - st["q0"])
                                       >= st["lens4"][:, :, None])
        conc_lo = lo_lok & lo_rok & (lo_bl["ed"] + lo_br["ed"] <= max_ed) \
            & (lo_bl["sclen"] <= max_sc) & (lo_br["sclen"] <= max_sc)
        lo_ret = torch.where(fullcov | conc_lo, CONCRD,
                             torch.where(lo_lok | lo_rok, CANDID,
                                         ORPHAN)).to(_i32)
        lo_sp = torch.where(fullcov, st["r0"], lo_spos)
        lo_ep = torch.where(fullcov, st["lastr"] + k - 1, lo_epos)
        lo_ivs, _ = _overlap_ind(ad, fa, lo_sp)
        lo_ive, _ = _overlap_ind(ad, fa, lo_ep)
        lo_genic = (lo_ivs >= 0) | (lo_ive >= 0)
    if upto == "lo":
        return dict(lo_ret=lo_ret, lo_sp=lo_sp, lo_ep=lo_ep,
                    lo_genic=lo_genic), st["defer"]

    with record_function("cm.phase2"):
        st2 = _phase2(st, ad, fa, seqs, genome, k=k, max_ed=max_ed,
                      max_sc=max_sc, band=band, P_MAX=P_MAX, KB=KB, mat=mat,
                      mis=mis, ind=ind, xd=xd, EW=EW, KSCAN=KSCAN, WPP=WPP,
                      MIDP=MIDP, ENDP=ENDP,
                      upto=upto if upto.startswith("p2_") else "full")
    defer = st2["defer"]
    if upto == "phase2" or upto.startswith("p2_"):
        return {kk: v for kk, v in st2.items()
                if isinstance(v, torch.Tensor)}, defer
    lmm, rmm = st2["lmm"], st2["rmm"]
    success, fwd_left, pvalid = st2["success"], st2["fwd_left"], \
        st2["pvalid"]

    # final mm type incl. the mid-failure fallback (extend.py:759-777)
    for mm in (lmm, rmm):
        mm["tfinal"] = torch.where(
            success, mm["type"],
            torch.where(mm["med"] <= max_ed, mm["ic2_type"], ORPHAN))

    # ---- mr fold ------------------------------------------------------
    mr = {kk: mr_in[:, i] for i, kk in enumerate(MR_KEYS)}
    cn4, hh4 = st["cn4"], st["hh4"]
    cn_r1 = cn4[:, 0] + cn4[:, 1]
    cn_r2 = cn4[:, 2] + cn4[:, 3]
    no_any = (cn_r1 + cn_r2) == 0
    manyhit = no_any & (hh4[:, 0] + hh4[:, 1] > 0) \
        & (hh4[:, 2] + hh4[:, 3] > 0)

    def const(v):
        return torch.full((B,), v, dtype=_i32, device=dev)
    mr = _mr_update_type(mr, const(NOPROC_MANYHIT), manyhit)
    mr = _mr_update_type(mr, const(NOPROC_NOMATCH), no_any & ~manyhit)
    oeanch = ~no_any & ((cn_r1 == 0) | (cn_r2 == 0))
    mr = _mr_update_type(mr, const(OEANCH), oeanch)
    done_read = no_any | oeanch

    # orientation order by best-chain score sums (filter.cpp:206-240)
    sc_best = torch.where(cn4 > 0, st["sc4"][..., 0], 0)     # [B, 4]
    sA = sc_best[:, 0] + sc_best[:, 3]
    sB = sc_best[:, 2] + sc_best[:, 1]
    defer = defer | DEF_SCTIE * (~done_read & (sA == sB) & (cn_r1 > 0)
                                 & (cn_r2 > 0)).to(_i32)     # f64 tie
    first_A = sA >= sB

    stopped = torch.zeros((B,), dtype=torch.bool, device=dev)
    # pair-pure relations + pooled calc_tlen over the [B, 2, P] pairs
    ct_need = pvalid & success & (lmm["iv_e"] >= 0) & (rmm["iv_s"] >= 0)
    with record_function("cm.pair_precompute"):
        pre_all = _pair_precompute(ad, fa, lmm, rmm, ct_need, W_MAX=W_MAX,
                                   CT_POOL=CT_POOL)
    defer = defer | DEF_CTPOOL * pre_all["ct_over"].reshape(B, -1).any(
        dim=1).to(_i32)
    if upto == "pre":
        return pre_all, defer
    with record_function("cm.mr_fold"):
        frows, vrows = _mate_rows(dev)
        ci = torch.arange(KB1, device=dev)[None, :]
        pairs = _pack_pairs(lmm, rmm, pre_all, success, fwd_left)
        for t in (0, 1):
            o_t = torch.where(first_A, t, 1 - t)
            saved = mr["type"]
            live = ~done_read & ~stopped

            pv = _at_o(pvalid, o_t)
            same_tr = _at_o(st2["same_tr"], o_t)
            fiv, riv = _at_o(st2["fiv"], o_t), _at_o(st2["riv"], o_t)

            # exact pair gate (filter.cpp:485-551) with this saved_type
            c1 = ((saved > CONGEN) if scan_level == 0
                  else (saved >= CONGEN))[:, None]
            sg1 = ~same_tr & (fiv >= 0) & c1 & _at_o(st2["sgf"], o_t)
            sg2 = ~sg1 & (riv >= 0) & (saved >= CONGEN)[:, None] \
                & _at_o(st2["sgr"], o_t)
            same_gen = sg1 | sg2
            gate = same_tr | same_gen | (
                (_at_o(st2["tlen_g"], o_t) <= MAXDISCRDTLEN)
                & (saved >= CONGNM)[:, None])
            mp_type = torch.where(same_tr, 0, torch.where(same_gen, 1, 2))

            chr_idx = torch.clamp(_bisect_le(fa.shift_bounds,
                                             _at_o(lmm["spos"], o_t)),
                                  0, fa.shift_vals.shape[0] - 1)
            shift = fa.shift_vals[chr_idx.long()]
            orient = torch.stack([x.to(_i32) for x in (
                pv & gate, mp_type, chr_idx, shift)], dim=-1)
            mr_t, aux = mr_pair_fold(
                torch.stack([mr[kk].to(_i32) for kk in MR_KEYS], dim=1),
                pairs, o_t.to(_i32), orient, live, stopped,
                max_tlen=max_tlen, contig_num=contig_num,
                scan_level=scan_level)
            mr = {kk: mr_t[:, i] for i, kk in enumerate(MR_KEYS)}
            stopped, r1g, r2g, defer_o = (aux[:, FOLD_AUX.index(kk)] != 0
                                          for kk in ("stopped", "r1g", "r2g",
                                                     "defer_o"))
            min1 = aux[:, FOLD_AUX.index("min1")]
            min2 = aux[:, FOLD_AUX.index("min2")]
            defer = defer | DEF_TLENWALK * defer_o.to(_i32)

            # ---- leftover single-chain extension (filter.cpp:356-394) ----
            do_lo = live & ~stopped & ~(mr["type"] <= CHI2BSJ)
            frow, vrow = frows[o_t.long()], vrows[o_t.long()]
            # exact paired flags over the full grid with this saved_type
            g_tr = _at_o(st2["grid_same_tr"], o_t)
            gg_sg1 = ~g_tr & c1[..., None] & _at_o(st2["grid_sgf"], o_t)
            gg_sg2 = ~gg_sg1 & (saved >= CONGEN)[:, None, None] \
                & _at_o(st2["grid_sgr"], o_t)
            gg = (_at_o(st2["grid_fvalid"], o_t)
                  & _at_o(st2["grid_rvalid"], o_t)) & (g_tr | gg_sg1 | gg_sg2 | (
                      (_at_o(st2["grid_tlen"], o_t) <= MAXDISCRDTLEN)
                      & (saved >= CONGNM)[:, None, None]))
            f_paired = gg.any(dim=2)                              # [B, KB1]
            r_paired = gg.any(dim=1)

            lo_ret_f, lo_ret_v = _at_o(lo_ret, frow), _at_o(lo_ret, vrow)
            lo_gen_f, lo_gen_v = _at_o(lo_genic, frow), _at_o(lo_genic, vrow)
            cnt_f = _at_o(cn4, frow)
            cnt_v = _at_o(cn4, vrow)
            un_f = do_lo[:, None] & (min1 != CONCRD)[:, None] \
                & (ci < cnt_f[:, None]) & ~f_paired
            un_v = do_lo[:, None] & (min2 != CONCRD)[:, None] \
                & (ci < cnt_v[:, None]) & ~r_paired
            min1 = torch.minimum(min1, torch.where(un_f, lo_ret_f,
                                                   ORPHAN).amin(dim=1))
            min2 = torch.minimum(min2, torch.where(un_v, lo_ret_v,
                                                   ORPHAN).amin(dim=1))
            # r*_genic: the last unpaired chain's lookup wins (mapping.py:204)
            last_f = torch.where(un_f, ci, -1).amax(dim=1)
            last_v = torch.where(un_v, ci, -1).amax(dim=1)
            r1g = torch.where(last_f >= 0,
                              _last(lo_gen_f, torch.clamp(last_f, 0, KB1 - 1)),
                              r1g)
            r2g = torch.where(last_v >= 0,
                              _last(lo_gen_v, torch.clamp(last_v, 0, KB1 - 1)),
                              r2g)
            both_c = (min1 == CONCRD) & (min2 == CONCRD)
            new_type = torch.where(
                ((min1 == ORPHAN) & (min2 == CONCRD))
                | ((min1 == CONCRD) & (min2 == ORPHAN)), OEANCH,
                torch.where((min1 == ORPHAN) | (min2 == ORPHAN), ORPHAN,
                            torch.where(both_c & r1g & r2g, CHIFUS,
                                        torch.where(both_c, OEA2, CANDID))))
            mr = _mr_update_type(mr, new_type.to(_i32), do_lo)

    mr_out = torch.stack([mr[kk].to(_i32) for kk in MR_KEYS], dim=1)
    return mr_out, defer


def device_full_step(seqs, lens, mr_in, entry_hv, entry_checksum,
                     entry_pos, genome, ad, fa, entry_prefix=None, *,
                     k, cs_len, n_slots, seed_lim, cap, max_ed, max_sc,
                     band, max_tlen, max_intron, seg_pad, scan_level,
                     contig_num, KB, P_MAX, W_MAX, OS_POOL, XD_POOL,
                     EX_ITERS, mat, mis, ind, xd,
                     prefix_shift=0, prefix_iters=0, EW=4, KSCAN=16,
                     WPP=None, MIDP=None, ENDP=None, seg_compact=False):
    """The fused step: lookup -> gather -> chain DP -> k-best -> pairing ->
    extension -> category lattice.  One device-to-host payload: int32
    [B, MRF + 1] = final MatchedRead state | defer bitmask.  seg_compact
    reaches the chain prelude (the reference's step drops it)."""
    from .seed import gather_seeds_device, lookup_batch_device

    with record_function("cm.lookup"):
        _, start, cnt, high = lookup_batch_device(
            seqs, lens, entry_hv, entry_checksum, entry_prefix, k=k,
            cs_len=cs_len, n_slots=n_slots, seed_lim=seed_lim,
            prefix_shift=prefix_shift, prefix_iters=prefix_iters)
    start_e = start[:, ::2]
    cnt_e = cnt[:, ::2]
    hh_row = high[:, ::2].sum(dim=1, dtype=_i32)
    with record_function("cm.gather_seeds"):
        pos, _ = gather_seeds_device(entry_pos, start_e,
                                     torch.clamp(cnt_e, max=cap), cap=cap)
    return full_from_seeds(
        seqs, lens, mr_in, pos, cnt_e, hh_row, genome, ad, fa,
        k=k, cap=cap, max_ed=max_ed, max_sc=max_sc, band=band,
        max_tlen=max_tlen, max_intron=max_intron, seg_pad=seg_pad,
        scan_level=scan_level, contig_num=contig_num, KB=KB, P_MAX=P_MAX,
        W_MAX=W_MAX, OS_POOL=OS_POOL, XD_POOL=XD_POOL, EX_ITERS=EX_ITERS,
        mat=mat, mis=mis, ind=ind, xd=xd, EW=EW, KSCAN=KSCAN, WPP=WPP,
        MIDP=MIDP, ENDP=ENDP, seg_compact=seg_compact)


def full_from_seeds(seqs, lens, mr_in, pos, cnt_e, hh_row, genome, ad, fa,
                    *, k, cap, max_ed, max_sc, band, max_tlen, max_intron,
                    seg_pad, scan_level, contig_num, KB, P_MAX, W_MAX,
                    OS_POOL, XD_POOL, EX_ITERS, mat, mis, ind, xd, EW=4,
                    KSCAN=16, WPP=None, MIDP=None, ENDP=None,
                    seg_compact=False):
    """The fused step from gathered seeds on: chain DP -> k-best ->
    finish."""
    from .chain_device import chain_batch_device
    from .device_finish import extract_kbest_device

    R4, L = seqs.shape
    B = R4 // 4
    NL = (L + k - 1) // k
    ql = (torch.arange(NL, dtype=_i32, device=seqs.device) * k)[None, :]
    qpos_e = torch.where(ql + k <= lens[:, None], ql, 0)
    occ_defer = (cnt_e > cap).any(dim=1).reshape(B, 4).any(dim=1)
    cnt_c = torch.clamp(cnt_e, max=cap)
    dp10, back = chain_batch_device(
        pos, cnt_c, qpos_e, lens,
        ad.nb_bits, ad.iv_spos, ad.iv_epos, ad.iv_max_end, ad.iv_min_end,
        ad.iv_max_next, ad.iv_nseg, ad.seg_end, ad.seg_next,
        k=k, max_ed=max_ed, max_intron=max_intron, seg_pad=seg_pad,
        seg_compact=seg_compact)
    with record_function("cm.extract_kbest"):
        rp, qp, cl, sc10, cn, inc = extract_kbest_device(
            dp10, back, pos, qpos_e, cnt_c, k=k, C=KB + 1, iters=EX_ITERS)
    mr_out, defer = device_full_finish(
        seqs, lens, hh_row, rp, qp, cl, sc10, cn, inc, mr_in, genome,
        ad, fa, k=k, max_ed=max_ed, max_sc=max_sc, band=band,
        max_tlen=max_tlen, scan_level=scan_level, contig_num=contig_num,
        KB=KB, P_MAX=P_MAX, W_MAX=W_MAX, OS_POOL=OS_POOL, XD_POOL=XD_POOL,
        mat=mat, mis=mis, ind=ind, xd=xd, EW=EW, KSCAN=KSCAN, WPP=WPP,
        MIDP=MIDP, ENDP=ENDP)
    defer = defer | DEF_OCC * occ_defer.to(_i32)
    return torch.cat([mr_out, defer[:, None]], dim=1)
