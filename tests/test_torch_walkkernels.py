"""The extension walk's three kernels of csrc/walk.cu on the CPU:
``walk_fold``, ``tiny_dp`` (END and GLOBAL) and ``walk_scan``.

- The port's plain fold (``device_walk.walk_fold`` on CPU tensors) against
  the reference's ``circminer_tpu.ops.device_walk.walk_fold``, bit-equal,
  on synthetic walk dicts made with numpy from a seed
  (``chip_smoke.walk_fold_inputs``): all five event kinds, xp exactly at
  bnd + aux and at bnd + need, bounds at I32MAX, negative ed_th, score and
  pos ties, lanes of other families and dead rows past n_act, both
  ``left`` values.
- The plain tiny DPs (``tiny_dp`` on CPU tensors) against the reference's
  ``_tiny_end`` and ``_tiny_global`` at w in {0, 1, 3, 5}, with candidate
  ties in ed and in |indel|, on pools where no row, half the rows or every
  row falls back to them; the other rows pass the banded answer through.
- A scalar transcription of each kernel's per-thread work (early exits
  included) against its plain version, with counts that show every branch
  taken: the fold's batched loads a transcript, the tiny DP's anti-diagonal
  steps on a row's lanes (and the row kept in shared memory past
  TINY_REG columns), the scan's steps with all six status transitions,
  empty flushes on both sides, a reference out of bounds and a negative
  rr2.
- Each ``*_args`` list against its ``_ext.KERNELS`` spec, and the C enums
  and constants against the Python orders.
- ``cuda``-marked (skipped without a card): each kernel against its plain
  version on the card, eagerly and inside a captured CUDA graph.

The scan's parity with JAX as a whole is the ``p2_walk`` cut of
tests/test_torch_cuts.py.  Every output is an integer: every comparison is
exact (tolerance 0)."""

import re
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (I32MAX, WALK_EMPTY, tiny_dp_inputs,
                        walk_fold_inputs, walk_scan_inputs)
from circminer_tpu.ops import device_full as jfull
from circminer_tpu.ops import device_walk as jwalk
from circminer_tpu_torch.ops import _ext
from circminer_tpu_torch.ops import device_walk as twalk
from circminer_tpu_torch.ops.pallas_align import POS

NEG_SCORE = twalk.NEG_SCORE


def w32(x):
    """x as int32 with two's-complement wrap-around."""
    return ((int(x) + 2 ** 31) % 2 ** 32) - 2 ** 31


def abs32(x):
    return w32(-x) if x < 0 else x


def _torch(arrays):
    return [torch.from_numpy(np.require(a, requirements="C")) for a in arrays]


# how many rows of a tiny-DP pool fall back to the tiny DP
SHARES = {"none": 0.0, "mixed": 0.5, "all": 1.0}


def fold_case(seed, B=6, P=4, WPP=40, fam=0, left=True, EW=4):
    """walk_fold_inputs at N = B * 2 * P pair slots, and the [4N] pool
    overflow mask of a walk dict."""
    rng = np.random.default_rng(seed)
    arrays, kw = walk_fold_inputs(rng, WPP, B * 2 * P, fam=fam, left=left,
                                  EW=EW)
    over = rng.random(4 * B * 2 * P) < 0.1
    return arrays, kw, over, (B, 2, P)


# --------------------------------------------------------------------------
# the plain versions against JAX
# --------------------------------------------------------------------------

def test_walk_constants_follow_the_reference():
    for name in ("WK_SCAN", "WK_PMID", "WK_PTRAIL", "WK_PEND", "WK_PENDND",
                 "WK_DONE", "EVK_NONE", "EVK_MID", "EVK_TRAIL", "EVK_END",
                 "EVK_ENDND", "EV_NF", "NEG_SCORE"):
        assert getattr(twalk, name) == getattr(jwalk, name), name
    assert twalk.STW == 8           # the reference's STW = min(ST, 8)


@pytest.mark.parametrize("fam,left", [(0, True), (1, True), (2, False),
                                      (3, False), (1, False), (2, True)])
def test_plain_walk_fold_matches_jax(fam, left):
    arrays, kw, over, shp3 = fold_case(11 + 7 * fam + left, fam=fam,
                                       left=left)
    (events, act, inv, n_act, p_live, p_pos, p_len, lane_defer, ed_th,
     bound) = arrays
    ST, WPP = act.shape
    meta = dict(N=ed_th.shape[0], ST=ST, EW=events.shape[0] // ST, WPP=WPP)
    tens = dict(events=events, act=act, inv=inv, n_act=n_act, p_live=p_live,
                p_pos=p_pos, p_len=p_len, lane_defer=lane_defer, over=over)
    stat = dict(max_ed=kw["max_ed"], max_sc=kw["max_sc"], band=kw["band"],
                left=left)
    wk = dict(meta, **{k: torch.from_numpy(v) for k, v in tens.items()})
    got = twalk.fold_result(
        twalk.walk_fold_rows(wk, fam, torch.from_numpy(ed_th.reshape(shp3)),
                             torch.from_numpy(bound.reshape(shp3)), **stat),
        wk["over"], fam, shp3)
    want = jwalk.walk_fold(
        dict(meta, **{k: jnp.asarray(v) for k, v in tens.items()}), fam,
        jnp.asarray(ed_th.reshape(shp3)), jnp.asarray(bound.reshape(shp3)),
        **stat)
    assert sorted(got[0]) == sorted(want[0])
    for k in want[0]:
        assert np.array_equal(got[0][k].numpy(), np.asarray(want[0][k])), k
        assert got[0][k].dtype == torch.int32
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.bool
        assert np.array_equal(g.numpy(), np.asarray(w))
    # the case is not vacuous: live lanes of the family moved their best
    assert (got[0]["score"] != 0).any() and got[1].any()


@pytest.mark.parametrize("share", SHARES)
@pytest.mark.parametrize("w", [0, 1, 3, 5])
def test_plain_tiny_dp_matches_jax(w, share):
    """END: (ed, indel) of _tiny_end; GLOBAL: dp[n][m] of _tiny_global; on
    the rows that fall back to them.  Every other row is its banded answer,
    bit for bit."""
    for end in (True, False):
        arrays, kw = tiny_dp_inputs(np.random.default_rng(40 + w), 300, w,
                                    end=end, share=SHARES[share])
        s, t, n, m, tiny, banded = arrays
        NM, MM = kw["NM"], kw["MM"]
        got = twalk.tiny_dp(*_torch(arrays), **kw)
        js, jt = jnp.asarray(s[:, :NM]), jnp.asarray(t[:, :MM])
        jn, jm = jnp.minimum(jnp.asarray(n), NM), jnp.minimum(
            jnp.asarray(m), MM)
        if end:
            ed, indel = jwalk._tiny_end(js, jt, jn, jm, w=w,
                                        max_ed=kw["max_ed"], NM=NM, MM=MM)
            want = np.stack([np.asarray(ed), np.asarray(indel)], axis=1)
        else:
            want = np.asarray(jfull._tiny_global(js, jt, jn, jm, NM, MM))
        assert got.dtype == torch.int32 and got.shape == banded.shape
        got = got.numpy()
        assert tiny.sum() == {"none": 0, "all": 300}.get(share, tiny.sum())
        assert 0 < tiny.sum() < 300 or share != "mixed"
        assert np.array_equal(got[tiny], want[tiny]), (w, end)
        assert np.array_equal(got[~tiny], banded[~tiny]), (w, end)


# --------------------------------------------------------------------------
# scalar transcriptions of the kernels' per-thread loops
# --------------------------------------------------------------------------

def _c_consts():
    """The integer constants of csrc/walk.cu."""
    with open(f"{_ext._CSRC}/walk.cu") as f:
        return {k: int(v) for k, v in
                re.findall(r"constexpr int (\w+) = (-?\d+);", f.read())}


C = _c_consts()
TERMINAL = (twalk.EVK_TRAIL, twalk.EVK_END, twalk.EVK_ENDND)


def fold_scalar(events, act, inv, n_act, p_live, p_pos, p_len, lane_defer,
                ed_th, bound, *, fam, left, max_ed, max_sc, band, cov):
    """walk_fold_kernel's warps, in its order: four pool lanes a warp, a
    lane's transcripts on FOLD_T threads.  Round 1: each thread's lane
    scalars, act and event kinds; a warp without a live lane of the family
    leaves.  Round 2: the extend's ed_th and bound, and each thread's
    event fields up to its first terminal kind; then each thread's curr
    chain keeps the candidate of every event that updates best.  Last the
    turns: transcript s's candidates fold into its lane's best, in event
    order, skipped where no thread s of the warp has one.  The chains read
    only the fields round 2 loaded."""
    N = ed_th.shape[0]
    ST, WPP = act.shape
    EW = events.shape[0] // ST
    T = C["FOLD_T"]
    lanes_a_warp = 32 // T
    out = np.zeros((len(twalk.FOLD_OUT), N), np.int64)

    def ev(t, e, f, w):
        return int(events[t * EW + e, twalk.EV_KEYS.index(f), w])

    for w0 in range(0, WPP, lanes_a_warp):
        lanes = range(w0, min(w0 + lanes_a_warp, WPP))
        mine = {}
        for w in lanes:
            if w >= int(n_act):
                cov["dead_row"] += 1
            elif int(inv[w]) // N != fam or not p_live[w]:
                cov["other_family"] += 1
            else:
                mine[w] = int(inv[w]) - fam * N
        if not mine:
            cov["warp_idle"] += 1
            continue
        chains = {}
        for w, slot in mine.items():
            eth, bnd = int(ed_th[slot]), int(bound[slot])
            pos, qlen = int(p_pos[w]), int(p_len[w])
            cov["eth_negative"] += eth < 0
            cov["bound_i32max"] += bnd == I32MAX
            for t in range(ST):
                kinds = [ev(t, q, "kind", w) for q in range(EW)]
                ne = next((q + 1 for q in range(EW) if kinds[q] in TERMINAL),
                          EW) if act[t, w] else 0
                cov["cut_at_terminal" if 0 < ne < EW else
                    "no_terminal" if ne else "inactive"] += 1
                loaded = []
                for q in range(ne):
                    keys = ("xpos", "aux") if kinds[q] != twalk.EVK_NONE \
                        else ()
                    if kinds[q] in (twalk.EVK_MID, twalk.EVK_TRAIL,
                                    twalk.EVK_END):
                        keys += ("ed", "indel", "score")
                    if kinds[q] == twalk.EVK_END:
                        keys += ("sclen",)
                    loaded.append({f: ev(t, q, f, w) for f in keys})
                chains[w, t] = _chain_scalar(kinds, loaded, ne, eth, bnd, pos,
                                             qlen, left, max_sc, cov)
        for w, slot in mine.items():
            eth, qlen = int(ed_th[slot]), int(p_len[w])
            out[:, slot] = [int(p_pos[w]), w32(eth + 1), w32(qlen + 1),
                            w32(band + 1), 0, 0, 0, bool(lane_defer[w])]
        for s in range(ST):
            if not any(chains[w, s][0] for w in mine):
                cov["turn_skipped"] += 1
                continue
            cov["turn"] += 1
            for w, slot in mine.items():
                best = list(out[:6, slot])
                for rule, cand in chains[w, s][0]:
                    best = (_dir_scalar(best, cand, max_ed, max_sc, left, cov)
                            if rule == "dir" else
                            _score_scalar(best, cand, left, cov))
                out[:6, slot] = best
        for w, slot in mine.items():
            consec = [t for t in range(ST) if chains[w, t][1]]
            cov["consec_past_thread0"] += bool(consec) and consec[0] > 0
            out[6, slot] = bool(consec)
    return out


def _chain_scalar(kinds, loaded, ne, eth, bnd, pos, qlen, left, max_sc,
                  cov):
    """One fold thread's curr chain over its transcript's first ne events:
    ([(rule, candidate)] in event order, consec)."""
    curr = [bnd, 0, 0, 0, 0, NEG_SCORE]
    cands, consec, alive = [], False, True
    for q in range(ne):
        if not alive:
            cov["dead_before_terminal"] += 1
            break
        kind, ev = kinds[q], loaded[q]
        cov[f"kind{kind}"] += 1
        if kind in (twalk.EVK_MID, twalk.EVK_TRAIL):
            xp, aux, ed = ev["xpos"], ev["aux"], ev["ed"]
            edge = w32(bnd + aux) if left else w32(bnd - aux)
            cov["xp_at_bnd_aux"] += xp == edge
            bad = xp < w32(bnd + aux) if left else w32(xp + aux) > bnd
            if bad or w32(curr[1] + ed) > eth:
                cov["mid_bound_bad" if bad else "mid_ed_over"] += 1
                alive = False
            else:
                indel = ev["indel"]
                curr = [w32(xp - aux) if left else w32(xp + aux),
                        w32(curr[1] + ed), 0, w32(curr[3] - indel),
                        w32(curr[4] + aux - indel), ev["score"]]
                cands.append(("dir", curr))
            if kind == twalk.EVK_TRAIL:
                alive = False
        elif kind in (twalk.EVK_END, twalk.EVK_ENDND):
            xp = ev["xpos"]
            need = w32(qlen - ev["aux"])
            edge = w32(bnd + need) if left else w32(bnd - need)
            cov["xp_at_bnd_need"] += xp == edge
            bad = xp < w32(bnd + need) if left else w32(xp + need) > bnd
            if bad:
                cov["end_bound_bad"] += 1
            else:
                if xp == pos:
                    cov["consec"] += 1
                    consec = True
                if kind == twalk.EVK_END \
                        and w32(curr[1] + ev["ed"]) <= eth \
                        and ev["sclen"] <= max_sc \
                        and w32(need - ev["sclen"]) >= ev["sclen"]:
                    sclen, indel = ev["sclen"], ev["indel"]
                    curr = [w32(xp - need + indel) if left
                            else w32(xp + need - indel),
                            w32(curr[1] + ev["ed"]), sclen,
                            w32(curr[3] + indel), w32(curr[4] + need),
                            ev["score"]]
                    cands.append(("score", curr))
                else:
                    cov["end_no_dp"] += 1
            alive = False
    return cands, consec


def _dir_scalar(best, c, max_ed, max_sc, left, cov):
    """update_dir: (pos, ed, sclen, indel, qcov, score) lists."""
    ok = c[1] <= max_ed and c[2] <= max_sc
    pos_better = c[0] > best[0] if left else c[0] < best[0]
    if c[4] > best[4]:
        take = ok and w32(2 * w32(c[1] - best[1])) < w32(c[4] - best[4])
        cov["dir_gt_take" if take else "dir_gt_keep"] += 1
    elif c[4] < best[4]:
        take = ok and w32(2 * w32(best[1] - c[1])) >= w32(best[4] - c[4])
        cov["dir_lt_take" if take else "dir_lt_keep"] += 1
    else:
        take = (c[1] < best[1] or (c[1] == best[1] and c[2] < best[2])
                or (c[1] == best[1] and c[2] == best[2] and pos_better))
        cov["dir_eq_take" if take else "dir_eq_keep"] += 1
        if c[1] == best[1] and c[2] == best[2]:
            cov["dir_pos_tie"] += 1
    return list(c) if take else best


def _score_scalar(best, c, left, cov):
    pos_better = c[0] > best[0] if left else c[0] < best[0]
    if best[5] == c[5]:
        cov["score_tie_pos_" + ("take" if pos_better else "keep")] += 1
    take = best[5] < c[5] or (best[5] == c[5] and pos_better)
    cov["score_take" if take else "score_keep"] += 1
    return list(c) if take else best


@pytest.mark.parametrize("fam,left", [(0, True), (3, False)])
def test_walk_fold_loop_order_matches_plain(fam, left):
    """Three pools at the main path's EW = 4 and one at EW = 7 (the
    kernel's threads hold up to 2 * FOLD_EW events)."""
    cov = Counter()
    for seed, EW in enumerate((4, 4, 4, 7)):
        arrays, kw, _, _ = fold_case(100 + seed, B=10, P=6, WPP=150, fam=fam,
                                     left=left, EW=EW)
        got = fold_scalar(*arrays, **kw, cov=cov)
        want = twalk.walk_fold_lanes(*_torch(arrays), **kw)
        assert np.array_equal(got, want.numpy())
    need = {"dead_row", "other_family", "eth_negative", "bound_i32max",
            "xp_at_bnd_aux", "xp_at_bnd_need", "mid_bound_bad",
            "mid_ed_over", "end_bound_bad", "consec", "end_no_dp",
            "dir_gt_take", "dir_gt_keep", "dir_lt_take", "dir_lt_keep",
            "dir_eq_take", "dir_eq_keep", "dir_pos_tie", "score_take",
            "score_keep", "score_tie_pos_take", "score_tie_pos_keep",
            "warp_idle", "cut_at_terminal", "no_terminal", "inactive",
            "dead_before_terminal", "turn", "turn_skipped",
            "consec_past_thread0"}
    need |= {f"kind{k}" for k in range(5)}
    assert need <= {k for k, v in cov.items() if v}, need - set(cov)


class _Cand:
    """The Cand struct of tiny_dp: AlignCandid.update with the strict key
    order, counting its branches."""

    def __init__(self, w, max_ed, cov):
        self.bk, self.be, self.bi = 0, w32(max_ed + 1), w32(w + 1)
        self.w, self.max_ed, self.cov = w, max_ed, cov

    def update(self, i, dmv, n, m):
        w, max_ed, cov = self.w, self.max_ed, self.cov
        indel = w32(m - i)
        ai = abs32(indel)
        if i <= n and ai <= w and dmv <= max_ed:
            key = w32(w32((max_ed - dmv) * (w + 2))
                      + w32(w + 1 - min(ai, w + 1)))
            if key > self.bk:
                if self.bk:
                    cov["cand_better"] += 1
                self.bk, self.be, self.bi = key, dmv, indel
                return
            cov["cand_ed_tie" if dmv == self.be else "cand_worse"] += 1
            if key == self.bk:
                cov["cand_key_tie"] += 1
            if dmv == self.be and ai == abs32(self.bi) and indel != self.bi:
                cov["cand_indel_sign_tie"] += 1


def _col0(i, m):
    return i if i >= 1 else (0 if m >= 0 else POS)


def _tiny_lanes(s, t, n, m, *, MM, w, max_ed, end, cov):
    """tiny_dp_kernel's TINY_REG lanes of one row: the mismatch masks down
    each column, then the anti-diagonal steps (lane c at step k on row
    i = k - c + 1, left from lane c - 1's last cell, diagonal the left of
    the step before), column mc's lane scanning candidates."""
    R = C["TINY_REG"]
    mc = min(max(m, 0), MM)
    mis = [0] * R
    for c in range(mc):
        tj = int(t[c])
        for i in range(min(n, R)):
            si = int(s[i])
            mis[c] |= int(si != tj or si >= 4 or tj >= 4) << i
    steps = n + mc - 1 if n >= 1 and mc >= 1 else 0
    own = mc - 1 if mc > 0 else 0
    cand = _Cand(w, max_ed, cov)
    if end and mc > 0:
        cand.update(0, mc, n, m)
    cur = [c + 1 for c in range(R)]
    diag = [0] * R
    for k in range(steps):
        lefts = [k + 1] + cur[:-1]          # the shuffle: all lanes at once
        for c in range(R):
            i = k - c + 1
            if c < mc and 1 <= i <= n:
                mi = (mis[c] >> (i - 1)) & 1
                cur[c] = min(diag[c] + mi, cur[c] + 1, lefts[c] + 1)
                cov["cell"] += 1
                if end and c == own:
                    cand.update(i, cur[c], n, m)
            diag[c] = lefts[c]
    if mc == 0:
        cov["column0"] += 1
        if end:
            for i in range(max(n, 0) + 1):
                cand.update(i, _col0(i, m), n, m)
        else:
            cur[own] = _col0(max(n, 0), m)
    return (cand.be, cand.bi) if end else cur[own]


def _tiny_row(s, t, n, m, *, MM, w, max_ed, end, cov):
    """tiny_dp_kernel_smem's thread of one row: the row of MM + 1 cells,
    rows up to n, the candidate scan after each row when end."""
    row = [j if j <= m else POS for j in range(MM + 1)]
    mc = min(max(m, 0), MM)
    cand = _Cand(w, max_ed, cov)
    if end:
        cand.update(0, row[mc], n, m)
    for i in range(1, n + 1):
        si = int(s[i - 1])
        diag, left = row[0], i
        row[0] = i
        for j in range(1, MM + 1):
            up = row[j]
            if j > m:
                v = POS
            else:
                tj = int(t[j - 1])
                mis = int(si != tj or si >= 4 or tj >= 4)
                v = min(diag + mis, up + 1, left + 1)
                cov["cell"] += 1
            row[j] = left = v
            diag = up
        if end:
            cand.update(i, row[mc], n, m)
    return (cand.be, cand.bi) if end else row[mc]


def tiny_scalar(s, t, n, m, tiny, banded, *, NM, MM, w, max_ed, end, cov):
    """tiny_dp's work per row: the banded answer on a row that does not
    fall back; else the lanes' wavefront at NM, MM <= TINY_REG, a thread's
    row in shared memory past it."""
    B = s.shape[0]
    out = banded.astype(np.int64).copy()
    lanes = NM <= C["TINY_REG"] and MM <= C["TINY_REG"]
    for b in range(B):
        if not tiny[b]:
            cov["pass_through"] += 1
            continue
        nb, mb = min(int(n[b]), NM), min(int(m[b]), MM)
        cov["n_clamped"] += int(n[b]) > NM
        cov["m_clamped"] += int(m[b]) > MM
        cov["lanes" if lanes else "smem_row"] += 1
        out[b] = (_tiny_lanes if lanes else _tiny_row)(
            s[b], t[b], nb, mb, MM=MM, w=w, max_ed=max_ed, end=end, cov=cov)
    return out


@pytest.mark.parametrize("share", SHARES)
@pytest.mark.parametrize("w", [0, 1, 3, 5, 14])
def test_tiny_dp_loop_order_matches_plain(w, share):
    cov = Counter()
    for end in (True, False):
        arrays, kw = tiny_dp_inputs(np.random.default_rng(70 + w), 200, w,
                                    end=end, share=SHARES[share])
        got = tiny_scalar(*arrays, **kw, cov=cov)
        want = twalk.tiny_dp(*_torch(arrays), **kw)
        assert np.array_equal(got, want.numpy()), end
    need = {"pass_through"} if share != "all" else set()
    if share != "none":
        need |= {"n_clamped", "m_clamped", "cell", "lanes", "column0"}
        if w > 3:   # END's TN = TM = 2w + 2 > TINY_REG: rows in shared memory
            need.add("smem_row")
        if w:       # at w = 0 the only candidate is i = m
            need |= {"cand_better", "cand_worse", "cand_ed_tie",
                     "cand_key_tie", "cand_indel_sign_tie"}
    assert need <= {k for k, v in cov.items() if v}, need - set(cov)


def scan_scalar(ws, slot, lane, iv_spos, iv_epos, t2s, *, KSCAN, G, cov):
    """walk_scan_kernel's thread per (slot, lane): KSCAN steps while the
    lane scans, in the kernel's order."""
    _, STW, WPP = ws.shape
    NIV, NS = iv_spos.shape[0], t2s.shape[0]
    out = ws.astype(np.int64).copy()
    for x in range(STW * WPP):
        s, w = divmod(x, WPP)
        f = [int(v) for v in ws[:, s, w]]
        i_abs, xpos, exlen, covered, first, stat = f[:6]
        first = first != 0
        remref = f[11]
        tstart, toff, tlen = (int(v) for v in slot[:, s, w])
        is_left = lane[0, w] != 0
        qlen, pos = int(lane[1, w]), int(lane[2, w])
        iend, istop = w32(tstart + tlen - 1), tstart
        need = w32(qlen - covered)
        for _ in range(KSCAN):
            if stat != twalk.WK_SCAN:
                break
            cov["step"] += 1
            ivc = min(max(i_abs, 0), NIV - 1)
            ivs, ive = int(iv_spos[ivc]), int(iv_epos[ivc])
            ivl = w32(ive - ivs + 1)
            row = w32(i_abs - tstart)
            stt = int(t2s[min(max(w32(toff + row), 0), NS - 1)]) \
                if 0 <= row < tlen else 0
            if is_left:
                ended = i_abs < istop
                go0 = not ended
                if go0 and stt != 0:
                    if first:
                        cov["left_first"] += 1
                        exlen = w32(pos - ivs)
                    else:
                        if exlen == 0:
                            cov["left_xpos_restart"] += 1
                            xpos = w32(ive + 1)
                        exlen = w32(exlen + ivl)
                    first = False
                brk = go0 and exlen >= need
            else:
                ended = i_abs > iend
                go0 = not ended
                brk = go0 and exlen >= need
            stop = ended or brk
            trail_geo = ended and 0 < exlen < need
            if is_left:
                t_inb = w32(xpos - exlen) >= 1 and w32(xpos - 1) <= G
            else:
                t_inb = w32(xpos + 1) >= 1 and w32(xpos + exlen) <= G
            end_geo = stop and not trail_geo and covered < qlen \
                and exlen >= need
            rr2 = min(remref, exlen)
            if is_left:
                e_inb = rr2 >= 0 and w32(xpos - rr2) >= 1 \
                    and w32(xpos - 1) <= G
            else:
                e_inb = rr2 >= 0 and w32(xpos + 1) >= 1 \
                    and w32(xpos + rr2) <= G
            cov["rr2_negative"] += end_geo and rr2 < 0
            cov["trail_ref_oob"] += trail_geo and not t_inb
            go = go0 and not brk
            flush = go and stt == 1 and exlen > 0
            if trail_geo and t_inb:
                stat = twalk.WK_PTRAIL
            elif end_geo:
                stat = twalk.WK_PEND if e_inb else twalk.WK_PENDND
            elif flush:
                stat = twalk.WK_PMID if t_inb else twalk.WK_DONE
                cov["mid_oob"] += not t_inb
            elif stop:
                stat = twalk.WK_DONE
            if stat != twalk.WK_SCAN:
                cov[f"to{stat}"] += 1
                moved = stat in (twalk.WK_PMID, twalk.WK_PTRAIL,
                                 twalk.WK_PEND, twalk.WK_PENDND)
                if stat == twalk.WK_PMID:
                    f[6] = i_abs
                if moved:
                    f[7], f[9] = xpos, covered
                if stat in (twalk.WK_PMID, twalk.WK_PTRAIL):
                    f[8] = exlen
                if stat == twalk.WK_PEND:
                    f[10] = rr2
            adv = go and stt != 1
            empty = go and stt == 1 and exlen == 0
            cov["empty_left" if is_left else "empty_right"] += empty
            if not is_left:
                if (adv or empty) and stt != 0:
                    exlen = w32(exlen + ivl)
                if empty:
                    xpos = w32(ivs - 1)
                if adv or empty:
                    i_abs = w32(i_abs + 1)
            elif adv or empty:
                i_abs = w32(i_abs - 1)
        f[:6] = [i_abs, xpos, exlen, covered, int(first), stat]
        out[:, s, w] = f
    return out


def test_walk_scan_loop_order_matches_plain():
    cov = Counter()
    for seed, (STW, WPP, KSCAN) in enumerate([(8, 60, 12), (3, 50, 1),
                                              (8, 40, 30)]):
        arrays, kw = walk_scan_inputs(np.random.default_rng(300 + seed), STW,
                                      WPP, KSCAN=KSCAN)
        got = scan_scalar(*arrays, **kw, cov=cov)
        want = twalk.walk_scan(*_torch(arrays), **kw)
        assert np.array_equal(got, want.numpy()), seed
    need = {f"to{s}" for s in range(1, 6)} | {
        "mid_oob", "empty_left", "empty_right", "trail_ref_oob",
        "rr2_negative", "left_first", "left_xpos_restart"}
    assert need <= {k for k, v in cov.items() if v}, need - set(cov)


# --------------------------------------------------------------------------
# the kernels' arguments and the C source against the Python orders
# --------------------------------------------------------------------------

def _args_ok(name, args):
    assert len(args) == len(_ext.KERNELS[name].tensors)
    for x, dtype, shape in args:
        assert x.dtype == dtype and tuple(x.shape) == tuple(shape) \
            and x.is_contiguous(), (name, x.dtype, tuple(x.shape), shape)


def test_kernel_args_follow_the_specs():
    arrays, kw, _, _ = fold_case(5)
    t = _torch(arrays)
    out = twalk.walk_fold_lanes(*t, **kw)
    assert out.dtype == torch.int32 and tuple(out.shape) == (
        len(twalk.FOLD_OUT), t[8].shape[0])
    _args_ok("walk_fold", twalk.walk_fold_args(*t, out.contiguous()))
    for end in (True, False):
        arrays, kw = tiny_dp_inputs(np.random.default_rng(5), 9, 3, end=end,
                                    share=0.5)
        t = _torch(arrays)
        out = twalk.tiny_dp(*t, **kw)
        _args_ok("tiny_dp", twalk.tiny_dp_args(*t, out, end=end))
    arrays, kw = walk_scan_inputs(np.random.default_rng(5), 4, 7)
    t = _torch(arrays)
    out = twalk.walk_scan(*t, **kw)
    assert out.dtype == torch.int32 and out.shape == t[0].shape
    _args_ok("walk_scan", twalk.walk_scan_args(*t, out))
    # each C entry point takes the spec's tensors, then its statics
    with open(f"{_ext._CSRC}/walk.cu") as f:
        src = f.read()
    for name in ("walk_fold", "tiny_dp", "walk_scan"):
        spec = _ext.KERNELS[name]
        sig = re.search(rf'extern "C" int {spec.sym}\(([^)]*)\)',
                        src).group(1)
        params = [q.split()[-1].lstrip("*") for q in sig.split(",")]
        assert params == [*spec.tensors, *spec.statics, "stream"], name


def _enum(src, name):
    body = re.search(rf"enum {name} \{{([^}}]*)\}}", src).group(1)
    return [e.split("=")[0].strip() for e in body.split(",") if e.strip()]


def test_walk_enums_and_constants_follow_python():
    with open(f"{_ext._CSRC}/walk.cu") as f:
        src = f.read()
    assert _enum(src, "WalkStat") == ["WK_SCAN", "WK_PMID", "WK_PTRAIL",
                                      "WK_PEND", "WK_PENDND", "WK_DONE"]
    assert [getattr(twalk, k) for k in _enum(src, "WalkStat")] == list(
        range(6))
    assert [getattr(twalk, k) for k in _enum(src, "EventKind")] == list(
        range(5))
    assert _enum(src, "EventField") == ["EV_" + k.upper()
                                        for k in twalk.EV_KEYS] + ["EV_NF"]
    assert _enum(src, "FoldOut") == ["FO_" + k.upper()
                                     for k in twalk.FOLD_OUT] + ["NFO"]
    assert _enum(src, "ScanField") == ["WS_" + k.upper()
                                       for k in twalk.WS_KEYS] + ["WS_NF"]
    assert _enum(src, "SlotField") == ["SL_" + k.upper()
                                       for k in twalk.SLOT_KEYS] + ["SL_NF"]
    assert _enum(src, "LaneField") == ["LN_" + k.upper()
                                       for k in twalk.LANE_KEYS] + ["LN_NF"]
    assert _enum(src, "WalkKernel") == ["WALK_FOLD", "WALK_TINY",
                                        "WALK_SCAN"]
    assert WALK_EMPTY == {"walk_fold": 0, "tiny_dp": 1, "walk_scan": 2}
    consts = dict(re.findall(r"constexpr int (\w+) = (-?\d+);", src))
    assert int(consts["NEG_SCORE"]) == NEG_SCORE
    assert int(consts["POS"]) == POS
    assert "if (row * nt > 48 * 1024)" in src and \
        twalk.TINY_MM_MAX == 48 * 1024 // (4 * 32) - 1
    assert "if (ST > FOLD_T || EW > 2 * FOLD_EW)" in src
    assert (twalk.FOLD_ST_MAX, twalk.FOLD_EW_MAX) == (
        int(consts["FOLD_T"]), 2 * int(consts["FOLD_EW"]))
    assert twalk.STW <= twalk.FOLD_ST_MAX


class _Cuda(torch.Tensor):
    """A CPU tensor that takes a wrapper's card path."""
    @property
    def is_cuda(self):
        return True


def test_tiny_dp_refuses_rows_it_cannot_read():
    """On a CUDA tensor the wrapper checks NM / MM against the rows before
    it builds; on the CPU the plain version runs (a fake tensor that
    reports is_cuda takes the card path here)."""
    Cuda = _Cuda
    s = torch.zeros((3, 6), dtype=torch.int8).as_subclass(Cuda)
    n = torch.zeros(3, dtype=torch.int32)
    tiny = torch.ones(3, dtype=torch.bool)
    banded = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="tiny_dp reads"):
        twalk.tiny_dp(s, s, n, n, tiny, banded, NM=8, MM=8, w=3, max_ed=4,
                      end=True)
    wide = torch.zeros((3, 400), dtype=torch.int8).as_subclass(Cuda)
    with pytest.raises(ValueError, match="at most"):
        twalk.tiny_dp(wide, wide, n, n, tiny, banded, NM=390, MM=390, w=194,
                      max_ed=4, end=True)


def test_walk_fold_refuses_lanes_it_cannot_hold():
    """On a CUDA tensor the wrapper checks ST and EW against the kernel's
    threads a lane and events a thread before it builds."""
    for ST, EW in ((9, 4), (2, 9)):
        arrays, kw, _, _ = fold_case(3)
        events = torch.zeros((ST * EW, twalk.EV_NF, 40), dtype=torch.int32)
        act = torch.zeros((ST, 40), dtype=torch.bool)
        t = _torch(arrays)
        with pytest.raises(ValueError, match="at most"):
            twalk.walk_fold_lanes(events.as_subclass(_Cuda), act, *t[2:],
                                  **kw)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (chip_smoke.py runs the kernels there)")
    return torch.device("cuda")


def _cases():
    """(kernel name, kernel call, plain call) on the card: the fold of
    every family and side, the tiny DP in both modes from w = 0 to a band
    whose row lives in shared memory, with no row, half the rows or every
    row falling back to it, the scan over ragged shapes."""
    out = []
    for seed, (B, P, WPP, fam, left, EW) in enumerate(
            [(4096, 8, 6144, 0, True, 4), (64, 8, 768, 2, False, 4),
             (3, 2, 5, 3, True, 4), (33, 4, 129, 1, False, 7)]):
        rng = np.random.default_rng(seed)
        arrays, kw = walk_fold_inputs(rng, WPP, B * 2 * P, fam=fam,
                                      left=left, EW=EW)
        t = [x.cuda() for x in _torch(arrays)]
        out.append(("walk_fold",
                    lambda t=t, kw=kw: (twalk.walk_fold_lanes(*t, **kw),),
                    lambda t=t, kw=kw: (twalk._walk_fold_plain(*t, **kw),)))
    for seed, (B, w, end, share) in enumerate(
            [(512, 3, True, 0.5), (4096, 3, False, 0.5), (512, 3, True, 0.0),
             (4096, 3, False, 1.0), (1, 0, True, 1.0), (300, 5, True, 0.5),
             (300, 31, True, 1.0), (129, 62, True, 0.5),
             (77, 1, False, 0.0)]):
        arrays, kw = tiny_dp_inputs(np.random.default_rng(seed), B, w,
                                    end=end, share=share)
        t = [x.cuda() for x in _torch(arrays)]
        out.append(("tiny_dp", lambda t=t, kw=kw: (twalk.tiny_dp(*t, **kw),),
                    lambda t=t, kw=kw: (twalk._tiny_dp_plain(*t, **kw),)))
    for seed, (STW, WPP, KSCAN) in enumerate([(8, 6144, 12), (3, 33, 1),
                                              (8, 129, 30)]):
        arrays, kw = walk_scan_inputs(np.random.default_rng(seed), STW, WPP,
                                      KSCAN=KSCAN)
        t = [x.cuda() for x in _torch(arrays)]
        out.append(("walk_scan",
                    lambda t=t, kw=kw: (twalk.walk_scan(*t, **kw),),
                    lambda t=t, kw=kw: (twalk._walk_scan_plain(*t, **kw),)))
    return out


@pytest.mark.cuda
def test_walk_kernels_match_plain_on_card(cuda_device):
    for name, kern, plain in _cases():
        _ext.reset_launches()
        got = kern()
        assert _ext.LAUNCHES[name] == 1
        for g, w in zip(got, plain()):
            assert torch.equal(g, w), name


@pytest.mark.cuda
def test_walk_kernels_replay_in_a_cuda_graph(cuda_device):
    """Each wrapper captured in a CUDA graph (the step's form) replays the
    plain version's outputs."""
    for name, kern, plain in _cases():
        kern()                           # load the library outside capture
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = kern()
        for x in out:
            x.fill_(-7)
        graph.replay()
        for g, w in zip(out, plain()):
            assert torch.equal(g, w), name
