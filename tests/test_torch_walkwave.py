"""The walk's lane set-up and wave body on the CPU: ``walk_init``,
``walk_pool`` and ``walk_commit`` (csrc/walk_wave.cu) and the
``walk_waves`` they compose with the scan and DP kernels.

- The port's plain ``walk_waves`` (the three plain versions between
  ``walk_scan`` and the pooled DPs) against the reference's
  ``circminer_tpu.ops.device_walk.walk_waves`` under ``jax.jit``, bit for
  bit on ``events``, ``act``, ``inv``, ``n_act``, ``over`` and
  ``lane_defer``, on adversarial lane tables made with numpy from a seed:
  pools small enough to overflow, dedup ties across slots, both sides in
  every family layout, windows across the genome's ends and the reads'
  row ends, a negative rr2, more than STW common tids, lanes that need
  more than EW waves, more active slots than WPP lanes, no active slot
  (empty pools), fewer tid slots than STW.
- A scalar transcription of each kernel's per-thread work in its loop
  order (walk_init: each cluster's rank of the flag groups, the CTAs'
  counts exchanged, the lanes' tables filled across CTAs, the set-up and
  the dead lanes, the events' zeroing at every alignment; walk_pool: the
  lane-major dedup, the per-CTA per-slot counts and the cross-CTA base,
  the follower's code from its own lane, the rows' table, a warp a pool
  row, the dead rows from one gathered S - 1 window; the commit's
  selects) against its plain version, with counts that show every branch
  taken.
- Each ``*_args`` list against the C signatures in csrc/walk_wave.cu, and
  its enums and constants against ``WS_KEYS``, ``EV_KEYS``, ``WK_*`` /
  ``EVK_*``, ``LANE_KEYS``, ``SLOT_KEYS``, ``PROW_KEYS``, ``POOL_ROWS`` and
  the map codes; the wrappers' refusals on the card path.
- ``cuda``-marked (skipped without a card): each kernel against its plain
  version on the card, eagerly and replayed in a captured CUDA graph.

Every output is an integer: every comparison is exact (tolerance 0)."""

import re
from collections import Counter
from types import SimpleNamespace as NS

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (WALK_SWEEP, WAVE_EMPTY, walk_anno, walk_case,
                        walk_commit_inputs, walk_init_inputs,
                        walk_pool_inputs)
from circminer_tpu.ops import device_walk as jwalk
from circminer_tpu_torch.ops import _ext
from circminer_tpu_torch.ops import device_walk as twalk

WS = {k: i for i, k in enumerate(twalk.WS_KEYS)}
W = 127            # the windows' bases (I - 1)


def w32(x):
    """x as int32 with two's-complement wrap-around."""
    return ((int(x) + 2 ** 31) % 2 ** 32) - 2 ** 31


def _torch(arrays):
    return [torch.from_numpy(np.require(a, requirements="C")) for a in arrays]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# walk_waves, the plain versions composed, against JAX
# --------------------------------------------------------------------------

LEFT4 = [True, True, False, False]
# (seed, options): the main layout, pools that overflow, one wave of short
# scans (lanes that need more waves), the families mirrored with band 0
# (every middle DP a tiny one), no active slot, four tid slots, more active
# slots than lanes, a wide band (indels past the band over two middle DPs
# take remref below 0: an end with a negative rr2)
CASES = {
    "main": (1, {}),
    "pools_overflow": (2, dict(MIDP=4, ENDP=4)),
    "one_wave": (3, dict(EW=1, KSCAN=3)),
    "mirrored_band0": (4, dict(left4=[False, True, True, False], band=0)),
    "no_lanes": (5, dict(share=0.0)),
    "four_tid_slots": (6, dict(ST=4)),
    "past_wpp": (7, dict(share=0.9, WPP=32)),
    "wide_band": (0, dict(band=14, max_ed=8)),
}


def waves_case(seed, *, share=0.5, ST=16, B=6, P=4, NIV=50, NT=24, R=40,
               L=150, **st):
    """Adversarial walk_waves inputs (numpy) and statics: a walk_anno
    annotation, [4, N] lane tables whose positions sit at their anchor
    interval's bounds or anywhere from before the genome to past its end,
    anchors off the table, query windows starting before their row and
    running past it (and rows past the reads), half the pairs with one
    anchor interval for both mates."""
    rng = np.random.default_rng(seed)
    an = walk_anno(rng, NIV, NT, ST)
    G, N = an["G"], B * 2 * P

    def r(lo, hi, shape):
        return rng.integers(lo, hi, size=shape).astype(np.int32)
    act4 = rng.random((4, N)) < share
    aiv4 = r(-1, NIV + 1, (4, N))
    aivc = np.clip(aiv4, 0, NIV - 1)
    at_iv = np.where(rng.random((4, N)) < 0.5, an["iv_spos"][aivc],
                     an["iv_epos"][aivc]) + r(-2, 3, (4, N))
    pos4 = np.where(rng.random((4, N)) < 0.6, at_iv,
                    r(-3, G + 3, (4, N))).astype(np.int32)
    fiv, riv = r(-1, NIV + 1, N), r(-1, NIV + 1, N)
    riv = np.where(rng.random(N) < 0.5, fiv, riv).astype(np.int32)
    tabs = (act4, pos4, r(0, 120, (4, N)), aiv4, r(0, R + 1, (4, N)),
            r(-2, 40, (4, N)))
    statics = dict(band=3, max_ed=4, max_sc=7, mat=1, mis=-3, ind=-3, xd=8,
                   EW=4, KSCAN=6, WPP=64, MIDP=64, ENDP=64)
    statics.update(st)
    left4 = statics.pop("left4", LEFT4)
    return dict(tabs=tabs, fiv=fiv, riv=riv,
                seqsf=rng.integers(0, 5, R * L).astype(np.int8), L=L,
                genome=rng.integers(0, 5, G).astype(np.int8), an=an,
                left4=left4, statics=statics)


def _run_port(c):
    an = c["an"]
    ad = NS(iv_spos=torch.from_numpy(an["iv_spos"]),
            iv_epos=torch.from_numpy(an["iv_epos"]))
    fa = NS(**{k: torch.from_numpy(an[k]) for k in (
        "iv_tids", "trans_start", "t2s_off", "t2s_state")})
    return twalk.walk_waves(
        *_torch(c["tabs"]), c["left4"], torch.from_numpy(c["fiv"]),
        torch.from_numpy(c["riv"]), torch.from_numpy(c["seqsf"]), c["L"],
        torch.from_numpy(c["genome"]), ad, fa, **c["statics"])


def _run_jax(c):
    an = c["an"]
    ad = NS(iv_spos=jnp.asarray(an["iv_spos"]),
            iv_epos=jnp.asarray(an["iv_epos"]))
    fa = NS(**{k: jnp.asarray(an[k]) for k in (
        "iv_tids", "trans_start", "t2s_off", "t2s_state")})

    def fn(act4, pos4, len4, aiv4, row4, qs04, fiv, riv, seqsf, genome):
        return jwalk.walk_waves(act4, pos4, len4, aiv4, row4, qs04,
                                c["left4"], fiv, riv, seqsf, c["L"], genome,
                                ad, fa, **c["statics"])
    return jax.jit(fn)(*(jnp.asarray(x) for x in (
        *c["tabs"], c["fiv"], c["riv"], c["seqsf"], c["genome"])))


class _Seen:
    """Wraps the plain walk_pool and walk_commit inside walk_waves and
    keeps what a case asks of them: pool overflows, the DP rows, the
    lanes not done after the last wave, the negative rr2s."""

    def __init__(self, monkeypatch):
        self.c = Counter()
        pool, commit = twalk.walk_pool, twalk.walk_commit

        def walk_pool(*a, **kw):
            out = pool(*a, **kw)
            self.c["over"] += int((out.maps == twalk.MAP_OVER).sum())
            self.c["rows"] += int(out.n.sum())
            self.c["followers"] += int((out.maps >= 0).sum()) \
                - int(out.n.sum())
            return out

        def walk_commit(ws, maps, md, xres, e_rows, lane, iv_spos, iv_epos,
                        events, nev, **kw):
            out = commit(ws, maps, md, xres, e_rows, lane, iv_spos, iv_epos,
                         events, nev, **kw)
            st = out[WS["stat"]]
            self.c["pending"] = int((st != twalk.WK_DONE).sum())
            self.c["negative_rr2"] += int(
                ((ws[WS["stat"]] == twalk.WK_PENDND)
                 & (torch.minimum(ws[WS["remref"]], ws[WS["exlen"]]) < 0))
                .sum())
            return out
        monkeypatch.setattr(twalk, "walk_pool", walk_pool)
        monkeypatch.setattr(twalk, "walk_commit", walk_commit)


@pytest.mark.parametrize("case", CASES)
def test_plain_walk_waves_match_jax(case, monkeypatch):
    seed, opts = CASES[case]
    c = waves_case(seed, **opts)
    seen = _Seen(monkeypatch)
    got = _run_port(c)
    want = _run_jax(c)
    for k in ("events", "act", "inv", "n_act", "over", "lane_defer",
              "p_pos", "p_len", "p_live"):
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype,
                                                           w.dtype)
        assert np.array_equal(g, w), (k, np.argwhere(g != w)[:5])
    for k in ("N", "ST", "EW", "WPP"):
        assert got[k] == want[k], k
    kinds = Counter(got["events"][:, 0].reshape(-1).tolist())
    n = seen.c
    if case == "no_lanes":
        assert int(got["n_act"]) == 0 and set(kinds) == {twalk.EVK_NONE}
        assert n["rows"] == 0
        return
    # the case is not vacuous: walks ran and emitted
    assert kinds[twalk.EVK_MID] and kinds[twalk.EVK_END], kinds
    if case == "main":
        assert all(kinds[k] for k in range(1, 5)), kinds
        assert n["followers"] > 0 and got["lane_defer"].any()
        assert got["act"].sum(0).max() > 1            # several tids a lane
    if case == "pools_overflow":
        assert n["over"] > 0, n
    if case == "one_wave":
        assert n["pending"] > 0 and got["lane_defer"].any(), n
    if case == "past_wpp":
        assert got["over"].any() and int(got["n_act"]) == 32
    if case == "four_tid_slots":
        assert got["act"].shape[0] == 4
    if case == "wide_band":
        assert n["negative_rr2"] > 0, n
    assert (got["lane_defer"] & ~got["p_live"]).sum() == 0


def test_walk_waves_cases_hold_lanes_past_stw_tids():
    """Over the cases together, lanes with more common tids than STW (they
    defer: lane_defer holds over_tid)."""
    over_tid = 0
    for seed, opts in CASES.values():
        c = waves_case(seed, **opts)
        t = _torch(c["tabs"])
        an = {k: torch.from_numpy(v) for k, v in c["an"].items()
              if k != "G"}
        wi = twalk._walk_init_plain(
            *t, torch.from_numpy(c["fiv"]), torch.from_numpy(c["riv"]),
            an["iv_epos"], an["iv_tids"], an["trans_start"], an["t2s_off"],
            left4=tuple(c["left4"]), band=c["statics"]["band"],
            EW=c["statics"]["EW"], WPP=c["statics"]["WPP"])
        over_tid += int(wi.over_tid.sum())
        assert not (wi.over_tid & ~_run_port(c)["lane_defer"]).any()
    assert over_tid > 0


# --------------------------------------------------------------------------
# scalar transcriptions of the kernels' loop orders
# --------------------------------------------------------------------------

def _src():
    with open(f"{_ext._CSRC}/walk_wave.cu") as f:
        return f.read()


# the launch constants of csrc/walk_wave.cu, read from the source
K = {k: int(v) for k, v in
     re.findall(r"constexpr int (\w+) = (-?\d+);", _src())}
CS = K["CS"]             # CTAs of a walk_init cluster


def init_geo(N, WPP):
    """walk_init's launch (csrc/walk_wave.cu ``init_geo``): ncl clusters
    of CS blocks of nt threads; a block's chunk of the [4N] flags is gpt
    32-flag groups a thread; a block sets up tpc table slots of lanes;
    smem bytes of shared memory."""
    groups = -(-4 * N // 32)
    per_cta = -(-groups // CS)
    nt = -(-per_cta // 32) * 32 if per_cta < K["MAX_NT"] else K["MAX_NT"]
    lgroups = -(-WPP // 32)
    tg = (K["SMEM_MAX"] // 4 - K["MAX_NT"] // 32 - CS) // 32
    ncl = max(min(K["INIT_CL"], -(-lgroups // CS)), -(-lgroups // (CS * tg)))
    tpc = -(-lgroups // (ncl * CS)) * 32
    return NS(nt=nt, gpt=-(-per_cta // nt), ncl=ncl, tpc=tpc,
              smem=4 * (tpc + nt // 32 + CS))


def pool_geo(WPP, MIDP, ENDP, W):
    """walk_pool's launch (csrc/walk_wave.cu ``pool_geo``): two clusters
    (MID, END) of PCS blocks of nt threads; lpc lanes a block, nch a
    thread, the first nchs kept in shared memory; rpc pool rows a block,
    the first rcap in its table; smem bytes of shared memory."""
    PCS, STW = K["PCS"], K["STW_MAX"]
    lpc = -(-WPP // PCS)
    nt = -(-lpc // 32) * 32 if lpc < K["POOL_NT"] else K["POOL_NT"]
    nch = -(-lpc // nt)
    rpc = -(-max(MIDP, ENDP) // PCS)
    fixed = (2 * W + 15) // 16 * 16 + 4 * (
        STW * (nch * nt // 32) + PCS * STW + 2 * STW + 4)
    avail = max(K["SMEM_MAX"] - fixed, 0)
    nchs = min(nch, avail // (20 * nt))
    rcap = min(rpc, (avail - 20 * nchs * nt) // 16)
    return NS(nt=nt, lpc=lpc, nch=nch, rpc=rpc, nchs=nchs, rcap=rcap,
              smem=fixed + 20 * nchs * nt + 16 * rcap)


def zero_scalar(n, offset, nthreads, cov):
    """walk_init's zero_words over n int32 words whose address is offset
    bytes past a 16-byte boundary, a grid of nthreads threads: a word
    store each up to the boundary, 16-byte stores, a word store each
    after them.  Returns each word's count of stores."""
    writes = np.zeros(n, np.int64)
    head = min((16 - offset) % 16 // 4, n)
    nv = (n - head) // 4
    cov["zero_head"] += head > 0
    cov["zero_tail"] += head + 4 * nv < n
    for t in range(nthreads):
        writes[t:head:nthreads] += 1
        for v in range(t, nv, nthreads):
            writes[head + 4 * v:head + 4 * v + 4] += 1
        writes[head + 4 * nv + t::nthreads] += 1
    return writes


def init_scalar(act4, pos4, len4, aiv4, row4, qs04, fiv, riv, iv_epos,
                iv_tids, trans_start, t2s_off, *, left4, band, EW, WPP, cov,
                geo=None, align=0):
    """walk_init: ncl clusters of CS CTAs of nt threads (``init_geo``).
    In every cluster CTA c counts chunk c of the [4N] flags, gpt 32-flag
    groups a thread (those past GPT_REG read again to be placed), and
    scans the threads' counts; after the cluster
    barrier it adds the CTAs' counts before its own.  The thread ranking a
    flag of lane j = r - 1 writes the flag's index into the table of the
    CTA that sets lane j up (cluster J mod ncl of lane group J = j / 32,
    CTA (J / ncl) mod CS, slot (J / (ncl CS)) 32 + j mod 32), and a flag
    group's over bytes are written by cluster (group mod ncl).  After the
    second barrier each CTA sets up its table's lanes, four a warp, eight
    threads a lane (those past n_act from flat 4N - 1): thread k tests
    f_iv's tid slots k and k + 8 against r_iv's list (every slot where ST
    passes 16), two ballots give the lane's common tids, thread k takes
    the (k + 1)-th and writes transcript slot k, thread 0 the lane's
    words.  Then the events and counts (align bytes past a 16-byte
    boundary) are zeroed by the grid's threads (``zero_scalar``) while
    the first barrier completes."""
    N = fiv.shape[0]
    NIV, ST = iv_tids.shape
    NT = trans_start.shape[0]
    STW = min(ST, twalk.STW)
    g = geo or init_geo(N, WPP)
    nt, gpt, ncl, tpc = g.nt, g.gpt, g.ncl, g.tpc
    F = 4 * N
    flags = act4.reshape(-1).astype(bool)
    cov["several_groups"] += gpt > 1
    cov["several_clusters"] += ncl > 1
    cov["more_clusters"] += ncl > K["INIT_CL"]

    def group(fg):
        return [k for k in range(32) if fg + k < F and flags[fg + k]]
    # each thread's groups, its count and its prefix in its CTA
    bits = {(c, x, i): group(((c * nt + x) * gpt + i) * 32)
            for c in range(CS) for x in range(nt) for i in range(gpt)
            if ((c * nt + x) * gpt + i) * 32 < F}
    cnt = {(c, x): sum(len(bits.get((c, x, i), ())) for i in range(gpt))
           for c in range(CS) for x in range(nt)}
    ctot = [sum(cnt[c, x] for x in range(nt)) for c in range(CS)]
    total = sum(ctot)
    nact = min(total, WPP)
    lb = sum(1 << f for f, left in enumerate(left4) if left)
    out = dict(inv=np.full(WPP, -7, np.int64),
               over=np.full(F, 2, np.int64),
               act=np.full((STW, WPP), 2, np.int64),
               p_live=np.full(WPP, 2, np.int64),
               over_tid=np.full(WPP, 2, np.int64),
               ws=np.full((len(WS), STW, WPP), -7, np.int64),
               slot=np.full((3, STW, WPP), -7, np.int64),
               lane=np.full((3, WPP), -7, np.int64),
               prow=np.full((2, WPP), -7, np.int64))
    p4 = [a.reshape(-1) for a in (pos4, len4, aiv4, row4, qs04)]
    for gc in range(ncl):
        table = [[None] * tpc for _ in range(CS)]
        for c in range(CS):
            cbase = sum(ctot[:c])
            cov["cross_cta_base"] += cbase > 0
            r = cbase
            for x in range(nt):
                for i in range(gpt):
                    fg = ((c * nt + x) * gpt + i) * 32
                    if fg >= F:
                        break
                    on = bits[c, x, i]
                    cov["group_read_again"] += i >= K["GPT_REG"]
                    if fg // 32 % ncl == gc:        # this group's over bytes
                        for k in range(min(32, F - fg)):
                            rk = r + sum(b <= k for b in on)
                            out["over"][fg + k] = k in on and rk > WPP
                            cov["past_limit"] += k in on and rk > WPP
                    rk = r
                    r += len(on)
                    for b in on:
                        if rk >= WPP:
                            break
                        j, rk = rk, rk + 1
                        J = j // 32
                        if J % ncl != gc:
                            continue
                        owner = J // ncl % CS
                        cov["table_remote"] += owner != c
                        table[owner][J // (ncl * CS) * 32 + j % 32] = fg + b
        for c in range(CS):
            for s in range(tpc):
                j = ((s // 32 * CS + c) * ncl + gc) * 32 + s % 32
                if j >= WPP:
                    continue
                live = j < nact
                f = table[c][s] if live else F - 1
                assert f is not None, (gc, c, s, j)
                out["inv"][j] = f
                pos, ln, aiv, row, qs0 = (int(a[f]) for a in p4)
                left = bool((lb >> (f // N)) & 1)
                cov["left" if left else "right"] += 1
                cov["live" if live else "dead_lane"] += 1
                tf = iv_tids[min(max(int(fiv[f % N]), 0), NIV - 1)]
                tr = iv_tids[min(max(int(riv[f % N]), 0), NIV - 1)]
                if ST <= 16:            # thread k: tid slots k and k + 8
                    memb = [[live and t < ST and tf[t] >= 0
                             and (tr == tf[t]).any() for t in (k, k + 8)]
                            for k in range(8)]
                    mask = sum(memb[k][h] << (k + 8 * h) for k in range(8)
                               for h in range(2))
                    pack = [t for t in range(16) if mask >> t & 1]
                    cov["two_ballots"] += mask >> 8 > 0
                else:
                    pack = [t for t in range(ST)
                            if live and tf[t] >= 0 and (tr == tf[t]).any()]
                    cov["wide_tid_list"] += 1
                over_t = live and len(pack) > STW
                cov["over_tid"] += over_t
                anchor = w32(int(iv_epos[min(max(aiv, 0), NIV - 1)]) - pos)
                for k in range(STW):
                    p = pack[k] if k < len(pack) else ST
                    cov["vacant_slot"] += p == ST
                    tid = int(tf[min(max(p, 0), ST - 1)])
                    tc = min(max(tid, 0), NT - 1)
                    a = p < ST and not over_t
                    out["act"][k, j] = a
                    out["slot"][:, k, j] = (trans_start[tc], t2s_off[tc],
                                            w32(t2s_off[tc + 1]
                                                - t2s_off[tc]))
                    st = out["ws"][:, k, j]
                    st[:] = 0
                    st[WS["i_abs"]] = aiv if left else w32(aiv + 1)
                    st[WS["xpos"]] = pos
                    st[WS["exlen"]] = 0 if left else anchor
                    st[WS["first"]] = left
                    st[WS["stat"]] = twalk.WK_SCAN if a else twalk.WK_DONE
                    st[WS["remref"]] = w32(ln + band)
                out["lane"][:, j] = (left, ln, pos)
                out["prow"][:, j] = (row, qs0)
                out["p_live"][j], out["over_tid"][j] = live, over_t
    nthreads = ncl * CS * nt
    events = np.full((STW, EW, twalk.EV_NF, WPP), -7, np.int64)
    nev = np.full((STW, WPP), -7, np.int64)
    for x in (events, nev):
        writes = zero_scalar(x.size, align, nthreads, cov)
        assert (writes == 1).all(), np.argwhere(writes != 1)[:3]
        x.reshape(-1)[:] = 0
    return dict(out, n_act=nact, events=events, nev=nev)


def pool_scalar(ws, lane, prow, seqsf, genome, *, L, band, MIDP, ENDP,
                cov, geo=None):
    """walk_pool: a cluster of CS (PCS) CTAs a pool
    (``pool_geo``).  Pass A: CTA c's thread x takes lane c lpc + i nt + x
    of each chunk i, loads its STW slots' status, then the geometry of the
    slots in the pool and the lane's words where it has one, dedups the
    slots (the first earlier slot in the pool with the slot's geometry, or
    a leader), and each (slot, chunk, warp)'s leaders are counted and
    scanned, the slots' counts pushed to every CTA.  While the cluster
    barrier completes one warp gathers flat S - 1's windows.  After it a
    leader of slot t has rank: every CTA's leaders of the slots before t,
    the CTAs before c's of slot t, its (chunk, warp)'s prefix, the lanes
    below it in its ballot, + 1.  Pass B writes the maps (a follower its
    own lane's leader's code), each leader row's n, m, flat index and tiny
    bit, and its window geometry into table slot j / CS of CTA j mod CS.
    After the second barrier warp w of CTA c gathers rows j = q CS + c,
    q = w, w + NW, ...; rows past the count copy the gathered windows.
    Past shared memory (``pool_geo``) a thread's lanes past its first nchs
    are loaded and deduped again in pass B, and a live row past a CTA's
    rcap table slots takes its geometry from its flat index after the
    barrier."""
    _, STW, WPP = ws.shape
    S = STW * WPP
    RL, G = len(seqsf), len(genome)
    g = geo or pool_geo(WPP, MIDP, ENDP, W)
    nt, lpc, nch, nchs, rcap = g.nt, g.lpc, g.nch, g.nchs, g.rcap
    CS = K["PCS"]
    NW = nt // 32
    M = nch * NW
    cov["several_chunks"] += nch > 1

    def words(l_):
        return lane[0, l_] != 0, lane[1, l_], w32(int(prow[0, l_]) * L), \
            prow[1, l_]

    def geometry(f, kind, lw):
        t, l_ = divmod(f, WPP)
        xpos, cv = ws[WS["pend_xpos"], t, l_], ws[WS["pend_cov"], t, l_]
        rn = ws[WS["pend_exlen" if kind == "m" else "pend_rr"], t, l_]
        left, qlen, base, _ = lw
        need = w32(qlen - cv)
        qn = min(w32(rn + band), need) if kind == "m" else need
        if not left:
            q0, r0 = w32(base + prow[1, l_] + cv), int(xpos)
        else:
            qend = w32(prow[1, l_] + qlen - cv) if kind == "m" \
                else w32(prow[1, l_] + qn)
            q0, r0 = w32(base + qend - 1), w32(xpos - 2)
        return dict(q0=q0, r0=r0, qn=int(qn), rn=int(rn), left=left)

    def window(p, kind):
        qw, rw = np.zeros(W, np.int64), np.zeros(W, np.int64)
        qn, rn = min(max(p["qn"], 0), W), min(max(p["rn"], 0), W)
        cov[f"{kind}_{'left' if p['left'] else 'right'}"] += 1
        for io in range(W):
            st = -io if p["left"] else io
            qi, ri = w32(p["q0"] + st), w32(p["r0"] + st)
            qw[io] = seqsf[min(max(qi, 0), RL - 1)] if io < qn else 127
            cov["query_row_cross"] += io < qn and qi // L != p["q0"] // L
            inside = io < rn and 0 <= ri < G
            cov["ref_off_genome"] += io < rn and not inside
            rw[io] = genome[ri] if inside else 127
        return (qw, rw) if kind == "m" else (rw, qw)

    out = {}
    for kind, P, fields in (("m", MIDP, ("pend_xpos", "pend_exlen",
                                         "pend_cov")),
                            ("e", ENDP, ("pend_xpos", "pend_cov",
                                         "pend_rr"))):
        stat = ws[WS["stat"]]
        def lane_code(k, l_):
            """Lane l_'s codes (a leader "L", a follower its slot u, or
            None) and whether a slot of it is in the pool."""
            cw, anyin = [None] * STW, False
            if k < lpc and l_ < WPP:
                inp = [stat[t, l_] in (twalk.WK_PMID, twalk.WK_PTRAIL)
                       if kind == "m" else stat[t, l_] == twalk.WK_PEND
                       for t in range(STW)]
                geo_ = [tuple(ws[WS[f], t, l_] for f in fields)
                        if inp[t] else (0, 0, 0) for t in range(STW)]
                anyin = any(inp)
                for t in range(STW):
                    if not inp[t]:
                        continue
                    cw[t] = "L"
                    for u in range(t):          # the first match
                        if inp[u] and geo_[u] == geo_[t]:
                            cw[t] = u
                            cov["follower"] += 1
                            break
                    cov["leader"] += cw[t] == "L"
            return cw, anyin

        stat = ws[WS["stat"]]
        # pass A: the codes (kept in shared memory for a thread's first
        # nchs lanes, with the words of lanes that have a slot in the pool)
        # and each (slot, chunk, warp)'s leaders
        code, held, cnt = {}, {}, np.zeros((CS, STW, M), np.int64)
        lanew = {}
        for c in range(CS):
            for i in range(nch):
                for x in range(nt):
                    k = i * nt + x
                    l_ = c * lpc + k
                    cw, anyin = lane_code(k, l_)
                    held[c, k] = cw               # in registers
                    if i < nchs:
                        code[c, k] = cw
                        if anyin:
                            lanew[c, k] = words(l_)
                        elif k < lpc and l_ < WPP:
                            cov["lane_words_skipped"] += 1
                    for t in range(STW):
                        cnt[c, t, i * NW + x // 32] += cw[t] == "L"
        pre = np.cumsum(cnt, axis=2) - cnt                # a slot's prefix
        tot = cnt.sum(axis=2)                             # [CS, STW], pushed
        allv = tot.sum(axis=0)
        nlive = min(int(allv.sum()), P)
        dp = geometry(S - 1, kind, words(WPP - 1))        # one warp a CTA
        dead = window(dp, kind)
        maps = np.full((STW, WPP), -9, np.int64)
        rows = np.full((3, P), -9, np.int64)
        tiny = np.full(P, 2, np.int64)
        win = np.full((2, P, W), -9, np.int64)
        table = [[None] * rcap for _ in range(CS)]
        for c in range(CS):
            before = tot[:c].sum(axis=0)
            cov["cross_cta_base"] += bool((before > 0).any())
            for i in range(nch):
                for x in range(nt):
                    k = i * nt + x
                    l_ = c * lpc + k
                    if i < nchs:
                        cw, lw = code[c, k], lanew.get((c, k))
                    else:                         # past shared memory
                        cw, anyin = lane_code(k, l_)
                        lw = words(l_) if anyin else None
                        cov["lanes_loaded_again"] += 1
                    mc = []
                    for t in range(STW):
                        v = twalk.MAP_NONE
                        if cw[t] == "L":
                            w0 = x // 32 * 32
                            below = sum(held[c, i * nt + y][t] == "L"
                                        for y in range(w0, x))
                            r = int(allv[:t].sum() + before[t]
                                    + pre[c, t, i * NW + x // 32] + below + 1)
                            v = r - 1 if r <= P else twalk.MAP_OVER
                            cov["over"] += r > P
                            if r <= P:
                                j, f = r - 1, t * WPP + l_
                                p = geometry(f, kind, lw)
                                rows[:, j] = (p["qn"], p["rn"], f) \
                                    if kind == "m" else (p["rn"], p["qn"], f)
                                tiny[j] = p["qn"] <= 2 * band \
                                    or p["rn"] <= band
                                if j // CS < rcap:
                                    cov["table_remote"] += j % CS != c
                                    table[j % CS][j // CS] = p
                        elif cw[t] is not None:
                            v = mc[cw[t]]
                        mc.append(v)
                        if k < lpc and l_ < WPP:
                            maps[t, l_] = v
        for c in range(CS):                     # after the second barrier
            q_end = -(-(P - c) // CS) if P > c else 0
            q_dead = -(-(nlive - c) // CS) if nlive > c else 0
            for w in range(NW):
                for q in range(w, q_end, NW):
                    j = q * CS + c
                    if q < q_dead:
                        if q < rcap:
                            p = table[c][q]
                        else:           # from its flat index (PR_INV)
                            f = int(rows[2, j])
                            p = geometry(f, kind, words(f % WPP))
                            cov["row_past_table"] += 1
                        win[0, j], win[1, j] = window(p, kind)
                        continue
                    cov["dead_pool_row"] += 1
                    cov["dead_row_past_table"] += q >= rcap
                    win[0, j], win[1, j] = dead
                    rows[:, j] = (dp["qn"], dp["rn"], S - 1) \
                        if kind == "m" else (dp["rn"], dp["qn"], S - 1)
                    tiny[j] = dp["qn"] <= 2 * band or dp["rn"] <= band
        out[kind] = (win, rows, tiny.astype(bool), nlive, maps)
    return twalk.WalkPool(
        m_win=out["m"][0], m_rows=out["m"][1], m_tiny=out["m"][2],
        e_win=out["e"][0], e_rows=out["e"][1],
        n=np.array([out["m"][3], out["e"][3]]),
        maps=np.stack([out["m"][4], out["e"][4]]))


def commit_scalar(ws, maps, md, xres, e_rows, lane, iv_spos, iv_epos,
                  events, nev, *, mat, mis, band, max_ed, max_sc, cov):
    """walk_commit: a thread a (slot, lane)."""
    _, STW, WPP = ws.shape
    EW = events.shape[1]
    NIV = len(iv_spos)
    ws = ws.astype(np.int64).copy()
    events, nev = events.astype(np.int64).copy(), nev.astype(np.int64).copy()
    for t in range(STW):
        for l_ in range(WPP):
            st = ws[:, t, l_]
            left = lane[0, l_] != 0
            mm, em = int(maps[0, t, l_]), int(maps[1, t, l_])
            md_ed, md_in = (int(md[mm, 0]), int(md[mm, 1])) if mm >= 0 \
                else (0, 0)
            e = (0, 0, 0, 0)
            if em >= 0:
                sc, on_s, on_t = (int(v) for v in xres[em])
                m = int(e_rows[1, em])
                ed = w32(mat * max(on_s, on_t) - sc) // (mat - mis)
                ok = ed <= max_ed and (left or sc >= 0)
                cov[f"drop_{'ok' if ok else 'bad'}_{'l' if left else 'r'}"] \
                    += 1
                e = (ed, w32(m - on_t), w32(on_t - on_s), sc) if ok else (
                    max_ed + 1, w32(max(m, max_sc) + 1), band + 1, sc)
            s = st[WS["stat"]]
            mid = s == twalk.WK_PMID and mm != twalk.MAP_OVER
            tr = s == twalk.WK_PTRAIL and mm != twalk.MAP_OVER
            end = s == twalk.WK_PEND and em != twalk.MAP_OVER
            endnd = s == twalk.WK_PENDND
            cov["overflowed"] += s in (twalk.WK_PMID, twalk.WK_PTRAIL,
                                       twalk.WK_PEND) \
                and not (mid or tr or end)
            if mid or tr or end or endnd:
                kind = (twalk.EVK_MID if mid else twalk.EVK_TRAIL if tr
                        else twalk.EVK_END if end else twalk.EVK_ENDND)
                cov[f"kind{kind}"] += 1
                ev = (kind, st[WS["pend_xpos"]],
                      st[WS["pend_cov"]] if end or endnd
                      else st[WS["pend_exlen"]],
                      e[0] if end else 0 if endnd else md_ed,
                      e[2] if end else 0 if endnd else md_in,
                      e[1] if end else 0,
                      e[3] if end else 0 if endnd else w32(-md_ed))
                slot = min(max(int(nev[t, l_]), 0), EW - 1)
                cov["nev_clamped"] += slot != nev[t, l_]
                events[t, slot, :, l_] = ev
                nev[t, l_] = w32(nev[t, l_] + 1)
            if mid:
                pend = int(st[WS["pend_iv"]])
                st[WS["covered"]] = w32(st[WS["covered"]]
                                        + st[WS["pend_exlen"]] - md_in)
                st[WS["remref"]] = w32(st[WS["remref"]]
                                       - st[WS["pend_exlen"]])
                cov["mid_left" if left else "mid_right"] += 1
                if not left:
                    p = min(max(pend, 0), NIV - 1)
                    st[WS["xpos"]] = w32(iv_spos[p] - 1)
                    st[WS["exlen"]] = w32(iv_epos[p] - iv_spos[p] + 1)
                    st[WS["i_abs"]] = w32(pend + 1)
                else:
                    st[WS["exlen"]] = 0
                    st[WS["i_abs"]] = w32(pend - 1)
                st[WS["stat"]] = twalk.WK_SCAN
            elif tr or end or endnd:
                st[WS["stat"]] = twalk.WK_DONE
    return ws, events, nev


def _eq(got, want, tag):
    got, want = np.asarray(got), want.numpy()
    assert got.shape == want.shape, (tag, got.shape, want.shape)
    assert np.array_equal(got.astype(np.int64), want.astype(np.int64)), \
        (tag, np.argwhere(got != want)[:5])


def test_walk_init_loop_order_matches_plain():
    """init_scalar at the kernel's launch shapes (``init_geo``) and, for
    several 32-flag groups a thread (past GPT_REG too) and several
    clusters (past INIT_CL too) at small shapes, at narrower blocks and
    more clusters; the events and counts at each word alignment."""
    cov = Counter()
    for seed, (N, WPP, share, ST, left4, nt, ncl) in enumerate([
            (64, 40, 0.5, 16, (False, True, True, False), None, None),
            (200, 300, 0.2, 16, (True, True, False, False), None, None),
            (40, 20, 0.9, 5, (True, False, True, False), None, None),
            (16, 30, 0.0, 3, (False, False, False, True), None, None),
            (9000, 300, 0.3, 16, (True, True, False, False), None, None),
            (3000, 700, 0.4, 16, (True, True, False, False), 32, None),
            (64, 40, 0.5, 20, (False, True, True, False), None, None),
            (20000, 300, 0.02, 16, (True, True, False, False), 32, None),
            (3000, 700, 0.4, 16, (False, True, True, False), None, 9)]):
        arrays, kw = walk_init_inputs(np.random.default_rng(500 + seed), N,
                                      WPP, share=share, ST=ST, left4=left4)
        geo = init_geo(N, WPP)
        if nt:                   # narrower blocks: more groups a thread
            groups = -(-4 * N // 32)
            geo.nt, geo.gpt = nt, -(-groups // (CS * nt))
        if ncl:                  # more clusters, as past a table's room
            lgroups = -(-WPP // 32)
            geo.ncl, geo.tpc = ncl, -(-lgroups // (ncl * CS)) * 32
        got = init_scalar(*arrays, **kw, cov=cov, geo=geo,
                          align=4 * seed % 16)
        want = twalk.walk_init(*_torch(arrays), **kw)
        for k in twalk.WalkInit._fields:
            _eq(got[k], getattr(want, k), f"{seed} {k}")
    need = {"several_groups", "several_clusters", "cross_cta_base",
            "table_remote", "past_limit", "dead_lane", "left", "right",
            "live", "over_tid", "vacant_slot", "two_ballots",
            "wide_tid_list", "zero_head", "zero_tail", "group_read_again",
            "more_clusters"}
    assert need <= {k for k, v in cov.items() if v}, need - set(cov)


def test_walk_pool_loop_order_matches_plain():
    """pool_scalar at the kernel's launch shapes (``pool_geo``) and, for
    several lanes a thread, at narrower blocks; with less shared memory
    than the shapes need (lanes past nchs loaded again, live and dead
    rows past the CTAs' tables), at smaller nchs and rcap."""
    cov = Counter()
    for seed, (STW, WPP, MIDP, ENDP, band, nt, room) in enumerate([
            (8, 40, 16, 16, 3, None, None), (8, 1100, 600, 40, 5, None, None),
            (3, 50, 8, 4, 0, None, None), (1, 33, 5, 70, 1, None, None),
            (8, 700, 90, 200, 3, 32, None), (8, 700, 90, 200, 3, 32, (1, 3)),
            (8, 300, 600, 2000, 3, 32, (0, 5))]):
        arrays, kw = walk_pool_inputs(np.random.default_rng(600 + seed), STW,
                                      WPP, MIDP=MIDP, ENDP=ENDP, band=band)
        geo = pool_geo(WPP, MIDP, ENDP, W)
        if nt:                   # narrower blocks: several lanes a thread
            geo.nt, geo.nch = nt, -(-geo.lpc // nt)
            geo.nchs = geo.nch
        if room:                 # shapes past shared memory
            geo.nchs, geo.rcap = room
        got = pool_scalar(*arrays, **kw, cov=cov, geo=geo)
        want = twalk.walk_pool(*_torch(arrays), **kw)
        for k in twalk.WalkPool._fields:
            _eq(getattr(got, k), getattr(want, k), f"{seed} {k}")
    need = {"follower", "leader", "over", "dead_pool_row", "several_chunks",
            "cross_cta_base", "table_remote", "lane_words_skipped", "m_left",
            "m_right", "e_left", "e_right", "query_row_cross",
            "ref_off_genome", "lanes_loaded_again", "row_past_table",
            "dead_row_past_table"}
    assert need <= {k for k, v in cov.items() if v}, need - set(cov)


def test_walk_commit_loop_order_matches_plain():
    cov = Counter()
    for seed, (STW, WPP, MIDP, ENDP, EW, band) in enumerate([
            (8, 40, 16, 16, 4, 3), (3, 50, 8, 4, 1, 0),
            (8, 200, 64, 128, 7, 5), (2, 33, 5, 70, 2, 1)]):
        arrays, kw = walk_commit_inputs(np.random.default_rng(700 + seed),
                                        STW, WPP, MIDP=MIDP, ENDP=ENDP,
                                        EW=EW, band=band)
        got = commit_scalar(*arrays, **kw, cov=cov)
        t = _torch(arrays)
        ws = twalk.walk_commit(*t, **kw)
        for g, w, tag in zip(got, (ws, t[8], t[9]), ("ws", "events", "nev")):
            _eq(g, w, f"{seed} {tag}")
    need = {"drop_ok_l", "drop_ok_r", "drop_bad_l", "drop_bad_r",
            "overflowed", "nev_clamped", "mid_left", "mid_right",
            *(f"kind{k}" for k in range(1, 5))}
    assert need <= {k for k, v in cov.items() if v}, need - set(cov)


# --------------------------------------------------------------------------
# the kernels' arguments and the C source against the Python orders
# --------------------------------------------------------------------------

def _enum(src, name):
    body = re.search(rf"enum {name} \{{([^}}]*)\}}", src).group(1)
    return [e.split("=")[0].strip() for e in body.split(",") if e.strip()]


def _args_ok(name, args):
    assert len(args) == len(_ext.KERNELS[name].tensors)
    for x, dtype, shape in args:
        assert x.dtype == dtype and tuple(x.shape) == tuple(shape) \
            and x.is_contiguous(), (name, x.dtype, tuple(x.shape), shape)


@pytest.mark.parametrize("name", ["walk_init", "walk_pool", "walk_commit"])
def test_wave_args_follow_the_specs(name):
    """Each wrapper's ``*_args`` list on its plain outputs takes the
    spec's tensors, and the C entry point the spec's tensors, then its
    statics and the stream."""
    args, kw = walk_case(name, WALK_SWEEP[name][2], torch.device("cpu"), 3)
    if name == "walk_init":
        out = twalk.walk_init(*args, **kw)
        _args_ok(name, twalk.walk_init_args(*args, out))
    elif name == "walk_pool":
        out = twalk.walk_pool(*args, **kw)
        _args_ok(name, twalk.walk_pool_args(*args, out))
    else:
        out = twalk.walk_commit(*args, **kw)
        assert out.dtype == torch.int32 and out.shape == args[0].shape
        _args_ok(name, twalk.walk_commit_args(*args, out))
    spec = _ext.KERNELS[name]
    sig = re.search(rf'extern "C" int {spec.sym}\(([^)]*)\)',
                    _src()).group(1)
    params = [q.split()[-1].lstrip("*") for q in sig.split(",")]
    assert params == [*spec.tensors, *spec.statics, "stream"], name


def test_wave_enums_and_constants_follow_python():
    src = _src()
    assert [getattr(twalk, k) for k in _enum(src, "WalkStat")] == list(
        range(6))
    assert [getattr(twalk, k) for k in _enum(src, "EventKind")] == list(
        range(5))
    assert _enum(src, "EventField") == ["EV_" + k.upper()
                                        for k in twalk.EV_KEYS] + ["EV_NF"]
    assert _enum(src, "ScanField") == ["WS_" + k.upper()
                                       for k in twalk.WS_KEYS] + ["WS_NF"]
    assert _enum(src, "SlotField") == ["SL_" + k.upper()
                                       for k in twalk.SLOT_KEYS] + ["SL_NF"]
    assert _enum(src, "LaneField") == ["LN_" + k.upper()
                                       for k in twalk.LANE_KEYS] + ["LN_NF"]
    assert _enum(src, "ProwField") == ["PW_" + k.upper()
                                       for k in twalk.PROW_KEYS] + ["PW_NF"]
    assert _enum(src, "PoolRow") == ["PR_" + k.upper()
                                     for k in twalk.POOL_ROWS] + ["PR_NF"]
    assert _enum(src, "PoolKind") == ["POOL_MID", "POOL_END", "POOL_NK"]
    assert _enum(src, "WaveKernel") == ["WAVE_INIT", "WAVE_POOL",
                                        "WAVE_COMMIT"]
    assert WAVE_EMPTY == {"walk_init": 0, "walk_pool": 1, "walk_commit": 2}
    assert K["MAP_NONE"] == twalk.MAP_NONE
    assert K["MAP_OVER"] == twalk.MAP_OVER
    assert K["STW_MAX"] == twalk.STW
    # a slot's dedup codes (4 bits) stay clear of the slots 0 .. STW - 1
    assert twalk.STW <= K["LEAD_CODE"] < K["NONE_CODE"] < 16


class _Cuda(torch.Tensor):
    """A CPU tensor that takes a wrapper's card path."""
    @property
    def is_cuda(self):
        return True


def test_wave_wrappers_refuse_what_their_kernels_cannot_take():
    """On a CUDA tensor each wrapper checks its shapes and statics before
    it builds: walk_pool more than STW slots or an empty pool, walk_commit
    a non-positive mat - mis, walk_init no pair slot."""
    ws = torch.zeros((len(twalk.WS_KEYS), 9, 4), dtype=torch.int32)
    z = torch.zeros((3, 4), dtype=torch.int32)
    g = torch.zeros(10, dtype=torch.int8)
    with pytest.raises(ValueError, match="slots"):
        twalk.walk_pool(ws.as_subclass(_Cuda), z, z[:2], g, g, L=5, band=3,
                        MIDP=4, ENDP=4)
    with pytest.raises(ValueError, match="slots"):
        twalk.walk_pool(ws[:, :8].contiguous().as_subclass(_Cuda), z, z[:2],
                        g, g, L=5, band=3, MIDP=0, ENDP=4)
    with pytest.raises(ValueError, match="mat - mis"):
        twalk.walk_commit(ws.as_subclass(_Cuda), *(None,) * 9, mat=1, mis=1,
                          band=3, max_ed=2, max_sc=4)
    e = torch.zeros((4, 0), dtype=torch.int32)
    tids = torch.zeros((5, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="above 0"):
        twalk.walk_init(e.bool().as_subclass(_Cuda), e, e, e, e, e,
                        e[0], e[0], tids[:, 0], tids, tids[:, 0],
                        tids[:, 0], left4=LEFT4, band=3, EW=4, WPP=8)


@pytest.mark.parametrize("name", ["walk_init", "walk_pool"])
def test_wave_workspace_is_sized_by_the_shapes(name, monkeypatch):
    """The kernels keep their workspace in shared memory, sized by the
    shapes (``init_geo``: a table slot a lane a block takes, the warps'
    prefixes and the CTAs' counts; ``pool_geo``: the pool rows a block
    gathers, a code and the words a lane, the counts a (slot, chunk,
    warp)): no device buffer goes with the outputs, the main path's shapes
    take a few KB, and shapes past a block's shared memory still launch
    (walk_init more clusters and groups read again, walk_pool lanes loaded
    again and rows' geometry from their flat index), within it."""
    launched = []
    monkeypatch.setattr(_ext, "launch_tensors",
                        lambda name, args, statics: launched.append(name))
    args, kw = walk_case(name, WALK_SWEEP[name][0], torch.device("cpu"), 5)
    if name == "walk_init":
        out = twalk.walk_init(*args, **kw)
        x, _, _ = twalk.walk_init_args(*args, out)[-1]
        assert x is out.nev
        N, WPP = args[6].shape[0], kw["WPP"]
        geo = init_geo(N, WPP)
        assert (geo.nt, geo.gpt, geo.ncl) == (512, 2, 8)
        assert geo.tpc * geo.ncl * CS >= WPP
        assert geo.smem == 4 * (geo.tpc + geo.nt // 32 + CS) < 1024
        # a 16,384-pair step and past it: every group in registers, then
        # groups read again; lanes past eight clusters' tables
        assert init_geo(262144, 24576).gpt == K["GPT_REG"]
        assert init_geo(300000, 24576).gpt > K["GPT_REG"]
        big = init_geo(N, 4_000_000)
        assert big.ncl > K["INIT_CL"] and big.smem <= K["SMEM_MAX"]
        assert big.tpc * big.ncl * CS >= 4_000_000
        e = torch.zeros((4, 300000), dtype=torch.int32)
        tids = torch.zeros((5, 4), dtype=torch.int32)
        twalk.walk_init(e.bool().as_subclass(_Cuda), e, e, e, e, e, e[0],
                        e[0], tids[:, 0], tids, tids[:, 0], tids[:, 0],
                        left4=LEFT4, band=3, EW=4, WPP=24576)
    else:
        out = twalk.walk_pool(*args, **kw)
        x, _, _ = twalk.walk_pool_args(*args, out)[-1]
        assert x is out.maps
        _, STW, WPP = args[0].shape
        geo = pool_geo(WPP, kw["MIDP"], kw["ENDP"], W)
        assert (geo.nt, geo.nch, geo.lpc) == (384, 1, 384)
        assert (geo.nchs, geo.rcap) == (geo.nch, geo.rpc)
        assert geo.rpc * K["PCS"] >= max(kw["MIDP"], kw["ENDP"])
        assert geo.smem < 32 * 1024
        # 200,000 lanes into 60,000 rows: past shared memory
        big = pool_geo(200000, 4096, 60000, W)
        assert big.nchs < big.nch and big.rcap < big.rpc
        assert big.smem <= K["SMEM_MAX"]
        ws = torch.zeros((len(twalk.WS_KEYS), 8, 200000), dtype=torch.int32)
        z = torch.zeros((3, 200000), dtype=torch.int32)
        g = torch.zeros(10, dtype=torch.int8)
        twalk.walk_pool(ws.as_subclass(_Cuda), z, z[:2], g, g, L=5, band=3,
                        MIDP=4096, ENDP=60000)
    assert launched == [name]


@pytest.mark.parametrize("name", ["walk_init", "walk_pool", "walk_commit"])
def test_ab_outputs_take_their_wrappers_buffers(name, monkeypatch):
    """``chip_smoke.py --ab`` calls a source's kernel through ctypes, past
    the launch's checks, with fresh outputs named by WAVE_OUTS in place of
    the wrapper's: each name is the wrapper's output of that name, and an
    output paired with another's name is refused before any launch."""
    from chip_smoke import (WAVE_OUTS, SmokeFailure, ab_buffers,
                            ab_values)
    monkeypatch.setattr(_ext, "launch_tensors", lambda *a: None)
    spec = _ext.KERNELS[name]
    outs = WAVE_OUTS[name]
    assert set(outs) <= set(spec.tensors)
    if name == "walk_init":
        assert outs == twalk.WalkInit._fields
    elif name == "walk_pool":
        assert outs == twalk.WalkPool._fields
    else:
        assert outs == spec.tensors[-3:]
    args, kw = walk_case(name, WALK_SWEEP[name][2], torch.device("cpu"), 7)
    vals, _, want = ab_values(name, [a.as_subclass(_Cuda) for a in args],
                              kw, outs)
    assert len(want) == len(outs)
    fresh = {o: torch.zeros_like(x) for o, x in zip(outs, want)}
    got = ab_buffers(name, vals, fresh)
    assert all(got[o] is fresh[o] for o in outs)
    shifted = {o: torch.zeros_like(x) for o, x in zip(outs[1:], want)}
    with pytest.raises(SmokeFailure, match="given to the source"):
        ab_buffers(name, vals, shifted)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (chip_smoke.py runs the kernels there)")
    return torch.device("cuda")


def _card_cases(device):
    """(name, kernel call, plain call) over WALK_SWEEP's wave cases."""
    from chip_smoke import WAVE_KERNELS, tensor_kernel_calls
    out = []
    for name in WAVE_KERNELS:
        for k, spec in enumerate(WALK_SWEEP[name]):
            args, kw = walk_case(name, spec, device, 900 + k)
            out.append((name, *tensor_kernel_calls(name, args, kw)))
    return out


@pytest.mark.cuda
def test_wave_kernels_match_plain_on_card(cuda_device):
    for name, kern, plain in _card_cases(cuda_device):
        _ext.reset_launches()
        got = kern()
        assert _ext.LAUNCHES[name] == 1
        for g, w in zip(got, plain()):
            assert torch.equal(g, w), name


@pytest.mark.cuda
def test_wave_kernels_replay_in_a_cuda_graph(cuda_device):
    """Each wrapper captured in a CUDA graph (the step's form) replays the
    plain version's outputs."""
    for name, kern, plain in _card_cases(cuda_device):
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
