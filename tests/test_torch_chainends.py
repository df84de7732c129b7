"""The chain stage's two ends as kernels, on the CPU: ``chain_cells``
(csrc/chain_cells.cu, the cells of the reference's ``_chain_prelude``) and
``extract_kbest`` (csrc/extract_kbest.cu, the reference's
``extract_kbest_device_staged``).

- The port's plain versions against JAX, bit-equal, on adversarial inputs
  made with numpy from a seed (``chip_smoke.chain_cells_inputs`` /
  ``extract_kbest_inputs``): the port's ``_chain_prelude`` (its plain
  ``_chain_cells``, then the junction tables of the cells' intervals)
  against the reference's in both ``seg_compact`` forms, one interval or
  many, with positions before the first interval and past the last, at
  the bitmap's byte edges and past its end, k-mers that cross their
  interval's end, intervals without segments and sums that wrap; the
  plain extraction against the reference's on rows that fall back, rows
  capped at C, rows with more event cells than ``iters`` or exactly 0, 1,
  31, 32 or 33, scores at and past the other cells' key 2^29, tied rows,
  walks of every length up to NL, more than 64 picks and a row of 15,000
  cells.
- A scalar transcription of each kernel's per-thread work against its
  plain version, with counts that show every branch taken: the cell's
  bisect run until it closes and its segment loop only where the k-mer
  crosses the interval's end; the row's keys compacted by a ballot, its
  ranks among the event cells alone or, where an event key reaches
  2^29, among every cell, its walks of picks below min(iters, n_valid)
  only (from the staged row or from device memory), the emission from
  precomputed repeat masks (a ballot a pick above 64 picks), the
  assembly and the fallback one slot a lane; the rank paths' switch on
  hand-made rows, and the 64-bit keys against the plain sort up to 7,500
  cells.
- Each ``*_args`` list against its ``_ext.KERNELS`` spec and the C
  signature, the extraction's shared-memory words and limit against the
  source's, and the card path taken on CPU tensors that report ``is_cuda``: one
  launch for both ``seg_compact`` forms, the annotation's tables handed
  over as they are, no [B, M, P] temporary, and the shapes each kernel
  refuses raised.
- ``cuda``-marked (skipped without a card): each kernel against its plain
  version on the card, eagerly and replayed from a captured CUDA graph.

Every output is an integer: every comparison is exact (tolerance 0)."""

import re
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from chip_smoke import c_params, chain_cells_inputs, extract_kbest_inputs
from circminer_tpu.ops import chain as jchain
from circminer_tpu.ops import device_finish as jfin
from circminer_tpu_torch.ops import _ext
from circminer_tpu_torch.ops import chain_device as tchain
from circminer_tpu_torch.ops import device_finish as tfin

NEG = -(2 ** 29)
I32MAX = 2 ** 31 - 1

# (rows, NL, S, chain_cells_inputs options): chr21's lists (NL = 6, S =
# 16), one interval, two intervals of one segment slot, many intervals at
# seg_pad 16, a single cell
CELL_CASES = {"main": (48, 6, 16, {}), "one_iv": (33, 2, 5, dict(n_iv=1)),
              "two_iv": (16, 3, 7, dict(n_iv=2, P=1)),
              "many_iv": (24, 6, 16, dict(n_iv=300, P=16)),
              "one_cell": (3, 1, 1, {})}
# (rows, NL, S, iters, C): chr21's shape, short and long lists, picks
# above M / 2, no pick, no slot, one list, picks above the blocking masks'
# 64, a row too wide to stage in shared memory (M = 15,000)
EXTRACT_CASES = {"main": (96, 6, 16, 48, 7), "short": (48, 3, 20, 48, 7),
                 "long": (24, 15, 16, 48, 7), "wide": (24, 2, 30, 60, 3),
                 "no_pick": (9, 6, 16, 0, 7), "no_slot": (12, 6, 16, 48, 0),
                 "one_list": (24, 1, 40, 40, 40),
                 "many_picks": (16, 3, 40, 100, 9),
                 "device_walks": (3, 15, 1000, 48, 7)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def w32(x):
    """x as int32 with two's-complement wrap-around."""
    return ((int(x) + 2 ** 31) % 2 ** 32) - 2 ** 31


def _torch(arrays):
    return [torch.from_numpy(np.require(a, requirements="C")) for a in arrays]


def cells_case(name, seed=0):
    B, NL, S, opt = CELL_CASES[name]
    return chain_cells_inputs(np.random.default_rng(seed + len(name)), B,
                              NL, S, **opt)


def extract_case(name, seed=0):
    R, NL, S, iters, C = EXTRACT_CASES[name]
    return extract_kbest_inputs(np.random.default_rng(seed + 3 * len(name)),
                                R, NL, S, iters=iters, C=C)


# --------------------------------------------------------------------------
# the plain versions against JAX
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seg_compact", [False, True])
@pytest.mark.parametrize("name", CELL_CASES)
def test_plain_chain_cells_match_jax_prelude(name, seg_compact):
    """The port's prelude (plain ``_chain_cells``, then the junction tables
    of ol_iv) against the reference's ``_chain_prelude``: posf, qposf,
    validf, ub, mee, e1 and the [M, P, b] tables that ol_iv selects."""
    arrays, kw = cells_case(name)
    got = tchain._chain_prelude(*_torch(arrays), seg_compact=seg_compact,
                                **kw)
    want = jchain._chain_prelude(*(jnp.asarray(a) for a in arrays),
                                 seg_compact=seg_compact, **kw)
    assert len(got) == len(want) == 9
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g.numpy(), np.asarray(w)), (name, i)
    if name != "one_cell":          # the cases reach exons and introns
        ol_iv = tchain._chain_cells(*_torch(arrays), **kw)[6]
        assert (ol_iv >= 0).any() and (ol_iv < 0).any(), name


@pytest.mark.parametrize("name", [n for n in EXTRACT_CASES
                                  if EXTRACT_CASES[n][3] > 0])
def test_plain_extract_kbest_matches_jax_on_adversarial_rows(name):
    arrays, kw = extract_case(name)
    got = tfin.extract_kbest_device(*_torch(arrays), **kw)
    want = jfin.extract_kbest_device_staged(
        *(jnp.asarray(a) for a in arrays), upto="full", **kw)
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g.numpy(), np.asarray(w)), (name, i)


# --------------------------------------------------------------------------
# scalar transcriptions of the kernels against the plain versions
# --------------------------------------------------------------------------

def cells_scalar(pos, cnt, qpos, seq_len, nb_bits, iv_spos, iv_epos,
                 iv_max_end, iv_min_end, iv_max_next, iv_nseg, seg_end,
                 seg_next, *, k, max_ed, seg_pad, cov):
    """csrc/chain_cells.cu's thread c, for every cell c in turn."""
    B, NL, S = pos.shape
    M = NL * S
    n_iv, P = seg_end.shape
    nb_last = 8 * len(nb_bits) - 1
    posf = pos.reshape(B, M)
    out = {f: np.zeros((B, M), np.int64)
           for f in ("qposf", "validf", "ub", "mee", "e1", "ol_iv")}
    for c in range(B * M):
        r, m = divmod(c, M)
        l = m // S
        p, q = int(posf[r, m]), int(qpos[r, l])
        remain = w32(w32(int(seq_len[r]) - q) - k)
        out["qposf"][r, m] = q
        out["validf"][r, m] = (m - l * S) < cnt[r, l]
        pb = min(max(p, 0), nb_last)
        cov["nb clamped below"] += p < 0
        cov["nb clamped above"] += p > nb_last
        nb = (int(nb_bits[pb >> 3]) >> (pb & 7)) & 1
        cov[f"nb {nb} at a byte edge"] += (pb & 7) in (0, 7)
        lo, hi = 0, n_iv
        while lo < hi:
            mid = (lo + hi) >> 1
            if iv_spos[mid] <= p:
                lo = mid + 1
            else:
                hi = mid
        iv_raw = lo - 1
        iv = max(iv_raw, 0)
        cov["before the first interval"] += iv_raw < 0
        nseg = int(iv_nseg[iv])
        found = iv_raw >= 0 and iv_epos[iv] >= p and nseg > 0
        epos = w32(p + k - 1)
        cov["epos wraps"] += epos != p + k - 1
        max_end_intr = w32(int(iv_spos[lo]) - 1) if lo < n_iv else I32MAX
        cov["past the last interval"] += lo == n_iv
        far = w32(w32(p + remain) + max_ed)
        cov["far wraps"] += far != p + remain + max_ed
        ub_intr = 0
        if max_end_intr >= epos:
            ub_intr = min(far, w32(w32(max_end_intr - k) + 1))
        if epos > iv_epos[iv]:
            max_end, min_end, max_next = 0, 10 ** 9, 0
            n = min(nseg, seg_pad)
            cov["crosses, no segment"] += n <= 0
            for s in range(n):
                e = int(seg_end[iv, s])
                if e >= epos:
                    cov["crosses, a segment selected"] += 1
                    max_end, min_end = max(e, max_end), min(e, min_end)
                    max_next = max(int(seg_next[iv, s]), max_next)
        else:
            max_end, min_end, max_next = (int(iv_max_end[iv]),
                                          int(iv_min_end[iv]),
                                          int(iv_max_next[iv]))
        exonic = max_end > 0 and max_end >= epos
        if min_end < w32(remain + epos) and max_next != 0:
            ub_exon = w32(max_next + k - 1)
            cov["ub from the next exon"] += nb and found and exonic
        else:
            ub_exon = w32(w32(max_end - k) + 1)
            cov["ub from the exon end"] += nb and found and exonic
        if not nb:
            u, x = far, 0
        elif found:
            u, x = (ub_exon, max_end) if exonic else (0, 0)
            cov["found, exonic" if exonic else "found, not exonic"] += 1
        else:
            u, x = ub_intr, max_end_intr
            cov["intronic, bound 0" if max_end_intr < epos
                else "intronic"] += 1
        out["ub"][r, m], out["mee"][r, m], out["e1"][r, m] = u, x, epos
        out["ol_iv"][r, m] = iv if nb and found and exonic else -1
    return out


def test_chain_cells_loop_order_matches_plain():
    """The kernel's work per cell, transcribed, against ``_chain_cells`` on
    every case, with every branch of the cell taken somewhere."""
    cov = Counter()
    for name in CELL_CASES:
        arrays, kw = cells_case(name, seed=5)
        got = cells_scalar(*arrays, cov=cov, **kw)
        want = tchain._chain_cells(*_torch(arrays), **kw)
        for f, w in zip(("qposf", "validf", "ub", "mee", "e1", "ol_iv"),
                        want[1:]):
            assert np.array_equal(got[f], w.numpy().astype(np.int64)), \
                (name, f)
    need = {"nb clamped below", "nb clamped above", "nb 0 at a byte edge",
            "nb 1 at a byte edge", "before the first interval",
            "past the last interval", "epos wraps", "far wraps",
            "crosses, no segment", "crosses, a segment selected",
            "ub from the next exon", "ub from the exon end", "found, exonic",
            "found, not exonic", "intronic", "intronic, bound 0"}
    assert need <= {k for k, v in cov.items() if v}, need - set(cov)


def _ex_source():
    with open(f"{_ext._CSRC}/extract_kbest.cu") as f:
        return f.read()


def ex_words_of(src):
    """(ex_words, ex_stage_words) of the kernel source, as Python
    functions of (NL, S, C, T) and (NL, S)."""
    words = re.search(r"inline int ex_words\(int NL, int S, int C, int T\) "
                      r"\{\s*return ([^;]*);", src).group(1)
    stage = re.search(r"inline int ex_stage_words\(int NL, int S\) "
                      r"\{\s*return ([^;]*);", src).group(1)
    return (lambda NL, S, C, T: eval(words, {}, dict(NL=NL, S=S, C=C, T=T)),
            lambda NL, S: eval(stage, {}, dict(NL=NL, S=S)))


def ex_key(k1, l, s, m, NL, S):
    """The kernel's 64-bit sort key of cell m = l * S + s: its int32 key1
    (flipped to an unsigned order), then (list desc, index asc) and the
    cell in 16 bits each."""
    l, s, m = int(l), int(s), int(m)
    return ((w32(k1) + 2 ** 31) << 32) | (((NL - 1 - l) * S + s) << 16) | m


def extract_scalar(dp10, back, pos, qpos, cnt, *, k, C, iters, cov):
    """csrc/extract_kbest.cu's warp, for every row in turn: its lanes' loops
    run one after another (a persistent warp's rows are independent)."""
    R, NL, S = dp10.shape
    M, T = NL * S, iters
    words, stage = ex_words_of(_ex_source())
    staged = 4 * (words(NL, S, C, T) + stage(NL, S)) <= tfin.EX_SMEM_MAX
    cov["walks read device memory" if not staged else "walks staged"] += 1
    magic = 0xFFFFFFFF // S + 1 if S > 1 else 0

    def list_of(m):          # __umulhi(m, ceil(2^32 / S))
        return m if S == 1 else (m * magic) >> 32

    rpos = np.zeros((R, C, NL), np.int64)
    qp, clen, sc10 = np.zeros_like(rpos), np.zeros((R, C), np.int64), \
        np.zeros((R, C), np.int64)
    cn, incomplete = np.zeros(R, np.int64), np.zeros(R, bool)
    for r in range(R):
        dpr, bkr, psr = (x[r].reshape(M) for x in (dp10, back, pos))
        qpr, cnr = qpos[r], cnt[r]
        # the coalesced pass, 32 cells a step: the event cells' keys
        # compacted in cell order by a ballot
        key = np.zeros(M, np.uint64)
        k1s = []
        nv, best, late = 0, NEG, False
        for m0 in range(0, M, 32):
            for m in range(m0, min(m0 + 32, M)):
                l = list_of(m)
                s = m - l * S
                assert (l, s) == divmod(m, S)
                d = int(dpr[m])
                ev = s < cnr[l] and bkr[m] >= 0
                k1 = w32(-d) if ev else -NEG
                k1s.append(k1)
                late |= ev and k1 >= -NEG
                cov["an event key ties the other cells'"] += ev and k1 == -NEG
                cov["an event key INT32_MIN"] += ev and k1 == -2 ** 31
                best = d if ev and d > best else best
                if ev:                    # nv + the ballot's lanes below
                    key[nv] = ex_key(k1, l, s, m, NL, S)
                    nv += 1
        fast = not late
        if not fast:                      # every cell's key, in cell order
            for m in range(M):
                key[m] = ex_key(k1s[m], m // S, m % S, m, NL, S)
        cov["tied keys"] += len(set(k1s)) < M
        cov["ranks among the events" if fast
            else "ranks among every cell"] += 1
        n = nv if fast else M
        cov["more than 32 keys ranked"] += n > 32
        cov[f"n_valid {nv}" if nv in (0, 1, 31, 32, 33)
            else "n_valid above iters" if nv > T else "n_valid other"] += 1
        head, wsc = [None] * T, [None] * T
        ev_cells = set() if fast else {
            m for m in range(M) if (m % S) < cnr[m // S] and bkr[m] >= 0}
        for i in range(n):
            rank = int((key[:n] < key[i]).sum())
            if rank < T:
                m = int(key[i]) & 0xFFFF
                head[rank] = m
                wsc[rank] = w32(-(int(key[i] >> np.uint64(32)) - 2 ** 31)) \
                    if fast else int(dpr[m])
                cov["an event ranked after the other cells"] += (
                    rank >= nv and m in ev_cells)
        bk, ps = bkr, psr            # staged or not: the same words
        nt = min(T, nv)
        cov["more than 32 picks"] += nt > 32
        wcell, wlen = [], []
        for t in range(nt):
            cells = [head[t]]
            while len(cells) < NL and bk[cells[-1]] >= 0:
                cov["a walk loops"] += int(bk[cells[-1]]) in cells
                cells.append(int(bk[cells[-1]]))
            cov[f"walk of {len(cells)}"] += 1
            wcell.append(cells)
            wlen.append(len(cells))
        emit = []
        if T <= 64:
            cov["repeat masks"] += 1
            # lane u: the later picks below the best whose head position
            # one of u's non-head fragments holds
            hp = [int(ps[wcell[t][0]]) for t in range(nt)]
            below = sum(1 << t for t in range(nt) if wsc[t] < best)
            blocks = []
            for u in range(nt):
                hit = 0
                for cell in wcell[u][1:]:
                    for t in range(u + 1, nt):
                        hit |= int(hp[t] == ps[cell]) << t
                blocks.append(hit & below)
            # every lane alike: the next pick that no emitted pick blocks
            blocked, t = 0, 0
            while len(emit) < C and t < nt:
                open_ = ((1 << nt) - 1) & ~blocked & ~((1 << t) - 1)
                if not open_:
                    break
                nxt = (open_ & -open_).bit_length() - 1
                cov["a repeat skipped"] += nxt > t
                t = nxt
                if any(hp[t] in ps[wcell[e][1:]] for e in emit):
                    cov["a repeat of the best score" if wsc[t] >= best
                        else "a repeat taken"] += 1
                emit.append(t)
                blocked |= blocks[t]
                t += 1
            cov["capped at C"] += len(emit) == C and t < nt
        else:
            cov["a ballot a pick"] += 1
            for t in range(nt):
                if len(emit) == C:
                    cov["capped at C"] += 1
                    break
                rep = False
                if wsc[t] < best:
                    hp = ps[wcell[t][0]]
                    for q in range(len(emit) * (NL - 1)):   # the lanes' pairs
                        c, f = divmod(q, NL - 1)
                        e = emit[c]
                        rep |= 1 + f < wlen[e] and ps[wcell[e][1 + f]] == hp
                cov["a repeat skipped"] += rep
                if not rep:
                    emit.append(t)
        ne = len(emit)
        if ne:
            for c, e in enumerate(emit):
                for f, cell in enumerate(wcell[e]):
                    rpos[r, c, f], qp[r, c, f] = ps[cell], qpr[list_of(cell)]
                clen[r, c], sc10[r, c] = wlen[e], wsc[e]
            cn[r] = ne
        else:
            cov["the fallback"] += 1
            n_l = np.clip(cnr, 0, S)
            for c in range(C):
                left, m = c, -1
                for l in range(NL - 1, -1, -1):
                    if left < n_l[l]:
                        m = l * S + left
                        break
                    left -= n_l[l]
                if m >= 0:
                    rpos[r, c, 0], qp[r, c, 0] = ps[m], qpr[m // S]
                    clen[r, c], sc10[r, c] = 1, dpr[m]
            cn[r] = min(int(n_l.sum()), C)
        incomplete[r] = nv > T and ne < C
        cov["incomplete"] += incomplete[r]
    return rpos, qp, clen, sc10, cn, incomplete


def test_extract_kbest_loop_order_matches_plain():
    """The kernel's work per row, transcribed, against the plain
    extraction on every case, with every branch of the row taken
    somewhere: both rank paths, an event key at the other cells' 2^29 and
    at INT32_MIN, events ranked after the other cells, more than 32 keys
    and picks, the repeat masks and the ballot loop above 64 picks, walks
    of every length up to NL = 6 and walks from device memory."""
    cov = Counter()
    for name in EXTRACT_CASES:
        arrays, kw = extract_case(name, seed=9)
        got = extract_scalar(*arrays, cov=cov, **kw)
        want = tfin.extract_kbest_device_staged(*_torch(arrays), **kw)
        for i, (g, w) in enumerate(zip(got, want)):
            assert np.array_equal(g, w.numpy()), (name, i)
    need = {"tied keys", "a walk loops", "capped at C", "a repeat skipped",
            "a repeat of the best score", "the fallback", "incomplete",
            "ranks among the events", "ranks among every cell",
            "an event key ties the other cells'", "an event key INT32_MIN",
            "an event ranked after the other cells",
            "more than 32 keys ranked", "more than 32 picks",
            "repeat masks", "a ballot a pick", "walks staged",
            "walks read device memory", "n_valid above iters",
            *(f"n_valid {n}" for n in (0, 1, 31, 32, 33)),
            *(f"walk of {n}" for n in range(1, 7))}
    assert need <= {k for k, v in cov.items() if v}, need - set(cov)


# rows at the rank paths' switch: (event scores, other cells' scores) of
# one row of NL = 2 lists of S = 4, every cell in count; events are the
# first len(events) cells of list 0, then of list 1
BOUNDARY_ROWS = {
    "below 2^29": ([60, 50, -2 ** 29 + 1, 50], [7, 7, 7, 7]),
    "at 2^29, a tie": ([60, -2 ** 29, 50], [-2 ** 29] * 5),
    "INT32_MIN first": ([-2 ** 31, 60, 50], [0] * 5),
    "past 2^29": ([60, -2 ** 30, 50, -2 ** 29 - 1], [3, 3, 3, 3]),
    "every event past 2^29": ([-2 ** 30, -2 ** 30 - 5], [1] * 6),
}


@pytest.mark.parametrize("name", BOUNDARY_ROWS)
def test_extract_rank_paths_at_the_2_29_boundary(name):
    """One row at each side of the fast path's condition (every event key
    below the other cells' 2^29): the transcription takes the path the row
    allows and matches the plain extraction and the reference."""
    events, others = BOUNDARY_ROWS[name]
    NL, S = 2, 4
    M = NL * S
    dp = np.array(events + others, np.int64).astype(np.int32)
    back = np.full(M, -1, np.int32)
    back[:len(events)] = np.arange(len(events)) % M      # loops of one cell
    pos = (np.arange(M) % 3).astype(np.int32)            # repeats
    arrays = (dp.reshape(1, NL, S), back.reshape(1, NL, S),
              pos.reshape(1, NL, S), np.array([[3, 9]], np.int32),
              np.full((1, NL), S, np.int32))
    kw = dict(k=5, C=3, iters=M)
    cov = Counter()
    got = extract_scalar(*arrays, cov=cov, **kw)
    fast = all(w32(-e) < 2 ** 29 for e in events)
    assert cov["ranks among the events" if fast
               else "ranks among every cell"] == 1, name
    want = tfin.extract_kbest_device_staged(*_torch(arrays), **kw)
    ref = jfin.extract_kbest_device_staged(*(jnp.asarray(a) for a in arrays),
                                           upto="full", **kw)
    for i, (g, w, j) in enumerate(zip(got, want, ref)):
        assert np.array_equal(g, w.numpy()), (name, i)
        assert np.array_equal(w.numpy(), np.asarray(j)), (name, i)


@pytest.mark.parametrize("NL,S", [(6, 16), (15, 500), (1, 40), (3, 1)])
def test_extract_keys_order_as_the_plain_sort(NL, S):
    """The kernel's 64-bit keys sort a row's cells as the plain version's
    int64 composite key does (score desc for events, else 2^29; list desc,
    index asc), at widths up to gpu-chain's 7,500 cells, with every
    kernel's cell field recovered from the key."""
    rng = np.random.default_rng(NL * S)
    M = NL * S
    dp = rng.choice(np.array([5, 6, -2 ** 29, -2 ** 31, 2 ** 31 - 1,
                              -2 ** 30], np.int64), M)
    ev = rng.random(M) < 0.5
    l_of, s_of = np.arange(M) // S, np.arange(M) % S
    keys = [ex_key(-int(d) if e else -NEG, l, s, m, NL, S)
            for m, (d, e, l, s) in enumerate(zip(dp, ev, l_of, s_of))]
    assert all(k & 0xFFFF == m for m, k in enumerate(keys))
    order = sorted(range(M), key=lambda m: keys[m])
    arrays = (dp.astype(np.int32).reshape(1, NL, S),
              np.where(ev, 0, -1).astype(np.int32).reshape(1, NL, S),
              np.zeros((1, NL, S), np.int32), np.zeros((1, NL), np.int32),
              np.full((1, NL), S, np.int32))
    sidx, _ = tfin.extract_kbest_device_staged(
        *_torch(arrays), k=5, C=1, iters=0, upto="sort")
    assert order == sidx[0].tolist()


# --------------------------------------------------------------------------
# the kernels' arguments, the C source, and the card path on the CPU
# --------------------------------------------------------------------------

def _args_ok(name, args):
    assert len(args) == len(_ext.KERNELS[name].tensors)
    for x, dtype, shape in args:
        assert x.dtype == dtype and tuple(x.shape) == tuple(shape) \
            and x.is_contiguous(), (name, x.dtype, tuple(x.shape), shape)


def test_kernel_args_follow_the_specs():
    arrays, kw = cells_case("main")
    t = _torch(arrays)
    cells = tchain._chain_cells(*t, **kw)
    _args_ok("chain_cells", tchain.chain_cells_args(*t, *cells[1:]))
    arrays, kw = extract_case("main")
    t = _torch(arrays)
    out = tfin.extract_kbest_device(*t, **kw)
    _args_ok("extract_kbest", tfin.extract_kbest_args(*t, *out, C=kw["C"]))
    # each C entry point takes the spec's tensors, then its statics
    for name, src in (("chain_cells", "chain_cells.cu"),
                      ("extract_kbest", "extract_kbest.cu")):
        spec = _ext.KERNELS[name]
        params = c_params(f"{_ext._CSRC}/{src}")[spec.sym]
        assert params == [*spec.tensors, *spec.statics, "stream"], name


def test_extract_row_words_follow_the_source():
    """The wrapper's bytes a row and limit are the kernel's ex_words and
    EX_SMEM_MAX (a block's opted-in shared memory); a row is staged where
    ex_words plus ex_stage_words (its back pointers and positions) fit.
    Every shape of the kernel before the redesign (at most 48 KB of
    M + 3 iters + 2 iters NL + C words) still fits, gpu-chain's widest
    bucket among them; chr21's rows are staged, 15 x 1,000 cells are
    not."""
    src = _ex_source()
    words, stage = ex_words_of(src)
    for NL, S, C, T in ((6, 16, 7, 48), (15, 500, 3, 1), (15, 500, 7, 48),
                        (1, 1, 0, 0), (3, 40, 9, 100), (15, 1000, 7, 48),
                        (2, 3, 1, 6)):
        assert 4 * words(NL, S, C, T) == tfin.extract_row_bytes(NL, S, C, T)
        assert words(NL, S, C, T) % 2 == 0
    assert "constexpr int EX_SMEM_MAX = 232448;" in src
    assert tfin.EX_SMEM_MAX == 232448
    fits = 4 * (words(6, 16, 7, 48) + stage(6, 16)) <= tfin.EX_SMEM_MAX
    assert fits and stage(6, 16) == 2 * 96
    assert 4 * (words(15, 1000, 7, 48) + stage(15, 1000)) > tfin.EX_SMEM_MAX
    for M, T, C in ((12288, 0, 0), (12000, 40, 7), (7500, 48, 7),
                    (1000, 1000, 2), (96, 96, 96)):
        if 4 * (M + 3 * T + 2 * T * 1 + C) <= 48 * 1024:
            assert tfin.extract_row_bytes(1, M, C, T) <= tfin.EX_SMEM_MAX
    assert tfin.extract_row_bytes(15, 500, 7, 48) <= tfin.EX_SMEM_MAX


class _Cuda(torch.Tensor):
    """A CPU tensor that takes a wrapper's card path."""
    @property
    def is_cuda(self):
        return True


def test_chain_cells_card_path_is_one_launch_for_both_forms(monkeypatch):
    """On the card path both seg_compact forms are the same launch: the
    chain's inputs and the annotation's tables as they are (nothing is
    copied), the statics, and no tensor of B * M * P elements made."""
    arrays, kw = cells_case("many_iv")
    t = _torch(arrays)
    B, NL, S = t[0].shape
    P = t[11].shape[1]
    launched, made = [], []

    def launch(name, args, statics):
        launched.append((name, [x.data_ptr() for x, _, _ in args[:13]],
                         statics))
        _args_ok(name, args)

    class Made(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for x in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(x, torch.Tensor):
                    made.append(x.numel())
            return out

    monkeypatch.setattr(_ext, "launch_tensors", launch)
    for seg_compact in (False, True):
        with Made():
            cells = tchain.chain_cells(t[0].as_subclass(_Cuda), *t[1:],
                                       seg_compact=seg_compact, **kw)
        assert cells[0].data_ptr() == t[0].data_ptr()
        assert tuple(cells[0].shape) == (B, NL * S)
    assert launched[0] == launched[1]
    name, ptrs, statics = launched[0]
    assert name == "chain_cells" and ptrs == [x.data_ptr() for x in t]
    assert statics == (B, NL, S, t[4].numel(), t[5].numel(), P,
                       kw["seg_pad"], kw["k"], kw["max_ed"])
    assert made and max(made) <= B * NL * S < B * NL * S * P, made


def test_wrappers_refuse_what_the_kernels_cannot_take(monkeypatch):
    """On a CUDA tensor each wrapper checks the shapes its kernel takes
    before it builds; on the CPU the plain version runs."""
    monkeypatch.setattr(_ext, "launch_tensors", lambda *a: None)
    arrays, kw = cells_case("main")
    t = _torch(arrays)
    cuda_pos = t[0].as_subclass(_Cuda)
    with pytest.raises(ValueError, match="seg_pad <= P"):
        tchain.chain_cells(cuda_pos, *t[1:], **dict(kw, seg_pad=5))
    empty = [x[:0] for x in t[5:13]]
    with pytest.raises(ValueError, match="an interval"):
        tchain.chain_cells(cuda_pos, *t[1:5], *empty, **kw)
    arrays, kw = extract_case("main")
    t = _torch(arrays)
    dp = t[0].as_subclass(_Cuda)
    with pytest.raises(ValueError, match="iters <= M"):
        tfin.extract_kbest_device(dp, *t[1:], **dict(kw, iters=97))
    def wide(S):
        x = [torch.zeros((2, 15, S), dtype=torch.int32)] * 3
        return tfin.extract_kbest_device(
            x[0].as_subclass(_Cuda), *x[1:],
            torch.zeros((2, 15), dtype=torch.int32),
            torch.zeros((2, 15), dtype=torch.int32), k=20, C=7, iters=48)
    with pytest.raises(ValueError, match="shared memory"):
        wide(2000)                      # 2 x 30,000 words of keys
    wide(1000)      # taken: its walks read device memory
    wide(500)       # gpu-chain's widest bucket
    out = tfin.extract_kbest_device(dp, *t[1:], **kw)   # the card path
    assert [tuple(x.shape) for x in out] == [
        (96, 7, 6), (96, 7, 6), (96, 7), (96, 7), (96,), (96,)]


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (chip_smoke.py runs the kernels there)")
    return torch.device("cuda")


def _cases():
    """(kernel name, kernel call, plain call) on the card: every case of
    both kernels, chain_cells in both seg_compact forms."""
    out = []
    for name in CELL_CASES:
        arrays, kw = cells_case(name, seed=21)
        t = [x.cuda() for x in _torch(arrays)]
        for flag in (False, True):
            out.append(("chain_cells",
                        lambda t=t, kw=kw, f=flag: tchain.chain_cells(
                            *t, seg_compact=f, **kw),
                        lambda t=t, kw=kw, f=flag: tchain._chain_cells(
                            *t, seg_compact=f, **kw)))
    for name in EXTRACT_CASES:
        arrays, kw = extract_case(name, seed=21)
        t = [x.cuda() for x in _torch(arrays)]
        out.append(("extract_kbest",
                    lambda t=t, kw=kw: tfin.extract_kbest_device(*t, **kw),
                    lambda t=t, kw=kw: tfin.extract_kbest_device_staged(
                        *t, **kw)))
    return out


@pytest.mark.cuda
def test_chain_ends_match_plain_on_card(cuda_device):
    for name, kern, plain in _cases():
        _ext.reset_launches()
        got = kern()
        assert _ext.LAUNCHES[name] == 1
        for g, w in zip(got, plain()):
            assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.cuda
def test_chain_ends_replay_in_a_cuda_graph(cuda_device):
    """Each wrapper captured in a CUDA graph (the step's form) replays the
    plain version's outputs."""
    for name, kern, plain in _cases():
        kern()                           # load the library outside capture
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = kern()
        # chain_cells' posf is a view of its input
        for x in out[1:] if name == "chain_cells" else out:
            x.fill_(True if x.dtype == torch.bool else -7)
        graph.replay()
        for g, w in zip(out, plain()):
            assert torch.equal(g, w), name
