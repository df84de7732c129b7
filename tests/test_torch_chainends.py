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
  capped at C, rows with more event cells than ``iters``, tied rows and
  walks of every length up to NL.
- A scalar transcription of each kernel's per-thread work against its
  plain version, with counts that show every branch taken: the cell's
  bisect run until it closes and its segment loop only where the k-mer
  crosses the interval's end; the row's ranks of its unique keys, its
  walks of picks below min(iters, n_valid) only, the emission's repeat
  test over the emitted picks' non-head fragments, the assembly and the
  fallback one slot a lane.
- Each ``*_args`` list against its ``_ext.KERNELS`` spec and the C
  signature, the extraction's shared-memory words against the source's,
  and the card path taken on CPU tensors that report ``is_cuda``: one
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
# above M / 2, no pick, no slot, one list
EXTRACT_CASES = {"main": (96, 6, 16, 48, 7), "short": (48, 3, 20, 48, 7),
                 "long": (24, 15, 16, 48, 7), "wide": (24, 2, 30, 60, 3),
                 "no_pick": (9, 6, 16, 0, 7), "no_slot": (12, 6, 16, 48, 0),
                 "one_list": (24, 1, 40, 40, 40)}


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


def extract_scalar(dp10, back, pos, qpos, cnt, *, k, C, iters, cov):
    """csrc/extract_kbest.cu's warp, for every row in turn: its lanes'
    loops run one after another."""
    R, NL, S = dp10.shape
    M, T = NL * S, iters
    ll, ss = np.arange(M) // S, np.arange(M) % S
    rpos = np.zeros((R, C, NL), np.int64)
    qp, clen, sc10 = np.zeros_like(rpos), np.zeros((R, C), np.int64), \
        np.zeros((R, C), np.int64)
    cn, incomplete = np.zeros(R, np.int64), np.zeros(R, bool)
    for r in range(R):
        dpr, bkr, psr = (x[r].reshape(M) for x in (dp10, back, pos))
        qpr, cnr = qpos[r], cnt[r]
        ev = (ss < cnr[ll]) & (bkr >= 0)
        key = np.where(ev, [w32(-int(d)) for d in dpr], -NEG)
        nv = int(ev.sum())
        best = max([NEG] + [int(d) for d in dpr[ev]])
        cov["tied keys"] += len(np.unique(key)) < M
        head = [None] * T
        for m in range(M):
            rank = int(((key < key[m]) | ((key == key[m]) & (
                (ll > ll[m]) | ((ll == ll[m]) & (ss < ss[m]))))).sum())
            if rank < T:
                head[rank] = m
        nt = min(T, nv)
        wlen, wsc, wps, wqp = [], [], [], []
        for t in range(nt):
            cur, seen = head[t], set()
            wsc.append(int(dpr[cur]))
            ps, qs = [], []
            while True:
                cov["a walk loops"] += cur in seen
                seen.add(cur)
                ps.append(int(psr[cur]))
                qs.append(int(qpr[cur // S]))
                if len(ps) == NL or bkr[cur] < 0:
                    break
                cur = int(bkr[cur])
            cov[f"walk of {len(ps)}"] += 1
            wlen.append(len(ps))
            wps.append(ps)
            wqp.append(qs)
        emit = []
        for t in range(nt):
            if len(emit) == C:
                cov["capped at C"] += 1
                break
            rep = False
            if wsc[t] < best:
                for q in range(len(emit) * (NL - 1)):   # the lanes' pairs
                    c, f = divmod(q, NL - 1)
                    e = emit[c]
                    rep |= 1 + f < wlen[e] and wps[e][1 + f] == wps[t][0]
            elif any(wps[t][0] in wps[e][1:] for e in emit):
                cov["a repeat of the best score"] += 1
            cov["a repeat skipped"] += rep
            if not rep:
                emit.append(t)
        ne = len(emit)
        if ne:
            for c, e in enumerate(emit):
                rpos[r, c, :wlen[e]] = wps[e]
                qp[r, c, :wlen[e]] = wqp[e]
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
                    rpos[r, c, 0], qp[r, c, 0] = psr[m], qpr[m // S]
                    clen[r, c], sc10[r, c] = 1, dpr[m]
            cn[r] = min(int(n_l.sum()), C)
        incomplete[r] = nv > T and ne < C
        cov["incomplete"] += incomplete[r]
    return rpos, qp, clen, sc10, cn, incomplete


def test_extract_kbest_loop_order_matches_plain():
    """The kernel's work per row, transcribed, against the plain
    extraction on every case, with every branch of the row taken
    somewhere and walks of every length up to NL = 6."""
    cov = Counter()
    for name in EXTRACT_CASES:
        arrays, kw = extract_case(name, seed=9)
        got = extract_scalar(*arrays, cov=cov, **kw)
        want = tfin.extract_kbest_device_staged(*_torch(arrays), **kw)
        for i, (g, w) in enumerate(zip(got, want)):
            assert np.array_equal(g, w.numpy()), (name, i)
    need = {"tied keys", "a walk loops", "capped at C", "a repeat skipped",
            "a repeat of the best score", "the fallback", "incomplete",
            *(f"walk of {n}" for n in range(1, 7))}
    assert need <= {k for k, v in cov.items() if v}, need - set(cov)


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
    EX_SMEM_MAX."""
    with open(f"{_ext._CSRC}/extract_kbest.cu") as f:
        src = f.read()
    body = re.search(r"inline int ex_words\(int NL, int S, int C, int T\) "
                     r"\{\s*return ([^;]*);", src).group(1)
    for NL, S, C, T in ((6, 16, 7, 48), (15, 500, 3, 1), (1, 1, 0, 0)):
        assert 4 * eval(body, {}, dict(NL=NL, S=S, C=C, T=T)) == \
            tfin.extract_row_bytes(NL, S, C, T)
    assert "constexpr int EX_SMEM_MAX = 48 * 1024;" in src
    assert tfin.EX_SMEM_MAX == 48 * 1024


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
    wide = [torch.zeros((2, 15, 1000), dtype=torch.int32)] * 3
    with pytest.raises(ValueError, match="shared memory"):
        tfin.extract_kbest_device(wide[0].as_subclass(_Cuda), *wide[1:],
                                  torch.zeros((2, 15), dtype=torch.int32),
                                  torch.zeros((2, 15), dtype=torch.int32),
                                  k=20, C=7, iters=48)
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
