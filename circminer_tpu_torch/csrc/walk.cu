// The extension walk of the fused gpu-full step, hand-written for Hopper
// (sm_90a): three kernels of dependent integer logic.
//
//   cm_walk_fold  replaces the fori_loop of
//                 circminer_tpu/ops/device_walk.py::walk_fold (:628): per
//                 pool lane of one extend family, the replay of its
//                 ST * EW walk events in (tid, event) order against the
//                 extend's ed_th and bound, with AlignRes.update_right/left
//                 and update_by_score (_fold_update_dir :643,
//                 _fold_update_score :666).  It writes the family's six
//                 best fields, consec and defer straight into their pair
//                 slots (what _scatter_pool does on the TPU).  Plain version:
//                 ops/device_walk.py::_walk_fold_plain.
//   cm_tiny_dp    replaces the lax.scan of device_walk.py::_tiny_end (:113,
//                 end = 1: the full edit DP and the column-m candidate scan,
//                 ed asc, |indel| asc, smallest i) and the unrolled
//                 device_full.py::_tiny_global (:101, end = 0: dp[n][m]),
//                 with the select that follows each in its pool
//                 (device_walk.py:130, device_full.py:135): the DP runs only
//                 on the pool's fallback rows, and every other row gets the
//                 banded kernel's answer.  Plain version:
//                 ops/device_walk.py::_tiny_dp_plain.
//   cm_walk_scan  replaces scan_step, run by fori_loop(0, KSCAN) in
//                 device_walk.py::walk_waves (:247-343, :366): per
//                 (transcript slot, lane), up to KSCAN steps of the
//                 interval-scan state machine.  Plain version:
//                 ops/device_walk.py::_walk_scan_plain.
//
// What bounds them: latency and the launch.  Each runs short chains of a
// few dozen dependent integer operations a link and moves a few MB at
// most; each replaces hundreds to thousands of small torch kernels of the
// captured step.  Tensors are lane-minor ([..., WPP]), so a warp's loads
// of one field coalesce.  Blocks hold 32-128 threads, the fewest that
// still give each of the 132 SMs two blocks (spread), so a small pool
// spreads over the card and a large one launches fewer blocks.
//
// - walk_fold: a pool lane on FOLD_T threads, one per transcript slot,
//   four lanes a warp.  A launch folds one family, whose lanes are one
//   contiguous run of the pool (_compact keeps the flat order), so the
//   warps outside it leave after their first round of loads.  Each thread
//   loads its transcript's act and event kinds in that round, then the
//   other fields of the events up to the first TRAIL, END or ENDND in a
//   second, and runs the transcript's curr chain (curr starts anew each
//   transcript).  The best fold that follows is not associative
//   (update_dir compares differences), so it takes the transcripts in
//   turn, in (t, e) order; after each turn six shuffles hand best to the
//   lane's threads, and a turn without a candidate in the warp is skipped.
// - tiny_dp: at NM, MM <= TINY_REG (every main-path call: TN = TM = 8 at
//   w <= 3, the OS pool's 4 x 8) a row is TINY_REG lanes of a warp, one
//   per column, four rows a warp, and its DP an anti-diagonal wavefront of
//   n + m - 1 steps: a lane's left and diagonal neighbours come by
//   __shfl_up_sync, and its bases sit in registers before the chain starts
//   (its reference base and a bit mask of its mismatches down the column).
//   The lane of column m runs END's candidate scan; it sees the rows in
//   ascending i, as the strict key order needs.  A warp whose rows all pass
//   through leaves after the copy.  A wider row (off the default band, up
//   to TINY_MM_MAX) keeps one thread per row, the row in dynamic shared
//   memory, one column per thread (the word of cell j of thread x at
//   j * blockDim + x, so a warp's accesses hit 32 banks).
// - walk_scan: one thread per (slot, lane), its state in registers.
//
// Parity: every sum that torch or JAX computes in int32 wraps; here it is
// composed in uint32 and cast back (add32, sub32, mul32).  Gathers clamp
// their index where the plain version clamps it.  The updates run in the
// plain version's order: for a left lane accumulate, break, flush; for a
// right lane the break reads exlen before the step's accumulate; the stat
// priority is trail > end > endnd > mid > done.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// lane status codes and event kinds (ops/device_walk.py)
enum WalkStat { WK_SCAN, WK_PMID, WK_PTRAIL, WK_PEND, WK_PENDND, WK_DONE };
enum EventKind { EVK_NONE, EVK_MID, EVK_TRAIL, EVK_END, EVK_ENDND };
// event record fields (ops/device_walk.py EV_KEYS)
enum EventField { EV_KIND, EV_XPOS, EV_AUX, EV_ED, EV_INDEL, EV_SCLEN,
                  EV_SCORE, EV_NF };
// the fold's outputs (ops/device_walk.py FOLD_OUT)
enum FoldOut { FO_POS, FO_ED, FO_SCLEN, FO_INDEL, FO_QCOV, FO_SCORE,
               FO_CONSEC, FO_DEFER, NFO };
// the scan's carried state (ops/device_walk.py WS_KEYS)
enum ScanField { WS_I_ABS, WS_XPOS, WS_EXLEN, WS_COVERED, WS_FIRST, WS_STAT,
                 WS_PEND_IV, WS_PEND_XPOS, WS_PEND_EXLEN, WS_PEND_COV,
                 WS_PEND_RR, WS_REMREF, WS_NF };
// per (slot, lane) constants (SLOT_KEYS) and per lane constants (LANE_KEYS)
enum SlotField { SL_TSTART, SL_TOFF, SL_TLEN, SL_NF };
enum LaneField { LN_IS_LEFT, LN_QLEN, LN_POS, LN_NF };
// the kernels cm_walk_empty takes the launch shape of
enum WalkKernel { WALK_FOLD, WALK_TINY, WALK_SCAN };

constexpr int NEG_SCORE = -1000000000;
constexpr int POS = 10000000;
constexpr int TINY_REG = 8;   // the widest tiny-DP row (NM, MM) on lanes
constexpr int FOLD_T = 8;     // fold threads a pool lane (ST <= FOLD_T)
constexpr int FOLD_EW = 4;    // events a fold thread holds (or twice it)
constexpr int NT_MIN = 32;    // threads a block: at least a warp,
constexpr int NT_MAX = 128;   // at most four
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int add32(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int sub32(int a, int b) {
  return (int)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int mul32(int a, int b) {
  return (int)((uint32_t)a * (uint32_t)b);
}
// torch's and JAX's int32 abs: abs(INT32_MIN) is INT32_MIN
__device__ __forceinline__ int abs32(int a) { return a < 0 ? sub32(0, a) : a; }
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// --------------------------------------------------------------------------
// walk_fold
// --------------------------------------------------------------------------

struct Res {
  int pos, ed, sclen, indel, qcov, score;
};

// AlignRes.update_right/left (extend.py:165-187)
__device__ __forceinline__ void update_dir(Res& best, const Res& c,
                                           int max_ed, int max_sc,
                                           bool left) {
  const bool gt = c.qcov > best.qcov;
  const bool lt = c.qcov < best.qcov;
  const bool ok_lim = c.ed <= max_ed && c.sclen <= max_sc;
  const bool take_gt = gt && ok_lim &&
      mul32(2, sub32(c.ed, best.ed)) < sub32(c.qcov, best.qcov);
  const bool take_lt = lt && ok_lim &&
      mul32(2, sub32(best.ed, c.ed)) >= sub32(best.qcov, c.qcov);
  const bool pos_better = left ? c.pos > best.pos : c.pos < best.pos;
  const bool same_ed = c.ed == best.ed;
  const bool take_eq = !gt && !lt &&
      (c.ed < best.ed || (same_ed && c.sclen < best.sclen) ||
       (same_ed && c.sclen == best.sclen && pos_better));
  if (take_gt || take_lt || take_eq) best = c;
}

// AlignRes.update_by_score_right/left (extend.py:153-162)
__device__ __forceinline__ void update_score(Res& best, const Res& c,
                                             bool left) {
  const bool pos_better = left ? c.pos > best.pos : c.pos < best.pos;
  if (best.score < c.score || (best.score == c.score && pos_better))
    best = c;
}

// the kinds that end a transcript's walk
__device__ __forceinline__ bool terminal(int kind) {
  return kind == EVK_TRAIL || kind == EVK_END || kind == EVK_ENDND;
}

// A pool lane on FOLD_T threads, thread t on transcript t (ST <= FOLD_T),
// each holding EWC >= EW events.
template <int EWC>
__global__ void __launch_bounds__(NT_MAX) walk_fold_kernel(
    const int32_t* __restrict__ events, const uint8_t* __restrict__ act,
    const int32_t* __restrict__ inv, const int32_t* __restrict__ n_act,
    const uint8_t* __restrict__ p_live, const int32_t* __restrict__ p_pos,
    const int32_t* __restrict__ p_len,
    const uint8_t* __restrict__ lane_defer,
    const int32_t* __restrict__ ed_th, const int32_t* __restrict__ bound,
    int32_t* __restrict__ out, int WPP, int N, int fam, int left, int ST,
    int EW, int max_ed, int max_sc, int band) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int w = x / FOLD_T, t = x % FOLD_T;
  const bool in = w < WPP;
  auto field = [&](int e, int f) {
    return events[((size_t)(t * EW + e) * EV_NF + f) * WPP + w];
  };
  // round 1: the pool row's scalars, the transcript's act and kinds
  int na = 0, iv = 0, pos = 0, qlen = 0, k[EWC];
  bool live = false, dfr = false, a = false;
#pragma unroll
  for (int q = 0; q < EWC; ++q) k[q] = EVK_NONE;
  if (in) {
    na = *n_act;
    iv = inv[w];
    live = p_live[w] != 0;
    dfr = lane_defer[w] != 0;
    pos = p_pos[w];
    qlen = p_len[w];
    if (t < ST) {
      a = act[(size_t)t * WPP + w] != 0;
#pragma unroll
      for (int q = 0; q < EWC; ++q)
        if (q < EW) k[q] = field(q, EV_KIND);
    }
  }
  const bool mine = in && w < na && iv / N == fam && live;
  if (!__any_sync(FULL, mine)) return;          // the warp's lanes are idle
  // round 2: the extend's budget and bound, and the fields of the events
  // the transcript can reach (up to its first terminal kind)
  const int slot = mine ? iv - fam * N : 0;
  int eth = 0, bnd = 0;
  if (mine) {
    eth = ed_th[slot];
    bnd = bound[slot];
  }
  int ne = 0;
  if (mine && a) {
    ne = EW;
#pragma unroll
    for (int q = EWC - 1; q >= 0; --q)
      if (q < EW && terminal(k[q])) ne = q + 1;
  }
  int xp[EWC], aux[EWC], ed[EWC], indel[EWC], sclen[EWC], scr[EWC];
#pragma unroll
  for (int q = 0; q < EWC; ++q) {
    const int kq = q < ne ? k[q] : (int)EVK_NONE;
    xp[q] = aux[q] = ed[q] = indel[q] = sclen[q] = scr[q] = 0;
    if (kq != EVK_NONE) {
      xp[q] = field(q, EV_XPOS);
      aux[q] = field(q, EV_AUX);
    }
    if (kq == EVK_MID || kq == EVK_TRAIL || kq == EVK_END) {
      ed[q] = field(q, EV_ED);
      indel[q] = field(q, EV_INDEL);
      scr[q] = field(q, EV_SCORE);
    }
    if (kq == EVK_END) sclen[q] = field(q, EV_SCLEN);
  }
  // the transcript's curr chain: the candidate of each event that updates
  // best (bit q of by_dir: update_dir, of by_score: update_score)
  const bool lf = left != 0;
  Res cand[EWC];
  unsigned by_dir = 0, by_score = 0;
  bool consec = false, alive = ne > 0;
  Res curr = {bnd, 0, 0, 0, 0, NEG_SCORE};
#pragma unroll
  for (int q = 0; q < EWC; ++q) {
    cand[q] = curr;
    if (!alive || q >= ne) continue;              // nothing moves once dead
    const int kind = k[q];
    if (kind == EVK_MID || kind == EVK_TRAIL) {        // aux = exon_len
      const bool bound_bad = lf ? xp[q] < add32(bnd, aux[q])
                                : add32(xp[q], aux[q]) > bnd;
      if (bound_bad || add32(curr.ed, ed[q]) > eth) {
        alive = false;
      } else {
        curr = Res{lf ? sub32(xp[q], aux[q]) : add32(xp[q], aux[q]),
                   add32(curr.ed, ed[q]), 0, sub32(curr.indel, indel[q]),
                   sub32(add32(curr.qcov, aux[q]), indel[q]), scr[q]};
        cand[q] = curr;
        by_dir |= 1u << q;
      }
      if (kind == EVK_TRAIL) alive = false;
    } else if (kind == EVK_END || kind == EVK_ENDND) {    // aux = covered
      const int need = sub32(qlen, aux[q]);
      const bool e_bad = lf ? xp[q] < add32(bnd, need)
                            : add32(xp[q], need) > bnd;
      if (!e_bad) {
        if (xp[q] == pos) consec = true;
        if (kind == EVK_END && add32(curr.ed, ed[q]) <= eth &&
            sclen[q] <= max_sc && sub32(need, sclen[q]) >= sclen[q]) {
          curr = Res{lf ? add32(sub32(xp[q], need), indel[q])
                        : sub32(add32(xp[q], need), indel[q]),
                     add32(curr.ed, ed[q]), sclen[q],
                     add32(curr.indel, indel[q]), add32(curr.qcov, need),
                     scr[q]};
          cand[q] = curr;
          by_score |= 1u << q;
        }
      }
      alive = false;
    }
  }
  // the best fold in (t, e) order: transcript s's turn, then its best to
  // every thread of the lane; the turns where none of the warp's lanes
  // has a candidate are skipped
  // best.set(pos, edth + 1, len + 1, w + 1, 0, 0) (extend.py:609/663)
  Res best = {pos, add32(eth, 1), add32(qlen, 1), add32(band, 1), 0, 0};
  unsigned turns = __ballot_sync(FULL, (by_dir | by_score) != 0);
  turns |= turns >> 16;
  turns |= turns >> 8;
  for (int s = 0; s < ST; ++s) {
    if (!(turns >> s & 1u)) continue;
    if (t == s) {
#pragma unroll
      for (int q = 0; q < EWC; ++q) {
        if (by_dir >> q & 1u) update_dir(best, cand[q], max_ed, max_sc, lf);
        if (by_score >> q & 1u) update_score(best, cand[q], lf);
      }
    }
    best.pos = __shfl_sync(FULL, best.pos, s, FOLD_T);
    best.ed = __shfl_sync(FULL, best.ed, s, FOLD_T);
    best.sclen = __shfl_sync(FULL, best.sclen, s, FOLD_T);
    best.indel = __shfl_sync(FULL, best.indel, s, FOLD_T);
    best.qcov = __shfl_sync(FULL, best.qcov, s, FOLD_T);
    best.score = __shfl_sync(FULL, best.score, s, FOLD_T);
  }
  const unsigned lane_bits = 0xffu << (threadIdx.x % 32 / FOLD_T * FOLD_T);
  const bool any_consec = (__ballot_sync(FULL, consec) & lane_bits) != 0;
  if (!mine || t != 0) return;
  const size_t n = (size_t)N;
  out[FO_POS * n + slot] = best.pos;
  out[FO_ED * n + slot] = best.ed;
  out[FO_SCLEN * n + slot] = best.sclen;
  out[FO_INDEL * n + slot] = best.indel;
  out[FO_QCOV * n + slot] = best.qcov;
  out[FO_SCORE * n + slot] = best.score;
  out[FO_CONSEC * n + slot] = any_consec;
  out[FO_DEFER * n + slot] = dfr;
}

// --------------------------------------------------------------------------
// tiny_dp
// --------------------------------------------------------------------------

// AlignCandid.update with the strict key order (align.py:184-188): END's
// best (key, ed, indel) over the column-m cells dp[i][m], i ascending.
struct Cand {
  int bk, be, bi;
  __device__ __forceinline__ void update(int i, int dmv, int n, int m, int w,
                                         int max_ed) {
    const int indel = sub32(m, i);
    const int ai = abs32(indel);
    const int w1 = add32(w, 1);
    if (i <= n && ai <= w && dmv <= max_ed) {
      const int key = add32(mul32(sub32(max_ed, dmv), add32(w, 2)),
                            sub32(w1, ai < w1 ? ai : w1));
      if (key > bk) {
        bk = key;
        be = dmv;
        bi = indel;
      }
    }
  }
};

// dp[i][0] of a row whose column limit is m: i, or dp[0][0]
__device__ __forceinline__ int col0(int i, int m) {
  return i >= 1 ? i : (m >= 0 ? 0 : POS);
}

// Rows of NM, MM <= TINY_REG: TINY_REG lanes a row, lane c holding column
// j = c + 1; at step k lane c computes dp[i][j] for i = k - c + 1.  Its up
// neighbour is its own last cell, its left one its neighbour lane's last
// cell (one shuffle), its diagonal the left it received a step before.
// Only the columns j <= mc = clamp(m, 0, MM) reach dp[*][mc], so lanes
// past it idle and a row takes n + mc - 1 steps.
__global__ void __launch_bounds__(NT_MAX) tiny_dp_kernel(
    const int8_t* __restrict__ s, const int8_t* __restrict__ t,
    const int32_t* __restrict__ n_in, const int32_t* __restrict__ m_in,
    const uint8_t* __restrict__ tiny, const int32_t* __restrict__ banded,
    int32_t* __restrict__ out, int B, int Ls, int Lt, int NM, int MM, int w,
    int max_ed, int end) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = x / TINY_REG, c = x % TINY_REG;
  const int nout = end ? 2 : 1;
  // one round of loads: the row's flag, lengths and banded answer, the
  // lane's reference base and the row's query bases
  bool fall = false;
  int n = 0, m = 0, bv = 0, tj = 0, sq[TINY_REG];
  if (b < B) {
    fall = tiny[b] != 0;
    n = min(n_in[b], NM);
    m = min(m_in[b], MM);
    if (c < nout) bv = banded[(size_t)b * nout + c];
    if (c < MM) tj = t[(size_t)b * Lt + c];
#pragma unroll
    for (int i = 0; i < TINY_REG; ++i)
      sq[i] = i < NM ? s[(size_t)b * Ls + i] : 0;
  }
  if (b < B && !fall && c < nout)                 // the banded answer
    out[(size_t)b * nout + c] = bv;
  if (!__any_sync(FULL, fall)) return;            // the warp's rows passed
  if (!fall) n = m = 0;
  const int mc = clampi(m, 0, MM);
  // the mismatches down the lane's column, bit i - 1 for row i
  unsigned mis = 0;
  if (c < mc) {
#pragma unroll
    for (int i = 0; i < TINY_REG; ++i)
      if (i < n)
        mis |= (unsigned)((sq[i] != tj) | (sq[i] >= 4) | (tj >= 4)) << i;
  }
  const int steps = __reduce_max_sync(
      FULL, n >= 1 && mc >= 1 ? n + mc - 1 : 0);
  const bool own = fall && c == (mc > 0 ? mc - 1 : 0);   // column mc's lane
  Cand cand{0, add32(max_ed, 1), add32(w, 1)};
  if (end && own && mc > 0) cand.update(0, mc, n, m, w, max_ed);
  int cur = c + 1;   // dp[0][c + 1], a column inside m where it is used
  int diag = 0;      // dp[0][0] for lane 0; the others' comes by shuffle
  for (int k = 0; k < steps; ++k) {
    const int i = k - c + 1;
    int left = __shfl_up_sync(FULL, cur, 1, TINY_REG);
    if (c == 0) left = i;                         // dp[i][0]
    if (c < mc && i >= 1 && i <= n) {
      const int mi = (int)((mis >> (i - 1)) & 1u);
      cur = min(diag + mi, min(cur + 1, left + 1));
      if (end && own) cand.update(i, cur, n, m, w, max_ed);
    }
    diag = left;
  }
  if (!own) return;
  if (mc == 0) {                                  // column 0 alone
    if (end)
      for (int i = 0; i <= max(n, 0); ++i)
        cand.update(i, col0(i, m), n, m, w, max_ed);
    else
      cur = col0(max(n, 0), m);
  }
  if (end) {
    out[(size_t)b * 2] = cand.be;
    out[(size_t)b * 2 + 1] = cand.bi;
  } else {
    out[b] = cur;
  }
}

// One DP cell: dp[i][j] from its diagonal, upper and left neighbours, or
// POS past column m.
__device__ __forceinline__ int tiny_cell(int si, const int8_t* __restrict__ t,
                                         int j, int m, int diag, int up,
                                         int left) {
  if (j > m) return POS;
  const int tj = t[j - 1];
  const int mis = (si != tj) | (si >= 4) | (tj >= 4);
  return min(diag + mis, min(up + 1, left + 1));
}

// Rows wider than TINY_REG: one thread per row, the row of MM + 1 cells in
// dynamic shared memory, cells i <= n, j <= m (columns past m hold POS).
__global__ void __launch_bounds__(64) tiny_dp_kernel_smem(
    const int8_t* __restrict__ s, const int8_t* __restrict__ t,
    const int32_t* __restrict__ n_in, const int32_t* __restrict__ m_in,
    const uint8_t* __restrict__ tiny, const int32_t* __restrict__ banded,
    int32_t* __restrict__ out, int B, int Ls, int Lt, int NM, int MM, int w,
    int max_ed, int end) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int nout = end ? 2 : 1;
  int32_t* ob = out + (size_t)b * nout;
  if (!tiny[b]) {                                 // the banded answer
    for (int q = 0; q < nout; ++q) ob[q] = banded[(size_t)b * nout + q];
    return;
  }
  const int n = min(n_in[b], NM), m = min(m_in[b], MM);
  const int8_t* sb = s + (size_t)b * Ls;
  const int8_t* tb = t + (size_t)b * Lt;
  extern __shared__ int cm_tiny_row[];
  int* row = cm_tiny_row + threadIdx.x;           // cell j at row[j * st]
  const int st = blockDim.x;
  for (int j = 0; j <= MM; ++j) row[j * st] = j <= m ? j : POS;
  const int mc = clampi(m, 0, MM);
  Cand cand{0, add32(max_ed, 1), add32(w, 1)};
  if (end) cand.update(0, row[mc * st], n, m, w, max_ed);
  for (int i = 1; i <= n; ++i) {    // rows past n leave the row as it is
    const int si = sb[i - 1];
    int diag = row[0], left = i;
    row[0] = i;
    for (int j = 1; j <= MM; ++j) {
      const int up = row[j * st];
      left = row[j * st] = tiny_cell(si, tb, j, m, diag, up, left);
      diag = up;
    }
    if (end) cand.update(i, row[mc * st], n, m, w, max_ed);
  }
  if (end) {
    ob[0] = cand.be;
    ob[1] = cand.bi;
  } else {
    ob[0] = row[mc * st];
  }
}

__global__ void walk_empty_kernel(int) {}

// --------------------------------------------------------------------------
// walk_scan
// --------------------------------------------------------------------------

__global__ void __launch_bounds__(NT_MAX) walk_scan_kernel(
    const int32_t* __restrict__ ws, const int32_t* __restrict__ slot,
    const int32_t* __restrict__ lane, const int32_t* __restrict__ iv_spos,
    const int32_t* __restrict__ iv_epos,
    const uint8_t* __restrict__ t2s_state, int32_t* __restrict__ ws_out,
    int STW, int WPP, int NIV, int NS, int G, int KSCAN) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t plane = (size_t)STW * WPP;
  if ((size_t)x >= plane) return;
  const int w = x % WPP;
  int f[WS_NF];
#pragma unroll
  for (int k = 0; k < WS_NF; ++k) f[k] = ws[k * plane + x];
  int i_abs = f[WS_I_ABS], xpos = f[WS_XPOS], exlen = f[WS_EXLEN];
  const int covered = f[WS_COVERED];
  bool first = f[WS_FIRST] != 0;
  int stat = f[WS_STAT];
  const int remref = f[WS_REMREF];
  const int tstart = slot[SL_TSTART * plane + x];
  const int toff = slot[SL_TOFF * plane + x];
  const int tlen = slot[SL_TLEN * plane + x];
  const bool is_left = lane[LN_IS_LEFT * WPP + w] != 0;
  const int qlen = lane[LN_QLEN * WPP + w], pos = lane[LN_POS * WPP + w];
  const int iend = sub32(add32(tstart, tlen), 1);   // right scan end
  const int istop = tstart;                          // left scan floor
  const int need = sub32(qlen, covered);   // covered is constant in a scan
  // a scan ends for good once its lane leaves WK_SCAN
  for (int k = 0; k < KSCAN && stat == WK_SCAN; ++k) {
    const int ivc = clampi(i_abs, 0, NIV - 1);
    const int ivs = NIV > 0 ? iv_spos[ivc] : 0;
    const int ive = NIV > 0 ? iv_epos[ivc] : 0;
    const int ivl = add32(sub32(ive, ivs), 1);
    const int row = sub32(i_abs, tstart);
    int stt = 0;
    if (row >= 0 && row < tlen && NS > 0)
      stt = t2s_state[clampi(add32(toff, row), 0, NS - 1)];

    bool ended, brk, go0;
    if (is_left) {
      // accumulate, then break, then flush (extend.py:497-510)
      ended = i_abs < istop;
      go0 = !ended;
      if (go0 && stt != 0) {
        if (first) {
          exlen = sub32(pos, ivs);
        } else {
          if (exlen == 0) xpos = add32(ive, 1);
          exlen = add32(exlen, ivl);
        }
        first = false;
      }
      brk = go0 && exlen >= need;
    } else {
      // the break check reads exlen before the step's accumulate
      ended = i_abs > iend;
      go0 = !ended;
      brk = go0 && exlen >= need;
    }

    // terminal transitions (trailing / end / done)
    const bool stop = ended || brk;
    const bool trail_geo = ended && exlen > 0 && exlen < need;
    const bool t_inb = is_left
        ? (sub32(xpos, exlen) >= 1 && sub32(xpos, 1) <= G)
        : (add32(xpos, 1) >= 1 && add32(xpos, exlen) <= G);
    const bool to_trail = trail_geo && t_inb;
    const bool end_geo = stop && !trail_geo && covered < qlen &&
                         exlen >= need;
    const int rr2 = min(remref, exlen);
    const bool e_inb = rr2 >= 0 &&
        (is_left ? (sub32(xpos, rr2) >= 1 && sub32(xpos, 1) <= G)
                 : (add32(xpos, 1) >= 1 && add32(xpos, rr2) <= G));
    const bool to_end = end_geo && e_inb;
    const bool to_endnd = end_geo && !e_inb;
    const bool to_done = stop && !to_trail && !to_end && !to_endnd;
    // in-loop state-1 flush (its window test is the trailing one)
    const bool go = go0 && !brk;
    const bool flush = go && stt == 1 && exlen > 0;
    const bool to_mid = flush && t_inb;
    const bool mid_oob = flush && !t_inb;      // the host walk fails

    if (to_trail) stat = WK_PTRAIL;
    else if (to_end) stat = WK_PEND;
    else if (to_endnd) stat = WK_PENDND;
    else if (to_mid) stat = WK_PMID;
    else if (to_done || mid_oob) stat = WK_DONE;
    const bool moved = to_mid || to_trail || to_end || to_endnd;
    if (to_mid) f[WS_PEND_IV] = i_abs;
    if (moved) {
      f[WS_PEND_XPOS] = xpos;
      f[WS_PEND_COV] = covered;
    }
    if (to_mid || to_trail) f[WS_PEND_EXLEN] = exlen;
    if (to_end) f[WS_PEND_RR] = rr2;

    // plain scan advance; a right empty flush sets rspos = iv_spos - 1,
    // then the state-1 interval accumulates (extend.py:420-428)
    const bool adv = go && stt != 1;
    const bool empty = go && stt == 1 && exlen == 0;
    if (!is_left) {
      if ((adv || empty) && stt != 0) exlen = add32(exlen, ivl);
      if (empty) xpos = sub32(ivs, 1);
      if (adv || empty) i_abs = add32(i_abs, 1);
    } else if (adv || empty) {
      i_abs = sub32(i_abs, 1);
    }
  }
  f[WS_I_ABS] = i_abs;
  f[WS_XPOS] = xpos;
  f[WS_EXLEN] = exlen;
  f[WS_FIRST] = first;
  f[WS_STAT] = stat;
#pragma unroll
  for (int k = 0; k < WS_NF; ++k) ws_out[k * plane + x] = f[k];
}

// The launch shape of each kernel: grid, threads a block, dynamic shared
// memory (grid 0: rows the kernel cannot take).
struct Shape {
  unsigned grid;
  int nt;
  size_t smem;
};

unsigned blocks(long long threads, int nt) {
  return (unsigned)((threads + nt - 1) / nt);
}

// Blocks of NT_MIN..NT_MAX threads, the fewest that still give each of
// the card's 132 SMs two blocks where there are threads enough.
Shape spread(long long threads) {
  int nt = NT_MIN;
  while (nt < NT_MAX && threads > 2LL * 132 * nt) nt *= 2;
  return {blocks(threads, nt), nt, 0};
}

Shape fold_shape(int WPP) { return spread((long long)WPP * FOLD_T); }

// The widest row kept in shared memory: MM + 1 words for each of 32
// threads within the default 48 KB of a block (ops/device_walk.py
// TINY_MM_MAX); the port's pools pass MM <= 127.
Shape tiny_shape(int B, int NM, int MM) {
  if (NM <= TINY_REG && MM <= TINY_REG)
    return spread((long long)B * TINY_REG);
  const size_t row = (size_t)(MM + 1) * sizeof(int);
  const int nt = row * 64 <= 48 * 1024 ? 64 : 32;
  if (row * nt > 48 * 1024) return {0, nt, 0};
  return {blocks(B, nt), nt, row * nt};
}

Shape scan_shape(long long threads) {
  return spread(threads);
}

}  // namespace

// Each entry point launches one kernel on the given stream and returns
// cudaGetLastError() (0 when the launch was accepted).  CM_WALK_LAUNCH is
// the only launch site, so a host emulation can replace it.
#define CM_WALK_LAUNCH(KERNEL, grid, nt, smem, stream, ...)            \
  (KERNEL<<<grid, nt, smem, stream>>>(__VA_ARGS__), (int)cudaGetLastError())

extern "C" int cm_walk_fold(const void* events, const void* act,
                            const void* inv, const void* n_act,
                            const void* p_live, const void* p_pos,
                            const void* p_len, const void* lane_defer,
                            const void* ed_th, const void* bound, void* out,
                            int WPP, int N, int fam, int left, int ST, int EW,
                            int max_ed, int max_sc, int band, void* stream) {
  const Shape sh = fold_shape(WPP);
  if (ST > FOLD_T || EW > 2 * FOLD_EW) return (int)cudaErrorInvalidValue;
  if (EW <= FOLD_EW)
    return CM_WALK_LAUNCH(
        walk_fold_kernel<FOLD_EW>, sh.grid, sh.nt, sh.smem,
        (cudaStream_t)stream, (const int32_t*)events, (const uint8_t*)act,
        (const int32_t*)inv, (const int32_t*)n_act, (const uint8_t*)p_live,
        (const int32_t*)p_pos, (const int32_t*)p_len,
        (const uint8_t*)lane_defer, (const int32_t*)ed_th,
        (const int32_t*)bound, (int32_t*)out, WPP, N, fam, left, ST, EW,
        max_ed, max_sc, band);
  return CM_WALK_LAUNCH(
      walk_fold_kernel<2 * FOLD_EW>, sh.grid, sh.nt, sh.smem, (cudaStream_t)stream,
      (const int32_t*)events, (const uint8_t*)act, (const int32_t*)inv,
      (const int32_t*)n_act, (const uint8_t*)p_live, (const int32_t*)p_pos,
      (const int32_t*)p_len, (const uint8_t*)lane_defer,
      (const int32_t*)ed_th, (const int32_t*)bound, (int32_t*)out, WPP, N,
      fam, left, ST, EW, max_ed, max_sc, band);
}

extern "C" int cm_tiny_dp(const void* s, const void* t, const void* n,
                          const void* m, const void* tiny, const void* banded,
                          void* out, int B, int Ls, int Lt, int NM, int MM,
                          int w, int max_ed, int end, void* stream) {
  const Shape sh = tiny_shape(B, NM, MM);
  if (sh.grid == 0) return (int)cudaErrorInvalidValue;
  if (sh.smem == 0)
    return CM_WALK_LAUNCH(
        tiny_dp_kernel, sh.grid, sh.nt, sh.smem, (cudaStream_t)stream,
        (const int8_t*)s, (const int8_t*)t, (const int32_t*)n,
        (const int32_t*)m, (const uint8_t*)tiny, (const int32_t*)banded,
        (int32_t*)out, B, Ls, Lt, NM, MM, w, max_ed, end);
  return CM_WALK_LAUNCH(
      tiny_dp_kernel_smem, sh.grid, sh.nt, sh.smem, (cudaStream_t)stream,
      (const int8_t*)s, (const int8_t*)t, (const int32_t*)n,
      (const int32_t*)m, (const uint8_t*)tiny, (const int32_t*)banded,
      (int32_t*)out, B, Ls, Lt, NM, MM, w, max_ed, end);
}

extern "C" int cm_walk_scan(const void* ws, const void* slot,
                            const void* lane, const void* iv_spos,
                            const void* iv_epos, const void* t2s_state,
                            void* ws_out, int STW, int WPP, int NIV, int NS,
                            int G, int KSCAN, void* stream) {
  const Shape sh = scan_shape((long long)STW * WPP);
  return CM_WALK_LAUNCH(
      walk_scan_kernel, sh.grid, sh.nt, sh.smem, (cudaStream_t)stream,
      (const int32_t*)ws, (const int32_t*)slot, (const int32_t*)lane,
      (const int32_t*)iv_spos, (const int32_t*)iv_epos,
      (const uint8_t*)t2s_state, (int32_t*)ws_out, STW, WPP, NIV, NS, G,
      KSCAN);
}

// An empty kernel on the grid that kernel (a WalkKernel) takes for rows
// (walk_fold: WPP, tiny_dp: B at NM x MM, walk_scan: STW * WPP): the
// launch floor under each kernel's device time.  Not counted as a launch.
extern "C" int cm_walk_empty(int kernel, int rows, int NM, int MM,
                             void* stream) {
  const Shape sh = kernel == WALK_FOLD ? fold_shape(rows)
                   : kernel == WALK_TINY ? tiny_shape(rows, NM, MM)
                                         : scan_shape(rows);
  if (sh.grid == 0) return (int)cudaErrorInvalidValue;
  return CM_WALK_LAUNCH(walk_empty_kernel, sh.grid, sh.nt, 0,
                        (cudaStream_t)stream, 0);
}
