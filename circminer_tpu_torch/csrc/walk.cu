// The extension walk of the fused gpu-full step, hand-written for Hopper
// (sm_90a): three per-thread sequential chains of integer logic.
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
//                 device_full.py::_tiny_global (:101, end = 0: dp[n][m]).
//                 Plain version: ops/device_walk.py::_tiny_dp_plain.
//   cm_walk_scan  replaces scan_step, run by fori_loop(0, KSCAN) in
//                 device_walk.py::walk_waves (:247-343, :366): per
//                 (transcript slot, lane), up to KSCAN steps of the
//                 interval-scan state machine.  Plain version:
//                 ops/device_walk.py::_walk_scan_plain.
//
// Layout: one thread per lane (walk_fold), per pooled row (tiny_dp) and per
// (slot, lane) (walk_scan), its state in registers.  Tensors are
// lane-minor ([..., WPP]), so a warp's loads of one field coalesce.  The
// tiny DP's row of MM + 1 cells sits in registers at MM <= 8 (every main
// path call: TM = max(8, 2w + 2) = 8 at the default band w = 3, and the
// OS pool's TM = 8); a wider row lives in dynamic shared memory, one
// column per thread (the word of cell j of thread x at j * blockDim + x,
// so a warp's accesses hit 32 banks).
//
// What bounds them: latency.  Each thread runs one dependent chain (32
// events, KSCAN = 12 steps, TN rows of TM cells) of a few dozen integer
// operations a link; a launch moves a few MB at most.  Each replaces
// hundreds to thousands of small torch kernels of the captured step.
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

constexpr int NEG_SCORE = -1000000000;
constexpr int POS = 10000000;
constexpr int TINY_REG = 8;   // the widest tiny-DP row held in registers

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

__global__ void __launch_bounds__(128) walk_fold_kernel(
    const int32_t* __restrict__ events, const uint8_t* __restrict__ act,
    const int32_t* __restrict__ inv, const int32_t* __restrict__ n_act,
    const uint8_t* __restrict__ p_live, const int32_t* __restrict__ p_pos,
    const int32_t* __restrict__ p_len,
    const uint8_t* __restrict__ lane_defer,
    const int32_t* __restrict__ ed_th, const int32_t* __restrict__ bound,
    int32_t* __restrict__ out, int WPP, int N, int fam, int left, int ST,
    int EW, int max_ed, int max_sc, int band) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= WPP || w >= *n_act) return;          // pool rows past n_act
  const int iv = inv[w];
  if (iv / N != fam || !p_live[w]) return;      // outputs stay 0
  const int slot = iv - fam * N;
  const int eth = ed_th[slot], bnd = bound[slot];
  const int pos = p_pos[w], qlen = p_len[w];
  const bool lf = left != 0;
  // best.set(pos, edth + 1, len + 1, w + 1, 0, 0) (extend.py:609/663)
  Res best = {pos, add32(eth, 1), add32(qlen, 1), add32(band, 1), 0, 0};
  bool consec = false;
  const size_t plane = (size_t)WPP;
  for (int t = 0; t < ST; ++t) {
    Res curr = {bnd, 0, 0, 0, 0, NEG_SCORE};
    bool alive = act[(size_t)t * WPP + w] != 0;
    for (int e = 0; e < EW && alive; ++e) {   // nothing moves once dead
      const int32_t* ev = events + (size_t)(t * EW + e) * EV_NF * plane + w;
      const int kind = ev[EV_KIND * plane], xp = ev[EV_XPOS * plane];
      const int aux = ev[EV_AUX * plane], ed = ev[EV_ED * plane];
      const int indel = ev[EV_INDEL * plane];
      const int sclen = ev[EV_SCLEN * plane], scr = ev[EV_SCORE * plane];
      if (kind == EVK_MID || kind == EVK_TRAIL) {      // aux = exon_len
        const bool bound_bad = lf ? xp < add32(bnd, aux)
                                  : add32(xp, aux) > bnd;
        if (bound_bad || add32(curr.ed, ed) > eth) {
          alive = false;
        } else {
          curr = Res{lf ? sub32(xp, aux) : add32(xp, aux),
                     add32(curr.ed, ed), 0, sub32(curr.indel, indel),
                     sub32(add32(curr.qcov, aux), indel), scr};
          update_dir(best, curr, max_ed, max_sc, lf);
        }
        if (kind == EVK_TRAIL) alive = false;
      } else if (kind == EVK_END || kind == EVK_ENDND) {   // aux = covered
        const int need = sub32(qlen, aux);
        const bool e_bad = lf ? xp < add32(bnd, need)
                              : add32(xp, need) > bnd;
        if (!e_bad) {
          if (xp == pos) consec = true;
          if (kind == EVK_END && add32(curr.ed, ed) <= eth &&
              sclen <= max_sc && sub32(need, sclen) >= sclen) {
            curr = Res{lf ? add32(sub32(xp, need), indel)
                          : sub32(add32(xp, need), indel),
                       add32(curr.ed, ed), sclen, add32(curr.indel, indel),
                       add32(curr.qcov, need), scr};
            update_score(best, curr, lf);
          }
        }
        alive = false;
      }
    }
  }
  const size_t n = (size_t)N;
  out[FO_POS * n + slot] = best.pos;
  out[FO_ED * n + slot] = best.ed;
  out[FO_SCLEN * n + slot] = best.sclen;
  out[FO_INDEL * n + slot] = best.indel;
  out[FO_QCOV * n + slot] = best.qcov;
  out[FO_SCORE * n + slot] = best.score;
  out[FO_CONSEC * n + slot] = consec;
  out[FO_DEFER * n + slot] = lane_defer[w] != 0;
}

// --------------------------------------------------------------------------
// tiny_dp
// --------------------------------------------------------------------------

// The row's cells: registers (RC = TINY_REG columns past column 0, every
// loop over them unrolled, so every index is a constant) or dynamic shared
// memory (RC = 0).
template <int RC>
struct RegRow {
  int v[RC + 1];
  __device__ __forceinline__ int& operator[](int j) { return v[j]; }
  __device__ __forceinline__ int at(int j) const {   // a runtime index
    int r = v[0];
#pragma unroll
    for (int k = 1; k <= RC; ++k) r = (k == j) ? v[k] : r;
    return r;
  }
};

struct SharedRow {
  int* base;
  int stride;
  __device__ __forceinline__ int& operator[](int j) {
    return base[j * stride];
  }
  __device__ __forceinline__ int at(int j) const { return base[j * stride]; }
};

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

// One pooled row's full edit DP over cells i <= n, j <= m (n <= NM,
// m <= MM after the clamp; columns past m hold POS), with the column-m
// candidate scan when end.  The row has cols = MM columns past column 0
// (RC = 0) or RC >= MM, whose extra columns stay POS.
template <int RC, typename Row>
__device__ __forceinline__ void tiny_row(Row& row, int cols,
                                         const int8_t* __restrict__ s,
                                         const int8_t* __restrict__ t, int n,
                                         int m, int NM, int MM, int w,
                                         int max_ed, bool end,
                                         int32_t* __restrict__ out) {
  if constexpr (RC > 0) {
#pragma unroll
    for (int j = 0; j <= RC; ++j) row[j] = j <= m ? j : POS;
  } else {
    for (int j = 0; j <= cols; ++j) row[j] = j <= m ? j : POS;
  }
  const int mc = clampi(m, 0, MM);
  int bk = 0, be = add32(max_ed, 1), bi = add32(w, 1);
  // AlignCandid.update with the strict key order (align.py:184-188)
  auto upd = [&](int i) {
    const int dmv = row.at(mc);
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
  };
  if (end) upd(0);
  const int last = n < NM ? n : NM;   // rows past n leave the row as it is
  for (int i = 1; i <= last; ++i) {
    const int si = s[i - 1];
    int diag = row[0], left = i;
    row[0] = i;
    if constexpr (RC > 0) {
#pragma unroll
      for (int j = 1; j <= RC; ++j) {
        const int up = row[j];
        left = row[j] = tiny_cell(si, t, j, m, diag, up, left);
        diag = up;
      }
    } else {
      for (int j = 1; j <= cols; ++j) {
        const int up = row[j];
        left = row[j] = tiny_cell(si, t, j, m, diag, up, left);
        diag = up;
      }
    }
    if (end) upd(i);
  }
  if (end) {
    out[0] = be;
    out[1] = bi;
  } else {
    out[0] = row.at(mc);
  }
}

template <int RC>
__global__ void __launch_bounds__(128) tiny_dp_kernel(
    const int8_t* __restrict__ s, const int8_t* __restrict__ t,
    const int32_t* __restrict__ n_in, const int32_t* __restrict__ m_in,
    int32_t* __restrict__ out, int B, int Ls, int Lt, int NM, int MM, int w,
    int max_ed, int end) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int n = min(n_in[b], NM), m = min(m_in[b], MM);
  const int8_t* sb = s + (size_t)b * Ls;
  const int8_t* tb = t + (size_t)b * Lt;
  int32_t* ob = out + (size_t)b * (end ? 2 : 1);
  if constexpr (RC > 0) {
    RegRow<RC> row;
    tiny_row<RC>(row, RC, sb, tb, n, m, NM, MM, w, max_ed, end != 0, ob);
  } else {
    extern __shared__ int cm_tiny_row[];
    SharedRow row{cm_tiny_row + threadIdx.x, (int)blockDim.x};
    tiny_row<0>(row, MM, sb, tb, n, m, NM, MM, w, max_ed, end != 0, ob);
  }
}

// --------------------------------------------------------------------------
// walk_scan
// --------------------------------------------------------------------------

__global__ void __launch_bounds__(128) walk_scan_kernel(
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
  const int nt = 128;
  return CM_WALK_LAUNCH(
      walk_fold_kernel, (WPP + nt - 1) / nt, nt, 0, (cudaStream_t)stream,
      (const int32_t*)events, (const uint8_t*)act, (const int32_t*)inv,
      (const int32_t*)n_act, (const uint8_t*)p_live, (const int32_t*)p_pos,
      (const int32_t*)p_len, (const uint8_t*)lane_defer,
      (const int32_t*)ed_th, (const int32_t*)bound, (int32_t*)out, WPP, N,
      fam, left, ST, EW, max_ed, max_sc, band);
}

// The widest row kept in shared memory: MM + 1 words for each of 32
// threads within the default 48 KB of a block (ops/device_walk.py
// TINY_MM_MAX); the port's pools pass MM <= 127.
extern "C" int cm_tiny_dp(const void* s, const void* t, const void* n,
                          const void* m, void* out, int B, int Ls, int Lt,
                          int NM, int MM, int w, int max_ed, int end,
                          void* stream) {
  if (MM <= TINY_REG) {
    const int nt = 128;
    return CM_WALK_LAUNCH(
        tiny_dp_kernel<TINY_REG>, (B + nt - 1) / nt, nt, 0,
        (cudaStream_t)stream, (const int8_t*)s, (const int8_t*)t,
        (const int32_t*)n, (const int32_t*)m, (int32_t*)out, B, Ls, Lt, NM,
        MM, w, max_ed, end);
  }
  const size_t row = (size_t)(MM + 1) * sizeof(int);
  const int nt = row * 64 <= 48 * 1024 ? 64 : 32;
  if (row * nt > 48 * 1024) return (int)cudaErrorInvalidValue;
  return CM_WALK_LAUNCH(
      tiny_dp_kernel<0>, (B + nt - 1) / nt, nt, row * nt,
      (cudaStream_t)stream, (const int8_t*)s, (const int8_t*)t,
      (const int32_t*)n, (const int32_t*)m, (int32_t*)out, B, Ls, Lt, NM, MM,
      w, max_ed, end);
}

extern "C" int cm_walk_scan(const void* ws, const void* slot,
                            const void* lane, const void* iv_spos,
                            const void* iv_epos, const void* t2s_state,
                            void* ws_out, int STW, int WPP, int NIV, int NS,
                            int G, int KSCAN, void* stream) {
  const int nt = 128;
  const long long threads = (long long)STW * WPP;
  return CM_WALK_LAUNCH(
      walk_scan_kernel, (unsigned)((threads + nt - 1) / nt), nt, 0,
      (cudaStream_t)stream, (const int32_t*)ws, (const int32_t*)slot,
      (const int32_t*)lane, (const int32_t*)iv_spos,
      (const int32_t*)iv_epos, (const uint8_t*)t2s_state, (int32_t*)ws_out,
      STW, WPP, NIV, NS, G, KSCAN);
}
