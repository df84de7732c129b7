// The extension walk's lane set-up and wave body of the fused gpu-full
// step, hand-written for Hopper (sm_90a): everything of the reference's
// walk_waves (circminer_tpu/ops/device_walk.py:138-541) that walk.cu's
// scan and the DP kernels do not compute.  Four kernels behind three entry
// points:
//
//   cm_walk_init    replaces the lane set-up before the wave loop
//                   (device_walk.py:163-235): walk_compact_kernel
//                   compacts the [4N] active flags into WPP lanes
//                   (_compact, device_full.py:154: inv, n_act, over), then
//                   walk_init_kernel, a thread a lane, gathers the lane's
//                   tables, its common transcripts (f_iv's tids that r_iv
//                   also lists, duplicates kept) packed in order into STW
//                   slots (over_tid past STW), the slots' transcript
//                   constants, the initial scan state, and zeroes the
//                   lane's events and counts.  Plain version:
//                   ops/device_walk.py::_walk_init_plain.
//   cm_walk_pool    replaces a wave's two DP pools (wave_body's dedup
//                   :374-382, _compact :390 / :428, mg / eg and the window
//                   gathers :387-417 / :425-452, _gather_window
//                   device_full.py:85): walk_compact_kernel deduplicates
//                   each lane's slots by geometry and ranks the leaders in
//                   slot-major flat order (row j holds rank j + 1; rows past
//                   the count gather flat S - 1), writing each lane's map
//                   code (its leader's row, MAP_NONE or MAP_OVER); then
//                   walk_pool_kernel hands each follower its leader's code
//                   and, a warp a pool row, gathers the row's lengths and
//                   its query and reference windows.  Plain version:
//                   ops/device_walk.py::_walk_pool_plain.
//   cm_walk_commit  replaces the scatter-back and commit of a wave
//                   (:420-520): walk_commit_kernel, a thread a (slot,
//                   lane), reads its leader's middle-DP (ed, indel) and
//                   end-DP (score, on_s, on_t) through the map, applies
//                   _drop_wrap for its side (device_full.py:139, floor
//                   division), inherits its leader's overflow, writes the
//                   wave's one event at slot clamp(nev, 0, EW - 1), advances
//                   nev and applies the middle commit.  Plain version:
//                   ops/device_walk.py::_walk_commit_plain.
//
// The compactions: a rank is a prefix count over the whole flat order
// (262,144 lane flags, a pool's 49,152 slots at chr21), and a block alone
// is held to one SM's instruction rate (a first design of one block a
// compaction took 0.04-0.12 ms).  So walk_compact_kernel runs twice over
// tiles of CT units, a block a tile: the first launch counts each tile's
// flags into an int32 workspace, the second ranks each tile's flags after
// the counts of the tiles before it (no block waits on another).  A pool's
// followers need their leader's final code, so walk_pool_kernel, the next
// launch, resolves them.  Tensors are lane-minor, so a warp's loads of one
// field coalesce.
//
// Parity: every int32 sum wraps as in torch (add32, sub32, mul32); gathers
// clamp their index where the plain version clamps it; the windows pad
// with 127 where the plain version does (the query past its length only,
// its index clamped into the reads; the reference also outside the
// genome).  A pool's dead rows gather flat S - 1 exactly as _compact's
// clamped searchsorted does, so whole buffers compare bit-equal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// lane status codes and event kinds (ops/device_walk.py)
enum WalkStat { WK_SCAN, WK_PMID, WK_PTRAIL, WK_PEND, WK_PENDND, WK_DONE };
enum EventKind { EVK_NONE, EVK_MID, EVK_TRAIL, EVK_END, EVK_ENDND };
// event record fields (ops/device_walk.py EV_KEYS)
enum EventField { EV_KIND, EV_XPOS, EV_AUX, EV_ED, EV_INDEL, EV_SCLEN,
                  EV_SCORE, EV_NF };
// the scan's carried state (ops/device_walk.py WS_KEYS)
enum ScanField { WS_I_ABS, WS_XPOS, WS_EXLEN, WS_COVERED, WS_FIRST, WS_STAT,
                 WS_PEND_IV, WS_PEND_XPOS, WS_PEND_EXLEN, WS_PEND_COV,
                 WS_PEND_RR, WS_REMREF, WS_NF };
// per (slot, lane) constants (SLOT_KEYS), per lane constants (LANE_KEYS)
// and the pools' per lane rows (PROW_KEYS)
enum SlotField { SL_TSTART, SL_TOFF, SL_TLEN, SL_NF };
enum LaneField { LN_IS_LEFT, LN_QLEN, LN_POS, LN_NF };
enum ProwField { PW_ROW, PW_QS0, PW_NF };
// a pool's int32 rows (POOL_ROWS): its DP's n and m, the flat index
enum PoolRow { PR_N, PR_M, PR_INV, PR_NF };
// the two pools: the maps' planes and n's words
enum PoolKind { POOL_MID, POOL_END, POOL_NK };
// the entry point whose grids cm_wave_empty takes
enum WaveKernel { WAVE_INIT, WAVE_POOL, WAVE_COMMIT };

// a lane's code in a pool map (MAP_NONE, MAP_OVER in ops/device_walk.py):
// its leader's row (>= 0), none, or the leader's rank past the pool; while
// a pool is built, a leader holds MAP_LEAD and a follower of slot u
// MAP_FOLLOW - u
constexpr int MAP_NONE = -1;
constexpr int MAP_OVER = -2;
constexpr int MAP_LEAD = -3;
constexpr int MAP_FOLLOW = -4;
constexpr int STW_MAX = 8;    // transcript slots a lane (ops STW)
constexpr int ST_REG = 16;    // tid lists up to this width in registers
constexpr int CT = 1024;      // units of a compaction tile, a thread each
constexpr int IT = 32;        // threads of a walk_init block (a lane each)
constexpr int WT = 128;       // threads of a block of the other kernels
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
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
// torch.div(a, b, rounding_mode="floor") for b > 0
__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// --------------------------------------------------------------------------
// walk_compact: the lane compaction and the pools' dedup + compaction
// --------------------------------------------------------------------------

// One compaction.  flags non-null: the lane compaction of S byte flags
// (S a multiple of 4, flags 4-byte aligned), its over mask out.  Else a
// pool of kind POOL_MID / POOL_END over ws's S = STW * WPP (slot, lane)
// pairs, its map out.  Its flat order is cut into units (a word of four
// byte flags, or one (slot, lane)), a unit a thread, CT units a tile, a
// block a tile; the tiles' counts go to tiles[0, ntiles).
struct Compact {
  const uint8_t* flags;
  const int32_t* ws;
  int kind, STW, WPP, S, limit, ntiles;
  int32_t* inv;     // [limit]: row j -> the flat index of rank j + 1
  int32_t* n;       // min(count, limit)
  uint8_t* over;    // [S]: flagged with a rank past limit
  int32_t* map;     // [STW, WPP]: each lane's code
  int32_t* tiles;   // [ntiles]: each tile's count of flags
};

// The inclusive prefix of v over a warp's lanes.
__device__ __forceinline__ int warp_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += y;
  }
  return v;
}

// A pool's dedup at flat f = t WPP + l: slot t of lane l is in the pool
// when pending on it; its leader is the first such slot u <= t with the
// same geometry (MID: pend_xpos, pend_exlen, pend_cov; END: pend_xpos,
// pend_cov, pend_rr).  Returns MAP_NONE, MAP_LEAD or MAP_FOLLOW - u.
__device__ int dedup_code(const Compact& c, int f) {
  const size_t plane = (size_t)c.STW * c.WPP;
  const int t = f / c.WPP, l = f % c.WPP;
  const int32_t* stat = c.ws + WS_STAT * plane + l;
  const int32_t* fx = c.ws + WS_PEND_XPOS * plane + l;
  const int32_t* f1 =
      c.ws + (c.kind == POOL_MID ? WS_PEND_EXLEN : WS_PEND_COV) * plane + l;
  const int32_t* f2 =
      c.ws + (c.kind == POOL_MID ? WS_PEND_COV : WS_PEND_RR) * plane + l;
  bool in[STW_MAX];
#pragma unroll
  for (int u = 0; u < STW_MAX; ++u) {
    const int s = u <= t ? stat[(size_t)u * c.WPP] : WK_DONE;
    in[u] = c.kind == POOL_MID ? (s == WK_PMID || s == WK_PTRAIL)
                               : s == WK_PEND;
  }
  bool mine = false;
#pragma unroll
  for (int u = 0; u < STW_MAX; ++u) mine |= u == t && in[u];
  if (!mine) return MAP_NONE;
  const size_t k = (size_t)t * c.WPP;
  const int x = fx[k], a = f1[k], b = f2[k];
#pragma unroll
  for (int u = 0; u < STW_MAX; ++u) {    // the first match wins
    if (u >= t) break;
    const size_t q = (size_t)u * c.WPP;
    if (in[u] && fx[q] == x && f1[q] == a && f2[q] == b)
      return MAP_FOLLOW - u;
  }
  return MAP_LEAD;
}

// The flags of unit u (a word of four byte flags, or a pool's code) as
// bits, none past the order's end.
__device__ __forceinline__ unsigned unit_bits(const Compact& c, int u) {
  if (c.flags) {
    if (4 * u >= c.S) return 0;
    const uint32_t w = reinterpret_cast<const uint32_t*>(c.flags)[u];
    return ((w & 0xffu) != 0) | (((w >> 8) & 0xffu) != 0) << 1 |
           (((w >> 16) & 0xffu) != 0) << 2 | (((w >> 24) & 0xffu) != 0) << 3;
  }
  return u < c.S && c.map[u] == MAP_LEAD;
}

// Two launches, each a block a tile of every compaction (blocks
// [0, a.ntiles) a, the rest b).  Phase 0 writes a pool's dedup codes and
// each tile's count of flags.  Phase 1 sums the counts of the tiles before
// its own (and of all), ranks its flags (ballots within a warp, a scan of
// the warps' counts) and writes each flag's row (inv) and over mask or map
// code, the dead rows (flat S - 1) and the count of live rows.  A pool's
// followers keep MAP_FOLLOW - u: walk_pool_kernel hands them their
// leader's code once every leader's is final.
__global__ void __launch_bounds__(CT) walk_compact_kernel(Compact a,
                                                          Compact b,
                                                          int phase) {
  __shared__ int warp_base[CT / 32 + 1];
  __shared__ int tile_base, total;
  const bool first = (int)blockIdx.x < a.ntiles;
  const Compact& c = first ? a : b;
  const int tile = first ? blockIdx.x : blockIdx.x - a.ntiles;
  const int x = threadIdx.x, lane = x & 31, wid = x >> 5;
  const int u = tile * CT + x;
  const int U = c.flags ? 4 : 1;
  if (phase == 0) {
    if (!c.flags && u < c.S) c.map[u] = dedup_code(c, u);
    const unsigned bits =
        c.flags ? unit_bits(c, u) : (u < c.S && c.map[u] == MAP_LEAD);
    int cnt = __popc(bits);
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) cnt += __shfl_xor_sync(FULL, cnt, d);
    if (lane == 0) warp_base[wid] = cnt;
    __syncthreads();
    if (wid == 0) {
      int v = warp_base[lane];
#pragma unroll
      for (int d = 16; d >= 1; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
      if (lane == 0) c.tiles[tile] = v;
    }
    return;
  }
  if (wid == 0) {
    int before = 0, all = 0;
    for (int i = lane; i < c.ntiles; i += 32) {
      const int v = c.tiles[i];
      all += v;
      before += i < tile ? v : 0;
    }
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) {
      before += __shfl_xor_sync(FULL, before, d);
      all += __shfl_xor_sync(FULL, all, d);
    }
    if (lane == 0) {
      tile_base = before;
      total = all;
    }
  }
  const unsigned bits = unit_bits(c, u);
  const unsigned lt = (1u << lane) - 1;
  int below = 0, mine = 0;           // flags of lower lanes, of the warp
  for (int k = 0; k < U; ++k) {
    const unsigned m = __ballot_sync(FULL, (bits >> k) & 1);
    below += __popc(m & lt);
    mine += __popc(m);
  }
  if (lane == 0) warp_base[wid + 1] = mine;
  __syncthreads();
  if (wid == 0) {
    const int incl = warp_scan(warp_base[lane + 1]);
    warp_base[lane + 1] = incl;
  }
  __syncthreads();
  if (U * u < c.S) {
    int r = tile_base + (wid ? warp_base[wid] : 0) + below;
    uint32_t over = 0;
    for (int k = 0; k < U; ++k) {
      if (!((bits >> k) & 1)) continue;
      const int f = U * u + k;
      ++r;
      if (r <= c.limit) c.inv[r - 1] = f;
      if (c.flags)
        over |= (uint32_t)(r > c.limit) << (8 * k);
      else
        c.map[f] = r <= c.limit ? r - 1 : MAP_OVER;
    }
    if (c.flags) reinterpret_cast<uint32_t*>(c.over)[u] = over;
  }
  for (int j = total + u; j < c.limit; j += c.ntiles * CT) c.inv[j] = c.S - 1;
  if (u == 0) c.n[0] = min(total, c.limit);
}

// --------------------------------------------------------------------------
// walk_init: a thread a lane
// --------------------------------------------------------------------------

__global__ void __launch_bounds__(WT) walk_init_kernel(
    const int32_t* __restrict__ pos4, const int32_t* __restrict__ len4,
    const int32_t* __restrict__ aiv4, const int32_t* __restrict__ row4,
    const int32_t* __restrict__ qs04, const int32_t* __restrict__ fiv,
    const int32_t* __restrict__ riv, const int32_t* __restrict__ iv_epos,
    const int32_t* __restrict__ iv_tids,
    const int32_t* __restrict__ trans_start,
    const int32_t* __restrict__ t2s_off, const int32_t* __restrict__ inv,
    const int32_t* __restrict__ n_act, uint8_t* __restrict__ act,
    uint8_t* __restrict__ p_live, uint8_t* __restrict__ over_tid,
    int32_t* __restrict__ ws, int32_t* __restrict__ slot,
    int32_t* __restrict__ lane, int32_t* __restrict__ prow,
    int32_t* __restrict__ events, int32_t* __restrict__ nev, int N, int WPP,
    int STW, int ST, int NIV, int NT, int EW, int band, int left_bits) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= WPP) return;
  const int f = inv[j];
  const int pos = pos4[f], len = len4[f], aiv = aiv4[f];
  const bool left = (left_bits >> (f / N)) & 1;
  const bool live = j < n_act[0];
  const int pn = f % N;
  const int32_t* tf = iv_tids + (size_t)clampi(fiv[pn], 0, NIV - 1) * ST;
  const int32_t* tr = iv_tids + (size_t)clampi(riv[pn], 0, NIV - 1) * ST;
  // the common tids in order: pack[k] = the tid slot of the (k + 1)-th
  int pack[STW_MAX];
#pragma unroll
  for (int k = 0; k < STW_MAX; ++k) pack[k] = ST;
  int n_tid = 0;
  if (ST <= ST_REG) {                   // both lists in registers
    int a[ST_REG], b[ST_REG];
#pragma unroll
    for (int t = 0; t < ST_REG; ++t) {
      a[t] = t < ST ? tf[t] : -1;
      b[t] = t < ST ? tr[t] : -1;
    }
#pragma unroll
    for (int t = 0; t < ST_REG; ++t) {
      bool memb = false;
#pragma unroll
      for (int u = 0; u < ST_REG; ++u) memb |= u < ST && b[u] == a[t];
      if (t < ST && live && a[t] >= 0 && memb) {
#pragma unroll
        for (int k = 0; k < STW_MAX; ++k)
          if (k == n_tid) pack[k] = t;
        ++n_tid;
      }
    }
  } else {
    for (int t = 0; t < ST; ++t) {
      const int tid = tf[t];
      bool memb = false;
      for (int u = 0; u < ST; ++u) memb |= tr[u] == tid;
      if (live && tid >= 0 && memb) {
#pragma unroll
        for (int k = 0; k < STW_MAX; ++k)
          if (k == n_tid) pack[k] = t;
        ++n_tid;
      }
    }
  }
  const bool over = live && n_tid > STW;
  const int anchor_rem = sub32(iv_epos[clampi(aiv, 0, NIV - 1)], pos);
  const size_t plane = (size_t)STW * WPP;
#pragma unroll
  for (int k = 0; k < STW_MAX; ++k) {
    if (k >= STW) continue;
    // a vacant slot takes tid slot ST - 1, as the plain clamp does
    const int tid = tf[clampi(pack[k], 0, ST - 1)];
    const bool a = pack[k] < ST && !over;
    const int tc = clampi(tid, 0, NT - 1);
    const int toff = t2s_off[tc];
    const size_t x = (size_t)k * WPP + j;
    act[x] = a;
    slot[SL_TSTART * plane + x] = trans_start[tc];
    slot[SL_TOFF * plane + x] = toff;
    slot[SL_TLEN * plane + x] = sub32(t2s_off[tc + 1], toff);
    int st[WS_NF];
#pragma unroll
    for (int q = 0; q < WS_NF; ++q) st[q] = 0;
    st[WS_I_ABS] = left ? aiv : add32(aiv, 1);
    st[WS_XPOS] = pos;
    st[WS_EXLEN] = left ? 0 : anchor_rem;
    st[WS_FIRST] = left;
    st[WS_STAT] = a ? WK_SCAN : WK_DONE;
    st[WS_REMREF] = add32(len, band);
#pragma unroll
    for (int q = 0; q < WS_NF; ++q) ws[q * plane + x] = st[q];
    nev[x] = 0;
    int32_t* ev = events + (size_t)k * EW * EV_NF * WPP + j;
    for (int e = 0; e < EW * EV_NF; ++e) ev[(size_t)e * WPP] = 0;
  }
  lane[LN_IS_LEFT * WPP + j] = left;
  lane[LN_QLEN * WPP + j] = len;
  lane[LN_POS * WPP + j] = pos;
  prow[PW_ROW * WPP + j] = row4[f];
  prow[PW_QS0 * WPP + j] = qs04[f];
  p_live[j] = live;
  over_tid[j] = over;
}

// --------------------------------------------------------------------------
// walk_pool: a warp a pool row (MID rows first, then END)
// --------------------------------------------------------------------------

// Then, a thread a (pool, slot, lane) over the grid, each follower takes
// its leader's code (final since walk_compact's second launch).
// MID: s = the query window of remq = min(exlen + band, qlen - cov) bases,
// t = the reference window of exlen; END: s = the reference window of rr,
// t = the query window of need = qlen - cov.  Right lanes read forward
// from qs0 + cov and pend_xpos; left lanes reversed, the query ending at
// qs0 + qlen - cov (MID) or qs0 + need (END), the reference at
// pend_xpos - 1.
__global__ void __launch_bounds__(WT) walk_pool_kernel(
    const int32_t* __restrict__ ws, const int32_t* __restrict__ lane,
    const int32_t* __restrict__ prow, const int8_t* __restrict__ seqsf,
    const int8_t* __restrict__ genome, int8_t* __restrict__ m_win,
    int32_t* __restrict__ m_rows, uint8_t* __restrict__ m_tiny,
    int8_t* __restrict__ e_win, int32_t* __restrict__ e_rows,
    int32_t* __restrict__ maps, int STW, int WPP, int RL, int G, int L,
    int band, int MIDP, int ENDP, int W) {
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int S = STW * WPP;
  for (int x = gid; x < 2 * S; x += gridDim.x * blockDim.x) {
    const int v = maps[x];
    if (v <= MAP_FOLLOW)
      maps[x] = maps[x - x % S + (MAP_FOLLOW - v) * WPP + x % S % WPP];
  }
  const int warp = gid >> 5;
  const int ln = threadIdx.x & 31;
  if (warp >= MIDP + ENDP) return;
  const bool mid = warp < MIDP;
  const int j = mid ? warp : warp - MIDP;
  const int P = mid ? MIDP : ENDP;
  int32_t* rows = mid ? m_rows : e_rows;
  const int f = rows[PR_INV * P + j];
  const int l = f % WPP;
  const size_t plane = (size_t)STW * WPP;
  const int xpos = ws[WS_PEND_XPOS * plane + f];
  const int cov = ws[WS_PEND_COV * plane + f];
  // the reference window's length: exlen (MID) or rr (END)
  const int rn = ws[(mid ? WS_PEND_EXLEN : WS_PEND_RR) * plane + f];
  const bool left = lane[LN_IS_LEFT * WPP + l] != 0;
  const int qlen = lane[LN_QLEN * WPP + l];
  const int base = mul32(prow[PW_ROW * WPP + l], L);
  const int qs0 = prow[PW_QS0 * WPP + l];
  const int need = sub32(qlen, cov);
  const int qn = mid ? min(add32(rn, band), need) : need;
  // column 0's query index and reference position
  int q0, r0;
  if (!left) {
    q0 = add32(base, add32(qs0, cov));
    r0 = xpos;
  } else {
    const int qend = mid ? sub32(add32(qs0, qlen), cov) : add32(qs0, qn);
    q0 = add32(base, sub32(qend, 1));
    r0 = sub32(xpos, 2);      // (xpos - rn - 1) + (rn - 1)
  }
  int8_t* ws_q = (mid ? m_win : e_win + (size_t)ENDP * W) + (size_t)j * W;
  int8_t* ws_r = (mid ? m_win + (size_t)MIDP * W : e_win) + (size_t)j * W;
  for (int io = ln; io < W; io += 32) {
    const int step = left ? -io : io;
    const int qi = add32(q0, step);
    ws_q[io] = io < qn ? seqsf[clampi(qi, 0, RL - 1)] : (int8_t)127;
    const int ri = add32(r0, step);
    ws_r[io] = (io < rn && ri >= 0 && ri < G) ? genome[ri] : (int8_t)127;
  }
  if (ln == 0) {
    rows[PR_N * P + j] = mid ? qn : rn;
    rows[PR_M * P + j] = mid ? rn : qn;
    if (mid) m_tiny[j] = qn <= 2 * band || rn <= band;
  }
}

// --------------------------------------------------------------------------
// walk_commit: a thread a (slot, lane)
// --------------------------------------------------------------------------

__global__ void __launch_bounds__(WT) walk_commit_kernel(
    const int32_t* __restrict__ ws, const int32_t* __restrict__ maps,
    const int32_t* __restrict__ md, const int32_t* __restrict__ xres,
    const int32_t* __restrict__ e_rows, const int32_t* __restrict__ lane,
    const int32_t* __restrict__ iv_spos, const int32_t* __restrict__ iv_epos,
    int32_t* __restrict__ events, int32_t* __restrict__ nev,
    int32_t* __restrict__ ws_out, int STW, int WPP, int EW, int MIDP,
    int ENDP, int NIV, int mat, int mis, int band, int max_ed, int max_sc) {
  const size_t plane = (size_t)STW * WPP;
  const size_t x = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= plane) return;
  const int t = (int)(x / WPP), l = (int)(x % WPP);
  int st[WS_NF];
#pragma unroll
  for (int q = 0; q < WS_NF; ++q) st[q] = ws[q * plane + x];
  const bool left = lane[LN_IS_LEFT * WPP + l] != 0;
  const int mm = maps[POOL_MID * plane + x];
  const int em = maps[POOL_END * plane + x];
  const int md_ed = mm >= 0 ? md[2 * mm] : 0;
  const int md_in = mm >= 0 ? md[2 * mm + 1] : 0;
  // the leader's end DP through _drop_wrap for this lane's side
  int e_ed = 0, e_scl = 0, e_ind = 0, e_scr = 0;
  if (em >= 0) {
    const int sc = xres[3 * em], on_s = xres[3 * em + 1];
    const int on_t = xres[3 * em + 2];
    const int m = e_rows[PR_M * ENDP + em];
    const int ed = floordiv(sub32(mul32(mat, max(on_s, on_t)), sc),
                            mat - mis);
    const bool ok = ed <= max_ed && (left || sc >= 0);
    e_ed = ok ? ed : add32(max_ed, 1);
    e_scl = ok ? sub32(m, on_t) : add32(max(m, max_sc), 1);
    e_ind = ok ? sub32(on_t, on_s) : add32(band, 1);
    e_scr = sc;
  }
  const int stat = st[WS_STAT];
  const bool mid_c = stat == WK_PMID && mm != MAP_OVER;
  const bool tr_c = stat == WK_PTRAIL && mm != MAP_OVER;
  const bool end_c = stat == WK_PEND && em != MAP_OVER;
  const bool endnd_c = stat == WK_PENDND;
  if (mid_c || tr_c || end_c || endnd_c) {
    int ev[EV_NF];
    ev[EV_KIND] = mid_c ? EVK_MID : tr_c ? EVK_TRAIL
                                         : end_c ? EVK_END : EVK_ENDND;
    ev[EV_XPOS] = st[WS_PEND_XPOS];
    ev[EV_AUX] = (end_c || endnd_c) ? st[WS_PEND_COV] : st[WS_PEND_EXLEN];
    ev[EV_ED] = end_c ? e_ed : endnd_c ? 0 : md_ed;
    ev[EV_INDEL] = end_c ? e_ind : endnd_c ? 0 : md_in;
    ev[EV_SCLEN] = end_c ? e_scl : 0;
    ev[EV_SCORE] = end_c ? e_scr : endnd_c ? 0 : sub32(0, md_ed);
    const int n = nev[x];
    int32_t* dst = events + ((size_t)t * EW + clampi(n, 0, EW - 1)) *
                                EV_NF * WPP + l;
#pragma unroll
    for (int q = 0; q < EV_NF; ++q) dst[(size_t)q * WPP] = ev[q];
    nev[x] = add32(n, 1);
  }
  if (mid_c) {
    // covered/remref advance + rescan positioning: right rspos =
    // iv_spos[pend] - 1, exlen = len(pend), i = pend + 1 (extend.py:
    // 421-428); left exlen = 0, i = pend - 1 (:545-547)
    const int pend = st[WS_PEND_IV];
    st[WS_COVERED] = add32(st[WS_COVERED], sub32(st[WS_PEND_EXLEN], md_in));
    st[WS_REMREF] = sub32(st[WS_REMREF], st[WS_PEND_EXLEN]);
    if (!left) {
      const int p = clampi(pend, 0, NIV - 1);
      st[WS_XPOS] = sub32(iv_spos[p], 1);
      st[WS_EXLEN] = add32(sub32(iv_epos[p], iv_spos[p]), 1);
      st[WS_I_ABS] = add32(pend, 1);
    } else {
      st[WS_EXLEN] = 0;
      st[WS_I_ABS] = sub32(pend, 1);
    }
    st[WS_STAT] = WK_SCAN;
  } else if (tr_c || end_c || endnd_c) {
    st[WS_STAT] = WK_DONE;
  }
#pragma unroll
  for (int q = 0; q < WS_NF; ++q) ws_out[q * plane + x] = st[q];
}

__global__ void wave_empty_kernel(int) {}

unsigned blocks(long long threads, int nt) {
  return (unsigned)((threads + nt - 1) / nt);
}

}  // namespace

// Each entry point launches its kernels on the given stream and returns
// the first non-zero cudaGetLastError() (0 when every launch was
// accepted).  CM_WAVE_LAUNCH is the only launch site, so a host emulation
// can replace it.
#define CM_WAVE_LAUNCH(KERNEL, grid, nt, stream, ...)                  \
  (KERNEL<<<grid, nt, 0, stream>>>(__VA_ARGS__), (int)cudaGetLastError())

// walk_init's lane compaction reads its byte flags a word at a time.
extern "C" int cm_walk_init(
    const void* act4, const void* pos4, const void* len4, const void* aiv4,
    const void* row4, const void* qs04, const void* fiv, const void* riv,
    const void* iv_epos, const void* iv_tids, const void* trans_start,
    const void* t2s_off, void* inv, void* n_act, void* over, void* act,
    void* p_live, void* over_tid, void* ws, void* slot, void* lane,
    void* prow, void* events, void* nev, void* tiles, int N, int WPP,
    int STW, int ST, int NIV, int NT, int EW, int band, int left_bits,
    void* stream) {
  if (STW > STW_MAX || STW > ST || N <= 0 || WPP <= 0)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)act4 % 4 != 0) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = (cudaStream_t)stream;
  const int nt = (N + CT - 1) / CT;       // N words of four flags
  const Compact c{(const uint8_t*)act4, nullptr, 0, 0, 0, 4 * N, WPP, nt,
                  (int32_t*)inv, (int32_t*)n_act, (uint8_t*)over, nullptr,
                  (int32_t*)tiles};
  Compact none = c;
  none.ntiles = 0;
  for (int phase = 0; phase < 2; ++phase) {
    const int err = CM_WAVE_LAUNCH(walk_compact_kernel, nt, CT, s, c, none,
                                   phase);
    if (err != 0) return err;
  }
  return CM_WAVE_LAUNCH(
      walk_init_kernel, blocks(WPP, IT), IT, s, (const int32_t*)pos4,
      (const int32_t*)len4, (const int32_t*)aiv4, (const int32_t*)row4,
      (const int32_t*)qs04, (const int32_t*)fiv, (const int32_t*)riv,
      (const int32_t*)iv_epos, (const int32_t*)iv_tids,
      (const int32_t*)trans_start, (const int32_t*)t2s_off,
      (const int32_t*)inv, (const int32_t*)n_act, (uint8_t*)act,
      (uint8_t*)p_live, (uint8_t*)over_tid, (int32_t*)ws, (int32_t*)slot,
      (int32_t*)lane, (int32_t*)prow, (int32_t*)events, (int32_t*)nev, N,
      WPP, STW, ST, NIV, NT, EW, band, left_bits);
}

extern "C" int cm_walk_pool(const void* ws, const void* lane,
                            const void* prow, const void* seqsf,
                            const void* genome, void* m_win, void* m_rows,
                            void* m_tiny, void* e_win, void* e_rows, void* n,
                            void* maps, void* tiles, int STW, int WPP,
                            int RL, int G, int L, int band, int MIDP,
                            int ENDP, int W, void* stream) {
  if (STW > STW_MAX || STW <= 0 || WPP <= 0 || MIDP <= 0 || ENDP <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int S = STW * WPP, nt = (S + CT - 1) / CT;
  const Compact cm{nullptr, (const int32_t*)ws, POOL_MID, STW, WPP, S, MIDP,
                   nt, (int32_t*)m_rows + PR_INV * MIDP, (int32_t*)n,
                   nullptr, (int32_t*)maps, (int32_t*)tiles};
  const Compact ce{nullptr, (const int32_t*)ws, POOL_END, STW, WPP, S, ENDP,
                   nt, (int32_t*)e_rows + PR_INV * ENDP, (int32_t*)n + 1,
                   nullptr, (int32_t*)maps + S, (int32_t*)tiles + nt};
  for (int phase = 0; phase < 2; ++phase) {
    const int err = CM_WAVE_LAUNCH(walk_compact_kernel, 2 * nt, CT, s, cm,
                                   ce, phase);
    if (err != 0) return err;
  }
  return CM_WAVE_LAUNCH(
      walk_pool_kernel, blocks((long long)(MIDP + ENDP) * 32, WT), WT, s,
      (const int32_t*)ws, (const int32_t*)lane, (const int32_t*)prow,
      (const int8_t*)seqsf, (const int8_t*)genome, (int8_t*)m_win,
      (int32_t*)m_rows, (uint8_t*)m_tiny, (int8_t*)e_win, (int32_t*)e_rows,
      (int32_t*)maps, STW, WPP, RL, G, L, band, MIDP, ENDP, W);
}

extern "C" int cm_walk_commit(const void* ws, const void* maps,
                              const void* md, const void* xres,
                              const void* e_rows, const void* lane,
                              const void* iv_spos, const void* iv_epos,
                              void* events, void* nev, void* ws_out, int STW,
                              int WPP, int EW, int MIDP, int ENDP, int NIV,
                              int mat, int mis, int band, int max_ed,
                              int max_sc, void* stream) {
  if (mat - mis <= 0 || EW <= 0 || NIV <= 0)
    return (int)cudaErrorInvalidValue;
  return CM_WAVE_LAUNCH(
      walk_commit_kernel, blocks((long long)STW * WPP, WT), WT,
      (cudaStream_t)stream, (const int32_t*)ws, (const int32_t*)maps,
      (const int32_t*)md, (const int32_t*)xres, (const int32_t*)e_rows,
      (const int32_t*)lane, (const int32_t*)iv_spos, (const int32_t*)iv_epos,
      (int32_t*)events, (int32_t*)nev, (int32_t*)ws_out, STW, WPP, EW, MIDP,
      ENDP, NIV, mat, mis, band, max_ed, max_sc);
}

// An empty kernel on each grid that an entry point (a WaveKernel) launches
// for units compaction units (walk_init: N words of flags, walk_pool: STW *
// WPP slots) and rows (walk_init: WPP lanes, walk_pool: MIDP + ENDP pool
// rows, walk_commit: STW * WPP slots): the launch floor under its device
// time.  Returns the number of grids launched, or -1 if a launch failed.
// Not counted as a launch.
extern "C" int cm_wave_empty(int kernel, int units, int rows, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (kernel == WAVE_COMMIT)
    return CM_WAVE_LAUNCH(wave_empty_kernel, blocks(rows, WT), WT, s, 0)
               ? -1 : 1;
  const int nt = (units + CT - 1) / CT * (kernel == WAVE_POOL ? 2 : 1);
  int err = 0;
  for (int phase = 0; phase < 2; ++phase)
    err |= CM_WAVE_LAUNCH(wave_empty_kernel, nt, CT, s, 0);
  err |= kernel == WAVE_INIT
             ? CM_WAVE_LAUNCH(wave_empty_kernel, blocks(rows, IT), IT, s, 0)
             : CM_WAVE_LAUNCH(wave_empty_kernel, blocks(32LL * rows, WT), WT,
                              s, 0);
  return err ? -1 : 3;
}
