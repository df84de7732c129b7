// Seed-chain transition DP, hand-written for Hopper (sm_90a).
//
//   cm_chain_dp  replaces circminer_tpu/ops/chain.py::_chain_dp_core_lanes
//                (:251; one XLA fusion region of the reference's jitted
//                step, a Pallas kernel until round 4): per row, the seed
//                lists l = NL-2 .. 0 of S cells each take their best
//                transition into any cell of a later list j > l
//                (chain.cpp:73-301, with the gap, maxIntron and junction
//                gates of chain.cpp:28-64) and keep the first maximum as
//                the backpointer.  Its plain version is
//                ops/chain_device.py::_chain_dp_core_lanes, fed the tables
//                of ops/chain_device.py::_junction_tables.
//
// Interface.  The cells come as the row-major [b, M] tensors of
// _chain_cells (M = NL * S), each with ol_iv, its exon interval or -1.  A
// cell's junction segments are read by interval from the annotation's own
// tables: segment p < iv_nseg[ol_iv] at seg_end / seg_next[ol_iv * P + p],
// exactly the pv / sep / snp the reference's prelude gathers into [b, M,
// P] tables; those tables are never built on the card.
//
// Layout.  A row is served by T threads, thread x on cells x, x + T, ...
// of the list being worked: T = S at S <= 32, so that a warp holds 32 / S
// whole rows and the lists of a row need only the warp's own barriers;
// above, T = 32 W with W = ceil(S / 32) warps a row (at most NW_MAX), one
// row a block, whose lists are separated by block barriers.  A row's
// positions, scores and valid bits, its lists' query offsets and first
// maxima sit in shared memory, RW words a row with RW = S (mod 32), so
// that word x of row wr falls in bank wr S + x (mod 32): where lane t of
// each row reads word x + t of its row (its own cell, or target t) the
// warp's lanes meet 32 distinct banks, and where the lanes of a row read
// one word, the rows meet distinct banks.  At S <= 32 a block holds up
// to NW_ROW warps, fewer where their rows outgrow shared memory.  The
// kernel is one body, a template on WIDE = S > 32, so that at S <= 32 a
// thread's single cell and the warp barrier are fixed at compile time (at
// run time they cost chr21's launch 31%, PERF.md).
//
// Per list l from NL - 2 down: a cell whose valid bit is clear has only
// NEG-scored transitions, and NEG + a later score is exact (every score
// is >= NEG), so its thread sets it alone: NEG + the first maximum of the
// later lists' scores, one running maximum per row.  Then each warp's
// valid cells are walked one after another by the G = min(S, 32) lanes
// of their row in that warp, lane t on targets t, t + G, ... of each
// later list j: the maxIntron minimum over list j, reduced over those
// lanes; if that gate is closed NEG + list j's first maximum, else the
// gates, the junction scan and a running first maximum per lane, reduced
// over the lanes on (value descending, flat index j S + t ascending).  A
// cell's bounds are fetched one cell ahead by its own thread and passed
// by shuffles; its interval's segments are copied by the lanes into
// their shared words (2 P | 1 per G lanes), one round of loads.  Then
// list l's first maximum per row (over the row's warps through shared
// memory where W > 1) goes to the row's words and into the running
// maximum; a barrier separates the lists (list l - 1 reads list l's
// scores).

// What bounds it.  Its bytes: the [b, M] positions, valid bits and
// outputs, and for a valid source cell its three bounds, ol_iv and the
// segments of its interval (~19.5 MB at chr21's 16,384 rows, NL = 6, S =
// P = 16).  At chr21 few cells are valid (2.4%), and an invalid cell
// costs a few operations instead of a walk over every later target; what
// is left is latency: a row's lists one after another, a valid cell's
// bounds and segments fetched from memory, its walk reduced across lanes.
// Every lane of a warp is on a cell or a target and no block barrier is
// needed, so many independent warps hide it.  At gpu-chain's S = 128 and
// 500 buckets a row takes 4 and 16 warps and a block barrier a list; each
// warp walks its own 32 cells' valid ones; no read in the repo fills
// those buckets yet (PERF.md).

// Parity.  Every value is int32 with the reference's two's-complement
// wrap-around, composed in uint32 (wadd, wsub, wabs: |INT_MIN| = INT_MIN as
// in torch and XLA).  The first maximum is the reference's three rules: the
// smallest t among equal candidates of a list, the earliest list j among
// equal list maxima, and the cell's own score kept on a tie; a running
// strict ">" over (j, t) in order per lane, and across lanes the largest
// value with the smallest flat index.

#include <cuda_runtime.h>
#include <stdint.h>

extern __shared__ __align__(16) unsigned char cm_chain_smem[];

namespace {

constexpr int NEG = -(1 << 29);       // ops/chain_device.py _NEG
constexpr int I32MAX = 0x7fffffff;
constexpr int I32MIN = -I32MAX - 1;
constexpr int NW_ROW = 8;             // warps a block, at most, S <= 32
constexpr int NW_MAX = 16;            // warps a row, at most, S > 32
constexpr int SMEM_MAX = 232448;      // dynamic shared memory of one block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wabs(int a) {
  return a < 0 ? (int)(0u - (unsigned)a) : a;
}

// Lanes of a row in one warp: G = min(S, 32); warps of a row: W.
__host__ __device__ inline int row_lanes(int S) { return S < 32 ? S : 32; }
__host__ __device__ inline int row_warps(int S) {
  return S <= 32 ? 1 : ((S + 31) / 32 < NW_MAX ? (S + 31) / 32 : NW_MAX);
}

// Words of one row: positions, scores and valid bits (int32 [M] each),
// query offsets and first maxima (int32 [NL] x 3), padded to RW = S
// (mod 32), so that row wr's word x falls in bank wr S + x (mod 32): a
// warp's rows in distinct banks, and its lanes too where each reads its
// own cell.
__host__ __device__ inline int row_words(int NL, int S) {
  const int base = 3 * NL * S + 3 * NL;
  return base + ((S - base) % 32 + 32) % 32;
}

// Shared-memory bytes of a block of nw warps: its rows, each walking
// group's copy of its cell's segments (int32 [2 P | 1]), and where W > 1
// each warp's list maximum (int32 [2]).
inline size_t block_bytes(int NL, int S, int P, int nw) {
  const int W = row_warps(S), rows = W > 1 ? 1 : nw * (32 / S);
  return 4 * ((size_t)rows * row_words(NL, S)
              + (size_t)nw * (32 / row_lanes(S)) * ((2 * P) | 1)
              + (W > 1 ? 2 * (size_t)W : 0));
}

// One segment of the junction scan (chain.cpp:28-64) for a segment whose
// pv_e (pv and e12end >= 0) holds: accept (the first accepting segment
// sets the distance), or note an intron that the read skips.
__device__ __forceinline__ void junction_step(int e12end, int snp, int pjv,
                                              int rd, int k, int max_ed,
                                              bool& ok, int& dist,
                                              bool& intron) {
  const int beg = wsub(pjv, snp);
  const int td = wadd(e12end, beg);
  if (beg >= 0 && wabs(wsub(td, rd)) <= max_ed) {
    ok = true;
    dist = td;
  } else if (e12end < rd && wadd(beg, k) < 0) {
    intron = true;
  }
}

// One row as a walk sees it: its cells' positions, scores and valid
// bits, its lists' first maxima (lmv, lmi) and query offsets (qp).
struct Row {
  const int32_t *pos, *dp, *val, *lmv, *lmi, *qp;
};

// A valid cell's segments: e12end and snp of segment q < nseg at e12[q]
// and e12[P + q], a copy in shared memory that its lanes made before the
// walk.
struct Segs {
  const int32_t* e12;
  int nseg, P;
};

// The walk of a valid cell of list l, with position pi, by the G lanes
// of `group` (lane t0 of them), over the targets t = t0, t0 + G, ... of
// each later list: this lane's running first maximum (best_v, best_i),
// strict ">" in (j, t) order.  The maxIntron minimum is reduced over the
// group, so the lists' gates are uniform in it.
__device__ __forceinline__ void walk(const Row& w, int l, int S, int NL,
                                     int t0, int G, unsigned group, int pi,
                                     int ub_l, int mee_l, int e1_l,
                                     const Segs& sg, int k, int max_ed,
                                     int max_intron, int& best_v,
                                     int& best_i) {
  const int alpha10 = (int)(200000u * (unsigned)k);
  const int qp_l = w.qp[l];
  for (int j = l + 1; j < NL; ++j) {
    const int rd = wsub(wsub(w.qp[j], qp_l), k);
    const int col = j * S;
    // the maxIntron rule (chain.cpp:148-150): the nearest target beyond
    // pi, over every cell of list j
    int minpos = I32MAX;
#pragma unroll 4
    for (int t = t0; t < S; t += G) {
      const int x = w.pos[col + t];
      if (x > pi && x < minpos) minpos = x;
    }
    minpos = __reduce_min_sync(group, minpos);
    if (minpos > wadd(pi, max_intron)) {
      // every candidate of list j is NEG + a score: its first maximum
      if (t0 == 0) {
        const int cand = wadd(NEG, w.lmv[j]);
        if (cand > best_v) {
          best_v = cand;
          best_i = w.lmi[j];
        }
      }
      continue;
    }
#pragma unroll 4
    for (int t = t0; t < S; t += G) {
      const int at = col + t;
      const int pjv = w.pos[at];
      int sc = NEG;
      if (w.val[at] && pjv > pi && pjv <= ub_l) {
        const int gd = wsub(wsub(pjv, pi), k);
        const bool g_ok = (mee_l == 0 || wadd(pjv, k - 1) <= mee_l)
            && wabs(wsub(gd, rd)) <= max_ed;
        if (g_ok) {
          sc = wsub(alpha10, wabs(wsub(gd, rd)));
        } else if (pjv > e1_l) {
          bool jn_ok = false, intron = false;
          int jn_dist = 0;
          for (int q = 0; q < sg.nseg && !jn_ok; ++q) {
            const int e12 = sg.e12[q];
            if (e12 >= 0)
              junction_step(e12, sg.e12[sg.P + q], pjv, rd, k, max_ed, jn_ok,
                            jn_dist, intron);
          }
          if (jn_ok || intron)
            sc = wsub(alpha10, wabs(wsub(
                jn_ok ? jn_dist : wsub(wsub(pjv, e1_l), 1), rd)));
        }
      }
      const int cand = wadd(sc, w.dp[at]);
      if (cand > best_v) {
        best_v = cand;
        best_i = at;
      }
    }
  }
}

// posf, qposf, ub, mee, e1, ol_iv: int32 [b, M]; validf: uint8 [b, M];
// iv_nseg: int32 [n_iv]; seg_end, seg_next: int32 [n_iv, P]; dp, back:
// int32 [b, NL, S].  WIDE = S > 32: one row a block of W warps; else
// 32 / S rows a warp, blockDim.x / 32 warps a block, one cell a thread.
template <bool WIDE>
__global__ void __launch_bounds__(WIDE ? NW_MAX * 32 : NW_ROW * 32)
    chain_dp_kernel(
    const int32_t* __restrict__ posf, const int32_t* __restrict__ qposf,
    const uint8_t* __restrict__ validf, const int32_t* __restrict__ ub,
    const int32_t* __restrict__ mee, const int32_t* __restrict__ e1,
    const int32_t* __restrict__ ol_iv, const int32_t* __restrict__ iv_nseg,
    const int32_t* __restrict__ seg_end,
    const int32_t* __restrict__ seg_next, int32_t* __restrict__ dp,
    int32_t* __restrict__ back, int b, int NL, int S, int P, int k,
    int max_ed, int max_intron) {
  const int M = NL * S, RW = row_words(NL, S), G = WIDE ? 32 : S;
  const int W = WIDE ? row_warps(S) : 1, T = W * G;
  const int chunks = WIDE ? (S + T - 1) / T : 1;   // cells a thread
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rpw = 32 / G, nw = blockDim.x >> 5;
  const int wr = lane / G, i = lane - wr * G;
  // this thread's first cell of a list, its row's slot in the block, its
  // walking group (the G lanes of its row in this warp)
  const int xi = WIDE ? warp * 32 + i : i;
  const int slot = WIDE ? 0 : warp * rpw + wr, wg = warp * rpw + wr;
  const int64_t row = WIDE ? (int64_t)blockIdx.x
                           : (int64_t)blockIdx.x * nw * rpw + slot;
  const bool live = wr < rpw && row < b;
  int32_t* rs = reinterpret_cast<int32_t*>(cm_chain_smem) + slot * RW;
  int32_t *pos = rs, *dpr = rs + M, *val = rs + 2 * M;
  int32_t *qp = rs + 3 * M, *lmv = qp + NL, *lmi = lmv + NL;
  const int rows = WIDE ? 1 : nw * rpw;
  int32_t* seg_s = reinterpret_cast<int32_t*>(cm_chain_smem) + rows * RW
      + wg * ((2 * P) | 1);
  // each warp's list maximum (v, idx) where WIDE
  int32_t* red = reinterpret_cast<int32_t*>(cm_chain_smem) + rows * RW
      + nw * rpw * ((2 * P) | 1);
  const int64_t g0 = row * M;
  if (live) {
#pragma unroll 4
    for (int c = xi; c < M; c += T) {
      const bool v = validf[g0 + c] != 0;
      pos[c] = posf[g0 + c];
      val[c] = v;
      dpr[c] = v ? 10 * k : NEG;
    }
    for (int j = xi; j < NL; j += T) qp[j] = qposf[g0 + (int64_t)j * S];
    for (int t = xi; t < S; t += T) back[g0 + (NL - 1) * S + t] = -1;
  }
  if (WIDE)
    __syncthreads();
  else
    __syncwarp();
  // the G lanes of a row in this warp (the idle lanes form one group)
  const unsigned group = wr < rpw
      ? (G == 32 ? FULL : ((1u << G) - 1u) << (wr * G))
      : FULL << ((rpw * G) & 31);
  // the bounds of this thread's cell t2 of list l2, if valid: fetched one
  // cell ahead
  int n_ub = 0, n_mee = 0, n_e1 = 0, n_iv = -1;
  auto fetch = [&](int l2, int t2) {
    if (live && l2 >= 0 && t2 < S && val[l2 * S + t2]) {
      const int64_t g = g0 + l2 * S + t2;
      n_ub = ub[g];
      n_mee = mee[g];
      n_e1 = e1[g];
      n_iv = ol_iv[g];
    }
  };
  fetch(NL - 2, xi);
  const Row w{pos, dpr, val, lmv, lmi, qp};
  int sm_v = I32MIN, sm_i = -1;
  for (int l = NL - 1; l >= 0; --l) {
    int mine = I32MIN, mine_i = I32MAX;   // over this thread's cells
    for (int ch = 0; ch < chunks; ++ch) {
      const int x = xi + ch * T, c = l * S + x;
      const bool here = live && x < S;
      int cur = here ? dpr[c] : I32MIN;   // this cell's final score
      if (l < NL - 1) {
        const int c_ub = n_ub, c_mee = n_mee, c_e1 = n_e1, c_iv = n_iv;
        if (ch + 1 < chunks)
          fetch(l, x + T);
        else
          fetch(l - 1, xi);
        const bool valid = here && val[c];
        if (here && !valid) {
          const int cand = wadd(NEG, sm_v);   // no wrap: sm_v >= NEG
          const bool improve = cand > NEG;
          if (improve) {
            cur = cand;
            dpr[c] = cand;
          }
          back[g0 + c] = improve ? sm_i : -1;
        }
        // the group's valid cells, one after another, each walked by the
        // group's lanes, lane t on targets t, t + G, ... of every later
        // list
        for (unsigned vm = __ballot_sync(group, valid); vm; vm &= vm - 1u) {
          const int src = __ffs(vm) - 1;
          const int cv = c + (src - lane);   // the cell of lane src
          const int v_ub = __shfl_sync(group, c_ub, src);
          const int v_mee = __shfl_sync(group, c_mee, src);
          const int v_e1 = __shfl_sync(group, c_e1, src);
          const int v_iv = __shfl_sync(group, c_iv, src);
          __syncwarp(group);         // the last cell's readers are done
          if (v_iv >= 0)
            for (int q = i; q < P; q += G) {
              seg_s[q] = wsub(seg_end[(int64_t)v_iv * P + q], v_e1);
              seg_s[P + q] = seg_next[(int64_t)v_iv * P + q];
            }
          const Segs sg{seg_s, v_iv >= 0 ? min(iv_nseg[v_iv], P) : 0, P};
          __syncwarp(group);
          int best_v = NEG, best_i = -1;
          walk(w, l, S, NL, i, G, group, pos[cv], v_ub, v_mee, v_e1, sg, k,
               max_ed, max_intron, best_v, best_i);
          const int mv = __reduce_max_sync(group, best_v);
          const int mi = __reduce_min_sync(group,
                                           best_v == mv ? best_i : I32MAX);
          if (lane == src) {
            const bool improve = mv > cur;
            if (improve) {
              cur = mv;
              dpr[c] = mv;
            }
            back[g0 + c] = improve ? mi : -1;
          }
        }
      }
      if (cur > mine) {
        mine = cur;
        mine_i = c;
      }
    }
    // list l's first maximum over the row's lanes; every thread takes it
    int v = __reduce_max_sync(group, mine);
    int idx = __reduce_min_sync(group, mine == v ? mine_i : I32MAX);
    if (WIDE) {
      // over the row's warps: the largest value, the smallest index
      if (lane == 0) {
        red[2 * warp] = v;
        red[2 * warp + 1] = idx;
      }
      __syncthreads();
      v = red[0];
      idx = red[1];
      for (int q = 1; q < W; ++q)
        if (red[2 * q] > v || (red[2 * q] == v && red[2 * q + 1] < idx)) {
          v = red[2 * q];
          idx = red[2 * q + 1];
        }
    }
    if (live && xi == 0) {
      lmv[l] = v;
      lmi[l] = idx;
    }
    if (v >= sm_v) {
      sm_v = v;
      sm_i = idx;
    }
    if (WIDE)
      __syncthreads();
    else
      __syncwarp();
  }
  if (live)
    for (int c = xi; c < M; c += T) dp[g0 + c] = dpr[c];
}

// A kernel over b rows with `smem` bytes of dynamic shared memory; the
// launch's cudaGetLastError().
#define CM_CHAIN_LAUNCH(KERNEL, grid, nt, smem, stream, ...)             \
  (KERNEL<<<grid, nt, smem, stream>>>(__VA_ARGS__), (int)cudaGetLastError())

}  // namespace

// Plain C interface (loaded with ctypes).  Returns cudaGetLastError()
// right after the launch (0 and no launch for an empty batch;
// cudaErrorInvalidValue and no launch where a row outgrows a block's
// shared memory).
extern "C" int cm_chain_dp(const void* posf, const void* qposf,
                           const void* validf, const void* ub,
                           const void* mee, const void* e1,
                           const void* ol_iv, const void* iv_nseg,
                           const void* seg_end, const void* seg_next,
                           void* dp, void* back, int b, int NL, int S, int P,
                           int k, int max_ed, int max_intron, void* stream) {
  if (b <= 0 || NL <= 0 || S <= 0) return 0;
  // S <= 32: as many warps (up to NW_ROW) as shared memory holds; above,
  // one row of W warps a block
  const int W = row_warps(S);
  int nw = W;
  if (W == 1)
    while (nw < NW_ROW && block_bytes(NL, S, P, nw + 1) <= (size_t)SMEM_MAX)
      ++nw;
  const size_t smem = block_bytes(NL, S, P, nw);
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int rows = W > 1 ? 1 : nw * (32 / S);
  // the opt-in above 48 KB of dynamic shared memory, once
  static bool opted[2] = {false, false};
  if (smem > 48 * 1024 && !opted[W > 1]) {
    const cudaError_t e = cudaFuncSetAttribute(
        W > 1 ? chain_dp_kernel<true> : chain_dp_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    opted[W > 1] = true;
  }
#define CM_CHAIN_ARGS                                                      \
  (const int32_t*)posf, (const int32_t*)qposf, (const uint8_t*)validf,   \
      (const int32_t*)ub, (const int32_t*)mee, (const int32_t*)e1,       \
      (const int32_t*)ol_iv, (const int32_t*)iv_nseg,                    \
      (const int32_t*)seg_end, (const int32_t*)seg_next, (int32_t*)dp,   \
      (int32_t*)back, b, NL, S, P, k, max_ed, max_intron
  const int grid = (b + rows - 1) / rows;
  const cudaStream_t st = (cudaStream_t)stream;
  if (W > 1)
    return CM_CHAIN_LAUNCH(chain_dp_kernel<true>, grid, nw * 32, smem, st,
                           CM_CHAIN_ARGS);
  return CM_CHAIN_LAUNCH(chain_dp_kernel<false>, grid, nw * 32, smem, st,
                         CM_CHAIN_ARGS);
#undef CM_CHAIN_ARGS
}
