// Banded alignment DPs of the wave extension engine, hand-written for
// Hopper (sm_90a).  Four kernels, one per DP family of the reference's
// fused wave dispatch (circminer_tpu/ops/align_device.py wave_all_batch_ref):
//
//   cm_xdrop     replaces ops/pallas_align.py::_xdrop_kernel (Pallas) and its
//                scan twin xdrop_scan_ref: X-drop anti-diagonal score DP,
//                global_banded_alignment_drop (reference align.cpp:254-390).
//   cm_edit_sc   replaces ops/pallas_align.py::_edit_sc_kernel (Pallas) and
//                edit_sc_scan_ref: banded edit DP + online soft-clip argmax
//                (align.cpp:602-667).
//   cm_edit_end  replaces ops/align_device.py::edit_end_scan_ref: banded edit
//                DP, best candidate on column j == m (align.cpp:556-576).
//   cm_one_side  replaces ops/align_device.py::one_side_scan_ref: one-sided
//                band with a per-item width (align.cpp:219-252).
//
// Two layouts.
//
// xdrop and edit_end are band-local (the section "Band-local kernels"
// below).  A diagonal keeps only the window of w + 2 slots that can hold a
// value other than NEG / POS: the band |i - j| <= w (edit_end), or the live
// X-drop band [lb, ub] with one slot below it and the boundary cells of the
// first w diagonals (xdrop).  G lanes of NC cells serve one item, G * NC >=
// w + 2 (band_layout: G = 1 up to w = 6, so at the default w = 3 every lane
// is its own item and a diagonal needs no shuffle at all; G up to 32 for
// w up to 254).  The window start moves by 0 or 1 per diagonal, so the
// neighbours are fixed slots after one predicated shift per diagonal, and
// the block's s and t rows are staged once into shared memory with 16-byte
// loads of its contiguous span.  Each item's loop ends at min(2I - 1, n + m)
// or at X-drop's dead band; a warp leaves when all its items are done.
//
// edit_sc and one_side keep the first layout: one warp per item, lane l
// holding cells i = 4l .. 4l+3 of the whole I = 128 extent, the i-1
// neighbour of a lane's first cell by __shfl_up_sync, per-diagonal
// maxima/argmaxima by full-warp shuffle reductions.
//
// What bounds them.  Not bytes (the whole B = 1024 input is 260 KB) nor the
// card's ALU throughput (~0.3 M band cells at B = 1024), but the n + m
// anti-diagonals of the longest item in a warp, one after the other, times
// the cost of one diagonal for that warp.  In the warp-per-item layout that
// cost is two neighbour shuffles and a 5-step shuffle reduction (two for
// X-drop, one of them 64-bit) per diagonal, with ~97% of the lanes on
// masked cells at w = 3.  In the band-local layout at G = 1 there is no
// shuffle and no branch in a diagonal (the lanes of a warp are different
// items, so every update is a select): a diagonal is ~130 (xdrop) or ~80
// (edit_end) integer instructions, and a warp scheduler has 16 INT32 lanes,
// so each takes two cycles to dispatch.  That dispatch time, not the ~12-op
// dependent chain of a diagonal, is what the kernels now wait on; it does
// not shrink with more items (B = 1024 fills 16 SMs, B = 8192 128), only
// with fewer instructions per diagonal.
//
// Parity.  Everything is int32, bit-equal to the reference (x64 is off
// there): packed keys are composed in uint32 so that wrap-around matches
// the reference's int32 shifts, and (k - w) parity is taken only for k > w.
// Cells with i = 0 or j <= 0 never read the (wrapped) neighbours the
// reference's roll formulation gives them: they are boundary cells or out of
// band in every family, so their neighbour values are don't-care.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int I = 128;   // DP extent: cells i = 0 .. I-1 of a diagonal
constexpr int CPT = 4;   // cells per lane (warp-per-item layout)
constexpr int WPB = 4;   // warps (items) per block (warp-per-item layout)
constexpr int NEG = -10000000;
constexpr int POS = 10000000;
constexpr unsigned FULL = 0xffffffffu;
constexpr long long PK_MIN = -0x7fffffffffffffffLL - 1;

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ long long warp_max64(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    long long u = __shfl_xor_sync(FULL, v, o);
    v = u > v ? u : v;
  }
  return v;
}

// (value, low) packed so that a signed 64-bit max orders by value first.
__device__ __forceinline__ long long pack(int value, int low) {
  return (long long)value * 4294967296LL + (long long)low;
}
__device__ __forceinline__ int pk_value(long long p) { return (int)(p >> 32); }
__device__ __forceinline__ int pk_low(long long p) {
  return (int)(p & 0xffffffffLL);
}

// One warp's item: lengths, s[i-1] per cell, and the t row in shared memory.
struct Pair {
  int n, m, lane;
  int sv[CPT];
  const int8_t* tsh;
};

__device__ __forceinline__ void load_pair(Pair& p, const int8_t* s,
                                          const int8_t* t, const int32_t* n,
                                          const int32_t* m, int b, int L,
                                          int8_t* tsh) {
  p.lane = threadIdx.x & 31;
  p.n = n[b];
  p.m = m[b];
  const int8_t* srow = s + (size_t)b * L;
  const int8_t* trow = t + (size_t)b * L;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    int i = CPT * p.lane + c;
    int x = i - 1;  // rows are zero padded to I, as in the reference
    p.sv[c] = (x >= 0 && x < L) ? (int)srow[x] : 0;
    tsh[i] = i < L ? trow[i] : (int8_t)0;
  }
  __syncwarp();
  p.tsh = tsh;
}

// Cell (i, j = k - i) compares s[i-1] with t[j-1]; bases >= 4 (N) always
// mismatch.
__device__ __forceinline__ int mismatch(const Pair& p, int c, int i, int k) {
  int x = k - i - 1;
  int tv = (x >= 0 && x < I) ? (int)p.tsh[x] : 0;
  int sv = p.sv[c];
  return (sv != tv) | (sv >= 4) | (tv >= 4);
}

// dm1[c] = d at cell i - 1.
__device__ __forceinline__ void shift_up(const int (&d)[CPT],
                                         int (&dm1)[CPT]) {
  dm1[0] = __shfl_up_sync(FULL, d[CPT - 1], 1);
#pragma unroll
  for (int c = 1; c < CPT; ++c) dm1[c] = d[c - 1];
}

// Banded edit DP (|i - j| <= w) of diagonal k from diagonals k-2, k-1.
__device__ __forceinline__ void edit_step(const Pair& p, int k, int w,
                                          const int (&d2)[CPT],
                                          const int (&d1)[CPT],
                                          int (&dp)[CPT]) {
  int d2m[CPT], d1m[CPT];
  shift_up(d2, d2m);
  shift_up(d1, d1m);
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    int i = CPT * p.lane + c, j = k - i;
    int v = min(d2m[c] + mismatch(p, c, i, k), min(d1m[c] + 1, d1[c] + 1));
    if (j == 0 && i <= w) v = i;
    if (i == 0 && j <= w && j >= 0) v = j;
    bool valid = i <= p.n && j >= 0 && j <= p.m && abs(i - j) <= w;
    dp[c] = valid ? v : POS;
  }
}

__device__ __forceinline__ void roll_diags(int (&d2)[CPT], int (&d1)[CPT],
                                           const int (&dp)[CPT]) {
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    d2[c] = d1[c];
    d1[c] = dp[c];
  }
}

// AlignCandid preference key (pallas_align.py _edit_candidate_key): score
// desc, ed asc, |indel| asc, j desc, i asc; 0 = no candidate.
__device__ __forceinline__ int edit_key(int dp, int i, int k, int n, int m,
                                        int w, int max_ed, int max_sclen) {
  int j = k - i;
  int sclen = m - j, indel = j - i, score = m - sclen - 2 * dp;
  bool ok = dp <= max_ed && sclen >= 0 && sclen <= max_sclen &&
            j >= m - max_sclen && j >= 0 && j <= m && i >= 0 && i <= n &&
            abs(i - j) <= w;
  if (!ok) return 0;
  unsigned key = ((unsigned)(score + 512) << 21) |
                 ((unsigned)(31 - dp) << 16) |
                 ((unsigned)(15 - abs(indel)) << 12) | ((unsigned)j << 5) |
                 (unsigned)(31 - min(i, 31));
  return (int)key;
}

// Strict-better update with the diagonal's best key (first i on ties).
__device__ __forceinline__ void edit_sc_take(const Pair& p, const int (&d)[CPT],
                                             int k, int w, int max_ed,
                                             int max_sclen, int& best_key,
                                             int& best_i, int& best_j) {
  long long pk = PK_MIN;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    int i = CPT * p.lane + c;
    long long v = pack(edit_key(d[c], i, k, p.n, p.m, w, max_ed, max_sclen),
                       I - 1 - i);
    pk = v > pk ? v : pk;
  }
  pk = warp_max64(pk);
  int kmax = pk_value(pk);
  if (kmax > best_key) {
    int karg = I - 1 - pk_low(pk);
    best_key = kmax;
    best_i = karg;
    best_j = k - karg;
  }
}

__device__ __forceinline__ int floordiv2(int x) {
  return x >= 0 ? x / 2 : -((1 - x) / 2);
}

// Replaces pallas_align.py::_edit_sc_kernel / edit_sc_scan_ref.
// out [B, 4] = (ed, sclen, indel, score).
__global__ void __launch_bounds__(WPB * 32)
edit_sc_kernel(const int8_t* __restrict__ s, const int8_t* __restrict__ t,
               const int32_t* __restrict__ n, const int32_t* __restrict__ m,
               int32_t* __restrict__ out, int B, int L, int w, int max_ed,
               int max_sc) {
  __shared__ int8_t tsh[WPB][I];
  int warp = threadIdx.x >> 5;
  int b = blockIdx.x * WPB + warp;
  if (b >= B) return;
  Pair p;
  load_pair(p, s, t, n, m, b, L, tsh[warp]);
  int max_sclen = min(max_sc, p.m);
  int d2[CPT], d1[CPT], dp[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    int i = CPT * p.lane + c;
    d2[c] = i == 0 ? 0 : POS;                                        // k = 0
    d1[c] = (i <= 1 && i <= p.n && (1 - i) <= p.m) ? 1 : POS;        // k = 1
  }
  int best_key = 0, best_i = 0, best_j = 0;
  // the seed diagonals' cells are candidate sources too
  edit_sc_take(p, d2, 0, w, max_ed, max_sclen, best_key, best_i, best_j);
  edit_sc_take(p, d1, 1, w, max_ed, max_sclen, best_key, best_i, best_j);
  int kend = min(2 * I - 1, p.n + p.m);
  for (int k = 2; k <= kend; ++k) {
    edit_step(p, k, w, d2, d1, dp);
    edit_sc_take(p, dp, k, w, max_ed, max_sclen, best_key, best_i, best_j);
    roll_diags(d2, d1, dp);
  }
  if (p.lane != 0) return;
  int mm = p.m;
  bool has = best_key > 0;
  int sclen = has ? mm - best_j : max_sc + 1;
  int indel = has ? best_j - best_i : w + 1;
  int score_part = (best_key >> 21) - 512;
  int ed = has ? floordiv2(mm - sclen - score_part) : max_ed + 1;
  // oracle tail: if m <= max_ed, the candidate (m, 0, 0) competes
  int tail_key = (int)(((unsigned)(512 - mm) << 21) |
                       ((unsigned)(31 - mm) << 16) | (15u << 12) |
                       ((unsigned)mm << 5) | 31u);
  if (mm <= max_ed && tail_key > best_key) {
    ed = mm;
    sclen = 0;
    indel = 0;
  }
  int32_t* o = out + (size_t)b * 4;
  o[0] = ed;
  o[1] = sclen;
  o[2] = indel;
  o[3] = mm - sclen - 2 * ed;
}

// Replaces align_device.py::one_side_scan_ref.  out [B] = dp[n][m].
__global__ void __launch_bounds__(WPB * 32)
one_side_kernel(const int8_t* __restrict__ s, const int8_t* __restrict__ t,
                const int32_t* __restrict__ n, const int32_t* __restrict__ m,
                const int32_t* __restrict__ wvp, int32_t* __restrict__ out,
                int B, int L) {
  __shared__ int8_t tsh[WPB][I];
  int warp = threadIdx.x >> 5;
  int b = blockIdx.x * WPB + warp;
  if (b >= B) return;
  Pair p;
  load_pair(p, s, t, n, m, b, L, tsh[warp]);
  int wv = wvp[b];
  int top = min(wv, p.m);
  int d2[CPT], d1[CPT], d2m[CPT], d1m[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    int i = CPT * p.lane + c;
    d2[c] = i == 0 ? 0 : POS;                                   // (0, 0)
    d1[c] = (i == 0 && wv >= 1 && p.m >= 1) ? 1 : POS;          // (0, 1)
  }
  int res = POS;
  if (p.n == 0 && p.m == 0) res = 0;
  if (p.n + p.m == 1 && p.n == 0 && wv >= 1 && p.m == 1) res = 1;
  int kend = min(2 * I - 1, p.n + p.m);
  for (int k = 2; k <= kend; ++k) {
    shift_up(d2, d2m);
    shift_up(d1, d1m);
    int val = -1;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      int i = CPT * p.lane + c, j = k - i;
      int v = min(d2m[c] + mismatch(p, c, i, k), min(d1m[c] + 1, d1[c] + 1));
      if (i == 0 && j >= 0 && j <= top) v = j;
      bool valid = i <= p.n && j >= i && j <= min(i + wv, p.m);
      v = valid ? v : POS;
      if (i == p.n) val = max(val, v);
      d2[c] = d1[c];
      d1[c] = v;
    }
    if (k == p.n + p.m) res = warp_max(val);  // dp[n][m] (read only here)
  }
  if (p.lane == 0) out[b] = res;
}

// ---------------------------------------------------------------------------
// Band-local kernels: xdrop and edit_end
// ---------------------------------------------------------------------------
//
// A group of G lanes serves one item and keeps, per anti-diagonal k, only a
// window of WP = G * NC slots (slot q = NC * g + c of lane g holds the cell
// i = a_k + q, j = k - i), where a_k is
//   edit_end: ceil((k - w) / 2) - 1   (band cells |i - j| <= w in 1 .. w+1)
//   xdrop:    lb_k - 1                (live band [lb, ub] from slot 1; the
//                                      boundary cells (0, k), (k, 0) with
//                                      k <= w lie in the window too)
// and every cell outside the window holds POS / NEG (the window invariant:
// its values can never differ from those, so nothing outside is stored).
// a_k moves by delta = 0 or 1 per diagonal.  After each diagonal the two
// previous diagonals and the s / t codes are shifted by delta slots, so
// that cell q always reads its (i - 1) neighbours at slot q - 1 and its (i)
// neighbour at slot q, and one new code enters (s at the top when delta =
// 1, t at slot 0 when delta = 0; both are read at the start of the
// diagonal, before delta is known).  The first w diagonals, the only ones
// with boundary cells, run a separate instance of the step; edit_end's
// delta alternates with the parity of k - w, so its loop takes two
// diagonals per trip with the shifts fixed.

constexpr int NT_BAND = 64;   // threads per block of the band-local kernels
constexpr int W_ANCHOR = 2 * I - 2;  // a wider band changes no cell's test

// (G, NC) for band w (the Python twin is ops/_ext.py band_layout): one lane
// per item while the w + 2 slots fit 8 cells, then 8 cells per lane.
inline void band_layout(int w, int& g, int& nc) {
  int slots = (w < W_ANCHOR ? w : W_ANCHOR) + 2;
  if (slots <= 8) {
    g = 1;
    nc = slots < 2 ? 2 : slots;
    return;
  }
  g = 2;
  while (g * 8 < slots && g < 32) g *= 2;
  nc = 8;
}

template <int G>
__device__ __forceinline__ int group_max(int v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    v = max(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// A block stages its items' s and t rows as one contiguous span, in the
// codes the cells compare: N (>= 4) becomes 4 in s and 5 in t, so that a
// single compare tells a mismatch.  The codes a window reads lie within
// WP + 128 bytes before a row and WP + 256 after its start; those of cells
// outside the row are never live, so they read padding: the buffer carries
// pad_lo bytes before the span and pad_hi after it.
template <int WP, int NI>
struct Staging {
  static constexpr int pad_lo = (WP + 128 + 15) / 16 * 16;
  static constexpr int pad_hi = WP + 256;
  static constexpr int bytes = pad_lo + 16 + NI * I + pad_hi;
};

__device__ __forceinline__ unsigned code4(unsigned x, unsigned n4) {
  unsigned ge = __vcmpges4(x, 0x04040404u);  // bytes >= 4 (signed)
  return (x & ~ge) | (n4 & ge);
}

// Copy the nbytes of src, coded (N -> n), into sh[shift ..), shift = src &
// 15: 16-byte loads for the aligned middle (rows of 127 bytes are not
// 16-byte aligned themselves), bytes for the ends.
__device__ __forceinline__ void stage_span(const int8_t* __restrict__ src,
                                           int nbytes, int8_t* sh,
                                           int8_t n) {
  const int shift = (int)((uintptr_t)src & 15);
  const int head = min((16 - shift) & 15, nbytes);
  const int nvec = (nbytes - head) >> 4;
  const unsigned n4 = 0x01010101u * (unsigned)n;
  for (int x = threadIdx.x; x < head; x += blockDim.x)
    sh[shift + x] = src[x] >= 4 ? n : src[x];
  const int4* v = reinterpret_cast<const int4*>(src + head);
  int4* d = reinterpret_cast<int4*>(sh + shift + head);
  for (int x = threadIdx.x; x < nvec; x += blockDim.x) {
    int4 q = v[x];
    q.x = (int)code4((unsigned)q.x, n4);
    q.y = (int)code4((unsigned)q.y, n4);
    q.z = (int)code4((unsigned)q.z, n4);
    q.w = (int)code4((unsigned)q.w, n4);
    d[x] = q;
  }
  for (int x = head + (nvec << 4) + threadIdx.x; x < nbytes;
       x += blockDim.x)
    sh[shift + x] = src[x] >= 4 ? n : src[x];
}

// One item's coded rows in shared memory.
struct BandRows {
  const int8_t* s;
  const int8_t* t;
  __device__ __forceinline__ int code(bool from_s, int x) const {
    return from_s ? (int)s[x] : (int)t[x];
  }
};

// Stage the block's s and t spans, then point each lane at its item.
template <int G, int WP>
__device__ __forceinline__ BandRows stage_block(
    const int8_t* __restrict__ s, const int8_t* __restrict__ t, int B, int L,
    int8_t* ssh, int8_t* tsh) {
  constexpr int NI = NT_BAND / G;
  const int b0 = blockIdx.x * NI;
  const int nbytes = min(NI, B - b0) * L;
  const int8_t* sp = s + (size_t)b0 * L;
  const int8_t* tp = t + (size_t)b0 * L;
  ssh += Staging<WP, NI>::pad_lo;
  tsh += Staging<WP, NI>::pad_lo;
  stage_span(sp, nbytes, ssh, 4);
  stage_span(tp, nbytes, tsh, 5);
  __syncthreads();
  const int r = threadIdx.x / G;
  return BandRows{ssh + ((uintptr_t)sp & 15) + r * L,
                  tsh + ((uintptr_t)tp & 15) + r * L};
}

// The window arrays of one lane: the diagonals k-1 (P) and k-2 (PP), and
// the codes s[i-1] (S) and t[j-1] (T) of its NC cells.
template <int G, int NC>
struct Window {
  int P[NC], PP[NC], S[NC], T[NC];

  // Values at slot q - 1 for the lane's first cell (from the lane below in
  // the group; `fill` below slot 0).
  __device__ __forceinline__ void below(int g, int fill, int& pm,
                                        int& ppm) const {
    pm = ppm = fill;
    if constexpr (G > 1) {
      int x = __shfl_up_sync(FULL, P[NC - 1], 1, G);
      int y = __shfl_up_sync(FULL, PP[NC - 1], 1, G);
      if (g > 0) {
        pm = x;
        ppm = y;
      }
    }
  }

  // Re-anchor by delta after a diagonal N: PP <- P, P <- N, both shifted
  // down by delta (fill enters at the top); S shifts down by delta, T up by
  // 1 - delta.  s_new / t_new are the codes entering at the top (s[i-1],
  // delta = 1) and at slot 0 (t[j-1], delta = 0), read by the caller
  // before delta was known.
  __device__ __forceinline__ void advance(int g, const int (&N)[NC],
                                          bool delta, int fill, int s_new,
                                          int t_new) {
    int n_up = fill, p_up = fill, s_up = s_new, t_dn = t_new;
    if constexpr (G > 1) {
      int x = __shfl_down_sync(FULL, N[0], 1, G);
      int y = __shfl_down_sync(FULL, P[0], 1, G);
      int z = __shfl_down_sync(FULL, S[0], 1, G);
      int u = __shfl_up_sync(FULL, T[NC - 1], 1, G);
      if (g < G - 1) {
        n_up = x;
        p_up = y;
        s_up = z;
      }
      if (g > 0) t_dn = u;
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      int pn = c + 1 < NC ? P[c + 1] : p_up;
      int nx = c + 1 < NC ? N[c + 1] : n_up;
      int sn = c + 1 < NC ? S[c + 1] : s_up;
      PP[c] = delta ? pn : P[c];
      P[c] = delta ? nx : N[c];
      S[c] = delta ? sn : S[c];
    }
#pragma unroll
    for (int c = NC - 1; c >= 0; --c) {
      int tp = c > 0 ? T[c - 1] : t_dn;
      T[c] = delta ? T[c] : tp;
    }
  }

  __device__ __forceinline__ void load_codes(int q0, int a, int k,
                                             const BandRows& rows) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      int p = a + q0 + c;
      S[c] = rows.code(true, p - 1);
      T[c] = rows.code(false, k - p - 1);
    }
  }
};

// One item of the edit_end DP (one lane of its group of G).  Slot 0 of the
// window (i = ceil((k - w) / 2) - 1) is never in band: it only carries the
// previous diagonal's cell there for the shift, so a one-lane item does
// not compute it.
template <int G, int NC>
struct EditEndItem {
  Window<G, NC> win;
  BandRows rows;
  int g, q0, nn, mm, w, max_ed, a;
  int best_key, best_ed, best_indel;

  // Diagonal k (BND: k <= w, where the boundary cells (k, 0), (0, k) lie),
  // then the re-anchor by delta for k + 1.
  template <bool BND>
  __device__ __forceinline__ void step(int k, bool delta) {
    constexpr int WP = G * NC;
    const int s_new = rows.code(true, a + WP - 1);
    const int t_new = rows.code(false, k - a);
    int pm0, ppm0;
    win.below(g, POS, pm0, ppm0);
    // band cells: 0 <= j <= m, i <= n, |i - j| <= w, inside the extent
    const int off = a + q0;
    const int c_lo = max(max(0, k - mm), (k - w + 1) >> 1) - off;
    const int c_hi = min(min(nn, I - 1), min(k, (k + w) >> 1)) - off;
    const int c_m = k - mm - off;  // the one cell on column m
    int N[NC];
    int on_m = POS;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (G == 1 && c == 0) {
        N[0] = POS;
        continue;
      }
      int pm = c > 0 ? win.P[c - 1] : pm0;
      int ppm = c > 0 ? win.PP[c - 1] : ppm0;
      int v = min(ppm + (win.S[c] != win.T[c]), min(pm, win.P[c]) + 1);
      if constexpr (BND) {
        int p = off + c, j = k - p;
        if (j == 0 && p <= w) v = p;
        if (p == 0 && j >= 0 && j <= w) v = j;
      }
      N[c] = (c >= c_lo) & (c <= c_hi) ? v : POS;
      on_m = c == c_m ? N[c] : on_m;
    }
    int ce = on_m <= max_ed ? max_ed - on_m : -1;
    if constexpr (G > 1) ce = group_max<G>(ce);
    // strict: the smaller i wins exact ties (no branch: lanes are items)
    const int indel = mm - (k - mm);
    const int key = ce * (w + 2) + (w + 1 - min(abs(indel), w + 1));
    const bool better = (ce >= 0) & (key > best_key);
    best_key = better ? key : best_key;
    best_ed = better ? max_ed - ce : best_ed;
    best_indel = better ? indel : best_indel;
    win.advance(g, N, delta, POS, s_new, t_new);
    a += delta;
  }
};

// Replaces align_device.py::edit_end_scan_ref.  out [B, 2] = (ed, indel).
template <int G, int NC>
__global__ void __launch_bounds__(NT_BAND)
edit_end_kernel(const int8_t* __restrict__ s, const int8_t* __restrict__ t,
                const int32_t* __restrict__ n, const int32_t* __restrict__ m,
                int32_t* __restrict__ out, int B, int L, int w, int max_ed) {
  constexpr int NI = NT_BAND / G;
  __shared__ __align__(16) int8_t ssh[Staging<G * NC, NI>::bytes];
  __shared__ __align__(16) int8_t tsh[Staging<G * NC, NI>::bytes];
  EditEndItem<G, NC> it;
  it.rows = stage_block<G, G * NC>(s, t, B, L, ssh, tsh);
  it.g = threadIdx.x % G;
  it.q0 = it.g * NC;
  const int b = blockIdx.x * NI + threadIdx.x / G;
  const bool real = b < B;
  it.nn = real ? n[b] : 0;
  it.mm = real ? m[b] : 0;
  it.w = w;
  it.max_ed = max_ed;
  const int wa = min(w, W_ANCHOR);
  it.a = ((2 - wa + 1) >> 1) - 1;  // ceil((k - w) / 2) - 1 at k = 2
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    int p = it.a + it.q0 + c;
    it.win.PP[c] = p == 0 ? 0 : POS;                                  // k = 0
    it.win.P[c] =
        (p >= 0 && p <= 1 && p <= it.nn && 1 - p <= it.mm) ? 1 : POS;  // k = 1
  }
  it.win.load_codes(it.q0, it.a, 2, it.rows);
  it.best_key = 0;
  it.best_ed = max_ed + 1;
  it.best_indel = w + 1;
  // past k = n + m no cell is in band; the warp runs to its longest item
  const int kmax = __reduce_max_sync(FULL, min(2 * I - 1, it.nn + it.mm));
  int k = 2;
  for (; k <= kmax && k <= w; ++k)
    it.template step<true>(k, ((k - wa) & 1) == 0);
  // delta alternates from here on: two diagonals per trip, no predicate
  if (((k - wa) & 1) == 0) {
    for (; k < kmax; k += 2) {
      it.template step<false>(k, true);
      it.template step<false>(k + 1, false);
    }
  } else {
    for (; k < kmax; k += 2) {
      it.template step<false>(k, false);
      it.template step<false>(k + 1, true);
    }
  }
  if (k == kmax) it.template step<false>(k, ((k - wa) & 1) == 0);
  if (real && it.g == 0) {
    out[(size_t)b * 2] = it.best_ed;
    out[(size_t)b * 2 + 1] = it.best_indel;
  }
}

// One item of the X-drop DP (one lane of its group of G).  Outside the
// first w diagonals slot 0 (i = lb - 1) holds NEG: a one-lane item does not
// compute it there.
template <int G, int NC>
struct XdropItem {
  Window<G, NC> win;
  BandRows rows;
  int g, q0, nn, mm, w, wn, wm, mat, mis, ind, xd, a, kend;
  int lb, ub, pre_opt, cur_opt, best_i, best_j, best_v;
  bool pre_any, alive;

  // Diagonal k (BND: k <= w, where the boundary cells (k, 0), (0, k) lie),
  // the band trajectory, then the re-anchor for k + 1.
  template <bool BND>
  __device__ __forceinline__ void step(int k) {
    constexpr int WP = G * NC;
    const bool act = alive && k <= kend;
    const int s_new = rows.code(true, a + WP - 1);
    const int t_new = rows.code(false, k - a);
    int pm0, ppm0;
    win.below(g, NEG, pm0, ppm0);
    // the live band: lb <= i <= ub, 1 <= j <= m, i <= n, inside the extent
    const int off = a + q0;
    const int c_lo = max(lb, k - mm) - off;
    const int c_hi = min(min(ub, k - 1), min(nn, I - 1)) - off;
    const int thr = pre_opt - xd;  // prune: val + xd < pre_opt
    int N[NC], vb[NC];
    int vmax = NEG;
    bool any = false;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (G == 1 && !BND && c == 0) {
        N[0] = vb[0] = NEG;
        continue;
      }
      int pm = c > 0 ? win.P[c - 1] : pm0;
      int ppm = c > 0 ? win.PP[c - 1] : ppm0;
      int sub = win.S[c] != win.T[c] ? mis : mat;
      int val = max(ppm + sub, max(pm, win.P[c]) + ind);
      const bool band = (c >= c_lo) & (c <= c_hi);
      vb[c] = band ? val : NEG;
      vmax = max(vmax, vb[c]);
      const bool keep = band & (val >= thr);
      any |= keep;
      int v = keep ? val : NEG;
      if constexpr (BND) {
        int p = off + c, j = k - p;
        if (!band & (j == 0) & (p <= wn)) v = ind * p;
        if (!band & (p == 0) & (j >= 0) & (j <= wm)) v = ind * j;
      }
      N[c] = v;
    }
    if constexpr (G > 1) vmax = group_max<G>(vmax);
    // the largest i among the maxima
    int ia = -1;
#pragma unroll
    for (int c = 0; c < NC; ++c) ia = vb[c] == vmax ? off + c : ia;
    if constexpr (G > 1) {
      ia = group_max<G>(ia);
      any = group_max<G>((int)any) != 0;
    }
    // every cell at vmax >= 0 is in band; no branches below: the lanes of
    // a warp are different items
    const bool upd = act & (vmax >= cur_opt);
    cur_opt = upd ? vmax : cur_opt;
    best_i = upd ? ia : best_i;
    best_j = upd ? k - ia : best_j;
    best_v = upd ? vmax : best_v;
    // band trajectory (align.cpp:358-372); (k - w) parity only for k > w
    const bool odd = ((k - w) & 1) == 1;
    const bool lb_up = (k - lb == mm) | ((k > w) & !odd);
    const bool ub_up = (ub < nn) & ((k <= w) | odd);
    const bool dead = (!pre_any & !any) | (lb + lb_up > ub + ub_up);
    pre_any = act ? any : pre_any;
    pre_opt = act ? max(pre_opt, cur_opt) : pre_opt;
    const bool delta = act & lb_up;
    lb += delta;
    ub += act & ub_up;
    alive &= !(act & dead);
    win.advance(g, N, delta, NEG, s_new, t_new);
    a += delta;
  }
};

// Replaces pallas_align.py::_xdrop_kernel / xdrop_scan_ref.
// out [B, 3] = (best_score, on_s, on_t).
template <int G, int NC>
__global__ void __launch_bounds__(NT_BAND)
xdrop_kernel(const int8_t* __restrict__ s, const int8_t* __restrict__ t,
             const int32_t* __restrict__ n, const int32_t* __restrict__ m,
             int32_t* __restrict__ out, int B, int L, int w, int mat,
             int mis, int ind, int xd) {
  constexpr int NI = NT_BAND / G;
  __shared__ __align__(16) int8_t ssh[Staging<G * NC, NI>::bytes];
  __shared__ __align__(16) int8_t tsh[Staging<G * NC, NI>::bytes];
  XdropItem<G, NC> it;
  it.rows = stage_block<G, G * NC>(s, t, B, L, ssh, tsh);
  it.g = threadIdx.x % G;
  it.q0 = it.g * NC;
  const int b = blockIdx.x * NI + threadIdx.x / G;
  const bool real = b < B;
  it.nn = real ? n[b] : 0;
  it.mm = real ? m[b] : 0;
  it.w = w;
  it.wn = min(w, it.nn);
  it.wm = min(w, it.mm);
  it.mat = mat;
  it.mis = mis;
  it.ind = ind;
  it.xd = xd;
  it.kend = min(2 * I - 1, it.nn + it.mm);
  it.lb = it.ub = 1;
  it.pre_opt = it.cur_opt = 0;
  it.best_i = it.best_j = it.best_v = 0;
  it.pre_any = true;
  it.alive = it.nn > 0 && it.mm > 0;
  it.a = 0;  // lb - 1
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    int p = it.q0 + c;
    it.win.PP[c] = p == 0 ? 0 : NEG;                                 // (0, 0)
    it.win.P[c] = (p <= 1 && p <= it.wn && 1 - p <= it.wm) ? ind : NEG;  // k=1
  }
  it.win.load_codes(it.q0, it.a, 2, it.rows);
  int k = 2;
  for (; k <= w && __any_sync(FULL, it.alive && k <= it.kend); ++k)
    it.template step<true>(k);
  for (; __any_sync(FULL, it.alive && k <= it.kend); ++k)
    it.template step<false>(k);
  if (real && it.g == 0) {
    bool empty = it.nn <= 0 || it.mm <= 0;
    int32_t* o = out + (size_t)b * 3;
    o[0] = empty ? 0 : it.best_v;
    o[1] = empty ? 0 : it.best_i;
    o[2] = empty ? 0 : it.best_j;
  }
}

template <int G, int NC>
int launch_xdrop(const void* s, const void* t, const void* n, const void* m,
                 void* out, int B, int L, int w, int mat, int mis, int ind,
                 int xd, cudaStream_t stream) {
  constexpr int NI = NT_BAND / G;
  xdrop_kernel<G, NC><<<(B + NI - 1) / NI, NT_BAND, 0, stream>>>(
      (const int8_t*)s, (const int8_t*)t, (const int32_t*)n,
      (const int32_t*)m, (int32_t*)out, B, L, w, mat, mis, ind, xd);
  return (int)cudaGetLastError();
}

template <int G, int NC>
int launch_edit_end(const void* s, const void* t, const void* n,
                    const void* m, void* out, int B, int L, int w,
                    int max_ed, cudaStream_t stream) {
  constexpr int NI = NT_BAND / G;
  edit_end_kernel<G, NC><<<(B + NI - 1) / NI, NT_BAND, 0, stream>>>(
      (const int8_t*)s, (const int8_t*)t, (const int32_t*)n,
      (const int32_t*)m, (int32_t*)out, B, L, w, max_ed);
  return (int)cudaGetLastError();
}

// Call LAUNCH<G, NC>(args...) for the layout of band w.
#define CM_BAND_DISPATCH(LAUNCH, w, ...)                        \
  do {                                                          \
    int g_, nc_;                                                \
    band_layout(w, g_, nc_);                                    \
    if (g_ == 1) switch (nc_) {                                 \
        case 2: return LAUNCH<1, 2>(__VA_ARGS__);               \
        case 3: return LAUNCH<1, 3>(__VA_ARGS__);               \
        case 4: return LAUNCH<1, 4>(__VA_ARGS__);               \
        case 5: return LAUNCH<1, 5>(__VA_ARGS__);               \
        case 6: return LAUNCH<1, 6>(__VA_ARGS__);               \
        case 7: return LAUNCH<1, 7>(__VA_ARGS__);               \
        case 8: return LAUNCH<1, 8>(__VA_ARGS__);               \
      }                                                         \
    switch (g_) {                                               \
      case 2: return LAUNCH<2, 8>(__VA_ARGS__);                 \
      case 4: return LAUNCH<4, 8>(__VA_ARGS__);                 \
      case 8: return LAUNCH<8, 8>(__VA_ARGS__);                 \
      case 16: return LAUNCH<16, 8>(__VA_ARGS__);               \
      case 32: return LAUNCH<32, 8>(__VA_ARGS__);               \
    }                                                           \
    return (int)cudaErrorInvalidValue;                          \
  } while (0)

inline dim3 grid_for(int B) { return dim3((unsigned)((B + WPB - 1) / WPB)); }

}  // namespace

// Plain C interface (loaded with ctypes).  Pointers: s, t int8 [B, L];
// n, m (, wv) int32 [B]; out int32 [B, cols].  Each returns
// cudaGetLastError() right after its launch.
extern "C" {

int cm_xdrop(const void* s, const void* t, const void* n, const void* m,
             const void* wv, void* out, int B, int L, int w, int mat, int mis,
             int ind, int xd, void* stream) {
  (void)wv;
  CM_BAND_DISPATCH(launch_xdrop, w, s, t, n, m, out, B, L, w, mat, mis, ind,
                   xd, (cudaStream_t)stream);
}

int cm_edit_sc(const void* s, const void* t, const void* n, const void* m,
               const void* wv, void* out, int B, int L, int w, int max_ed,
               int max_sc, void* stream) {
  (void)wv;
  edit_sc_kernel<<<grid_for(B), WPB * 32, 0, (cudaStream_t)stream>>>(
      (const int8_t*)s, (const int8_t*)t, (const int32_t*)n,
      (const int32_t*)m, (int32_t*)out, B, L, w, max_ed, max_sc);
  return (int)cudaGetLastError();
}

int cm_edit_end(const void* s, const void* t, const void* n, const void* m,
                const void* wv, void* out, int B, int L, int w, int max_ed,
                void* stream) {
  (void)wv;
  CM_BAND_DISPATCH(launch_edit_end, w, s, t, n, m, out, B, L, w, max_ed,
                   (cudaStream_t)stream);
}

int cm_one_side(const void* s, const void* t, const void* n, const void* m,
                const void* wv, void* out, int B, int L, void* stream) {
  one_side_kernel<<<grid_for(B), WPB * 32, 0, (cudaStream_t)stream>>>(
      (const int8_t*)s, (const int8_t*)t, (const int32_t*)n,
      (const int32_t*)m, (const int32_t*)wv, (int32_t*)out, B, L);
  return (int)cudaGetLastError();
}

}  // extern "C"
