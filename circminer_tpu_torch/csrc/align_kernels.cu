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
// One layout, band-local.  A group of G lanes serves one item and keeps,
// per anti-diagonal k, only a window of WP = G * NC slots (slot q = NC * g
// + c of lane g holds the cell i = a_k + q, j = k - i), where a_k is
//   edit_end, edit_sc: ceil((k - w) / 2) - 1  (band |i - j| <= w in slots
//                                              1 .. w + 1; w + 2 slots)
//   one_side:          ceil((k - w) / 2) - 1  (band 0 <= j - i <= wv, for
//                                              every item's wv <= w, in
//                                              slots 1 .. w/2 + 1; w/2 + 2)
//   xdrop:             lb_k - 1               (live band [lb, ub] from slot
//                                              1; the boundary cells (0, k),
//                                              (k, 0) with k <= w lie in the
//                                              window too; w + 2 slots)
// and every cell outside the window holds POS / NEG (the window invariant:
// its values can never differ from those, so nothing outside is stored).
// band_layout picks G * NC >= the slots: G = 1 while they fit 8 cells (w <=
// 6; one_side w <= 13), so at the default w = 3 every lane is its own item
// and a diagonal needs no shuffle at all; G up to 32 for w up to 254.  The
// block's s and t rows are staged once into shared memory with 16-byte
// loads of its contiguous span.
//
// a_k moves by delta = 0 or 1 per diagonal.  After each diagonal the two
// previous diagonals and the s / t codes are shifted by delta slots, so
// that cell q always reads its (i - 1) neighbours at slot q - 1 and its (i)
// neighbour at slot q, and one new code enters (s at the top when delta =
// 1, t at slot 0 when delta = 0; both are read at the start of the
// diagonal, before delta is known).  The first w diagonals, the only ones
// with boundary cells, run a separate instance of the step.  In the edit
// DPs and one_side delta alternates with the parity of k - w, the same for
// every lane, so their loops take two diagonals per trip with the shifts
// fixed; one_side anchors at the launch's bound w rather than at each
// item's wv for that reason (an item's narrower band only masks more
// slots).  Each item's loop ends at min(2I - 1, n + m) or at X-drop's dead
// band; a warp leaves when all its items are done.
//
// What bounds them.  Not bytes (the whole B = 1024 input is 260 KB) nor the
// card's ALU throughput (~0.3 M band cells at B = 1024), but the n + m
// anti-diagonals of the longest item in a warp, one after the other, times
// the instructions of one diagonal.  At G = 1 there is no shuffle and no
// branch in a diagonal (the lanes of a warp are different items, so every
// update is a select), and a warp scheduler has 16 INT32 lanes, so each
// integer instruction takes two cycles to dispatch.  That dispatch time,
// not the ~12-op dependent chain of a diagonal, is what the kernels wait
// on; it does not shrink with more items (B = 1024 fills 16 SMs, B = 8192
// 128), only with fewer instructions per diagonal: fewer slots, and fewer
// instructions per slot (edit_sc's candidate key is the costliest).
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
constexpr int NEG = -10000000;
constexpr int POS = 10000000;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NT_BAND = 64;   // threads per block
constexpr int W_ANCHOR = 2 * I - 2;  // a wider band changes no cell's test

// Window slots of band w: w + 2, or w / 2 + 2 for the one-sided band.
inline int band_slots(int w, bool one_sided) {
  int wa = w < W_ANCHOR ? w : W_ANCHOR;
  return (one_sided ? wa / 2 : wa) + 2;
}

// (G, NC) for a window of `slots` (the Python twin is ops/_ext.py
// band_layout): one lane per item while the slots fit 8 cells, then 8
// cells per lane.
inline void band_layout(int slots, int& g, int& nc) {
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

// Diagonals 2 .. kmax of an item whose window start moves with the parity
// of k - wa (the edit DPs and one_side): the first w, the only ones with
// boundary cells, one at a time; then delta alternates, the same for every
// lane, so two diagonals per trip with the shifts fixed.
template <class Item>
__device__ __forceinline__ void sweep(Item& it, int w, int wa, int kmax) {
  int k = 2;
  for (; k <= kmax && k <= w; ++k)
    it.template step<true>(k, ((k - wa) & 1) == 0);
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
}

// edit_end's candidate rule: the one cell on column m of each diagonal; ed
// asc, |indel| asc, the smaller i (the earlier diagonal) on exact ties.
// out [B, 2] = (ed, indel).
struct EndCand {
  static constexpr int NCOLS = 2;
  int w, max_ed, best_key, best_ed, best_indel;

  __device__ __forceinline__ void init(int, int, int w_, int max_ed_, int) {
    w = w_;
    max_ed = max_ed_;
    best_key = 0;
    best_ed = max_ed + 1;
    best_indel = w + 1;
  }

  // Diagonal k's values N (POS off the band), slot c holding i = off + c.
  template <int G, int NC>
  __device__ __forceinline__ void take(const int (&N)[NC], int k, int off,
                                       int mm) {
    const int c_m = k - mm - off;  // the one cell on column m
    int on_m = POS;
#pragma unroll
    for (int c = G == 1 ? 1 : 0; c < NC; ++c) on_m = c == c_m ? N[c] : on_m;
    int ce = on_m <= max_ed ? max_ed - on_m : -1;
    if constexpr (G > 1) ce = group_max<G>(ce);
    // strict: the smaller i wins exact ties (no branch: lanes are items)
    const int indel = mm - (k - mm);
    const int key = ce * (w + 2) + (w + 1 - min(abs(indel), w + 1));
    const bool better = (ce >= 0) & (key > best_key);
    best_key = better ? key : best_key;
    best_ed = better ? max_ed - ce : best_ed;
    best_indel = better ? indel : best_indel;
  }

  __device__ __forceinline__ void write(int32_t* o, int) const {
    o[0] = best_ed;
    o[1] = best_indel;
  }
};

// edit_sc's candidate rule: every in-band cell with dp <= max_ed and sclen
// = m - j <= min(max_sc, m) is a soft-clip candidate, ranked by the
// reference's packed int32 key (pallas_align.py _edit_candidate_key):
// score desc, ed asc, |indel| asc, j desc, i asc.  The largest key wins,
// the smallest i of a diagonal and the earlier diagonal on ties: at G = 1 a
// strict-greater update over the slots in ascending i, diagonal after
// diagonal, does both; a group first takes its diagonal's largest key and
// then the smallest i at it, by two group maxima.  Keys <= 0 never win
// (the running best starts at 0, as the reference's does).
// out [B, 4] = (ed, sclen, indel, score).
struct ScCand {
  static constexpr int NCOLS = 4;
  int w, max_ed, max_sc, jmin, best_key, best_i, best_j;

  // composed in uint32 so that wrap-around matches the reference's int32
  // shifts (score = m - sclen - 2 dp = j - 2 dp)
  __device__ static __forceinline__ int key(int dp, int i, int j) {
    return (int)(((unsigned)(j - 2 * dp + 512) << 21) |
                 ((unsigned)(31 - dp) << 16) |
                 ((unsigned)(15 - abs(j - i)) << 12) | ((unsigned)j << 5) |
                 (unsigned)(31 - min(i, 31)));
  }

  __device__ __forceinline__ void offer(bool ok, int kc, int i, int j) {
    const bool gt = ok & (kc > best_key);
    best_key = gt ? kc : best_key;
    best_i = gt ? i : best_i;
    best_j = gt ? j : best_j;
  }

  __device__ __forceinline__ void init(int nn, int mm, int w_, int max_ed_,
                                       int max_sc_) {
    w = w_;
    max_ed = max_ed_;
    max_sc = max_sc_;
    jmin = mm - min(max_sc, mm);  // sclen <= max_sclen
    best_key = best_i = best_j = 0;
    // the seed diagonals are candidate sources too: dp = 0 at (0, 0), 1 at
    // (0, 1) and (1, 0) where those lie in the matrix (k = 0, then k = 1 in
    // ascending i)
    offer((0 <= max_ed) & (jmin <= 0), key(0, 0, 0), 0, 0);
    offer((mm >= 1) & (1 <= max_ed) & (jmin <= 1) & (w >= 1), key(1, 0, 1),
          0, 1);
    offer((nn >= 1) & (1 <= max_ed) & (jmin <= 0) & (w >= 1), key(1, 1, 0),
          1, 0);
  }

  template <int G, int NC>
  __device__ __forceinline__ void take(const int (&N)[NC], int k, int off,
                                       int) {
    int kmax = 0, imax = 0;
#pragma unroll
    for (int c = G == 1 ? 1 : 0; c < NC; ++c) {
      const int i = off + c, j = k - i;
      // N is POS off the band, so these two tests leave only band cells
      const bool ok = (N[c] <= max_ed) & (j >= jmin);
      const int kc = key(N[c], i, j);
      if constexpr (G == 1) {
        offer(ok, kc, i, j);
      } else {
        const bool gt = ok & (kc > kmax);
        kmax = gt ? kc : kmax;
        imax = gt ? i : imax;
      }
    }
    if constexpr (G > 1) {
      const int top = group_max<G>(kmax);
      const int i = I - 1 - group_max<G>(kmax == top ? I - 1 - imax : -1);
      offer(top > 0, top, i, k - i);
    }
  }

  __device__ __forceinline__ void write(int32_t* o, int mm) const {
    const bool has = best_key > 0;
    int sclen = has ? mm - best_j : max_sc + 1;
    int indel = has ? best_j - best_i : w + 1;
    // floor((m - sclen - score) / 2): >> is arithmetic on int
    int ed = has ? (mm - sclen - ((best_key >> 21) - 512)) >> 1 : max_ed + 1;
    // oracle tail: if m <= max_ed, the candidate (m, 0, 0) competes
    int tail_key = (int)(((unsigned)(512 - mm) << 21) |
                         ((unsigned)(31 - mm) << 16) | (15u << 12) |
                         ((unsigned)mm << 5) | 31u);
    if (mm <= max_ed && tail_key > best_key) {
      ed = mm;
      sclen = 0;
      indel = 0;
    }
    o[0] = ed;
    o[1] = sclen;
    o[2] = indel;
    o[3] = mm - sclen - 2 * ed;
  }
};

// One item of the banded edit DP (one lane of its group of G), with the
// candidate rule Cand.  Slot 0 of the window (i = ceil((k - w) / 2) - 1) is
// never in band: it only carries the previous diagonal's cell there for the
// shift, so a one-lane item does not compute it.
template <int G, int NC, class Cand>
struct EditItem {
  Window<G, NC> win;
  BandRows rows;
  int g, q0, nn, mm, w, a;
  // last, and set up after the window: in that order nvcc allocates
  // edit_end's loop as tightly as a separate edit_end item does (other
  // orders cost it one register move per two diagonals)
  Cand cand;

  // Diagonal k (BND: k <= w, where the boundary cells (k, 0), (0, k) lie),
  // its candidates, then the re-anchor by delta for k + 1.
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
    int N[NC];
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
    }
    cand.template take<G, NC>(N, k, off, mm);
    win.advance(g, N, delta, POS, s_new, t_new);
    a += delta;
  }
};

template <int G, int NC, class Cand>
__device__ __forceinline__ void edit_item(
    const int8_t* __restrict__ s, const int8_t* __restrict__ t,
    const int32_t* __restrict__ n, const int32_t* __restrict__ m,
    int32_t* __restrict__ out, int B, int L, int w, int max_ed, int max_sc) {
  constexpr int NI = NT_BAND / G;
  __shared__ __align__(16) int8_t ssh[Staging<G * NC, NI>::bytes];
  __shared__ __align__(16) int8_t tsh[Staging<G * NC, NI>::bytes];
  EditItem<G, NC, Cand> it;
  it.rows = stage_block<G, G * NC>(s, t, B, L, ssh, tsh);
  it.g = threadIdx.x % G;
  it.q0 = it.g * NC;
  const int b = blockIdx.x * NI + threadIdx.x / G;
  const bool real = b < B;
  it.nn = real ? n[b] : 0;
  it.mm = real ? m[b] : 0;
  it.w = w;
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
  it.cand.init(it.nn, it.mm, w, max_ed, max_sc);
  // past k = n + m no cell is in band; the warp runs to its longest item
  sweep(it, w, wa, __reduce_max_sync(FULL, min(2 * I - 1, it.nn + it.mm)));
  if (real && it.g == 0) it.cand.write(out + (size_t)b * Cand::NCOLS, it.mm);
}

// Replaces align_device.py::edit_end_scan_ref.  out [B, 2] = (ed, indel).
template <int G, int NC>
__global__ void __launch_bounds__(NT_BAND)
edit_end_kernel(const int8_t* __restrict__ s, const int8_t* __restrict__ t,
                const int32_t* __restrict__ n, const int32_t* __restrict__ m,
                int32_t* __restrict__ out, int B, int L, int w, int max_ed) {
  edit_item<G, NC, EndCand>(s, t, n, m, out, B, L, w, max_ed, 0);
}

// Replaces pallas_align.py::_edit_sc_kernel / edit_sc_scan_ref.
// out [B, 4] = (ed, sclen, indel, score).
template <int G, int NC>
__global__ void __launch_bounds__(NT_BAND)
edit_sc_kernel(const int8_t* __restrict__ s, const int8_t* __restrict__ t,
               const int32_t* __restrict__ n, const int32_t* __restrict__ m,
               int32_t* __restrict__ out, int B, int L, int w, int max_ed,
               int max_sc) {
  edit_item<G, NC, ScCand>(s, t, n, m, out, B, L, w, max_ed, max_sc);
}

// One item of the one_side DP (one lane of its group of G): band 0 <= j - i
// <= wv, boundary dp[0][j] = j for j <= min(wv, m).  The window is anchored
// at the launch's bound w, so slot 0 is never in band and a one-lane item
// does not compute it.  The result is one cell, dp[n][m], kept by a select
// on diagonal n + m (POS when it is out of band).
template <int G, int NC>
struct OneSideItem {
  Window<G, NC> win;
  BandRows rows;
  int g, q0, nn, mm, wv, top, a, res;

  // Diagonal k (BND: k <= w, where the boundary cells (0, k) lie), then the
  // re-anchor by delta for k + 1.
  template <bool BND>
  __device__ __forceinline__ void step(int k, bool delta) {
    constexpr int WP = G * NC;
    const int s_new = rows.code(true, a + WP - 1);
    const int t_new = rows.code(false, k - a);
    int pm0, ppm0;
    win.below(g, POS, pm0, ppm0);
    // band cells: 0 <= j - i <= wv, i <= n, j <= m, inside the extent
    const int off = a + q0;
    const int c_lo = max(max(0, k - mm), (k - wv + 1) >> 1) - off;
    const int c_hi = min(min(nn, I - 1), k >> 1) - off;
    const int c_n = k == nn + mm ? nn - off : -1;  // dp[n][m], read only here
    int N[NC];
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
        if ((off + c == 0) & (k <= top)) v = k;
      }
      N[c] = (c >= c_lo) & (c <= c_hi) ? v : POS;
      res = c == c_n ? N[c] : res;
    }
    win.advance(g, N, delta, POS, s_new, t_new);
    a += delta;
  }
};

// Replaces align_device.py::one_side_scan_ref.  out [B] = dp[n][m].  Every
// row's wv must lie in [0, w]: the window is sized from w, so a row outside
// it stops the kernel with a trap (the launch fails at the next
// synchronisation) instead of answering from a window too small.
template <int G, int NC>
__global__ void __launch_bounds__(NT_BAND)
one_side_kernel(const int8_t* __restrict__ s, const int8_t* __restrict__ t,
                const int32_t* __restrict__ n, const int32_t* __restrict__ m,
                const int32_t* __restrict__ wvp, int32_t* __restrict__ out,
                int B, int L, int w) {
  constexpr int NI = NT_BAND / G;
  __shared__ __align__(16) int8_t ssh[Staging<G * NC, NI>::bytes];
  __shared__ __align__(16) int8_t tsh[Staging<G * NC, NI>::bytes];
  OneSideItem<G, NC> it;
  it.rows = stage_block<G, G * NC>(s, t, B, L, ssh, tsh);
  it.g = threadIdx.x % G;
  it.q0 = it.g * NC;
  const int b = blockIdx.x * NI + threadIdx.x / G;
  const bool real = b < B;
  it.nn = real ? n[b] : 0;
  it.mm = real ? m[b] : 0;
  it.wv = real ? wvp[b] : 0;
  if (it.wv < 0 || it.wv > w) __trap();
  it.top = min(it.wv, it.mm);
  const int wa = min(w, W_ANCHOR);
  it.a = ((2 - wa + 1) >> 1) - 1;  // ceil((k - w) / 2) - 1 at k = 2
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    int p = it.a + it.q0 + c;
    it.win.PP[c] = p == 0 ? 0 : POS;                                // (0, 0)
    it.win.P[c] = (p == 0 && it.wv >= 1 && it.mm >= 1) ? 1 : POS;   // (0, 1)
  }
  it.win.load_codes(it.q0, it.a, 2, it.rows);
  it.res = POS;
  if (it.nn == 0 && it.mm == 0) it.res = 0;
  if (it.nn == 0 && it.mm == 1 && it.wv >= 1) it.res = 1;
  sweep(it, w, wa, __reduce_max_sync(FULL, min(2 * I - 1, it.nn + it.mm)));
  // one lane of the group holds dp[n][m]; the others hold POS or the same
  // special case
  int res = it.res;
  if constexpr (G > 1) res = -group_max<G>(-res);
  if (real && it.g == 0) out[b] = res;
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

// KERNEL<G, NC> over B items, NT_BAND / G items per block; the launch's
// cudaGetLastError().
#define CM_LAUNCH(KERNEL, G, NC, B, stream, ...)                      \
  (KERNEL<G, NC><<<((B) + NT_BAND / (G) - 1) / (NT_BAND / (G)), NT_BAND, \
                   0, stream>>>(__VA_ARGS__),                         \
   (int)cudaGetLastError())

// Return CM_LAUNCH(KERNEL, G, NC, ...) for the layout of `slots`.
#define CM_BAND_DISPATCH(KERNEL, slots, ...)                        \
  do {                                                              \
    int g_, nc_;                                                    \
    band_layout(slots, g_, nc_);                                    \
    if (g_ == 1) switch (nc_) {                                     \
        case 2: return CM_LAUNCH(KERNEL, 1, 2, __VA_ARGS__);        \
        case 3: return CM_LAUNCH(KERNEL, 1, 3, __VA_ARGS__);        \
        case 4: return CM_LAUNCH(KERNEL, 1, 4, __VA_ARGS__);        \
        case 5: return CM_LAUNCH(KERNEL, 1, 5, __VA_ARGS__);        \
        case 6: return CM_LAUNCH(KERNEL, 1, 6, __VA_ARGS__);        \
        case 7: return CM_LAUNCH(KERNEL, 1, 7, __VA_ARGS__);        \
        case 8: return CM_LAUNCH(KERNEL, 1, 8, __VA_ARGS__);        \
      }                                                             \
    switch (g_) {                                                   \
      case 2: return CM_LAUNCH(KERNEL, 2, 8, __VA_ARGS__);          \
      case 4: return CM_LAUNCH(KERNEL, 4, 8, __VA_ARGS__);          \
      case 8: return CM_LAUNCH(KERNEL, 8, 8, __VA_ARGS__);          \
      case 16: return CM_LAUNCH(KERNEL, 16, 8, __VA_ARGS__);        \
      case 32: return CM_LAUNCH(KERNEL, 32, 8, __VA_ARGS__);        \
    }                                                               \
    return (int)cudaErrorInvalidValue;                              \
  } while (0)

// The pointer arguments every kernel starts with.
#define CM_ROWS                                                      \
  (const int8_t*)s, (const int8_t*)t, (const int32_t*)n, (const int32_t*)m

}  // namespace

// Plain C interface (loaded with ctypes).  Pointers: s, t int8 [B, L];
// n, m (, wv) int32 [B]; out int32 [B, cols].  Each returns
// cudaGetLastError() right after its launch.
extern "C" {

int cm_xdrop(const void* s, const void* t, const void* n, const void* m,
             const void* wv, void* out, int B, int L, int w, int mat, int mis,
             int ind, int xd, void* stream) {
  (void)wv;
  CM_BAND_DISPATCH(xdrop_kernel, band_slots(w, false), B,
                   (cudaStream_t)stream, CM_ROWS, (int32_t*)out, B, L, w, mat,
                   mis, ind, xd);
}

int cm_edit_sc(const void* s, const void* t, const void* n, const void* m,
               const void* wv, void* out, int B, int L, int w, int max_ed,
               int max_sc, void* stream) {
  (void)wv;
  CM_BAND_DISPATCH(edit_sc_kernel, band_slots(w, false), B,
                   (cudaStream_t)stream, CM_ROWS, (int32_t*)out, B, L, w,
                   max_ed, max_sc);
}

int cm_edit_end(const void* s, const void* t, const void* n, const void* m,
                const void* wv, void* out, int B, int L, int w, int max_ed,
                void* stream) {
  (void)wv;
  CM_BAND_DISPATCH(edit_end_kernel, band_slots(w, false), B,
                   (cudaStream_t)stream, CM_ROWS, (int32_t*)out, B, L, w,
                   max_ed);
}

// w: a bound on every row's wv (the window is sized from it).
int cm_one_side(const void* s, const void* t, const void* n, const void* m,
                const void* wv, void* out, int B, int L, int w,
                void* stream) {
  CM_BAND_DISPATCH(one_side_kernel, band_slots(w, true), B,
                   (cudaStream_t)stream, CM_ROWS, (const int32_t*)wv,
                   (int32_t*)out, B, L, w);
}

// The CUDA runtime's text for an error code a cm_* function returned.
const char* cm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
