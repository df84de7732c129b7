// Per-cell prelude of the seed-chain DP, hand-written for Hopper (sm_90a).
//
//   cm_chain_cells  replaces the cell half of circminer_tpu/ops/chain.py::
//                   _chain_prelude (:355; XLA-lowered inside the
//                   reference's jitted step): per seed cell the near-border
//                   bit (annotation/device.py), the exon interval that
//                   holds it (the bisect at :380), the intronic bound, the
//                   exonic aggregates over the interval's segments that end
//                   at or after the k-mer's end (the two seg_compact forms
//                   at :407), and from them the cell's upper bound ub, its
//                   max exon end mee, e1 and its interval ol_iv (or -1).
//                   Its plain version is ops/chain_device.py::_chain_cells.
//
// Interface.  The chain's [B, NL, S] positions and [B, NL] counts and
// query offsets, [B] read lengths, the annotation's bitmap and interval
// tables as they are; out the row-major [B, M] cells (M = NL * S) that
// chain_dp takes: qposf, validf (one byte a cell), ub, mee, e1, ol_iv.
// posf is the positions themselves (a view, written by no one).
//
// Layout.  One thread a cell, cells in row-major order, so that a warp's
// positions and outputs are one contiguous run; the grid is sized in
// 64-bit cells (gpu-chain's buckets reach M = 7,500 a row).  The bisect is
// the reference's lower bound over iv_spos, run until it closes (the
// reference's fixed count of steps is at least as many, and a step after
// it closes changes nothing); the segments are read in place, row iv of
// seg_end / seg_next, only where the k-mer crosses its interval's end
// (need_rc), with the three aggregates in registers: no [B, M, P]
// temporary in either seg_compact form, so both are this one launch.
//
// What bounds it.  Its bytes: a position in and six words out a cell
// (~40 MB at chr21's 16,384 rows of M = 96), the small per-list inputs
// and the annotation's tables, which stay in L2.  The bisect's ~12
// dependent loads a cell are its latency; many warps a SM hide it.
//
// Parity.  Every sum is int32 with two's-complement wrap-around, composed
// in uint32; the sentinels are the reference's (INT32_MAX for no next
// interval, 10**9 for min_end with no segment selected, 0 for the maxima).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t I32MAX = 2147483647;
constexpr int32_t NO_SEG_END = 1000000000;  // min_end over no segment
constexpr int CELLS_THREADS = 256;

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}

__global__ void chain_cells_kernel(
    const int32_t* __restrict__ pos, const int32_t* __restrict__ cnt,
    const int32_t* __restrict__ qpos, const int32_t* __restrict__ seq_len,
    const uint8_t* __restrict__ nb_bits, const int32_t* __restrict__ iv_spos,
    const int32_t* __restrict__ iv_epos,
    const int32_t* __restrict__ iv_max_end,
    const int32_t* __restrict__ iv_min_end,
    const int32_t* __restrict__ iv_max_next,
    const int32_t* __restrict__ iv_nseg, const int32_t* __restrict__ seg_end,
    const int32_t* __restrict__ seg_next, int32_t* __restrict__ qposf,
    uint8_t* __restrict__ validf, int32_t* __restrict__ ub,
    int32_t* __restrict__ mee, int32_t* __restrict__ e1,
    int32_t* __restrict__ ol_iv, long long cells, int NL, int S,
    long long nb_last, int n_iv, int P, int seg_pad, int k, int max_ed) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cells) return;
  const int M = NL * S;
  const long long r = c / M;
  const int m = (int)(c - r * M);
  const int l = m / S;
  const long long rl = r * NL + l;
  const int32_t p = pos[c];
  const int32_t q = qpos[rl];
  const int32_t remain = wsub(wsub(seq_len[r], q), k);
  qposf[c] = q;
  validf[c] = (m - l * S) < cnt[rl];

  // the near-border bit at pos, clamped to the bitmap
  const long long pb = p < 0 ? 0 : (p > nb_last ? nb_last : p);
  const bool nb = (nb_bits[pb >> 3] >> (pb & 7)) & 1;

  // iv_raw = (# intervals with spos <= pos) - 1, in [-1, n_iv - 1]
  int lo = 0, hi = n_iv;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (iv_spos[mid] <= p)
      lo = mid + 1;
    else
      hi = mid;
  }
  const int iv_raw = lo - 1;
  const int iv = iv_raw < 0 ? 0 : iv_raw;
  const int32_t nseg = iv_nseg[iv];
  const bool found = iv_raw >= 0 && iv_epos[iv] >= p && nseg > 0;
  const int32_t epos = wadd(p, k - 1);

  // intronic: bound by the next interval's start
  const int32_t max_end_intr =
      lo < n_iv ? wsub(iv_spos[lo], 1) : I32MAX;  // lo = iv_raw + 1
  const int32_t far = wadd(wadd(p, remain), max_ed);
  int32_t ub_intr = 0;
  if (max_end_intr >= epos) {
    const int32_t cap = wadd(wsub(max_end_intr, k), 1);
    ub_intr = far < cap ? far : cap;
  }

  // exonic: the interval's aggregates, or those of its segments ending at
  // or after epos where the k-mer crosses the interval's end
  int32_t max_end, min_end, max_next;
  if (epos > iv_epos[iv]) {
    max_end = 0;
    min_end = NO_SEG_END;
    max_next = 0;
    const int n = nseg < seg_pad ? nseg : seg_pad;
    const int32_t* se = seg_end + (long long)iv * P;
    const int32_t* sn = seg_next + (long long)iv * P;
    for (int s = 0; s < n; ++s) {
      const int32_t e = se[s];
      if (e >= epos) {
        const int32_t x = sn[s];
        max_end = e > max_end ? e : max_end;
        min_end = e < min_end ? e : min_end;
        max_next = x > max_next ? x : max_next;
      }
    }
  } else {
    max_end = iv_max_end[iv];
    min_end = iv_min_end[iv];
    max_next = iv_max_next[iv];
  }
  const bool exonic = max_end > 0 && max_end >= epos;
  const int32_t ub_exon = (min_end < wadd(remain, epos) && max_next != 0)
                              ? wadd(max_next, k - 1)
                              : wadd(wsub(max_end, k), 1);

  int32_t u, x;
  if (!nb) {
    u = far;
    x = 0;
  } else if (found) {
    u = exonic ? ub_exon : 0;
    x = exonic ? max_end : 0;
  } else {
    u = ub_intr;
    x = max_end_intr;
  }
  ub[c] = u;
  mee[c] = x;
  e1[c] = epos;
  ol_iv[c] = (nb && found && exonic) ? iv : -1;
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns cudaGetLastError()
// right after the launch (0 and no launch for an empty batch;
// cudaErrorInvalidValue and no launch without an interval or a bitmap
// byte, or with seg_pad above the tables' P).
extern "C" int cm_chain_cells(const void* pos, const void* cnt,
                              const void* qpos, const void* seq_len,
                              const void* nb_bits, const void* iv_spos,
                              const void* iv_epos, const void* iv_max_end,
                              const void* iv_min_end, const void* iv_max_next,
                              const void* iv_nseg, const void* seg_end,
                              const void* seg_next, void* qposf, void* validf,
                              void* ub, void* mee, void* e1, void* ol_iv,
                              int B, int NL, int S, int n_nb, int n_iv, int P,
                              int seg_pad, int k, int max_ed, void* stream) {
  const long long cells = (long long)B * NL * S;
  if (cells <= 0) return 0;
  if (n_iv <= 0 || n_nb <= 0 || seg_pad > P)
    return (int)cudaErrorInvalidValue;
  const long long grid = (cells + CELLS_THREADS - 1) / CELLS_THREADS;
  chain_cells_kernel<<<(unsigned)grid, CELLS_THREADS, 0,
                       (cudaStream_t)stream>>>(
      (const int32_t*)pos, (const int32_t*)cnt, (const int32_t*)qpos,
      (const int32_t*)seq_len, (const uint8_t*)nb_bits,
      (const int32_t*)iv_spos, (const int32_t*)iv_epos,
      (const int32_t*)iv_max_end, (const int32_t*)iv_min_end,
      (const int32_t*)iv_max_next, (const int32_t*)iv_nseg,
      (const int32_t*)seg_end, (const int32_t*)seg_next, (int32_t*)qposf,
      (uint8_t*)validf, (int32_t*)ub, (int32_t*)mee, (int32_t*)e1,
      (int32_t*)ol_iv, cells, NL, S, (long long)n_nb * 8 - 1, n_iv, P,
      seg_pad, k, max_ed);
  return (int)cudaGetLastError();
}
