// k-best chain extraction from the chain DP, hand-written for Hopper
// (sm_90a).
//
//   cm_extract_kbest  replaces circminer_tpu/ops/device_finish.py::
//                     extract_kbest_device_staged (:58; XLA-lowered inside
//                     the reference's jitted step): per row the two-key
//                     lax.sort of its M = NL * S cells (:84; score desc for
//                     event cells, list desc, index asc), the back-pointer
//                     walks of the first `iters` picks, the pick_body
//                     fori_loop (:144, :158) that emits up to C chains with
//                     the repeat rule, their assembly, and the
//                     single-fragment fallback of a row that emitted none.
//                     Its plain version is ops/device_finish.py::
//                     extract_kbest_device_staged (upto="full").
//
// Interface.  The [R, NL, S] scores, back pointers and positions of
// chain_dp, the [R, NL] query offsets and counts; out rpos, qp [R, C, NL],
// clen, sc10 [R, C], cn [R] and incomplete [R] (one byte a row), zeroed
// past a row's count.
//
// Layout.  One warp a row; a persistent grid (the card's SMs times the
// blocks of EX_WARPS warps resident on each), each warp striding over the
// rows.  A warp's words of shared memory (ex_words): the row's event
// cells' sort keys [M] (64 bits), the picks' blocking masks [iters] (64
// bits, where iters <= 64), the walks' cells [iters, NL], lengths, scores
// and head positions [iters] and the emitted picks [C]; then, where they
// fit the block's opted-in shared memory, the row's back pointers and
// positions [M] each (ex_stage_words; else the walks read device memory).
//   - One coalesced pass over the row: each cell's list (a multiply by
//     the host's 2^32 / S, no division), its event bit (back >= 0 and
//     s < cnt), its key k1 = -dp for an event (int32, so that -INT32_MIN
//     wraps as in torch and XLA) or 2^29 and the row's best event score;
//     it keeps the back pointers and positions in shared memory.  A
//     ballot and a prefix popc compact the event keys in cell order: key
//     = (k1, (list desc, index asc) << 16 | cell), unique per cell.
//   - Ranks.  Where every event key is below 2^29 (one __any_sync) the
//     events hold ranks 0 .. n_valid - 1 ahead of every other cell, so
//     they are ranked among themselves (n_valid^2 compares, not M^2);
//     else every cell's key is written and ranked against every other.
//     A cell ranked below `iters` is that pick's head.
//   - Walks of picks u < min(iters, n_valid) only (later picks never
//     reach an output), one lane each, through the staged back pointers:
//     at most NL fragments, a chain ending at the first back pointer
//     below 0.  On its way lane u builds blocks[u]: the later picks t
//     whose head position one of u's non-head fragments holds and whose
//     score is below the row's best (the best score is exempt).
//   - Emission, serial over t as the reference's, on registers: every
//     lane alike jumps to the next pick that no emitted pick blocks (a
//     find-first-set), emits it and ORs in its mask, up to C.  Above 64
//     picks the lanes test the emitted picks' fragments at each step and
//     a ballot joins them.
//   - Assembly from the emitted picks, or the fallback (in-count cells,
//     lists desc, index asc, at most C), one lane a slot.
//
// What bounds it.  Its bytes: a row's scores, back pointers, positions
// and small per-list inputs in, ~2 C NL words out (~21 MB at chr21's
// 16,384 rows of M = 96).  Its time goes to the row's short dependent
// chains in shared memory (ranks, walks, emission, assembly), a few
// hundred instructions a row on mostly idle lanes; the grid keeps as
// many warps resident as registers allow to overlap them.
//
// Parity.  Bit for bit the plain version: incomplete = (n_valid > iters)
// & (cn < C) with the count before the fallback, the best-score exception
// to the repeat rule, zeroed slots past cn.  Every output is a value
// copied from the inputs, so no sum can wrap.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t NEG = -(1 << 29);
constexpr unsigned FULL = 0xffffffffu;
constexpr int EX_WARPS = 4;
constexpr int EX_SMEM_MAX = 232448;  // a block's shared memory, opted into
constexpr int EX_MASK_T = 64;        // the most picks a mask holds

// int32 words of shared memory a row (warp) needs: keys 2 [M], blocking
// masks 2 [iters] where iters <= EX_MASK_T, walk cells [iters, NL],
// lengths, scores and head positions [iters], emitted picks [C]; even,
// so that every warp's keys are 8-byte aligned
__host__ __device__ inline int ex_words(int NL, int S, int C, int T) {
  return (2 * NL * S + 2 * T * (T <= 64) + T * NL + 3 * T + C + 1) & ~1;
}

// and, where they fit, the row's back pointers and positions [M] each
__host__ __device__ inline int ex_stage_words(int NL, int S) {
  return 2 * NL * S;
}

// a cell's sort key: its int32 key k1 (flipped to an unsigned order), then
// (list desc, index asc) and the cell, 16 bits each: unique per cell
__device__ __forceinline__ uint64_t cell_key(int32_t k1, int l, int s, int m,
                                             int NL, int S) {
  return (uint64_t)((uint32_t)k1 ^ 0x80000000u) << 32 |
         (uint32_t)((NL - 1 - l) * S + s) << 16 | (uint32_t)m;
}

template <bool STAGED>
__global__ void __launch_bounds__(EX_WARPS * 32) extract_kbest_kernel(
    const int32_t* __restrict__ dp10, const int32_t* __restrict__ back,
    const int32_t* __restrict__ pos, const int32_t* __restrict__ qpos,
    const int32_t* __restrict__ cnt, int32_t* __restrict__ rpos,
    int32_t* __restrict__ qp, int32_t* __restrict__ clen,
    int32_t* __restrict__ sc10, int32_t* __restrict__ cn,
    uint8_t* __restrict__ incomplete, int R, int NL, int S, int C, int T,
    unsigned magic, int words) {
  extern __shared__ __align__(8) int32_t ex_smem[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int M = NL * S;
  const bool masks = T <= EX_MASK_T;
  int32_t* mine = ex_smem + w * words;
  uint64_t* key = reinterpret_cast<uint64_t*>(mine);           // [M]
  uint64_t* blocks = key + M;                                  // [T]
  int32_t* wcell = reinterpret_cast<int32_t*>(blocks + (masks ? T : 0));
  int32_t* wlen = wcell + T * NL;                              // [T]
  int32_t* wsc = wlen + T;                                     // [T]
  int32_t* hp = wsc + T;                                       // [T]
  int32_t* emit = hp + T;                                      // [C]
  int32_t* sback = mine + ex_words(NL, S, C, T);                // [M]
  int32_t* spos = sback + M;                                   // [M]
  const unsigned before_me = (1u << lane) - 1u;
  // a cell's list: m * ceil(2^32 / S) >> 32 is m / S for m * S < 2^32
  auto list_of = [&](int m) {
    return S == 1 ? m : (int)__umulhi((unsigned)m, magic);
  };
  // the assembly's slot and fragment of word q = lane + 32 i, stepped
  const int c0 = lane / NL, f0 = lane - c0 * NL;
  const int dc = 32 / NL, df = 32 - dc * NL;

  for (long long r = (long long)blockIdx.x * nw + w; r < R;
       r += (long long)gridDim.x * nw) {
    const int32_t* dpr = dp10 + r * M;
    const int32_t* qpr = qpos + r * NL;
    const int32_t* cnr = cnt + r * NL;
    // the walks' back pointers and positions: staged by the first pass
    const int32_t* bkr = STAGED ? sback : back + r * M;
    const int32_t* psr = STAGED ? spos : pos + r * M;

    // the event cells' keys, compacted in cell order by a ballot
    int nv = 0;
    int32_t best = NEG;
    bool late = false;  // an event key at or past the other cells' 2^29
    for (int m0 = 0; m0 < M; m0 += 32) {
      const int m = m0 + lane;
      bool ev = false;
      int32_t k1 = 0;
      int l = 0, s = 0;
      if (m < M) {
        l = list_of(m);
        s = m - l * S;
        const int32_t d = dpr[m], b = back[r * M + m];
        if (STAGED) {
          sback[m] = b;
          spos[m] = pos[r * M + m];
        }
        ev = s < cnr[l] && b >= 0;
        k1 = (int32_t)(0u - (uint32_t)d);
        late |= ev && k1 >= -NEG;
        best = ev && d > best ? d : best;
      }
      const unsigned evs = __ballot_sync(FULL, ev);
      if (ev)
        key[nv + __popc(evs & before_me)] = cell_key(k1, l, s, m, NL, S);
      nv += __popc(evs);
    }
    best = __reduce_max_sync(FULL, best);
    const bool fast = !__any_sync(FULL, late);
    if (!fast) {  // every cell's key, in cell order
      __syncwarp();
      for (int m = lane; m < M; m += 32) {
        const int l = list_of(m), s = m - l * S;
        const bool ev = s < cnr[l] && back[r * M + m] >= 0;
        key[m] = cell_key(ev ? (int32_t)(0u - (uint32_t)dpr[m]) : -NEG, l,
                          s, m, NL, S);
      }
    }
    __syncwarp();

    // rank = keys below; fast: among the events, else among all cells
    const int n = fast ? nv : M;
    for (int i = lane; i < n; i += 32) {
      const uint64_t ki = key[i];
      int rank = 0;
#pragma unroll 4
      for (int j = 0; j < n; ++j) rank += key[j] < ki;
      if (rank < T) {
        const int m = (int)(ki & 0xffffu);
        wcell[rank * NL] = m;
        wsc[rank] = dpr[m];
        hp[rank] = psr[m];
      }
    }
    __syncwarp();

    // the walks of picks u < min(T, n_valid), one lane each; with the
    // masks, lane u also marks the later picks t whose head position one
    // of its non-head fragments holds and whose score is below the best
    // (the picks that u, once emitted, blocks)
    const int nt = nv < T ? nv : T;
    uint64_t below = 0;
    if (masks) {
      const bool b0 = lane < nt && wsc[lane] < best;
      const bool b1 = lane + 32 < nt && wsc[lane + 32] < best;
      below = (uint64_t)__ballot_sync(FULL, b1) << 32 |
              __ballot_sync(FULL, b0);
    }
    for (int u = lane; u < nt; u += 32) {
      int32_t* wc = wcell + u * NL;
      int cur = wc[0], f = 1;
      uint64_t hit = 0;
      for (; f < NL; ++f) {
        const int nxt = bkr[cur];
        if (nxt < 0) break;
        cur = nxt;
        wc[f] = cur;
        if (masks) {
          const int32_t p = psr[cur];
          for (int t = u + 1; t < nt; ++t)
            hit |= (uint64_t)(hp[t] == p) << t;
        }
      }
      wlen[u] = f;
      if (masks) blocks[u] = hit & below;
    }
    __syncwarp();

    // serial emission with the repeat rule
    int ne = 0;
    if (masks) {
      // every lane alike: the next pick that no emitted pick blocks
      const uint64_t picks = nt == 64 ? ~0ull : (1ull << nt) - 1;
      uint64_t blocked = 0;
      for (int t = 0; ne < C && t < nt; ++t) {
        const uint64_t open = picks & ~blocked & (~0ull << t);
        if (!open) break;
        t = __ffsll((long long)open) - 1;
        if (lane == 0) emit[ne] = t;
        ++ne;
        blocked |= blocks[t];
      }
    } else {
      const int nf = NL - 1;
      for (int t = 0; t < nt && ne < C; ++t) {
        bool rep = false;
        if (wsc[t] < best) {
          const int32_t hpt = hp[t];
          for (int q = lane; q < ne * nf; q += 32) {
            const int c = q / nf, f = 1 + q - c * nf;
            const int e = emit[c];
            rep |= f < wlen[e] && psr[wcell[e * NL + f]] == hpt;
          }
          rep = __any_sync(FULL, rep);
        }
        if (!rep) {
          if (lane == 0) emit[ne] = t;
          ++ne;
          __syncwarp();
        }
      }
    }
    __syncwarp();

    const long long o = r * C;
    if (ne > 0) {
      // slot c <- the c-th emitted pick
      for (int q = lane, c = c0, f = f0; q < C * NL; q += 32) {
        int32_t a = 0, v = 0;
        if (c < ne) {
          const int e = emit[c];
          if (f < wlen[e]) {
            const int cell = wcell[e * NL + f];
            a = psr[cell];
            v = qpr[list_of(cell)];
          }
        }
        rpos[o * NL + q] = a;
        qp[o * NL + q] = v;
        c += dc;
        f += df;
        if (f >= NL) {
          f -= NL;
          ++c;
        }
      }
      for (int c = lane; c < C; c += 32) {
        clen[o + c] = c < ne ? wlen[emit[c]] : 0;
        sc10[o + c] = c < ne ? wsc[emit[c]] : 0;
      }
    } else {
      // fallback: slot c <- the c-th in-count cell, lists desc, index asc
      for (int c = lane; c < C; c += 32) {
        int m = -1, lm = 0;
        for (int l = NL - 1, left = c; l >= 0; --l) {
          const int k = cnr[l] < 0 ? 0 : (cnr[l] > S ? S : cnr[l]);
          if (left < k) {
            m = l * S + left;
            lm = l;
            break;
          }
          left -= k;
        }
        for (int f = 0; f < NL; ++f) {
          rpos[(o + c) * NL + f] = (m >= 0 && f == 0) ? psr[m] : 0;
          qp[(o + c) * NL + f] = (m >= 0 && f == 0) ? qpr[lm] : 0;
        }
        clen[o + c] = m >= 0;
        sc10[o + c] = m >= 0 ? dpr[m] : 0;
      }
    }
    if (lane == 0) {
      int k = ne;
      if (ne == 0) {
        for (int l = 0; l < NL; ++l)
          k += cnr[l] < 0 ? 0 : (cnr[l] > S ? S : cnr[l]);
        k = k < C ? k : C;
      }
      cn[r] = k;
      incomplete[r] = nv > T && ne < C;
    }
    __syncwarp();  // the next row reuses the warp's words
  }
}

// The persistent grid's cap for kernel at nt threads and smem bytes a
// block: the SMs times the blocks resident on each, after the opt-in to
// EX_SMEM_MAX (the first, eager launch of a shape makes it, before any
// graph capture).  The last answer is kept.
template <bool STAGED>
cudaError_t ex_grid_cap(int nt, size_t smem, int* cap) {
  static int dev_c = -1, smem_c = -1, cap_c = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev != dev_c || (int)smem != smem_c) {
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(extract_kbest_kernel<STAGED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               EX_SMEM_MAX);
      if (e != cudaSuccess) return e;
    }
    int sms = 0, per = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, extract_kbest_kernel<STAGED>, nt, smem);
    if (e != cudaSuccess) return e;
    dev_c = dev;
    smem_c = (int)smem;
    cap_c = sms * (per > 0 ? per : 1);
  }
  *cap = cap_c;
  return cudaSuccess;
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns cudaGetLastError()
// right after the launch (0 and no launch for an empty batch;
// cudaErrorInvalidValue and no launch where M < iters or a row's words
// (ex_words) outgrow EX_SMEM_MAX, which also keeps M below 2^16, the
// keys' cell field).
extern "C" int cm_extract_kbest(const void* dp10, const void* back,
                                const void* pos, const void* qpos,
                                const void* cnt, void* rpos, void* qp,
                                void* clen, void* sc10, void* cn,
                                void* incomplete, int R, int NL, int S,
                                int C, int iters, void* stream) {
  if (R <= 0) return 0;
  if (NL <= 0 || S <= 0 || C < 0 || iters < 0 ||
      (long long)NL * S > 0xffff || NL * S < iters)
    return (int)cudaErrorInvalidValue;
  const size_t need = 4 * (size_t)ex_words(NL, S, C, iters);
  if (need > (size_t)EX_SMEM_MAX) return (int)cudaErrorInvalidValue;
  // the staged row where it fits: the walks then read shared memory
  const size_t with_row = need + 4 * (size_t)ex_stage_words(NL, S);
  const bool staged = with_row <= (size_t)EX_SMEM_MAX;
  const size_t row = staged ? with_row : need;
  int nw = EX_WARPS;
  while (nw > 1 && nw * row > (size_t)EX_SMEM_MAX) --nw;
  const size_t smem = nw * row;
  int cap = 0;
  const cudaError_t e = staged ? ex_grid_cap<true>(nw * 32, smem, &cap)
                               : ex_grid_cap<false>(nw * 32, smem, &cap);
  if (e != cudaSuccess) return (int)e;
  const int rows_grid = (R + nw - 1) / nw;
  const int grid = rows_grid < cap ? rows_grid : cap;
  const unsigned magic = S > 1 ? 0xffffffffu / (unsigned)S + 1u : 0u;
  const int words = (int)(row / 4);
  const cudaStream_t st = (cudaStream_t)stream;
  if (staged)
    extract_kbest_kernel<true><<<grid, nw * 32, smem, st>>>(
        (const int32_t*)dp10, (const int32_t*)back, (const int32_t*)pos,
        (const int32_t*)qpos, (const int32_t*)cnt, (int32_t*)rpos,
        (int32_t*)qp, (int32_t*)clen, (int32_t*)sc10, (int32_t*)cn,
        (uint8_t*)incomplete, R, NL, S, C, iters, magic, words);
  else
    extract_kbest_kernel<false><<<grid, nw * 32, smem, st>>>(
        (const int32_t*)dp10, (const int32_t*)back, (const int32_t*)pos,
        (const int32_t*)qpos, (const int32_t*)cnt, (int32_t*)rpos,
        (int32_t*)qp, (int32_t*)clen, (int32_t*)sc10, (int32_t*)cn,
        (uint8_t*)incomplete, R, NL, S, C, iters, magic, words);
  return (int)cudaGetLastError();
}
