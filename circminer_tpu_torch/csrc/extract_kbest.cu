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
// Layout.  One warp a row, EX_WARPS rows a block, each warp with its own
// words of shared memory: the row's sort keys [M], the picks' heads,
// chain lengths and scores [iters], the walks' positions and query
// offsets [iters, NL], and the emitted picks [C].
//   - Order.  A cell's key (k1, k2) is k1 = -dp for an event cell (back
//     >= 0 and s < cnt; int32, so that -INT32_MIN wraps as in torch and
//     XLA), 2^29 otherwise, and k2 = its (list, index) order; k2 is
//     unique, so a cell's rank is the count of cells below it, exact
//     with no sorting network: each lane ranks its cells against the
//     row's keys, and a cell ranked below `iters` is that pick's head.
//   - Walks.  Picks t < min(iters, n_valid) only (later picks never reach
//     an output), one lane each: at most NL fragments, a chain ending at
//     the first back pointer below 0.
//   - Emission, serial over t as the reference's: pick t is skipped when
//     its score is below the row's best and its head position is a
//     non-head fragment of an emitted pick; the lanes test the emitted
//     picks' fragments (at most C (NL - 1)) and a ballot joins them.
//   - Assembly from the emitted picks, or the fallback (in-count cells,
//     lists desc, index asc, at most C), one lane a slot.
//
// What bounds it.  Its bytes: a row's scores, back pointers and small
// per-list inputs in, the positions its walks read, ~2 C NL words out
// (~21 MB at chr21's 16,384 rows of M = 96).  Its work is the rank (M^2
// compares a row, M = 96: 288 a lane) and the serial emission, whose
// steps each wait on a ballot; many rows a SM hide both.
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
constexpr int EX_SMEM_MAX = 48 * 1024;

// int32 words of shared memory a row (warp) takes
__host__ __device__ inline int ex_words(int NL, int S, int C, int T) {
  return NL * S + 3 * T + 2 * T * NL + C;
}

__global__ void extract_kbest_kernel(
    const int32_t* __restrict__ dp10, const int32_t* __restrict__ back,
    const int32_t* __restrict__ pos, const int32_t* __restrict__ qpos,
    const int32_t* __restrict__ cnt, int32_t* __restrict__ rpos,
    int32_t* __restrict__ qp, int32_t* __restrict__ clen,
    int32_t* __restrict__ sc10, int32_t* __restrict__ cn,
    uint8_t* __restrict__ incomplete, int R, int NL, int S, int C, int T) {
  extern __shared__ int32_t ex_smem[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long r = (long long)blockIdx.x * (blockDim.x >> 5) + w;
  if (r >= R) return;  // a warp leaves as a whole
  const int M = NL * S;
  int32_t* key = ex_smem + (long long)w * ex_words(NL, S, C, T);  // [M]
  int32_t* head = key + M;                                         // [T]
  int32_t* wlen = head + T;                                        // [T]
  int32_t* wsc = wlen + T;                                         // [T]
  int32_t* wpos = wsc + T;                                         // [T, NL]
  int32_t* wqp = wpos + T * NL;                                    // [T, NL]
  int32_t* emit = wqp + T * NL;                                    // [C]
  const int32_t* dpr = dp10 + r * M;
  const int32_t* bkr = back + r * M;
  const int32_t* psr = pos + r * M;
  const int32_t* qpr = qpos + r * NL;
  const int32_t* cnr = cnt + r * NL;

  // keys, the event count and the best event score
  int nv = 0;
  int32_t best = NEG;
  for (int m = lane; m < M; m += 32) {
    const int l = m / S;
    const int32_t d = dpr[m];
    const bool ev = (m - l * S) < cnr[l] && bkr[m] >= 0;
    key[m] = ev ? (int32_t)(0u - (uint32_t)d) : -NEG;
    nv += ev;
    best = ev && d > best ? d : best;
  }
  nv = __reduce_add_sync(FULL, nv);
  best = __reduce_max_sync(FULL, best);
  __syncwarp();

  // rank = cells with a smaller key1, or an equal key1 and a later list
  // or an earlier index in the same list
  for (int m = lane; m < M; m += 32) {
    const int lm = m / S, sm = m - lm * S;
    const int32_t km = key[m];
    int rank = 0;
    for (int l = 0, j = 0; l < NL; ++l)
      for (int s = 0; s < S; ++s, ++j) {
        const int32_t kj = key[j];
        rank += kj < km || (kj == km && (l > lm || (l == lm && s < sm)));
      }
    if (rank < T) head[rank] = m;
  }
  __syncwarp();

  // the walks of picks t < min(T, n_valid)
  const int nt = nv < T ? nv : T;
  for (int t = lane; t < nt; t += 32) {
    int cur = head[t];
    wsc[t] = dpr[cur];
    int f = 0;
    for (;;) {
      wpos[t * NL + f] = psr[cur];
      wqp[t * NL + f] = qpr[cur / S];
      if (++f == NL) break;
      const int nxt = bkr[cur];
      if (nxt < 0) break;
      cur = nxt;
    }
    wlen[t] = f;
  }
  __syncwarp();

  // serial emission with the repeat rule
  int ne = 0;
  const int nf = NL - 1;
  for (int t = 0; t < nt && ne < C; ++t) {
    bool rep = false;
    if (wsc[t] < best) {
      const int32_t hp = wpos[t * NL];
      for (int q = lane; q < ne * nf; q += 32) {
        const int c = q / nf, f = 1 + q - c * nf;
        const int e = emit[c];
        rep |= f < wlen[e] && wpos[e * NL + f] == hp;
      }
      rep = __any_sync(FULL, rep);
    }
    if (!rep) {
      if (lane == 0) emit[ne] = t;
      ++ne;
      __syncwarp();
    }
  }

  const long long o = r * C;
  if (ne > 0) {
    // slot c <- the c-th emitted pick
    for (int q = lane; q < C * NL; q += 32) {
      const int c = q / NL, f = q - c * NL;
      int32_t a = 0, b = 0;
      if (c < ne) {
        const int e = emit[c];
        if (f < wlen[e]) {
          a = wpos[e * NL + f];
          b = wqp[e * NL + f];
        }
      }
      rpos[o * NL + q] = a;
      qp[o * NL + q] = b;
    }
    for (int c = lane; c < C; c += 32) {
      clen[o + c] = c < ne ? wlen[emit[c]] : 0;
      sc10[o + c] = c < ne ? wsc[emit[c]] : 0;
    }
  } else {
    // fallback: slot c <- the c-th in-count cell, lists desc, index asc
    for (int c = lane; c < C; c += 32) {
      int m = -1;
      for (int l = NL - 1, left = c; l >= 0; --l) {
        const int n = cnr[l] < 0 ? 0 : (cnr[l] > S ? S : cnr[l]);
        if (left < n) {
          m = l * S + left;
          break;
        }
        left -= n;
      }
      for (int f = 0; f < NL; ++f) {
        rpos[(o + c) * NL + f] = (m >= 0 && f == 0) ? psr[m] : 0;
        qp[(o + c) * NL + f] = (m >= 0 && f == 0) ? qpr[m / S] : 0;
      }
      clen[o + c] = m >= 0;
      sc10[o + c] = m >= 0 ? dpr[m] : 0;
    }
  }
  if (lane == 0) {
    int n = ne;
    if (ne == 0) {
      for (int l = 0; l < NL; ++l)
        n += cnr[l] < 0 ? 0 : (cnr[l] > S ? S : cnr[l]);
      n = n < C ? n : C;
    }
    cn[r] = n;
    incomplete[r] = nv > T && ne < C;
  }
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns cudaGetLastError()
// right after the launch (0 and no launch for an empty batch;
// cudaErrorInvalidValue and no launch where M < iters or a row's words
// outgrow EX_SMEM_MAX).
extern "C" int cm_extract_kbest(const void* dp10, const void* back,
                                const void* pos, const void* qpos,
                                const void* cnt, void* rpos, void* qp,
                                void* clen, void* sc10, void* cn,
                                void* incomplete, int R, int NL, int S,
                                int C, int iters, void* stream) {
  if (R <= 0) return 0;
  const size_t row = 4 * (size_t)ex_words(NL, S, C, iters);
  if (NL <= 0 || S <= 0 || C < 0 || iters < 0 || NL * S < iters ||
      row > (size_t)EX_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  int nw = EX_WARPS;
  while (nw > 1 && nw * row > (size_t)EX_SMEM_MAX) --nw;
  const int grid = (R + nw - 1) / nw;
  extract_kbest_kernel<<<grid, nw * 32, nw * row, (cudaStream_t)stream>>>(
      (const int32_t*)dp10, (const int32_t*)back, (const int32_t*)pos,
      (const int32_t*)qpos, (const int32_t*)cnt, (int32_t*)rpos,
      (int32_t*)qp, (int32_t*)clen, (int32_t*)sc10, (int32_t*)cn,
      (uint8_t*)incomplete, R, NL, S, C, iters);
  return (int)cudaGetLastError();
}
