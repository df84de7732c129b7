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
//                ops/chain_device.py::_chain_dp_core_lanes.
//
// Layout.  A block holds R rows: R = 256 / S rows (1 from S = 256 up),
// fewer where their lists outgrow shared memory.  Thread x serves row
// x % R and the cells i = x / R, x / R + blockDim / R, ...  The rows'
// positions, valid bits and scores (M = NL * S cells each) are staged in
// shared memory; the row-major [b, M] inputs are read there and the scores
// written back in one coalesced pass each.  Per list l a thread loads its
// cell's bounds and junction table (P <= 16: into registers) if the cell
// is valid, then walks every target (j > l, t < S): the maxIntron minimum
// over list j, the gates, the junction scan, the candidate and the running
// first maximum; it writes its cell's score and backpointer, and a barrier
// separates the lists (list l - 1 reads list l's scores).  The junction
// tables are read in the [b, M, P] order the prelude's gathers produce
// them, a cell's P segments contiguous, so that no caller copies them.
//
// What bounds it: operations.  It reads a cell's bounds and segments only
// where the cell is valid (sep where pv is set, snp where e12end >= 0 too),
// and at chr21's main shape (b = 16,384, NL = 6, S = P = 16) few cells
// are, so its bytes are those of the [b, M] positions, valid bits and
// outputs (~22 MB, ~0.007 ms at 3.35 TB/s), while each (row, cell, list
// pair) walks S targets of ~20 integer operations, and the junction scan
// (up to P steps) runs only where the gap gate failed.  The design skips
// only work whose result cannot matter: the junction scan where the cell
// is invalid, the target fails the base gates or the gap gate already
// passed, and the scan's later segments once one accepted.  Invalid cells
// are not skipped: their candidates (NEG + a later score) can still beat
// the running best, as in the reference.
//
// Parity.  Every value is int32 with the reference's two's-complement
// wrap-around, composed in uint32 (wadd, wsub, wabs: |INT_MIN| = INT_MIN as
// in torch and XLA).  The first maximum is the reference's three rules in
// one running strict ">" over (j, t) in order: the smallest t among equal
// candidates of a list, the earliest list j among equal list maxima, and
// the cell's own score kept on a tie.

#include <cuda_runtime.h>
#include <stdint.h>

extern __shared__ __align__(16) unsigned char cm_chain_smem[];

namespace {

constexpr int NEG = -(1 << 29);       // ops/chain_device.py _NEG
constexpr int I32MAX = 0x7fffffff;
constexpr int P_REG = 16;             // P up to this: tables in registers
constexpr int NT_MAX = 512;           // threads per block at most
constexpr int NT_ROWS = 256;          // R = NT_ROWS / S rows per block
constexpr int SMEM_MAX = 232448;      // dynamic shared memory of one block

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wabs(int a) {
  return a < 0 ? (int)(0u - (unsigned)a) : a;
}

// Shared-memory bytes of one row: scores and positions (int32 [M]), the
// lists' query offsets (int32 [NL]) and valid bits (uint8 [M]).
inline size_t row_bytes(int NL, int S) {
  const size_t M = (size_t)NL * S;
  return 8 * M + 4 * (size_t)NL + M;
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

// posf, qposf, ub, mee, e1: int32 [b, M]; validf: uint8 [b, M]; sep, snp:
// int32 [b, M, P]; pv: uint8 [b, M, P]; dp, back: int32 [b, NL, S].
template <bool REG>
__global__ void __launch_bounds__(NT_MAX) chain_dp_kernel(
    const int32_t* __restrict__ posf, const int32_t* __restrict__ qposf,
    const uint8_t* __restrict__ validf, const int32_t* __restrict__ ub,
    const int32_t* __restrict__ mee, const int32_t* __restrict__ e1,
    const int32_t* __restrict__ sep, const int32_t* __restrict__ snp,
    const uint8_t* __restrict__ pv, int32_t* __restrict__ dp,
    int32_t* __restrict__ back, int b, int NL, int S, int P, int R, int k,
    int max_ed, int max_intron) {
  const int M = NL * S;
  int32_t* dp_s = reinterpret_cast<int32_t*>(cm_chain_smem);
  int32_t* pos_s = dp_s + (size_t)R * M;
  int32_t* qp_s = pos_s + (size_t)R * M;
  uint8_t* v_s = reinterpret_cast<uint8_t*>(qp_s + (size_t)R * NL);
  const int64_t row0 = (int64_t)blockIdx.x * R;
  const int nrows = (int)((int64_t)b - row0 < R ? (int64_t)b - row0 : R);
  const int64_t base = row0 * M;
  for (int x = threadIdx.x; x < nrows * M; x += blockDim.x) {
    const bool v = validf[base + x] != 0;
    pos_s[x] = posf[base + x];
    v_s[x] = v;
    dp_s[x] = v ? 10 * k : NEG;
  }
  for (int x = threadIdx.x; x < nrows * NL; x += blockDim.x)
    qp_s[x] = qposf[(row0 + x / NL) * M + (int64_t)(x % NL) * S];
  __syncthreads();

  const int r = threadIdx.x % R;
  const int per_pass = blockDim.x / R;
  const bool has_row = r < nrows && (int)threadIdx.x < R * per_pass;
  const int64_t row = row0 + r;
  const int alpha10 = (int)(200000u * (unsigned)k);
  const int32_t* prow = pos_s + (size_t)r * M;
  const uint8_t* vrow = v_s + (size_t)r * M;
  int32_t* dprow = dp_s + (size_t)r * M;
  if (has_row)
    for (int i = threadIdx.x / R; i < S; i += per_pass)
      back[row * M + (int64_t)(NL - 1) * S + i] = -1;

  for (int l = NL - 2; l >= 0; --l) {
    if (has_row) {
      for (int i = threadIdx.x / R; i < S; i += per_pass) {
        const int c = l * S + i;
        const int64_t g = row * M + c;
        const int pi = prow[c];
        const bool v_l = vrow[c] != 0;
        int ub_l = 0, mee_l = 0, e1_l = 0;   // read by valid cells only
        if (v_l) {
          ub_l = ub[g];
          mee_l = mee[g];
          e1_l = e1[g];
        }
        const int qp_l = qp_s[r * NL + l];
        const int64_t jt = g * P;                     // [row, c, 0]
        int e12[REG ? P_REG : 1], sn[REG ? P_REG : 1];
        unsigned pvm = 0;
        if constexpr (REG) {
#pragma unroll
          for (int p = 0; p < P_REG; ++p) {
            e12[p] = 0;
            sn[p] = 0;
            if (v_l && p < P && pv[jt + p]) {
              const int e = wsub(sep[jt + p], e1_l);
              if (e >= 0) {
                e12[p] = e;
                sn[p] = snp[jt + p];
                pvm |= 1u << p;
              }
            }
          }
        }
        int best_v = NEG, best_i = -1;
        for (int j = l + 1; j < NL; ++j) {
          const int32_t* pj = prow + j * S;
          const int32_t* dj = dprow + j * S;
          const uint8_t* vj = vrow + j * S;
          const int rd = wsub(wsub(qp_s[r * NL + j], qp_l), k);
          // v_l and the maxIntron rule (chain.cpp:148-150): the nearest
          // target beyond pi, over every cell of list j
          bool gate = false;
          if (v_l) {
            int minpos = I32MAX;
            for (int t = 0; t < S; ++t) {
              const int x = pj[t];
              if (x > pi && x < minpos) minpos = x;
            }
            gate = minpos <= wadd(pi, max_intron);
          }
          for (int t = 0; t < S; ++t) {
            const int pjv = pj[t];
            int sc = NEG;
            if (gate && vj[t] && pjv > pi && pjv <= ub_l) {
              const int gd = wsub(wsub(pjv, pi), k);
              const bool g_ok = (mee_l == 0 || wadd(pjv, k - 1) <= mee_l)
                  && wabs(wsub(gd, rd)) <= max_ed;
              if (g_ok) {
                sc = wsub(alpha10, wabs(wsub(gd, rd)));
              } else if (pjv > e1_l) {
                bool jn_ok = false, intron = false;
                int jn_dist = 0;
                if constexpr (REG) {
#pragma unroll
                  for (int p = 0; p < P_REG; ++p)
                    if (!jn_ok && ((pvm >> p) & 1u))
                      junction_step(e12[p], sn[p], pjv, rd, k, max_ed,
                                    jn_ok, jn_dist, intron);
                } else {
                  for (int p = 0; p < P && !jn_ok; ++p) {
                    if (!pv[jt + p]) continue;
                    const int e = wsub(sep[jt + p], e1_l);
                    if (e >= 0)
                      junction_step(e, snp[jt + p], pjv, rd, k, max_ed,
                                    jn_ok, jn_dist, intron);
                  }
                }
                if (jn_ok || intron)
                  sc = wsub(alpha10, wabs(wsub(
                      jn_ok ? jn_dist : wsub(wsub(pjv, e1_l), 1), rd)));
              }
            }
            const int cand = wadd(sc, dj[t]);
            if (cand > best_v) {
              best_v = cand;
              best_i = j * S + t;
            }
          }
        }
        const bool improve = best_v > dprow[c];
        if (improve) dprow[c] = best_v;
        back[g] = improve ? best_i : -1;
      }
    }
    __syncthreads();
  }
  for (int x = threadIdx.x; x < nrows * M; x += blockDim.x)
    dp[base + x] = dp_s[x];
}

// chain_dp_kernel<REG> over b rows, R per block, with `smem` bytes of
// dynamic shared memory; the launch's cudaGetLastError().
#define CM_CHAIN_LAUNCH(REG, grid, nt, smem, stream, ...)                \
  (chain_dp_kernel<REG><<<grid, nt, smem, stream>>>(__VA_ARGS__),        \
   (int)cudaGetLastError())

template <bool REG>
int launch_chain_dp(const void* posf, const void* qposf, const void* validf,
                    const void* ub, const void* mee, const void* e1,
                    const void* sep, const void* snp, const void* pv,
                    void* dp, void* back, int b, int NL, int S, int P, int k,
                    int max_ed, int max_intron, cudaStream_t stream) {
  const size_t per_row = row_bytes(NL, S);
  if (per_row > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  int R = S >= NT_ROWS ? 1 : NT_ROWS / S;
  if ((size_t)R * per_row > (size_t)SMEM_MAX)
    R = (int)((size_t)SMEM_MAX / per_row);
  if (R > b) R = b;
  const int nt = R * S >= NT_MAX ? NT_MAX : (R * S + 31) / 32 * 32;
  const size_t smem = (size_t)R * per_row;
  static bool wide = false;   // the opt-in above 48 KB, once per kernel
  if (smem > 48 * 1024 && !wide) {
    const cudaError_t e = cudaFuncSetAttribute(
        chain_dp_kernel<REG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    wide = true;
  }
  const int grid = (b + R - 1) / R;
  return CM_CHAIN_LAUNCH(
      REG, grid, nt, smem, stream, (const int32_t*)posf,
      (const int32_t*)qposf, (const uint8_t*)validf, (const int32_t*)ub,
      (const int32_t*)mee, (const int32_t*)e1, (const int32_t*)sep,
      (const int32_t*)snp, (const uint8_t*)pv, (int32_t*)dp,
      (int32_t*)back, b, NL, S, P, R, k, max_ed, max_intron);
}

}  // namespace

// Plain C interface (loaded with ctypes); returns cudaGetLastError() right
// after the launch (0 and no launch for an empty batch).
extern "C" int cm_chain_dp(const void* posf, const void* qposf,
                           const void* validf, const void* ub,
                           const void* mee, const void* e1, const void* sep,
                           const void* snp, const void* pv, void* dp,
                           void* back, int b, int NL, int S, int P, int k,
                           int max_ed, int max_intron, void* stream) {
  if (b <= 0 || NL <= 0 || S <= 0) return 0;
  if (P <= P_REG)
    return launch_chain_dp<true>(posf, qposf, validf, ub, mee, e1, sep, snp,
                                 pv, dp, back, b, NL, S, P, k, max_ed,
                                 max_intron, (cudaStream_t)stream);
  return launch_chain_dp<false>(posf, qposf, validf, ub, mee, e1, sep, snp,
                                pv, dp, back, b, NL, S, P, k, max_ed,
                                max_intron, (cudaStream_t)stream);
}
