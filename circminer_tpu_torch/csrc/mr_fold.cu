// The pair steps of the mr fold, hand-written for Hopper (sm_90a).
//
//   cm_mr_pair_fold  replaces the pair_body fori_loop of
//                    circminer_tpu/ops/device_full.py::device_full_finish
//                    (:1510-1565): per read, for one orientation, P_MAX
//                    sequential applications of the category lattice
//                    (utils.cpp:157-320: concordant_explanation, then the
//                    chimeric, BSJ and double-BSJ checks, each a
//                    conditional best-mapping update, common.cpp:286-411)
//                    to the read's 20-field MatchedRead state, with the
//                    carries stopped, min1, min2, r1g, r2g and the calc_tlen
//                    defer.  Its plain version is
//                    ops/device_full.py::_mr_pair_fold_plain.
//
// Layout: one warp per block of RB = 32 reads, one thread per read; its
// state in registers, nothing crosses reads.  The per-pair fields
// (ops/device_full.py PAIR_KEYS, the enum below) come packed as int32
// [B, 2, P, NPF] for both orientations, and the orientation's own pair
// tables (the pair gate, the mapping type, the chromosome and its shift)
// as int32 [B, P, NOF].  A read's records of its orientation are
// contiguous (NPF * 4 = 144 bytes per step, a multiple of 16), so the warp
// stages the block's records of PC = 8 steps at a time into shared memory
// with 16-byte cp.async copies, coalesced read by read, then each thread
// runs the dependent chain of steps on shared memory: a step's 36 fields
// as nine 16-byte loads from its row, whose stride (REC = PC * NPF + 4
// words, 73 chunks of 16 bytes) is odd in chunks, so that the eight lanes
// of each quarter-warp phase hit distinct banks.  The mr states in and out
// (stride MRF = 20 words, 5 chunks) and the carries go through shared
// memory in coalesced passes too.
//
// What bounds it: latency.  A launch moves ~1.2 MB per 4,096 reads and
// does a few thousand integer operations per read, one dependent chain of
// P_MAX steps; at 4,096 reads the 128 blocks take 128 of 132 SMs.  It
// replaces ~1,000 small torch kernels per pair step.  Its tensors must
// start at 16-byte boundaries (fresh torch allocations do), or the launch
// is refused.
//
// Parity: every sum is int32 with two's-complement wrap-around, composed
// in uint32; the rules read the state that the rule before left, in the
// reference's order.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

// categories (config.py)
constexpr int CONCRD = 0;
constexpr int DISCRD = 1;
constexpr int CHIORF = 2;
constexpr int CHIBSJ = 3;
constexpr int CHI2BSJ = 4;
constexpr int CONGEN = 5;
constexpr int CONGNM = 7;
constexpr int CANDID = 9;
constexpr int ORPHAN = 11;
constexpr int MAXDISCRDTLEN = 20000;

// MatchedRead fields (ops/device_full.py MR_KEYS)
enum MrField {
  MR_TYPE, MR_SPOS_R1, MR_EPOS_R1, MR_QSPOS_R1, MR_QEPOS_R1, MR_MLEN_R1,
  MR_ED_R1, MR_R1_FWD, MR_SPOS_R2, MR_EPOS_R2, MR_QSPOS_R2, MR_QEPOS_R2,
  MR_MLEN_R2, MR_ED_R2, MR_R2_FWD, MR_TLEN, MR_JUNC, MR_GM, MR_CHR,
  MR_CONTIG, MRF
};
// fields of one mate's mapping (ops/device_full.py MM_USED)
enum MmField {
  MM_SPOS, MM_EPOS, MM_QSPOS, MM_QEPOS, MM_MLEN, MM_LED, MM_MED, MM_RED,
  MM_DIR, MM_TFINAL, MM_IV_S, MM_IV_E, MM_L_OK, MM_R_OK, NMM
};
// per-pair fields (ops/device_full.py PAIR_KEYS): the left and the right
// mapping, the pair-pure relations, success and fwd_left
enum PairField {
  PF_LMM = 0, PF_RMM = NMM, PF_SE = 2 * NMM, PF_SG_IV, PF_BSJ_HIT, PF_CT_TL,
  PF_CT_INN, PF_CT_DF, PF_SUCCESS, PF_FWD_LEFT, NPF
};
// per-orientation pair tables (ops/device_full.py ORIENT_KEYS)
enum OrientField { OR_ACT, OR_MP_TYPE, OR_CHR_IDX, OR_SHIFT, NOF };
// the carries out (ops/device_full.py FOLD_AUX)
enum AuxField { A_STOPPED, A_MIN1, A_MIN2, A_R1G, A_R2G, A_DEFER, NAUX };

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

struct Mm {
  int spos, epos, qspos, qepos, mlen, ed, dir, tfinal, iv_s, iv_e;
  bool l_ok, r_ok;
};

__device__ __forceinline__ Mm load_mm(const int32_t* f) {
  Mm m;
  m.spos = f[MM_SPOS];
  m.epos = f[MM_EPOS];
  m.qspos = f[MM_QSPOS];
  m.qepos = f[MM_QEPOS];
  m.mlen = f[MM_MLEN];
  m.ed = wadd(wadd(f[MM_LED], f[MM_MED]), f[MM_RED]);
  m.dir = f[MM_DIR];
  m.tfinal = f[MM_TFINAL];
  m.iv_s = f[MM_IV_S];
  m.iv_e = f[MM_IV_E];
  m.l_ok = f[MM_L_OK] != 0;
  m.r_ok = f[MM_R_OK] != 0;
  return m;
}

// The pair's context for every rule of one step.
struct Pair {
  Mm sm, lm;          // the left (lmm) and the right (rmm) mapping
  int chr, shift;
  bool r1_sm;         // sm is read 1's mapping
};

// go_for_update (common.cpp:362-411): mlen first, then ed, when type_ >=
// CHIBSJ; else ed, tlen, mlen; the gm win / lose gates first.
__device__ __forceinline__ bool go_for_update(const int* mr, const Pair& q,
                                              int tlen, bool gm, int type_) {
  const int ed = wadd(q.sm.ed, q.lm.ed);
  const int mlen = wadd(q.sm.mlen, q.lm.mlen);
  const int mr_ed = wadd(mr[MR_ED_R1], mr[MR_ED_R2]);
  const int mr_ml = wadd(mr[MR_MLEN_R1], mr[MR_MLEN_R2]);
  if (type_ < mr[MR_TYPE]) return true;
  if (type_ > mr[MR_TYPE]) return false;
  const bool mr_gm = mr[MR_GM] != 0;
  if (gm && !mr_gm) return true;
  if (!gm && mr_gm) return false;
  if (type_ >= CHIBSJ)
    return mr_ml < mlen || (!(mr_ml > mlen) && mr_ed > ed);
  return mr_ed > ed || (!(mr_ed < ed) && (
      mr[MR_TLEN] > tlen || (!(mr[MR_TLEN] < tlen) && mr_ml < mlen)));
}

// _mr_update (common.cpp:286-351): the conditional best-mapping update.
__device__ __forceinline__ void mr_update(int* mr, const Pair& q, int tlen,
                                          int jun, bool gm, int type_,
                                          int contig_num, bool apply) {
  if (!apply || !go_for_update(mr, q, tlen, gm, type_)) return;
  const Mm& a = q.r1_sm ? q.sm : q.lm;
  const Mm& b = q.r1_sm ? q.lm : q.sm;
  mr[MR_TYPE] = type_;
  mr[MR_CHR] = q.chr;
  mr[MR_SPOS_R1] = wsub(a.spos, q.shift);
  mr[MR_EPOS_R1] = wsub(a.epos, q.shift);
  mr[MR_QSPOS_R1] = a.qspos;
  mr[MR_QEPOS_R1] = a.qepos;
  mr[MR_MLEN_R1] = a.mlen;
  mr[MR_ED_R1] = a.ed;
  mr[MR_SPOS_R2] = wsub(b.spos, q.shift);
  mr[MR_EPOS_R2] = wsub(b.epos, q.shift);
  mr[MR_QSPOS_R2] = b.qspos;
  mr[MR_QEPOS_R2] = b.qepos;
  mr[MR_MLEN_R2] = b.mlen;
  mr[MR_ED_R2] = b.ed;
  mr[MR_R1_FWD] = a.dir > 0;
  mr[MR_R2_FWD] = b.dir > 0;
  mr[MR_TLEN] = tlen;
  mr[MR_JUNC] = jun;
  mr[MR_GM] = gm;
  mr[MR_CONTIG] = contig_num;
}

constexpr int RB = 32;              // reads per block: one warp
constexpr int PC = 8;               // pair steps staged at a time
constexpr int REC = PC * NPF + 4;   // words per read's staged records
constexpr int ORW = PC * NOF + 4;   // words per read's staged orient rows
static_assert(NPF % 4 == 0 && NOF == 4 && MRF % 4 == 0,
              "records, orient rows and states move in 16-byte chunks");
static_assert((REC / 4) % 2 == 1 && (ORW / 4) % 2 == 1 && (MRF / 4) % 2 == 1,
              "odd row strides in 16-byte chunks: no bank conflicts");

// 16 bytes from global to shared memory, asynchronously (cp.async).
__device__ __forceinline__ void cp16(int32_t* dst, const int32_t* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
#else
  memcpy(dst, src, 16);
#endif
}

// This thread's cp.async copies done; then the warp's, after __syncwarp.
__device__ __forceinline__ void cp_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
  __syncwarp();
}

// n int32 words (n % 4 == 0) from global to shared memory, by the warp.
__device__ __forceinline__ void stage(int32_t* dst, const int32_t* src,
                                      int n) {
  for (int x = 4 * (int)threadIdx.x; x < n; x += 4 * RB)
    cp16(dst + x, src + x);
}

// One warp: the P pair steps of one orientation of RB reads.
__global__ void __launch_bounds__(RB) mr_pair_fold_kernel(
    const int32_t* __restrict__ mr_in, const int32_t* __restrict__ pairs,
    const int32_t* __restrict__ o_t, const int32_t* __restrict__ orient,
    const uint8_t* __restrict__ live_in,
    const uint8_t* __restrict__ stopped_in, int32_t* __restrict__ mr_out,
    int32_t* __restrict__ aux, int B, int P, int max_tlen, int contig_num,
    int scan_level) {
  __shared__ __align__(16) int32_t rec_s[RB * REC];
  __shared__ __align__(16) int32_t or_s[RB * ORW];
  __shared__ __align__(16) int32_t mr_s[RB * MRF];
  __shared__ int32_t aux_s[RB * NAUX];
  __shared__ int32_t o_s[RB];
  const int lane = threadIdx.x;
  const int64_t rd0 = (int64_t)blockIdx.x * RB;
  const int n = (int)((int64_t)B - rd0 < RB ? (int64_t)B - rd0 : RB);
  const int64_t rd = rd0 + lane;
  const bool have = lane < n;
  stage(mr_s, mr_in + rd0 * MRF, n * MRF);
  const int o = have ? o_t[rd] : 0;
  o_s[lane] = o;
  const bool live = have && live_in[rd] != 0;
  bool stopped = have && stopped_in[rd] != 0;
  int mr[MRF];
  int min1 = ORPHAN, min2 = ORPHAN;
  bool r1g = false, r2g = false, defer_o = false;
  __syncwarp();
  for (int p0 = 0; p0 < P; p0 += PC) {
    const int pc = P - p0 < PC ? P - p0 : PC;
    const int nch = pc * NPF / 4;         // 16-byte chunks per read
    for (int x = lane; x < n * nch; x += RB) {
      const int rr = x / nch, cc = x - rr * nch;
      cp16(rec_s + rr * REC + 4 * cc,
           pairs + (((rd0 + rr) * 2 + o_s[rr]) * P + p0) * NPF + 4 * cc);
    }
    for (int x = lane; x < n * pc; x += RB) {
      const int rr = x / pc, cc = x - rr * pc;
      cp16(or_s + rr * ORW + 4 * cc,
           orient + ((rd0 + rr) * P + p0 + cc) * NOF);
    }
    cp_wait();
    if (p0 == 0 && have) {
#pragma unroll
      for (int c = 0; c < MRF / 4; ++c)
        *reinterpret_cast<int4*>(mr + 4 * c) =
            *reinterpret_cast<const int4*>(mr_s + lane * MRF + 4 * c);
    }
    for (int p = 0; p < pc && have; ++p) {
      int f[NPF];
#pragma unroll
      for (int c = 0; c < NPF / 4; ++c)
        *reinterpret_cast<int4*>(f + 4 * c) = *reinterpret_cast<const int4*>(
            rec_s + lane * REC + p * NPF + 4 * c);
      int q_o[NOF];
      *reinterpret_cast<int4*>(q_o) =
          *reinterpret_cast<const int4*>(or_s + lane * ORW + p * NOF);
      Pair q;
      q.sm = load_mm(f + PF_LMM);
      q.lm = load_mm(f + PF_RMM);
      q.chr = q_o[OR_CHR_IDX];
      q.shift = q_o[OR_SHIFT];
      const bool flp = f[PF_FWD_LEFT] != 0;
      q.r1_sm = flp == (o == 0);
      const bool pact = q_o[OR_ACT] != 0 && live && !stopped;
      const bool succ = pact && f[PF_SUCCESS] != 0;
      const int r1t = flp ? q.sm.tfinal : q.lm.tfinal;
      const int r2t = flp ? q.lm.tfinal : q.sm.tfinal;
      const bool cc = succ && flp && r1t == CONCRD && r2t == CONCRD;
      const bool bsj_m = succ && ((r1t == CANDID && r2t == CONCRD)
                                  || (r1t == CONCRD && r2t == CANDID));
      const bool b2_m = succ && r1t == CANDID && r2t == CANDID;
      const bool chim = succ && !flp && r1t == CONCRD && r2t == CONCRD;
      const Mm& sm = q.sm;
      const Mm& lm = q.lm;

      // concordant_explanation (utils.cpp:157-213)
      {
        const bool ok0 = cc && sm.spos <= lm.spos;
        const bool on_cdna = sm.iv_s >= 0 && sm.iv_e >= 0 && lm.iv_s >= 0
            && lm.iv_e >= 0;
        const int tlen_a = wadd(wadd(wsub(wsub(lm.spos, sm.epos), 1),
                                     lm.mlen), sm.mlen);
        const bool near = tlen_a <= max_tlen || tlen_a <= MAXDISCRDTLEN;
        const bool b1_no = sm.iv_s < 0 || lm.iv_s < 0;
        mr_update(mr, q, tlen_a, 0, false, CONGNM, contig_num,
                  ok0 && b1_no && near);
        const int tlen_b = wsub(wadd(lm.spos, lm.mlen), sm.spos);
        const int typ_b = q_o[OR_MP_TYPE] == 0 ? CONCRD : CONGEN;
        mr_update(mr, q, tlen_b, 0, on_cdna,
                  tlen_b <= max_tlen ? typ_b : DISCRD, contig_num,
                  ok0 && !b1_no && f[PF_SE] != 0);
        const bool b2_no = sm.iv_e < 0 || lm.iv_s < 0;
        mr_update(mr, q, tlen_a, 0, false, CONGNM, contig_num,
                  ok0 && b2_no && near);
        const int tl = f[PF_CT_TL], inn = f[PF_CT_INN];
        const bool u2b = ok0 && !b2_no;
        defer_o = defer_o || (cc && u2b && f[PF_CT_DF] != 0);
        const bool good = tl >= 0 && tl <= max_tlen;
        mr_update(mr, q, tl, inn, on_cdna, typ_b, contig_num, u2b && good);
        mr_update(mr, q, tl < 0 ? tlen_a : tl, tl < 0 ? 0 : inn, on_cdna,
                  DISCRD, contig_num, u2b && !good);
      }
      if (scan_level == 0) stopped = stopped || (cc && mr[MR_TYPE] == CONCRD);
      const int tl = wadd(wsub(lm.epos, sm.spos), 1);
      // _check_chimeric
      mr_update(mr, q, tl, 0, false, CHIORF, contig_num,
                chim && mr[MR_TYPE] != CONCRD && sm.iv_s >= 0
                && lm.iv_s >= 0 && f[PF_SG_IV] != 0 && sm.spos < lm.spos);
      // _check_bsj
      mr_update(mr, q, tl, 0, false, CHIBSJ, contig_num,
                bsj_m && mr[MR_TYPE] != CONCRD && mr[MR_TYPE] != DISCRD
                && sm.r_ok && lm.l_ok && f[PF_BSJ_HIT] != 0);
      // _check_2bsj
      mr_update(mr, q, tl, 0, false, CHI2BSJ, contig_num,
                b2_m && mr[MR_TYPE] >= CHI2BSJ && sm.spos <= lm.spos
                && !(sm.r_ok && lm.r_ok && sm.spos != lm.spos)
                && !(sm.l_ok && lm.l_ok && sm.epos != lm.epos)
                && !(sm.l_ok && lm.r_ok) && f[PF_BSJ_HIT] != 0);
      if (pact) {
        min1 = min(min1, r1t);
        min2 = min(min2, r2t);
        const bool on1 = (flp ? sm.iv_s : lm.iv_s) >= 0
            || (flp ? sm.iv_e : lm.iv_e) >= 0;
        const bool on2 = (flp ? lm.iv_s : sm.iv_s) >= 0
            || (flp ? lm.iv_e : sm.iv_e) >= 0;
        r1g = succ && on1;
        r2g = succ && on2;
      }
    }
    __syncwarp();     // the next steps overwrite the staged records
  }
  if (P <= 0) cp_wait();   // no step: the states pass through
  if (have) {
    if (P <= 0) {
#pragma unroll
      for (int f = 0; f < MRF; ++f) mr[f] = mr_s[lane * MRF + f];
    }
#pragma unroll
    for (int c = 0; c < MRF / 4; ++c)
      *reinterpret_cast<int4*>(mr_s + lane * MRF + 4 * c) =
          *reinterpret_cast<const int4*>(mr + 4 * c);
    int32_t* a = aux_s + lane * NAUX;
    a[A_STOPPED] = stopped;
    a[A_MIN1] = min1;
    a[A_MIN2] = min2;
    a[A_R1G] = r1g;
    a[A_R2G] = r2g;
    a[A_DEFER] = defer_o;
  }
  __syncwarp();
  for (int x = lane; x < n * MRF / 4; x += RB)
    *reinterpret_cast<int4*>(mr_out + rd0 * MRF + 4 * x) =
        *reinterpret_cast<const int4*>(mr_s + 4 * x);
  for (int x = lane; x < n * NAUX; x += RB) aux[rd0 * NAUX + x] = aux_s[x];
}

// mr_pair_fold_kernel over B reads; the launch's cudaGetLastError().
#define CM_FOLD_LAUNCH(grid, nt, stream, ...)                          \
  (mr_pair_fold_kernel<<<grid, nt, 0, stream>>>(__VA_ARGS__),          \
   (int)cudaGetLastError())

inline bool aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

}  // namespace

// Plain C interface (loaded with ctypes).  mr, mr_out: int32 [B, MRF];
// pairs: int32 [B, 2, P, NPF]; o_t: int32 [B]; orient: int32 [B, P, NOF];
// live, stopped: uint8 [B]; aux: int32 [B, NAUX].  Returns
// cudaGetLastError() right after the launch (0 and no launch for B = 0;
// cudaErrorMisalignedAddress and no launch if mr, pairs, orient or mr_out
// does not start at a 16-byte boundary).
extern "C" int cm_mr_pair_fold(const void* mr, const void* pairs,
                               const void* o_t, const void* orient,
                               const void* live, const void* stopped,
                               void* mr_out, void* aux, int B, int P,
                               int max_tlen, int contig_num, int scan_level,
                               void* stream) {
  if (B <= 0) return 0;
  if (!aligned16(mr) || !aligned16(pairs) || !aligned16(orient)
      || !aligned16(mr_out))
    return (int)cudaErrorMisalignedAddress;
  return CM_FOLD_LAUNCH(
      (B + RB - 1) / RB, RB, (cudaStream_t)stream, (const int32_t*)mr,
      (const int32_t*)pairs, (const int32_t*)o_t, (const int32_t*)orient,
      (const uint8_t*)live, (const uint8_t*)stopped, (int32_t*)mr_out,
      (int32_t*)aux, B, P, max_tlen, contig_num, scan_level);
}
