// Phase 2's extend wrap-up, hand-written for Hopper (sm_90a).
//
//   cm_extend_core      replaces circminer_tpu/ops/device_full.py::
//                       _extend_core (:214, flat :327; XLA-lowered inside
//                       the reference's jitted step) where phase 2's
//                       run_side calls it (:1060-1085): one extend family
//                       of the [B, 2, P] pair slots, the wrap-up of
//                       extend.cpp:285-432 over the walk engine's fold.
//   cm_extend_leftover  the same wrap-up (extend_one) for
//                       device_full_finish's two leftover extends
//                       (:1353-1370): a thread runs a chain's left extend,
//                       then its right one, whose ed_th the left one's ed
//                       sets.
//
// Their plain versions are ops/device_full.py::_extend_core_plain and
// _extend_leftover_plain.  (The chain-order walk that was here is part of
// csrc/pair_grid.cu.)
//
// Interface.  The side bundle's fields as phase 2 holds them, one int32 or
// bool (one byte) tensor each, the walk fold's raw [8, N] rows, the pool
// overflow mask [4N] and the lane masks [4, N] (the family's row read in
// place); the leftover reads phase 1's fragments (pos_l = rp4[c][0],
// remain_beg = qp4[c][0]) and its [N, 2, 2] DP fields where they lie.
//
// Layout.  A thread a slot (a chain for the leftover), slots in order, so
// that a warp's loads of each field are one contiguous run; no shared
// memory.  extend_core's fold rows and the walk DP are read only where the
// slot's lane is active or its walk DP can be taken.
//
// What bounds them.  Their bytes: ~125 B a slot for extend_core, ~110 B a
// chain for the leftover.  Every thread does a few dozen integer
// operations.
//
// Parity.  Every sum that can wrap (pos + length against an I32MAX bound,
// the triv branch's bound) is int32 with two's-complement wrap-around,
// composed in uint32; every select keeps the reference's order
// (_upd_by_score's position tie-break by side, the engine's best over the
// walk DP's, consecutive gating the genomic try).

#ifndef CM_EXTEND_LAUNCH
#include <cuda_runtime.h>
#define CM_EXTEND_LAUNCH(KERNEL, grid, nt, stream, ...) \
  KERNEL<<<(grid), (nt), 0, (stream)>>>(__VA_ARGS__)
#endif
#include <stdint.h>

namespace {

constexpr int32_t I32MAX = 2147483647;
constexpr int32_t NEG_SCORE = -1000000000;  // -INF (config.py)
constexpr int EXT_THREADS = 256;
enum FoldRow { FD_POS, FD_ED, FD_SCLEN, FD_INDEL, FD_QCOV, FD_SCORE,
               FD_CONSEC, FD_DEFER, FD_ROWS };  // device_walk.FOLD_OUT

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}

struct Dp {
  int32_t ed, sclen, indel, score;
};

struct Ares {
  int32_t pos, ed, sclen, indel, qcov, score;
};

// One extend's inputs (a slot of _extend_core's flat operands).
struct Side {
  int32_t pos, length, ed_th, bound, exon_len;
  bool has_tids, iv_ok, walk_ok, gen_ok;
  Dp wdp, gdp;
  bool eng, eng_active, eng_consec, eng_defer;  // the walk engine's fold
  Ares eng_best;
};

// update_by_score_right/left (_upd_by_score): the candidate replaces best
__device__ __forceinline__ bool better_by_score(const Ares& best,
                                                const Ares& c, bool left) {
  const bool pos_better = left ? c.pos > best.pos : c.pos < best.pos;
  return best.score < c.score || (best.score == c.score && pos_better);
}

// _extend_core on one slot (extend.cpp:285-432), select by select.
__device__ void extend_one(const Side& s, bool left, int max_sc, int band,
                           bool& ok, int32_t& pos_out, Ares& best,
                           bool& defer) {
  const int32_t orig = s.pos, len = s.length;
  best = {orig, wadd(s.ed_th, 1), wadd(len, 1), band + 1, 0, 0};
  const bool covered = s.iv_ok && s.exon_len >= len;
  const bool walk_active = s.has_tids && s.iv_ok && len > 0;
  defer = s.eng ? (s.eng_active && s.eng_defer) : (walk_active && !covered);
  // the bound check decides walk DP against fallback (extend.cpp:403/510)
  const bool gate_ok = left ? orig >= wadd(s.bound, len)
                            : wadd(orig, len) <= s.bound;
  const bool do_walk = walk_active && covered && gate_ok;
  bool consecutive = do_walk;
  // the walk end DP's acceptance (_extend_*_end_g, curr.ed = 0)
  if (do_walk && s.walk_ok && s.wdp.ed <= s.ed_th && s.wdp.sclen <= max_sc &&
      wsub(len, s.wdp.sclen) >= s.wdp.sclen) {
    const Ares c = {left ? wadd(wsub(orig, len), s.wdp.indel)
                         : wsub(wadd(orig, len), s.wdp.indel),
                    s.wdp.ed, s.wdp.sclen, s.wdp.indel, len, s.wdp.score};
    if (better_by_score(best, c, left)) best = c;
  }
  if (s.eng && s.eng_active) {
    best = s.eng_best;
    consecutive = consecutive || s.eng_consec;
  }
  // wrap-up stage 1 (extend.cpp:316-324)
  const bool st1 = best.ed <= s.ed_th;
  pos_out = st1 ? (left ? wadd(best.pos, best.sclen)
                        : wsub(best.pos, best.sclen))
                : orig;
  bool done = st1 && best.qcov >= len && best.sclen <= max_sc;
  ok = done;
  // intron retention / plain genomic (extend.cpp:326-341)
  if (!done && !consecutive && s.gen_ok && len > 0 && s.gdp.ed <= s.ed_th &&
      s.gdp.sclen <= max_sc) {
    const int32_t gp = left ? wadd(wsub(orig, len), s.gdp.indel)
                            : wsub(wadd(orig, len), s.gdp.indel);
    const Ares c = {gp, s.gdp.ed, s.gdp.sclen, s.gdp.indel, len,
                    s.gdp.score};
    if (better_by_score(best, c, left)) {
      best = c;
      pos_out = left ? wadd(gp, s.gdp.sclen) : wsub(gp, s.gdp.sclen);
      ok = true;
      done = true;
    }
  }
  // tail wrap-up (extend.cpp:343-356)
  if (!done && best.qcov <= 0) {
    pos_out = orig;
    best = {orig, 0, 0, 0, 0, NEG_SCORE};
  }
  const int32_t qrem = wsub(len, best.qcov);
  if (!done && wadd(qrem, best.sclen) <= max_sc) {
    best = {pos_out, best.ed, wadd(best.sclen, qrem), best.indel, len,
            best.score};
    ok = true;
    done = true;
  }
  if (!done) ok = best.qcov >= len && best.ed <= s.ed_th;
  // remain == 0: untouched best, ok (extend.py:637,666)
  if (len <= 0) {
    ok = true;
    pos_out = orig;
    best = {s.bound, 0, 0, 0, 0, NEG_SCORE};
  }
  defer = defer && len > 0;
}

__device__ __forceinline__ void store_best(int32_t* out, long long i,
                                           long long N, const Ares& b) {
  out[i] = b.pos;
  out[N + i] = b.ed;
  out[2 * N + i] = b.sclen;
  out[3 * N + i] = b.indel;
  out[4 * N + i] = b.qcov;
  out[5 * N + i] = b.score;
}

struct CoreArgs {
  const int32_t *pos, *length, *ed_th, *bound;
  const uint8_t* has_tids;
  const int32_t *iv, *exon_len;
  const uint8_t *covered, *wx, *walk_inb, *gen_inb;
  const int32_t *g_ed, *g_sclen, *g_indel, *g_score;
  const int32_t *w_ed, *w_sclen, *w_indel, *w_score;
  const int32_t* fold;
  const uint8_t *over, *act;
  uint8_t* ok;
  int32_t *pos_out, *best;
  uint8_t* defer;
};

struct LeftoverArgs {
  const int32_t *rp4, *qp4, *pos_r, *remain_end, *est_mid;
  const uint8_t *genL_inb, *genR_inb;
  const int32_t *dp_ed, *dp_sclen, *dp_indel, *dp_score;  // [N, 2, 2]
  uint8_t* ok;
  int32_t *pos, *best;
};

__device__ __forceinline__ Dp load_dp(const int32_t* ed, const int32_t* sc,
                                      const int32_t* in, const int32_t* sr,
                                      long long i) {
  return {ed[i], sc[i], in[i], sr[i]};
}

// A leftover extend's side (no transcripts: no walk, no engine).
__device__ __forceinline__ Side leftover_side(const LeftoverArgs& a,
                                              long long i, int side,
                                              int32_t pos, int32_t len,
                                              int32_t ed_th, int32_t bound,
                                              bool gen_ok) {
  Side s;
  s.pos = pos;
  s.length = len;
  s.ed_th = ed_th;
  s.bound = bound;
  s.exon_len = 0;
  s.has_tids = s.iv_ok = s.walk_ok = false;
  s.gen_ok = gen_ok;
  s.gdp = load_dp(a.dp_ed, a.dp_sclen, a.dp_indel, a.dp_score,
                  4 * i + 2 * side);  // (side, variant 0: genomic)
  s.wdp = s.gdp;
  s.eng = s.eng_active = s.eng_consec = s.eng_defer = false;
  s.eng_best = {0, 0, 0, 0, 0, 0};
  return s;
}

__global__ void __launch_bounds__(EXT_THREADS)
    extend_core_kernel(const CoreArgs a, long long N, int fam, int left,
                       int max_sc, int band) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  Side s;
  s.pos = a.pos[i];
  s.length = a.length[i];
  s.ed_th = a.ed_th[i];
  s.bound = a.bound[i];
  s.has_tids = a.has_tids[i] != 0;
  s.iv_ok = a.iv[i] >= 0;
  s.exon_len = a.exon_len[i];
  s.gen_ok = a.gen_inb[i] != 0;
  s.gdp = load_dp(a.g_ed, a.g_sclen, a.g_indel, a.g_score, i);
  const bool wx = a.wx[i] != 0;
  s.walk_ok = a.covered[i] != 0 && (wx ? a.walk_inb[i] != 0 : s.gen_ok);
  // the walk DP only where it can be taken
  s.wdp = (wx && s.walk_ok && s.has_tids)
              ? load_dp(a.w_ed, a.w_sclen, a.w_indel, a.w_score, i)
              : s.gdp;
  s.eng = true;
  s.eng_active = a.act[fam * N + i] != 0;
  s.eng_consec = s.eng_defer = false;
  s.eng_best = {0, 0, 0, 0, 0, 0};
  if (s.eng_active) {  // the fold's rows only where its lane is live
    const int32_t* f = a.fold + i;
    s.eng_best = {f[FD_POS * N], f[FD_ED * N], f[FD_SCLEN * N],
                  f[FD_INDEL * N], f[FD_QCOV * N], f[FD_SCORE * N]};
    s.eng_consec = f[FD_CONSEC * N] != 0;
    s.eng_defer = f[FD_DEFER * N] != 0 || a.over[fam * N + i] != 0;
  }
  bool ok, defer;
  int32_t pos;
  Ares best;
  extend_one(s, left != 0, max_sc, band, ok, pos, best, defer);
  a.ok[i] = ok;
  a.pos_out[i] = pos;
  store_best(a.best, i, N, best);
  a.defer[i] = defer;
}

// A chain's left extend, then its right one, whose ed_th the left one's ed
// sets.
__global__ void __launch_bounds__(EXT_THREADS)
    extend_leftover_kernel(const LeftoverArgs lo, long long N, int NL,
                           int max_ed, int max_sc, int band) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  bool ok, defer;
  int32_t pos;
  Ares best;
  const int32_t eth = wsub(max_ed, lo.est_mid[i]);
  Side s = leftover_side(lo, i, 0, lo.rp4[i * NL], lo.qp4[i * NL], eth, 0,
                         lo.genL_inb[i] != 0);
  extend_one(s, true, max_sc, band, ok, pos, best, defer);
  lo.ok[i] = ok;
  lo.pos[i] = pos;
  store_best(lo.best, i, N, best);
  s = leftover_side(lo, i, 1, lo.pos_r[i], lo.remain_end[i],
                    wsub(eth, best.ed), I32MAX, lo.genR_inb[i] != 0);
  extend_one(s, false, max_sc, band, ok, pos, best, defer);
  lo.ok[N + i] = ok;
  lo.pos[N + i] = pos;
  store_best(lo.best + 6 * N, i, N, best);
}

inline unsigned grid_of(long long n) {
  return (unsigned)((n + EXT_THREADS - 1) / EXT_THREADS);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each returns cudaGetLastError()
// right after its launch (0 and no launch for no slot).
extern "C" int cm_extend_core(
    const void* pos, const void* length, const void* ed_th,
    const void* bound, const void* has_tids, const void* iv,
    const void* exon_len, const void* covered, const void* wx,
    const void* walk_inb, const void* gen_inb, const void* g_ed,
    const void* g_sclen, const void* g_indel, const void* g_score,
    const void* w_ed, const void* w_sclen, const void* w_indel,
    const void* w_score, const void* fold, const void* over,
    const void* act, void* ok, void* pos_out, void* best, void* defer, int N,
    int fam, int left, int max_sc, int band, void* stream) {
  if (N <= 0) return 0;
  if (fam < 0 || fam > 3) return (int)cudaErrorInvalidValue;
  CoreArgs a = {(const int32_t*)pos, (const int32_t*)length,
                (const int32_t*)ed_th, (const int32_t*)bound,
                (const uint8_t*)has_tids, (const int32_t*)iv,
                (const int32_t*)exon_len, (const uint8_t*)covered,
                (const uint8_t*)wx, (const uint8_t*)walk_inb,
                (const uint8_t*)gen_inb, (const int32_t*)g_ed,
                (const int32_t*)g_sclen, (const int32_t*)g_indel,
                (const int32_t*)g_score, (const int32_t*)w_ed,
                (const int32_t*)w_sclen, (const int32_t*)w_indel,
                (const int32_t*)w_score, (const int32_t*)fold,
                (const uint8_t*)over, (const uint8_t*)act, (uint8_t*)ok,
                (int32_t*)pos_out, (int32_t*)best, (uint8_t*)defer};
  CM_EXTEND_LAUNCH(extend_core_kernel, grid_of(N), EXT_THREADS,
                   (cudaStream_t)stream, a, (long long)N, fam, left, max_sc,
                   band);
  return (int)cudaGetLastError();
}

extern "C" int cm_extend_leftover(
    const void* rp4, const void* qp4, const void* pos_r,
    const void* remain_end, const void* est_mid, const void* genL_inb,
    const void* genR_inb, const void* dp_ed, const void* dp_sclen,
    const void* dp_indel, const void* dp_score, void* ok, void* pos,
    void* best, int N, int NL, int max_ed, int max_sc, int band,
    void* stream) {
  if (N <= 0) return 0;
  if (NL < 1) return (int)cudaErrorInvalidValue;
  LeftoverArgs lo = {(const int32_t*)rp4, (const int32_t*)qp4,
                     (const int32_t*)pos_r, (const int32_t*)remain_end,
                     (const int32_t*)est_mid, (const uint8_t*)genL_inb,
                     (const uint8_t*)genR_inb, (const int32_t*)dp_ed,
                     (const int32_t*)dp_sclen, (const int32_t*)dp_indel,
                     (const int32_t*)dp_score, (uint8_t*)ok, (int32_t*)pos,
                     (int32_t*)best};
  CM_EXTEND_LAUNCH(extend_leftover_kernel, grid_of(N), EXT_THREADS,
                   (cudaStream_t)stream, lo, (long long)N, NL, max_ed, max_sc,
                   band);
  return (int)cudaGetLastError();
}
