// Phase 2's pair grid, hand-written for Hopper (sm_90a).
//
//   cm_pair_grid  replaces, in circminer_tpu/ops/device_full.py::_phase2
//                 (:861; XLA-lowered inside the reference's jitted step),
//                 the pair-union grid (:875-908), its rank into P_MAX slots
//                 and their inverse (:910-926), grid_at (:928), the
//                 per-pair chain gathers side_fields (:964), _is_left_chain
//                 (:801, called at :993) and the l/r-mate select sel
//                 (:996).  Its plain version is ops/device_full.py::
//                 _pair_grid_plain.
//
// Interface.  Per read b: its chains' int fields [4, KB1, NI] (SfInt:
// device_full.SF_INT, then the 16 DP fields of SF_DP) and flags
// [4, KB1, NB] (SF_BOOL), its fragments rp4 / qp4 [4, KB1, NL], cn4 and
// lens4 [4] and its defer word; the annotation's tid lists [NIV, ST], tid
// and segment counts [NIV], segment genes [NIV, SP] and gene spans [NG].
// Out: the grid's same_tr, sgf, sgr (grid_b [3, B, 2, KB1, KB1]) and
// tlen_g; the chains' fvalid and rvalid (valid [2, B, 2, KB1]); per pair
// slot [B, 2, P] pcell, p_tlen, p_fiv, p_riv (slot_i) and pvalid,
// p_same_tr, p_sgf, p_sgr, fwd_left (slot_b); n_union [B, 2]; the l-mate
// and r-mate bundles field by field, mate_i [2, NO, B, 2, P] (the NI
// fields, then seq_len and arow) and mate_b [2, NB, B, 2, P], so that each
// field the extend kernels read is one contiguous [B, 2, P] tensor; and
// the new defer word (DEF_PANNO, DEF_UNION).
//
// Layout.  One CTA of PG_THREADS threads a read, in phases between block
// barriers, every phase on shared memory after the first:
//   - Stage the read once: its [4, KB1] chains' fields, flags and
//     fragments (coalesced runs), then, per chain that a valid cell can
//     use (in its row's count, on an interval), its interval's tid list
//     and segment genes' spans, one thread a (chain, entry), and its
//     padding-overflow bit.
//   - Threads over the 2 KB1^2 cells: tlen, the tid-list intersection and
//     both gene-span tests on the staged lists (valid cells only: the
//     others are false whatever the lists hold), union and the DEF_PANNO
//     test; the grid's outputs written in cell order.
//   - A warp an orientation ranks its cells in row-major order by
//     __ballot_sync / __popc, 32 cells a chunk, the rank carried across
//     chunks: slot rank < P takes the cell; the slots past n_union keep
//     cell 0, as the reference's zero-filled inverse does.
//   - Threads over the 2 P slots: the slot fields, and _is_left_chain's
//     merge walk on the staged fragments of the slot's two chains (no
//     dependent load of device memory: the design PR 17's one-thread-a-slot
//     kernel lacked).
//   - Threads over (mate, field, slot): the bundles, each field's 2 P
//     slots of a read one contiguous run.
//
// What bounds it.  Its bytes: a read's chain fields (~3.4 KB at KB1 = 7)
// in, ~2.6 KB of grid, slot and bundle fields out, and the annotation
// rows of its valid chains on intervals.  Every thread does a few dozen
// integer operations a cell or a slot, and the tid lists' compares (ST^2
// at most) only for a valid cell of two chains on intervals.
//
// Parity.  Every sum that can wrap (lastr + k, the tlen differences, the
// walk's distances and overlaps) is int32 with two's-complement wrap,
// composed in uint32; every test keeps the reference's form (a tid list's
// entry counts only where it is >= 0, a segment's gene only below the
// interval's segment count and where it is >= 0, clamped indices).

#ifndef CM_PAIR_LAUNCH
#include <cuda_runtime.h>
#define CM_PAIR_LAUNCH(KERNEL, grid, nt, smem, stream, ...) \
  KERNEL<<<(grid), (nt), (smem), (stream)>>>(__VA_ARGS__)
#endif
#include <stdint.h>

namespace {

constexpr int32_t MAXDISCRDTLEN = 20000;  // config.py
constexpr int32_t INF = 1000000000;
constexpr int32_t DEF_PANNO = 1 << 5;
constexpr int32_t DEF_UNION = 1 << 6;
constexpr int PG_THREADS = 64;
constexpr int PG_VEC = 4;  // a thread's 16-byte field loads in one pass
constexpr long long PG_SMEM_MAX = 232448;  // a block's opt-in maximum
// a chain's int fields (device_full.SF_INT), then SF_DP's 16
enum SfInt { SF_R0, SF_Q0, SF_LASTQ, SF_LASTR, SF_REMAIN_BEG, SF_REMAIN_END,
             SF_POS_L, SF_POS_R, SF_IV_L, SF_IV_R, SF_EXON_LEN_L,
             SF_EXON_LEN_R, SF_MID_DP, SF_CLEN, SF_INTS };
constexpr int NI = SF_INTS + 16;
constexpr int NO = NI + 2;  // + seq_len, arow
constexpr int NB = 8;       // device_full.SF_BOOL
// a cell's bits
enum CellBit { CB_SAME_TR = 1, CB_SGF = 2, CB_SGR = 4, CB_UNION = 8,
               CB_OVER = 16 };
// the read's words: cn4, lens4, n_union and DEF_PANNO per orientation
enum Misc { M_CN = 0, M_LENS = 4, M_NUN = 8, M_OVER = 10, M_WORDS = 12 };

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}

__device__ __forceinline__ int clampi(int32_t x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : (int)x);
}

struct PgArgs {
  const int32_t* sf_i;
  const uint8_t* sf_b;
  const int32_t *rp4, *qp4, *cn4, *lens4, *defer;
  const int32_t *iv_tids, *iv_ntid, *iv_nseg_true, *iv_nseg, *seg_gene_p,
      *gene_start, *gene_end;
  uint8_t* grid_b;
  int32_t* tlen_g;
  uint8_t* valid;
  int32_t* slot_i;
  uint8_t* slot_b;
  int32_t* n_union;
  int32_t* mate_i;
  uint8_t* mate_b;
  int32_t* defer_out;
};

struct PgDims {
  int B, KB1, NL, P, k, NIV, ST, SP, SEG_PAD, NG;
};

// A read's shared memory: words, then bytes.
struct Stage {
  int32_t *sf, *rp, *qp, *tids, *gs, *ge, *ntid, *ngene, *ivs, *pcell, *misc;
  uint8_t *sfb, *gok, *over, *cellf, *fleft;
};

__host__ __device__ inline long long pg_words(int KB1, int NL, int ST,
                                              int SP, int P) {
  return 4LL * KB1 * (NI + 2LL * NL + ST + 2LL * SP + 3) +
         ((2LL * P + M_WORDS + 3) & ~3LL);
}

__host__ __device__ inline long long pg_smem(int KB1, int NL, int ST, int SP,
                                             int P) {
  const long long bytes = 4LL * KB1 * (NB + SP + 1) + 2LL * KB1 * KB1 +
                          2LL * P;
  return (4 * pg_words(KB1, NL, ST, SP, P) + bytes + 15) / 16 * 16;
}

__device__ inline Stage carve(unsigned char* base, const PgDims& d) {
  const int C4 = 4 * d.KB1;
  Stage s;
  int32_t* w = (int32_t*)base;
  s.sf = w;
  s.rp = s.sf + C4 * NI;
  s.qp = s.rp + C4 * d.NL;
  s.tids = s.qp + C4 * d.NL;
  s.gs = s.tids + C4 * d.ST;
  s.ge = s.gs + C4 * d.SP;
  s.ntid = s.ge + C4 * d.SP;
  s.ngene = s.ntid + C4;
  s.ivs = s.ngene + C4;
  s.misc = s.ivs + C4;
  s.pcell = s.misc + M_WORDS;
  // the bytes from a 16-byte boundary (the flags are staged as int4)
  uint8_t* c = (uint8_t*)(s.pcell + ((2 * d.P + M_WORDS + 3) & ~3) - M_WORDS);
  s.sfb = c;
  s.gok = s.sfb + C4 * NB;
  s.over = s.gok + C4 * d.SP;
  s.cellf = s.over + C4;
  s.fleft = s.cellf + 2 * d.KB1 * d.KB1;
  return s;
}

// _tids_intersect on two staged lists of their entries >= 0: a shared
// entry.
__device__ bool tids_meet(const int32_t* ta, int na, const int32_t* tb,
                          int nb) {
  for (int x = 0; x < na; ++x) {
    const int32_t v = ta[x];
    for (int y = 0; y < nb; ++y)
      if (tb[y] == v) return true;
  }
  return false;
}

// _same_gene_span's hit on chain c's staged gene spans (its valid
// segments'): [lo, hi] inside one.
__device__ bool in_gene(const Stage& s, int c, int SP, int32_t lo,
                        int32_t hi) {
  for (int x = 0; x < s.ngene[c]; ++x) {
    const int e = c * SP + x;
    if (s.gs[e] <= lo && hi <= s.ge[e]) return true;
  }
  return false;
}

__device__ __forceinline__ int32_t cell_tlen(const int32_t* F,
                                             const int32_t* V, int k) {
  const int32_t fs = F[SF_R0], rs = V[SF_R0];
  return fs < rs ? wsub(wadd(V[SF_LASTR], k), fs)
                 : wsub(wadd(F[SF_LASTR], k), rs);
}

// _is_left_chain (utils.cpp:827-887) on two staged chains: the merge walk
// to the closest fragment pair or the first overlap, stopping when done,
// where the reference's state freezes.
__device__ bool is_left(const int32_t* A, const int32_t* Bf,
                        const int32_t* QA, const int32_t* QB, int32_t a_len,
                        int32_t b_len, int32_t read_len, int NL, int k) {
  const int32_t km1 = k - 1;
  const int32_t a_beg = A[0], b_beg = Bf[0];
  const int32_t a_end = wadd(A[clampi(wsub(a_len, 1), 0, NL - 1)], km1);
  const int32_t b_end = wadd(Bf[clampi(wsub(b_len, 1), 0, NL - 1)], km1);
  if (b_beg > a_end || a_beg > b_end) return a_beg < b_beg;  // separated
  int32_t i = 0, j = 0, bd = INF, bi = -1, bj = -1;
  for (int step = 0; step < 2 * NL; ++step) {
    if (!(i < a_len && j < b_len)) break;
    const int32_t ai_beg = A[clampi(i, 0, NL - 1)];
    const int32_t bj_beg = Bf[clampi(j, 0, NL - 1)];
    const int32_t ai_end = wadd(ai_beg, km1), bj_end = wadd(bj_beg, km1);
    if (ai_end < bj_beg) {
      const int32_t dd = wsub(bj_beg, ai_end);
      if (dd < bd) {
        bd = dd;
        bi = i;
        bj = j;
      }
      ++i;
    } else if (bj_end < ai_beg) {
      const int32_t dd = wsub(ai_beg, bj_end);
      if (dd < bd) {
        bd = dd;
        bi = i;
        bj = j;
      }
      ++j;
    } else {  // overlap
      bi = i;
      bj = j;
      break;
    }
  }
  const int bic = clampi(bi, 0, NL - 1), bjc = clampi(bj, 0, NL - 1);
  const int32_t a_bp = A[bic], b_bp = Bf[bjc];
  const int32_t common = a_bp > b_bp ? a_bp : b_bp;
  const int32_t a_ov = wadd(QA[bic], wsub(common, a_bp));
  const int32_t b_ov = wadd(QB[bjc], wsub(common, b_bp));
  const bool both_in = a_ov < read_len && b_ov < read_len && bi >= 0;
  return both_in ? a_ov >= b_ov : a_beg < b_beg;
}

__global__ void __launch_bounds__(PG_THREADS)
    pair_grid_kernel(const PgArgs a, const PgDims d) {
  extern __shared__ __align__(16) unsigned char pg_smem_buf[];
  const Stage s = carve(pg_smem_buf, d);
  const int KB1 = d.KB1, NL = d.NL, P = d.P, ST = d.ST, SP = d.SP;
  const int C4 = 4 * KB1, KK = KB1 * KB1, S2 = 2 * P;
  const long long b = blockIdx.x;
  const int t = threadIdx.x, nt = blockDim.x;
  const int warp = t >> 5, lane = t & 31, nwarps = nt >> 5;
  const unsigned below = (1u << lane) - 1u;

  // ---- stage the read's chains: its fields, fragments and flags as
  // 16-byte words, every array's first PG_VEC (fields) or one (the rest)
  // words of a thread loaded before any is stored
  {
    const int n_sf = C4 * NI / 4, n_fr = KB1 * NL, n_b = C4 * NB / 16;
    const int4* sfg = (const int4*)a.sf_i + b * n_sf;
    const int4* rpg = (const int4*)a.rp4 + b * n_fr;
    const int4* qpg = (const int4*)a.qp4 + b * n_fr;
    const int4* sbg = (const int4*)a.sf_b + b * n_b;
    int4 *sf4 = (int4*)s.sf, *rp4 = (int4*)s.rp, *qp4 = (int4*)s.qp,
         *sb4 = (int4*)s.sfb;
    int4 v[PG_VEC], vr, vq, vb;
#pragma unroll
    for (int u = 0; u < PG_VEC; ++u)
      if (t + u * nt < n_sf) v[u] = __ldg(sfg + t + u * nt);
    if (t < n_fr) {
      vr = __ldg(rpg + t);
      vq = __ldg(qpg + t);
    }
    if (t < n_b) vb = __ldg(sbg + t);
#pragma unroll
    for (int u = 0; u < PG_VEC; ++u)
      if (t + u * nt < n_sf) sf4[t + u * nt] = v[u];
    if (t < n_fr) {
      rp4[t] = vr;
      qp4[t] = vq;
    }
    if (t < n_b) sb4[t] = vb;
    // the rest, where a read outgrows one pass
    for (int e = t + PG_VEC * nt; e < n_sf; e += nt) sf4[e] = __ldg(sfg + e);
    for (int e = t + nt; e < n_fr; e += nt) {
      rp4[e] = __ldg(rpg + e);
      qp4[e] = __ldg(qpg + e);
    }
    for (int e = t + nt; e < n_b; e += nt) sb4[e] = __ldg(sbg + e);
  }
  for (int e = t; e < S2; e += nt) s.pcell[e] = 0;
  if (t < 4) {
    s.misc[M_CN + t] = a.cn4[b * 4 + t];
    s.misc[M_LENS + t] = a.lens4[b * 4 + t];
  }
  __syncthreads();

  // ---- each chain's interval where a valid cell can use it (in its
  // row's count, on an interval), else -1
  for (int c = t; c < C4; c += nt) {
    const int row = c / KB1;
    const int32_t iv = s.sf[c * NI + SF_IV_L];
    s.ivs[c] = c - row * KB1 < s.misc[M_CN + row] && iv >= 0 ? iv : -1;
    s.over[c] = false;
  }
  __syncthreads();

  // ---- the annotation rows of those chains: threads as [rows][cols], a
  // row every rows-th chain, a column its tid entry and segment (one
  // division a thread): per chain the tid list, the segments' genes and
  // counts in flight at once, then the genes' spans
  {
    const int W = ST > SP ? ST : SP;
    const int tc = W < nt ? W : nt, tr = nt / tc;
    const int x0 = t % tc, c0 = t / tc;
    for (int c = c0 < tr ? c0 : C4; c < C4; c += tr) {
      const int32_t iv = s.ivs[c];
      if (iv < 0) continue;
      const long long ivc = clampi(iv, 0, d.NIV - 1);
      if (x0 == 0)
        s.over[c] = __ldg(a.iv_ntid + ivc) > ST ||
                    __ldg(a.iv_nseg_true + ivc) > d.SEG_PAD;
      const int32_t nseg = __ldg(a.iv_nseg + ivc);
      for (int x = x0; x < W; x += tc) {
        const int32_t tid = x < ST ? __ldg(a.iv_tids + ivc * ST + x) : -1;
        const int32_t g = x < SP ? __ldg(a.seg_gene_p + ivc * SP + x) : -1;
        if (x < ST) s.tids[c * ST + x] = tid;
        if (x < SP) {
          const bool ok = x < nseg && g >= 0;
          const int e = c * SP + x;
          s.gok[e] = ok;
          if (ok) {
            const int gc = clampi(g, 0, d.NG - 1);
            s.gs[e] = __ldg(a.gene_start + gc);
            s.ge[e] = __ldg(a.gene_end + gc);
          }
        }
      }
    }
  }
  const long long VN = (long long)d.B * 2 * KB1;
  for (int e = t; e < 2 * KB1; e += nt) {
    const int o = e / KB1, c = e - o * KB1;
    a.valid[b * 2 * KB1 + e] = c < s.misc[M_CN + 2 * o];
    a.valid[VN + b * 2 * KB1 + e] = c < s.misc[M_CN + 3 - 2 * o];
  }
  __syncthreads();

  // ---- a warp a chain: its tid list's entries >= 0 and its valid
  // segments' gene spans compacted in place (ballot, prefix popc), so the
  // cells' tests scan only what can match
  for (int c = warp; c < C4; c += nwarps) {
    if (s.ivs[c] < 0) continue;  // the same c on every lane
    int n = 0;
    for (int base = 0; base < ST; base += 32) {
      const int x = base + lane;
      const int32_t v = x < ST ? s.tids[c * ST + x] : -1;
      const unsigned m = __ballot_sync(0xffffffffu, v >= 0);
      __syncwarp();
      if (v >= 0) s.tids[c * ST + n + __popc(m & below)] = v;
      n += __popc(m);
      __syncwarp();
    }
    if (lane == 0) s.ntid[c] = n;
    n = 0;
    for (int base = 0; base < SP; base += 32) {
      const int x = base + lane, e = c * SP + x;
      const bool ok = x < SP && s.gok[e];
      const int32_t lo = ok ? s.gs[e] : 0, hi = ok ? s.ge[e] : 0;
      const unsigned m = __ballot_sync(0xffffffffu, ok);
      __syncwarp();
      if (ok) {
        const int r = c * SP + n + __popc(m & below);
        s.gs[r] = lo;
        s.ge[r] = hi;
      }
      n += __popc(m);
      __syncwarp();
    }
    if (lane == 0) s.ngene[c] = n;
  }
  __syncthreads();

  // ---- the grid and its rank: a warp an orientation, a lane a cell of a
  // 32-cell chunk in row-major order; the rank carried across chunks
  {
    const long long GN = (long long)d.B * 2 * KK;
    for (int o = warp; o < 2; o += nwarps) {
      int count = 0;
      bool any_over = false;
      for (int base = 0; base < KK; base += 32) {
        const int cell = base + lane;
        int f = 0;
        if (cell < KK) {
          const int i = cell / KB1, j = cell - i * KB1;
          const int cf = 2 * o * KB1 + i, cv = (3 - 2 * o) * KB1 + j;
          const int32_t *F = s.sf + cf * NI, *V = s.sf + cv * NI;
          const bool gv =
              i < s.misc[M_CN + 2 * o] && j < s.misc[M_CN + 3 - 2 * o];
          const int32_t tlen = cell_tlen(F, V, d.k);
          const int32_t fiv = F[SF_IV_L], riv = V[SF_IV_L];
          bool same_tr = false, sgf = false, sgr = false;
          if (gv) {
            same_tr = fiv >= 0 && riv >= 0 &&
                      tids_meet(s.tids + cf * ST, s.ntid[cf],
                                s.tids + cv * ST, s.ntid[cv]);
            sgf = fiv >= 0 && in_gene(s, cf, SP, V[SF_R0],
                                      wadd(V[SF_LASTR], d.k));
            sgr = riv >= 0 && in_gene(s, cv, SP, F[SF_R0],
                                      wadd(F[SF_LASTR], d.k));
          }
          const bool uni =
              gv && (same_tr || sgf || sgr || tlen <= MAXDISCRDTLEN);
          const bool over = uni && (s.over[cf] || s.over[cv]);
          f = (same_tr ? CB_SAME_TR : 0) | (sgf ? CB_SGF : 0) |
              (sgr ? CB_SGR : 0) | (uni ? CB_UNION : 0) |
              (over ? CB_OVER : 0);
          s.cellf[o * KK + cell] = f;
          const long long g = (b * 2 + o) * KK + cell;
          a.grid_b[g] = same_tr;
          a.grid_b[GN + g] = sgf;
          a.grid_b[2 * GN + g] = sgr;
          a.tlen_g[g] = tlen;
        }
        const unsigned um = __ballot_sync(0xffffffffu, f & CB_UNION);
        any_over |= __ballot_sync(0xffffffffu, f & CB_OVER) != 0u;
        const int r = count + __popc(um & below);
        if ((f & CB_UNION) && r < P) s.pcell[o * P + r] = cell;
        count += __popc(um);
      }
      if (lane == 0) {
        s.misc[M_NUN + o] = count;
        s.misc[M_OVER + o] = any_over;
        a.n_union[b * 2 + o] = count;
      }
    }
  }
  __syncthreads();
  if (t == 0) {
    int32_t df = a.defer[b];
    if (s.misc[M_OVER] || s.misc[M_OVER + 1]) df |= DEF_PANNO;
    if (s.misc[M_NUN] > P || s.misc[M_NUN + 1] > P) df |= DEF_UNION;
    a.defer_out[b] = df;
  }

  // ---- the slots: a thread a slot (o, p)
  {
    const long long SN = (long long)d.B * S2;
    for (int e = t; e < S2; e += nt) {
      const int o = e / P, p = e - o * P;
      const int cell = s.pcell[e], pi = cell / KB1, pj = cell - pi * KB1;
      const int fr = 2 * o, cf = fr * KB1 + pi, cv = (3 - 2 * o) * KB1 + pj;
      const int32_t *F = s.sf + cf * NI, *V = s.sf + cv * NI;
      const bool pvalid = p < s.misc[M_NUN + o];
      const int f = s.cellf[o * KK + cell];
      const bool left = is_left(s.rp + cf * NL, s.rp + cv * NL,
                                s.qp + cf * NL, s.qp + cv * NL, F[SF_CLEN],
                                V[SF_CLEN], s.misc[M_LENS + fr], NL, d.k);
      s.fleft[e] = left;
      const long long g = b * S2 + e;
      a.slot_i[g] = cell;
      a.slot_i[SN + g] = cell_tlen(F, V, d.k);
      a.slot_i[2 * SN + g] = F[SF_IV_L];
      a.slot_i[3 * SN + g] = V[SF_IV_L];
      a.slot_b[g] = pvalid;
      a.slot_b[SN + g] = pvalid && (f & CB_SAME_TR);
      a.slot_b[2 * SN + g] = pvalid && (f & CB_SGF);
      a.slot_b[3 * SN + g] = pvalid && (f & CB_SGR);
      a.slot_b[4 * SN + g] = left;
    }
  }
  __syncthreads();

  // ---- the bundles: threads as [rows][cols], a column a slot, a row
  // every rows-th field; mate 0 is the l-mate (the forward chain where
  // fwd_left), mate 1 the r-mate
  {
    const long long MN = (long long)d.B * S2;
    const int cols = S2 < nt ? S2 : nt, rows = nt / cols;
    const int col = t % cols, row = t / cols;
    for (int os = row < rows ? col : S2; os < S2; os += cols) {
      const int o = os / P;
      const int cell = s.pcell[os], pi = cell / KB1;
      const bool fl = s.fleft[os] != 0;
      const int fr = 2 * o, vr = 3 - 2 * o;
      const int cF = fr * KB1 + pi, cV = vr * KB1 + (cell - pi * KB1);
      const int c[2] = {fl ? cF : cV, fl ? cV : cF};
      const int rw[2] = {fl ? fr : vr, fl ? vr : fr};
      for (int m = 0; m < 2; ++m) {
        int32_t* out = a.mate_i + m * NO * MN + b * S2 + os;
        const int32_t* src = s.sf + c[m] * NI;
        for (int fld = row; fld < NI; fld += rows) out[fld * MN] = src[fld];
        if (row == 0) {
          out[NI * MN] = s.misc[M_LENS + rw[m]];
          out[(NI + 1) * MN] = (int32_t)(b * 4 + rw[m]);
        }
        uint8_t* outb = a.mate_b + m * NB * MN + b * S2 + os;
        for (int fld = row; fld < NB; fld += rows)
          outb[fld * MN] = s.sfb[c[m] * NB + fld] != 0;
      }
    }
  }
}

// The block's opt-in shared memory (above 48 KB) and the SM's carveout
// set to all shared memory, once per device.
cudaError_t pg_attributes() {
  static int dev_c = -1;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev == dev_c) return e;
  e = cudaFuncSetAttribute(pair_grid_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)PG_SMEM_MAX);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(pair_grid_kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           100);
  if (e != cudaSuccess) return e;
  dev_c = dev;
  return cudaSuccess;
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns cudaGetLastError()
// right after the launch (0 and no launch for no read;
// cudaErrorInvalidValue and no launch for an empty dimension, a read's
// shared memory, pg_smem, above PG_SMEM_MAX, or sf_i, sf_b, rp4 or qp4 off
// a 16-byte boundary).
extern "C" int cm_pair_grid(
    const void* sf_i, const void* sf_b, const void* rp4, const void* qp4,
    const void* cn4, const void* lens4, const void* defer,
    const void* iv_tids, const void* iv_ntid, const void* iv_nseg_true,
    const void* iv_nseg, const void* seg_gene_p, const void* gene_start,
    const void* gene_end, void* grid_b, void* tlen_g, void* valid,
    void* slot_i, void* slot_b, void* n_union, void* mate_i, void* mate_b,
    void* defer_out, int B, int KB1, int NL, int P, int k, int NIV, int ST,
    int SP, int SEG_PAD, int NG, void* stream) {
  if (B <= 0) return 0;
  if (KB1 < 1 || NL < 1 || P < 1 || NIV < 1 || ST < 1 || SP < 1 || NG < 1)
    return (int)cudaErrorInvalidValue;
  const long long smem = pg_smem(KB1, NL, ST, SP, P);
  if (smem > PG_SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)sf_i | (uintptr_t)sf_b | (uintptr_t)rp4 | (uintptr_t)qp4) %
      16)  // staged as int4
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = pg_attributes();
  if (e != cudaSuccess) return (int)e;
  const PgArgs a = {(const int32_t*)sf_i,     (const uint8_t*)sf_b,
                    (const int32_t*)rp4,      (const int32_t*)qp4,
                    (const int32_t*)cn4,      (const int32_t*)lens4,
                    (const int32_t*)defer,    (const int32_t*)iv_tids,
                    (const int32_t*)iv_ntid,  (const int32_t*)iv_nseg_true,
                    (const int32_t*)iv_nseg,  (const int32_t*)seg_gene_p,
                    (const int32_t*)gene_start, (const int32_t*)gene_end,
                    (uint8_t*)grid_b,         (int32_t*)tlen_g,
                    (uint8_t*)valid,          (int32_t*)slot_i,
                    (uint8_t*)slot_b,         (int32_t*)n_union,
                    (int32_t*)mate_i,         (uint8_t*)mate_b,
                    (int32_t*)defer_out};
  const PgDims dims = {B, KB1, NL, P, k, NIV, ST, SP, SEG_PAD, NG};
  CM_PAIR_LAUNCH(pair_grid_kernel, (unsigned)B, PG_THREADS, (size_t)smem,
                 (cudaStream_t)stream, a, dims);
  return (int)cudaGetLastError();
}
