// The extension walk's lane set-up and wave body of the fused gpu-full
// step, hand-written for Hopper (sm_90a): everything of the reference's
// walk_waves (circminer_tpu/ops/device_walk.py:138-541) that walk.cu's
// scan and the DP kernels do not compute.  Three kernels behind three
// entry points, one launch each:
//
//   cm_walk_init    replaces the lane set-up before the wave loop
//                   (device_walk.py:163-235): walk_init_kernel compacts
//                   the [4N] active flags into WPP lanes (_compact,
//                   device_full.py:154: inv, n_act, over) and sets up each
//                   lane: its tables, its common transcripts (f_iv's tids
//                   that r_iv also lists, duplicates kept) packed in order
//                   into STW slots (over_tid past STW), the slots'
//                   transcript constants and the initial scan state; it
//                   zeroes the events and counts.  Plain version:
//                   ops/device_walk.py::_walk_init_plain.
//   cm_walk_pool    replaces a wave's two DP pools (wave_body's dedup
//                   :374-382, _compact :390 / :428, mg / eg and the window
//                   gathers :387-417 / :425-452, _gather_window
//                   device_full.py:85): walk_pool_kernel deduplicates each
//                   lane's slots by geometry, ranks the leaders in
//                   slot-major flat order (row j holds rank j + 1; rows
//                   past the count gather flat S - 1), writes each lane's
//                   map code (its leader's row, MAP_NONE or MAP_OVER) and
//                   gathers each row's lengths and its query and reference
//                   windows.  Plain version: ops/device_walk.py::
//                   _walk_pool_plain.
//   cm_walk_commit  replaces the scatter-back and commit of a wave
//                   (:420-520): walk_commit_kernel, a thread a (slot,
//                   lane), reads its leader's middle-DP (ed, indel) and
//                   end-DP (score, on_s, on_t) through the map, applies
//                   _drop_wrap for its side (device_full.py:139, floor
//                   division), inherits its leader's overflow, writes the
//                   wave's one event at slot clamp(nev, 0, EW - 1), advances
//                   nev and applies the middle commit.  Plain version:
//                   ops/device_walk.py::_walk_commit_plain.
//
// The ranks.  A compaction's rank is a prefix count over the whole flat
// order (262,144 lane flags, a pool's 49,152 slots at chr21), and a block
// alone is held to one SM.  Both kernels rank inside thread block
// clusters: each CTA counts its part of the order and pushes its count
// into every CTA of its cluster (distributed shared memory), and after a
// cluster barrier each adds the counts before its own.  No count goes
// through device memory and no block waits on another outside its
// cluster, so one launch does what three did (a count pass, a rank pass
// and the body), and a graph replays it as one node.
//
//   walk_pool: two clusters of PCS = 16 CTAs (a non-portable size: the
//   pass over the state is shared by twice the SMs of an 8-CTA cluster),
//   MID then END.  A thread owns a lane (and loops over lanes where WPP
//   passes the cluster's threads): it loads its STW slots' status, then
//   the geometry of those in the pool, lane-minor, and dedups them in
//   registers, so a follower's code is its own lane's leader's.  Row j is
//   the leader of rank j + 1 in flat t * WPP + l order: the leaders of the
//   slots before t (every CTA's) plus those of slot t in the lanes before
//   l (the CTAs before, the (chunk, warp)s before, the lanes before in a
//   ballot).  A leader writes its row's lengths and flat index and hands
//   its window's geometry to the CTA that gathers row j (j mod PCS)
//   through distributed shared memory, so the rows spread evenly whichever
//   lanes hold them; after a second cluster barrier a warp gathers each
//   of a CTA's rows.  The dead rows (j >= n) hold flat S - 1's windows,
//   which one warp a CTA gathers into shared memory while the first
//   barrier completes.  Past a batch of about 100,000 pairs the lanes'
//   codes and the rows' geometry outgrow shared memory: the lanes past
//   it are deduped again in the second pass, and the rows past it take
//   their geometry from their flat index, written before the barrier.
//   walk_init: up to eight clusters of CS = 8 CTAs.  The flags' rank is done
//   by every cluster alike (a CTA a chunk of 32-flag groups, gpt groups a
//   thread, loaded 16 bytes at a time); each cluster then sets up its own
//   lanes, 32 consecutive lanes of each group of lane groups, so that every
//   CTA of the grid sets up about WPP / (clusters CS) lanes: the CTA that
//   ranks a flag writes the flag's index into the setting-up CTA's table
//   through distributed shared memory.  A lane is set up by four threads,
//   each two transcript slots, so that a slot field's store writes whole
//   sectors.  Lanes past n_act are set up from flat 4N - 1, as the plain
//   version's clamped gather.  Every thread of the grid zeroes its share of
//   the events and counts, 16 bytes a store, while the first cluster barrier
//   completes.
//
// What bounds them.  Neither is near its bytes (at chr21 ~9.5 MB for
// walk_init, mostly the events' zeroing, and ~0.4 MB of state, windows
// and rows for walk_pool).  Their time is a chain of dependent phases,
// each a round trip to L2 or device memory or a cluster barrier:
// walk_init the flags' loads, two barriers and the
// lane set-up's three dependent gathers (slot tables, tid lists,
// transcripts) and its stores; walk_pool the state's two loads, two
// barriers and the windows' gathers and stores, on 16 SMs a pool.

// Parity: every int32 sum wraps as in torch (add32, sub32, mul32); gathers
// clamp their index where the plain version clamps it; the windows pad
// with 127 where the plain version does (the query past its length only,
// its index clamped into the reads; the reference also outside the
// genome).  A pool's dead rows gather flat S - 1 exactly as _compact's
// clamped searchsorted does, so whole buffers compare bit-equal.

#include <cuda_runtime.h>
#include <stdint.h>
#ifndef CM_WAVE_LAUNCH
#include <cooperative_groups.h>
#endif

namespace cg = cooperative_groups;

namespace {

// lane status codes and event kinds (ops/device_walk.py)
enum WalkStat { WK_SCAN, WK_PMID, WK_PTRAIL, WK_PEND, WK_PENDND, WK_DONE };
enum EventKind { EVK_NONE, EVK_MID, EVK_TRAIL, EVK_END, EVK_ENDND };
// event record fields (ops/device_walk.py EV_KEYS)
enum EventField { EV_KIND, EV_XPOS, EV_AUX, EV_ED, EV_INDEL, EV_SCLEN,
                  EV_SCORE, EV_NF };
// the scan's carried state (ops/device_walk.py WS_KEYS)
enum ScanField { WS_I_ABS, WS_XPOS, WS_EXLEN, WS_COVERED, WS_FIRST, WS_STAT,
                 WS_PEND_IV, WS_PEND_XPOS, WS_PEND_EXLEN, WS_PEND_COV,
                 WS_PEND_RR, WS_REMREF, WS_NF };
// per (slot, lane) constants (SLOT_KEYS), per lane constants (LANE_KEYS)
// and the pools' per lane rows (PROW_KEYS)
enum SlotField { SL_TSTART, SL_TOFF, SL_TLEN, SL_NF };
enum LaneField { LN_IS_LEFT, LN_QLEN, LN_POS, LN_NF };
enum ProwField { PW_ROW, PW_QS0, PW_NF };
// a pool's int32 rows (POOL_ROWS): its DP's n and m, the flat index
enum PoolRow { PR_N, PR_M, PR_INV, PR_NF };
// the two pools: the maps' planes and n's words
enum PoolKind { POOL_MID, POOL_END, POOL_NK };
// the entry point whose grid cm_wave_empty takes
enum WaveKernel { WAVE_INIT, WAVE_POOL, WAVE_COMMIT };

// a lane's code in a pool map (MAP_NONE, MAP_OVER in ops/device_walk.py):
// its leader's row (>= 0), none, or the leader's rank past the pool
constexpr int MAP_NONE = -1;
constexpr int MAP_OVER = -2;
// a slot's dedup code in walk_pool, 4 bits a slot: its leader's slot u
// (a follower), LEAD_CODE or NONE_CODE
constexpr int LEAD_CODE = 8;
constexpr int NONE_CODE = 15;
constexpr int STW_MAX = 8;    // transcript slots a lane (ops STW)
constexpr int ST_REG = 16;    // tid lists up to this width in registers
constexpr int CS = 8;         // CTAs of a walk_init cluster
constexpr int MAX_NT = 512;   // threads of a walk_init block at most
constexpr int INIT_CL = 8;    // walk_init's clusters at most
constexpr int PCS = 16;       // CTAs of a walk_pool cluster (non-portable)
constexpr int POOL_NT = 1024; // threads of a walk_pool block at most
constexpr int GPT_REG = 8;    // walk_init's 32-flag groups a thread kept in
                              // registers (the rest read twice)
constexpr int WT = 128;       // threads of a walk_commit block
constexpr int SMEM_MAX = 232448;   // a block's opted-in shared memory
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int add32(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int sub32(int a, int b) {
  return (int)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int mul32(int a, int b) {
  return (int)((uint32_t)a * (uint32_t)b);
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
// torch.div(a, b, rounding_mode="floor") for b > 0
__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// A cluster barrier split in two: every thread arrives (release), may
// work on, then waits (acquire) for every thread of the cluster.
#ifndef CM_WAVE_LAUNCH
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
#endif

// The inclusive prefix of v over a warp's lanes.
__device__ __forceinline__ int warp_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += y;
  }
  return v;
}

// --------------------------------------------------------------------------
// walk_init: the lane compaction and set-up, a cluster's CTAs ranking the
// flags, the grid's CTAs setting up the lanes
// --------------------------------------------------------------------------

// The launch's shape: blocks of nt threads, clusters of CS CTAs; a CTA's
// chunk of flags is gpt 32-flag groups a thread; a CTA sets up its tpc
// table slots of lanes (32 consecutive lanes of each lane group it takes).
// Up to INIT_CL clusters, more only where a table would outgrow a CTA's
// shared memory.
struct InitGeo {
  int nt, gpt, ncl, tpc;
  size_t smem;
};

InitGeo init_geo(int N, int WPP) {
  InitGeo g;
  const long long groups = (4LL * N + 31) / 32;   // of the flags
  const long long per_cta = (groups + CS - 1) / CS;
  g.nt = (int)(per_cta < MAX_NT ? (per_cta + 31) / 32 * 32 : MAX_NT);
  g.gpt = (int)((per_cta + g.nt - 1) / g.nt);
  const int lgroups = (WPP + 31) / 32;            // of the lanes
  g.ncl = (lgroups + CS - 1) / CS;
  if (g.ncl > INIT_CL) g.ncl = INIT_CL;
  // more clusters where a CTA's table would outgrow its shared memory
  const int tg = (SMEM_MAX / 4 - MAX_NT / 32 - CS) / 32;   // lane groups
  const int need = (lgroups + CS * tg - 1) / (CS * tg);
  if (g.ncl < need) g.ncl = need;
  g.tpc = (lgroups + g.ncl * CS - 1) / (g.ncl * CS) * 32;
  g.smem = 4 * ((size_t)g.tpc + g.nt / 32 + CS);
  return g;
}

// Zero the n words at p, a thread's share of the grid's: a word a store up
// to p's first 16-byte boundary and after its last, 16 bytes a store
// between.
__device__ void zero_words(int32_t* p, long long n, long long tid,
                           long long nthreads) {
  const long long head =
      min(n, (long long)(((16 - ((uintptr_t)p & 15)) & 15) / 4));
  for (long long i = tid; i < head; i += nthreads) p[i] = 0;
  int4* q = reinterpret_cast<int4*>(p + head);
  const long long nv = (n - head) / 4;
  for (long long i = tid; i < nv; i += nthreads) q[i] = make_int4(0, 0, 0, 0);
  for (long long i = head + 4 * nv + tid; i < n; i += nthreads) p[i] = 0;
}

// The active bits of the 32 byte flags at flags + f (none past F).
__device__ uint32_t group_mask(const uint8_t* flags, long long f, long long F) {
  uint32_t m = 0;
  if (f + 32 <= F) {
    const uint4* v = reinterpret_cast<const uint4*>(flags + f);
    const uint4 a = v[0], b = v[1];
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < 32; ++k)
      m |= (uint32_t)(((w[k >> 2] >> (8 * (k & 3))) & 0xffu) != 0) << k;
    return m;
  }
  for (int k = 0; k < 32 && f + k < F; ++k)
    m |= (uint32_t)(flags[f + k] != 0) << k;
  return m;
}

// Set up lane j from flat slot f (live: j < n_act), four threads a lane
// (eight lanes a warp, so that each store of a transcript slot's field
// writes whole 32-byte sectors): thread kk of its group of four tests
// f_iv's tid slots kk, kk + 4, kk + 8 and kk + 12 for r_iv's list (where
// ST <= ST_REG; wider lists each thread alone), four ballots give the
// lane's common tids, and thread kk writes transcript slots kk and
// kk + 4, thread 0 the lane's words.  Every lane of the warp calls it
// (valid: j < WPP).
__device__ void init_lane4(
    bool valid, int j, int f, bool live, const int32_t* __restrict__ pos4,
    const int32_t* __restrict__ len4, const int32_t* __restrict__ aiv4,
    const int32_t* __restrict__ row4, const int32_t* __restrict__ qs04,
    const int32_t* __restrict__ fiv, const int32_t* __restrict__ riv,
    const int32_t* __restrict__ iv_epos, const int32_t* __restrict__ iv_tids,
    const int32_t* __restrict__ trans_start,
    const int32_t* __restrict__ t2s_off, int32_t* __restrict__ inv,
    uint8_t* __restrict__ act, uint8_t* __restrict__ p_live,
    uint8_t* __restrict__ over_tid, int32_t* __restrict__ ws,
    int32_t* __restrict__ slot, int32_t* __restrict__ lane,
    int32_t* __restrict__ prow, int N, int WPP, int STW, int ST, int NIV,
    int NT, int band, int left_bits) {
  const int ln = threadIdx.x & 31, kk = ln & 3, gb = ln & 28;
  int pos = 0, len = 0, aiv = 0, anchor = 0;
  bool left = false;
  const int32_t* tf = iv_tids;
  const int32_t* tr = iv_tids;
  if (valid) {
    pos = pos4[f];
    len = len4[f];
    aiv = aiv4[f];
    left = (left_bits >> (f / N)) & 1;
    const int pn = f % N;
    tf = iv_tids + (size_t)clampi(fiv[pn], 0, NIV - 1) * ST;
    tr = iv_tids + (size_t)clampi(riv[pn], 0, NIV - 1) * ST;
    anchor = iv_epos[clampi(aiv, 0, NIV - 1)];
  }
  // pack[e]: the tid slot of the lane's (kk + 4 e + 1)-th common tid (ST:
  // none); tid[e]: f_iv's tid at pack[e], clamped (a vacant slot takes
  // ST - 1, as the plain clamp does)
  int pack[2] = {ST, ST}, tid[2] = {0, 0}, n_tid = 0;
  if (ST <= ST_REG) {
    int av[4];
    bool mb[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int t = kk + 4 * h;
      av[h] = valid && t < ST ? tf[t] : -1;
      mb[h] = false;
    }
    if (valid && ST % 4 == 0 && ((uintptr_t)iv_tids & 15) == 0) {
#pragma unroll
      for (int u = 0; u < ST_REG; u += 4) {
        if (u < ST) {
          const int4 b = *reinterpret_cast<const int4*>(tr + u);
#pragma unroll
          for (int h = 0; h < 4; ++h)
            mb[h] |= b.x == av[h] || b.y == av[h] || b.z == av[h] ||
                     b.w == av[h];
        }
      }
    } else if (valid) {
#pragma unroll
      for (int u = 0; u < ST_REG; ++u) {
        if (u < ST) {
          const int b = tr[u];
#pragma unroll
          for (int h = 0; h < 4; ++h) mb[h] |= b == av[h];
        }
      }
    }
    unsigned m = 0;                     // bit t: tid slot t is common
#pragma unroll
    for (int h = 0; h < 4; ++h)
      m |= ((__ballot_sync(FULL, live && av[h] >= 0 && mb[h]) >> gb) &
            0xfu) << (4 * h);
    n_tid = __popc(m);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      unsigned r = m;
      for (int i = 0; i < kk + 4 * e && r; ++i) r &= r - 1;
      if (r) pack[e] = __ffs(r) - 1;
      const int pc = clampi(pack[e], 0, ST - 1);
      int v = 0;
#pragma unroll
      for (int h = 0; h < 4; ++h) {     // av[pc / 4] of thread pc mod 4
        const int y = __shfl_sync(FULL, av[h], gb + (pc & 3));
        if (h == pc >> 2) v = y;
      }
      tid[e] = v;
    }
  } else if (valid) {
    for (int t = 0; t < ST; ++t) {
      const int a = tf[t];
      bool memb = false;
      for (int u = 0; u < ST; ++u) memb |= tr[u] == a;
      if (live && a >= 0 && memb) {
        if (n_tid == kk) pack[0] = t;
        if (n_tid == kk + 4) pack[1] = t;
        ++n_tid;
      }
    }
    tid[0] = tf[clampi(pack[0], 0, ST - 1)];
    tid[1] = tf[clampi(pack[1], 0, ST - 1)];
  }
  if (!valid) return;
  const bool over = live && n_tid > STW;
  const size_t plane = (size_t)STW * WPP;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int k = kk + 4 * e;
    if (k >= STW) continue;
    const bool a = pack[e] < ST && !over;
    const int tc = clampi(tid[e], 0, NT - 1);
    const int toff = t2s_off[tc];
    const size_t x = (size_t)k * WPP + j;
    act[x] = a;
    slot[SL_TSTART * plane + x] = trans_start[tc];
    slot[SL_TOFF * plane + x] = toff;
    slot[SL_TLEN * plane + x] = sub32(t2s_off[tc + 1], toff);
    int st[WS_NF];
#pragma unroll
    for (int q = 0; q < WS_NF; ++q) st[q] = 0;
    st[WS_I_ABS] = left ? aiv : add32(aiv, 1);
    st[WS_XPOS] = pos;
    st[WS_EXLEN] = left ? 0 : sub32(anchor, pos);
    st[WS_FIRST] = left;
    st[WS_STAT] = a ? WK_SCAN : WK_DONE;
    st[WS_REMREF] = add32(len, band);
#pragma unroll
    for (int q = 0; q < WS_NF; ++q) ws[q * plane + x] = st[q];
  }
  if (kk == 0) {
    inv[j] = f;
    lane[LN_IS_LEFT * WPP + j] = left;
    lane[LN_QLEN * WPP + j] = len;
    lane[LN_POS * WPP + j] = pos;
    prow[PW_ROW * WPP + j] = row4[f];
    prow[PW_QS0 * WPP + j] = qs04[f];
    p_live[j] = live;
    over_tid[j] = over;
  }
}

// One launch of ncl clusters of CS CTAs.  Each cluster ranks every flag:
// CTA c takes chunk c of the flags, gpt consecutive 32-flag groups a
// thread, loaded 16 bytes at a time (the first GPT_REG groups' masks kept
// in registers, any after them read again to be placed); a block scan of
// the threads' counts, a cluster barrier and the other CTAs' counts
// (distributed shared memory) give each flag's rank r.  Lane j = r - 1
// (r <= WPP) belongs to lane group J = j / 32, set up by cluster J mod
// ncl, CTA (J / ncl) mod CS, at table slot (J / (ncl CS)) 32 + j mod 32:
// the ranking thread writes the flag's index there.  A flag group's over
// bytes are written by cluster (group mod ncl).  After a second cluster
// barrier each CTA sets up its table's lanes, those past n_act from flat
// 4N - 1.
__global__ void __launch_bounds__(MAX_NT) walk_init_kernel(
    const uint8_t* __restrict__ act4, const int32_t* __restrict__ pos4,
    const int32_t* __restrict__ len4, const int32_t* __restrict__ aiv4,
    const int32_t* __restrict__ row4, const int32_t* __restrict__ qs04,
    const int32_t* __restrict__ fiv, const int32_t* __restrict__ riv,
    const int32_t* __restrict__ iv_epos, const int32_t* __restrict__ iv_tids,
    const int32_t* __restrict__ trans_start,
    const int32_t* __restrict__ t2s_off, int32_t* __restrict__ inv,
    int32_t* __restrict__ n_act, uint8_t* __restrict__ over,
    uint8_t* __restrict__ act, uint8_t* __restrict__ p_live,
    uint8_t* __restrict__ over_tid, int32_t* __restrict__ ws,
    int32_t* __restrict__ slot, int32_t* __restrict__ lane,
    int32_t* __restrict__ prow, int32_t* __restrict__ events,
    int32_t* __restrict__ nev, int N, int WPP, int STW, int ST, int NIV,
    int NT, int EW, int band, int left_bits, int gpt, int ncl, int tpc) {
  extern __shared__ __align__(16) unsigned char wave_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int g = (int)blockIdx.x / CS;
  const int nth = blockDim.x, NW = nth >> 5;
  const int x = threadIdx.x, ln = x & 31, wid = x >> 5;
  int* table = reinterpret_cast<int*>(wave_smem);  // [tpc] flat slots
  int* wsum = table + tpc;                         // [NW] warps' prefixes
  int* ctot = wsum + NW;                           // [CS] every CTA's count
  const long long F = 4LL * N;
  // this thread's flag groups and their count: the first GPT_REG groups'
  // masks kept in registers, the rest read again when they are placed
  const long long f0 = ((long long)c * nth + x) * gpt * 32;
  uint32_t mask[GPT_REG];
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < GPT_REG; ++i) {
    mask[i] = i < gpt && f0 + 32 * i < F ? group_mask(act4, f0 + 32 * i, F)
                                         : 0u;
    cnt += __popc(mask[i]);
  }
  for (int i = GPT_REG; i < gpt && f0 + 32 * i < F; ++i)
    cnt += __popc(group_mask(act4, f0 + 32 * i, F));
  const int inc = warp_scan(cnt);
  if (ln == 31) wsum[wid] = inc;
  __syncthreads();
  if (wid == 0) {
    const int v = ln < NW ? wsum[ln] : 0;
    const int iv = warp_scan(v);
    if (ln < NW) wsum[ln] = iv - v;
    const int all = __shfl_sync(FULL, iv, 31);
    if (ln < CS) cluster.map_shared_rank(ctot, ln)[c] = all;   // to CTA ln
  }
  cluster_arrive();                     // every CTA's count pushed
  // the events and counts, independent of the rank, while the cluster
  // gathers
  const long long gtid = (long long)blockIdx.x * nth + x;
  const long long gthreads = (long long)gridDim.x * nth;
  zero_words(events, (long long)STW * EW * EV_NF * WPP, gtid, gthreads);
  zero_words(nev, (long long)STW * WPP, gtid, gthreads);
  cluster_wait();
  int total = 0, cbase = 0;
#pragma unroll
  for (int r = 0; r < CS; ++r) {
    total += ctot[r];
    cbase += r < c ? ctot[r] : 0;
  }
  const int nact = min(total, WPP);
  if (g == 0 && c == 0 && x == 0) n_act[0] = nact;
  int r = cbase + wsum[wid] + inc - cnt;   // the flags before this thread's
  // group fg's flags m from rank r on: its over bytes, its lanes' table
  // slots
  auto place = [&](uint32_t m, long long fg) {
    if ((fg >> 5) % ncl == g) {         // this group's over bytes
      // the flags past rank WPP: m's set bits after its first WPP - r
      uint32_t om = m;
      for (int i = 0; i < WPP - r && om; ++i) om &= om - 1;
      uint32_t w[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const uint32_t b = (om >> (4 * q)) & 15u;
        w[q] = (b & 1u) | (b & 2u) << 7 | (b & 4u) << 14 | (b & 8u) << 21;
      }
      if (fg + 32 <= F && ((uintptr_t)(over + fg) & 15) == 0) {
        uint4* o = reinterpret_cast<uint4*>(over + fg);
        o[0] = make_uint4(w[0], w[1], w[2], w[3]);
        o[1] = make_uint4(w[4], w[5], w[6], w[7]);
      } else {
        for (int k = 0; k < 32 && fg + k < F; ++k)
          over[fg + k] = (uint8_t)(w[k / 4] >> (8 * (k % 4)));
      }
    }
    int rk = r;
    r += __popc(m);
    while (m && rk < WPP) {             // this group's lanes
      const int b = __ffs(m) - 1;
      m &= m - 1;
      const int j = rk++;
      const int J = j >> 5;
      if (J % ncl != g) continue;
      const int s = (J / (ncl * CS)) * 32 + (j & 31);
      cluster.map_shared_rank(table, (J / ncl) % CS)[s] = (int)(fg + b);
    }
  };
#pragma unroll
  for (int i = 0; i < GPT_REG; ++i) {
    if (i >= gpt || f0 + 32 * i >= F) break;
    place(mask[i], f0 + 32 * i);
  }
  for (int i = GPT_REG; i < gpt && f0 + 32 * i < F; ++i)
    place(group_mask(act4, f0 + 32 * i, F), f0 + 32 * i);
  cluster.sync();                       // every table filled
  for (int s0 = wid * 8; s0 < tpc; s0 += NW * 8) {   // eight lanes a warp
    const int s = s0 + (ln >> 2);
    const int j = (((s >> 5) * CS + c) * ncl + g) * 32 + (s & 31);
    const bool live = j < nact;
    init_lane4(j < WPP, j, live ? table[s] : (int)(F - 1), live, pos4, len4,
               aiv4, row4, qs04, fiv, riv, iv_epos, iv_tids, trans_start,
               t2s_off, inv, act, p_live, over_tid, ws, slot, lane, prow, N,
               WPP, STW, ST, NIV, NT, band, left_bits);
  }
}

// --------------------------------------------------------------------------
// walk_pool: a cluster a pool, a thread a lane, a warp a pool row
// --------------------------------------------------------------------------

// The launch's shape: two clusters of PCS blocks of nt threads (a lane
// each, nch lanes a thread), lpc lanes a CTA, rpc pool rows a CTA.  The
// codes and words of a thread's first nchs lanes and a CTA's first rcap
// rows' geometry stay in shared memory (all of them unless the shapes
// outgrow it): a later lane's are loaded again in pass B, a later row's
// geometry is recomputed from its flat index after the second barrier.
struct PoolGeo {
  int nt, lpc, nch, rpc, nchs, rcap;
  size_t smem;
};

PoolGeo pool_geo(int WPP, int MIDP, int ENDP, int W) {
  PoolGeo g;
  g.lpc = (WPP + PCS - 1) / PCS;
  g.nt = g.lpc < POOL_NT ? (g.lpc + 31) / 32 * 32 : POOL_NT;
  g.nch = (g.lpc + g.nt - 1) / g.nt;
  g.rpc = ((MIDP > ENDP ? MIDP : ENDP) + PCS - 1) / PCS;
  const size_t m = (size_t)g.nch * g.nt / 32;
  const size_t fixed = ((2 * (size_t)W + 15) & ~(size_t)15) +
                       4 * (STW_MAX * m + PCS * STW_MAX + 2 * STW_MAX + 4);
  const size_t avail = fixed < SMEM_MAX ? SMEM_MAX - fixed : 0;
  const size_t lanes_fit = avail / (20 * (size_t)g.nt);   // whole chunks
  g.nchs = (int)(lanes_fit < (size_t)g.nch ? lanes_fit : g.nch);
  const size_t rows_fit = (avail - 20 * (size_t)g.nchs * g.nt) / 16;
  g.rcap = (int)(rows_fit < (size_t)g.rpc ? rows_fit : g.rpc);
  g.smem = fixed + 20 * (size_t)g.nchs * g.nt + 16 * (size_t)g.rcap;
  return g;
}

// A pool row's geometry: the query window starts at q0 and the reference
// window at r0, each stepping by -1 (left) or +1; qn and rn bases of each.
// MID: s = the query window of remq = min(exlen + band, qlen - cov) bases,
// t = the reference window of exlen; END: s = the reference window of rr,
// t = the query window of need = qlen - cov.  Right lanes read forward
// from qs0 + cov and pend_xpos; left lanes reversed, the query ending at
// qs0 + qlen - cov (MID) or qs0 + need (END), the reference at
// pend_xpos - 1.  rn is exlen (MID) or rr (END); lw the lane's words
// (is_left, qlen, row * L, qs0).
struct PoolRowGeo {
  int q0, r0, qn, rn;
  bool left;
};

__device__ __forceinline__ PoolRowGeo pool_row(int xpos, int cov, int rn,
                                               int4 lw, bool mid, int band) {
  PoolRowGeo p;
  p.left = lw.x != 0;
  const int qlen = lw.y, base = lw.z, qs0 = lw.w;
  const int need = sub32(qlen, cov);
  p.qn = mid ? min(add32(rn, band), need) : need;
  p.rn = rn;
  if (!p.left) {
    p.q0 = add32(base, add32(qs0, cov));
    p.r0 = xpos;
  } else {
    const int qend = mid ? sub32(add32(qs0, qlen), cov) : add32(qs0, p.qn);
    p.q0 = add32(base, sub32(qend, 1));
    p.r0 = sub32(xpos, 2);      // (xpos - rn - 1) + (rn - 1)
  }
  return p;
}

// Lane l's words for pool_row.
__device__ __forceinline__ int4 lane_words(const int32_t* __restrict__ lane,
                                           const int32_t* __restrict__ prow,
                                           int WPP, int l, int L) {
  return make_int4(lane[LN_IS_LEFT * WPP + l], lane[LN_QLEN * WPP + l],
                   mul32(prow[PW_ROW * WPP + l], L), prow[PW_QS0 * WPP + l]);
}

// A lane's bases io = ln + 32 k of a row's query (qv) and reference (rv)
// windows; qn and rn clamped to [0, W].
__device__ __forceinline__ void window_bytes(
    int q0, int r0, int qn, int rn, bool left, int ln,
    const int8_t* __restrict__ seqsf, const int8_t* __restrict__ genome,
    int RL, int G, int8_t* qv, int8_t* rv) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int io = ln + 32 * k;
    const int step = left ? -io : io;
    const int qi = add32(q0, step), ri = add32(r0, step);
    qv[k] = io < qn ? seqsf[clampi(qi, 0, RL - 1)] : (int8_t)127;
    rv[k] = (io < rn && ri >= 0 && ri < G) ? genome[ri] : (int8_t)127;
  }
}

// Lane l's dedup codes, 4 bits a slot: the first earlier slot in the
// pool with its geometry (the first match wins), LEAD_CODE or NONE_CODE;
// any: a slot of the lane is in the pool, and then lw its words.  Its STW
// slots' status is loaded first, then the geometry of those in the pool,
// lane-minor, and the words, all before the dedup.
__device__ __forceinline__ uint32_t lane_codes(
    const int32_t* __restrict__ stat, const int32_t* __restrict__ fx,
    const int32_t* __restrict__ f1, const int32_t* __restrict__ f2,
    const int32_t* __restrict__ lane, const int32_t* __restrict__ prow,
    int l, int L, bool ok, bool mid, int STW, int WPP, bool& any,
    int4& lw) {
  bool in[STW_MAX];
  any = false;
#pragma unroll
  for (int t = 0; t < STW_MAX; ++t) {
    const int sv = ok && t < STW ? stat[(size_t)t * WPP + l] : WK_DONE;
    in[t] = mid ? (sv == WK_PMID || sv == WK_PTRAIL) : sv == WK_PEND;
    any |= in[t];
  }
  int a[STW_MAX], b[STW_MAX], d[STW_MAX];
#pragma unroll
  for (int t = 0; t < STW_MAX; ++t) {
    const size_t o = (size_t)t * WPP + l;
    a[t] = in[t] ? fx[o] : 0;
    b[t] = in[t] ? f1[o] : 0;
    d[t] = in[t] ? f2[o] : 0;
  }
  if (any) lw = lane_words(lane, prow, WPP, l, L);
  uint32_t cw = 0;
#pragma unroll
  for (int t = 0; t < STW_MAX; ++t) {
    int cd = in[t] ? LEAD_CODE : NONE_CODE;
#pragma unroll
    for (int u = t - 1; u >= 0; --u)
      if (in[t] && in[u] && a[u] == a[t] && b[u] == b[t] && d[u] == d[t])
        cd = u;
    cw |= (uint32_t)cd << (4 * t);
  }
  return cw;
}

// One launch of two clusters of PCS CTAs: MID (the first) and END.  CTA
// c owns lanes [c lpc, (c + 1) lpc), a thread lane c lpc + i nt + x of
// each chunk i.  Pass A loads a lane's STW slots' status, then the
// geometry of the slots in the pool and the lane's words where it has
// one, and dedups them (a slot's code: the first earlier slot in the pool
// with its geometry, or LEAD_CODE, or NONE_CODE); ballots count each
// (slot, chunk, warp)'s leaders, a warp a slot scans them and pushes the
// slot's count to every CTA of the cluster (distributed shared memory).
// While the cluster barrier completes, one warp gathers flat S - 1's
// windows, which every dead row (j >= n) holds, into shared memory.
// After it a leader of slot t in lane l has rank start[t] (every leader
// of the slots before t, and of slot t in the CTAs before) + its (chunk,
// warp)'s prefix + the leaders below it in its ballot + 1.  Pass B writes
// the maps, each leader's row (n, m, flat index, the MID pool's tiny
// mask) and its window geometry to table slot j / PCS of CTA j mod PCS,
// so that the rows spread evenly over the CTAs whichever lanes hold them.
// After a second cluster barrier warp w of CTA c gathers rows j = q PCS +
// c, q = w, w + NW, ...; a dead row copies the dead window.  Where the
// shapes outgrow shared memory (pool_geo; FITS false), pass B loads and
// dedups a thread's lanes past its first nchs again, and a row past its
// CTA's rcap table slots takes its geometry from its flat index (PR_INV,
// written before the barrier); where they fit (FITS) neither path is
// compiled, so the main path's registers stay those of the passes alone.
template <bool FITS>
__global__ void __launch_bounds__(POOL_NT) walk_pool_kernel(
    const int32_t* __restrict__ ws, const int32_t* __restrict__ lane,
    const int32_t* __restrict__ prow, const int8_t* __restrict__ seqsf,
    const int8_t* __restrict__ genome, int8_t* __restrict__ m_win,
    int32_t* __restrict__ m_rows, uint8_t* __restrict__ m_tiny,
    int8_t* __restrict__ e_win, int32_t* __restrict__ e_rows,
    int32_t* __restrict__ n, int32_t* __restrict__ maps, int STW, int WPP,
    int RL, int G, int L, int band, int MIDP, int ENDP, int W, int lpc,
    int nch, int rpc, int nchs, int rcap) {
  extern __shared__ __align__(16) unsigned char wave_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const bool mid = (int)blockIdx.x < PCS;
  const int P = mid ? MIDP : ENDP;
  const int NT = blockDim.x, NW = NT >> 5;
  const int x = threadIdx.x, ln = x & 31, wid = x >> 5;
  const unsigned lt = (1u << ln) - 1;
  const int M = nch * NW;               // (chunk, warp)s a slot
  int4* table = reinterpret_cast<int4*>(wave_smem);  // [rcap] rows' windows
  int4* lanew = table + rcap;                         // [nchs NT]
  int8_t* dead = reinterpret_cast<int8_t*>(lanew + nchs * NT);  // [2 W]
  int* cnt = reinterpret_cast<int*>(dead + ((2 * W + 15) & ~15));
  uint32_t* code = reinterpret_cast<uint32_t*>(cnt + STW_MAX * M);
  // [PCS][STW_MAX]: each CTA's leaders a slot, pushed by that CTA
  int* rt = reinterpret_cast<int*>(code + nchs * NT);
  int* start = rt + PCS * STW_MAX;      // [STW_MAX]: the CTAs' before
  int* allv = start + STW_MAX;          // [STW_MAX]: every CTA's
  int* dgeo = allv + STW_MAX;           // the dead rows' n, m, tiny
  const size_t plane = (size_t)STW * WPP;
  const int S = STW * WPP;
  const int32_t* stat = ws + WS_STAT * plane;
  const int32_t* fx = ws + WS_PEND_XPOS * plane;
  const int32_t* f1 =
      ws + (mid ? WS_PEND_EXLEN : WS_PEND_COV) * plane;
  const int32_t* f2 = ws + (mid ? WS_PEND_COV : WS_PEND_RR) * plane;
  const int32_t* fcov = ws + WS_PEND_COV * plane;
  const int32_t* frn = ws + (mid ? WS_PEND_EXLEN : WS_PEND_RR) * plane;
  const int l0 = c * lpc;
  // pass A: each lane's codes, the leaders of each (slot, chunk, warp)
  for (int i = 0; i < nch; ++i) {
    const int k = i * NT + x;
    const int l = l0 + k;
    bool any;
    int4 lw;
    const uint32_t cw = lane_codes(stat, fx, f1, f2, lane, prow, l, L,
                                   k < lpc && l < WPP, mid, STW, WPP, any,
                                   lw);
    if (FITS || i < nchs) {
      if (any) lanew[k] = lw;
      code[k] = cw;
    }
#pragma unroll
    for (int t = 0; t < STW_MAX; ++t) {
      const unsigned bal =
          __ballot_sync(FULL, ((cw >> (4 * t)) & 15) == LEAD_CODE);
      if (ln == 0) cnt[t * M + i * NW + wid] = __popc(bal);
    }
  }
  __syncthreads();
  for (int t = wid; t < STW_MAX; t += NW) {   // a slot's exclusive prefix
    int carry = 0;
    for (int e0 = 0; e0 < M; e0 += 32) {
      const int e = e0 + ln;
      const int v = e < M ? cnt[t * M + e] : 0;
      const int iv = warp_scan(v);
      if (e < M) cnt[t * M + e] = carry + iv - v;
      carry += __shfl_sync(FULL, iv, 31);
    }
    if (ln < PCS)                       // to CTA ln
      cluster.map_shared_rank(rt, ln)[c * STW_MAX + t] = carry;
  }
  cluster_arrive();                     // every CTA's counts a slot
  if (wid == NW - 1) {                  // flat S - 1's windows, once
    const PoolRowGeo p = pool_row(fx[S - 1], fcov[S - 1], frn[S - 1],
                                  lane_words(lane, prow, WPP, WPP - 1, L),
                                  mid, band);
    int8_t qv[4], rv[4];
    window_bytes(p.q0, p.r0, clampi(p.qn, 0, W), clampi(p.rn, 0, W),
                 p.left, ln, seqsf, genome, RL, G, qv, rv);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int io = ln + 32 * k;
      if (io < W) {
        dead[io] = qv[k];
        dead[W + io] = rv[k];
      }
    }
    if (ln == 0) {
      dgeo[0] = mid ? p.qn : p.rn;
      dgeo[1] = mid ? p.rn : p.qn;
      dgeo[2] = p.qn <= 2 * band || p.rn <= band;
    }
  }
  cluster_wait();
  if (x < STW_MAX) {
    int before = 0, all = 0;
    for (int r = 0; r < PCS; ++r) {
      const int v = rt[r * STW_MAX + x];
      all += v;
      before += r < c ? v : 0;
    }
    start[x] = before;
    allv[x] = all;
  }
  __syncthreads();
  int base[STW_MAX];
  int total = 0;
#pragma unroll
  for (int t = 0; t < STW_MAX; ++t) {
    base[t] = total + start[t];
    total += allv[t];
  }
  const int nlive = min(total, P);
  if (c == 0 && x == 0) n[mid ? POOL_MID : POOL_END] = nlive;
  int32_t* rows = mid ? m_rows : e_rows;
  // pass B: the maps, the leaders' rows and their windows' geometry
  for (int i = 0; i < nch; ++i) {
    const int k = i * NT + x;
    const int l = l0 + k;
    const bool ok = k < lpc && l < WPP;
    bool any;
    int4 lw;
    const uint32_t cw =
        FITS || i < nchs ? code[k]     // past shared memory: again
                         : lane_codes(stat, fx, f1, f2, lane, prow, l, L, ok,
                                      mid, STW, WPP, any, lw);
    int mc[STW_MAX];
#pragma unroll
    for (int t = 0; t < STW_MAX; ++t) {
      const int cd = (cw >> (4 * t)) & 15;
      const unsigned bal = __ballot_sync(FULL, cd == LEAD_CODE);
      int v = MAP_NONE;
      if (cd == LEAD_CODE) {
        const int r = base[t] + cnt[t * M + i * NW + wid] +
                      __popc(bal & lt) + 1;
        v = r <= P ? r - 1 : MAP_OVER;
        if (r <= P) {
          const int j = r - 1, f = t * WPP + l;
          const PoolRowGeo p = pool_row(
              fx[f], fcov[f], frn[f],
              FITS || i < nchs ? lanew[k]
                               : lane_words(lane, prow, WPP, l, L),
              mid, band);
          rows[PR_N * P + j] = mid ? p.qn : p.rn;
          rows[PR_M * P + j] = mid ? p.rn : p.qn;
          rows[PR_INV * P + j] = f;
          if (mid) m_tiny[j] = p.qn <= 2 * band || p.rn <= band;
          if (FITS || j / PCS < rcap)   // else gathered from PR_INV
            cluster.map_shared_rank(table, j % PCS)[j / PCS] = make_int4(
                p.q0, p.r0, clampi(p.qn, 0, W) | clampi(p.rn, 0, W) << 16,
                p.left);
        }
      } else if (cd != NONE_CODE) {     // a follower: its leader's code
#pragma unroll
        for (int u = 0; u < STW_MAX; ++u)
          if (u == cd) v = mc[u];
      }
      mc[t] = v;
      if (ok && t < STW)
        maps[(mid ? 0 : plane) + (size_t)t * WPP + l] = v;
    }
  }
  cluster.sync();                       // every row's geometry in place
  // this CTA's rows j = q PCS + c: live ones q < q_dead, dead ones after;
  // a live row past the table takes its geometry from its flat index
  const int q_end = P > c ? (P - c + PCS - 1) / PCS : 0;
  const int q_dead = nlive > c ? (nlive - c + PCS - 1) / PCS : 0;
  int8_t* gq = mid ? m_win : e_win + (size_t)ENDP * W;
  int8_t* gr = mid ? m_win + (size_t)MIDP * W : e_win;
  for (int q = wid; q < q_end; q += NW) {
    const int j = q * PCS + c;
    const bool live = q < q_dead;
    int8_t qv[4], rv[4];
    if (live) {
      int4 p;
      if (FITS || q < rcap) {
        p = table[q];
      } else {
        const int f = rows[PR_INV * P + j], l = f % WPP;
        const PoolRowGeo g = pool_row(fx[f], fcov[f], frn[f],
                                      lane_words(lane, prow, WPP, l, L), mid,
                                      band);
        p = make_int4(g.q0, g.r0,
                      clampi(g.qn, 0, W) | clampi(g.rn, 0, W) << 16, g.left);
      }
      window_bytes(p.x, p.y, p.z & 0xffff, p.z >> 16, p.w != 0, ln, seqsf,
                   genome, RL, G, qv, rv);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int io = ln + 32 * k;
      if (io < W) {
        gq[(size_t)j * W + io] = live ? qv[k] : dead[io];
        gr[(size_t)j * W + io] = live ? rv[k] : dead[W + io];
      }
    }
    if (!live && ln == 0) {
      rows[PR_N * P + j] = dgeo[0];
      rows[PR_M * P + j] = dgeo[1];
      rows[PR_INV * P + j] = S - 1;
      if (mid) m_tiny[j] = dgeo[2];
    }
  }
}

// --------------------------------------------------------------------------
// walk_commit: a thread a (slot, lane)
// --------------------------------------------------------------------------

__global__ void __launch_bounds__(WT) walk_commit_kernel(
    const int32_t* __restrict__ ws, const int32_t* __restrict__ maps,
    const int32_t* __restrict__ md, const int32_t* __restrict__ xres,
    const int32_t* __restrict__ e_rows, const int32_t* __restrict__ lane,
    const int32_t* __restrict__ iv_spos, const int32_t* __restrict__ iv_epos,
    int32_t* __restrict__ events, int32_t* __restrict__ nev,
    int32_t* __restrict__ ws_out, int STW, int WPP, int EW, int MIDP,
    int ENDP, int NIV, int mat, int mis, int band, int max_ed, int max_sc) {
  const size_t plane = (size_t)STW * WPP;
  const size_t x = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= plane) return;
  const int t = (int)(x / WPP), l = (int)(x % WPP);
  int st[WS_NF];
#pragma unroll
  for (int q = 0; q < WS_NF; ++q) st[q] = ws[q * plane + x];
  const bool left = lane[LN_IS_LEFT * WPP + l] != 0;
  const int mm = maps[POOL_MID * plane + x];
  const int em = maps[POOL_END * plane + x];
  const int md_ed = mm >= 0 ? md[2 * mm] : 0;
  const int md_in = mm >= 0 ? md[2 * mm + 1] : 0;
  // the leader's end DP through _drop_wrap for this lane's side
  int e_ed = 0, e_scl = 0, e_ind = 0, e_scr = 0;
  if (em >= 0) {
    const int sc = xres[3 * em], on_s = xres[3 * em + 1];
    const int on_t = xres[3 * em + 2];
    const int m = e_rows[PR_M * ENDP + em];
    const int ed = floordiv(sub32(mul32(mat, max(on_s, on_t)), sc),
                            mat - mis);
    const bool ok = ed <= max_ed && (left || sc >= 0);
    e_ed = ok ? ed : add32(max_ed, 1);
    e_scl = ok ? sub32(m, on_t) : add32(max(m, max_sc), 1);
    e_ind = ok ? sub32(on_t, on_s) : add32(band, 1);
    e_scr = sc;
  }
  const int stat = st[WS_STAT];
  const bool mid_c = stat == WK_PMID && mm != MAP_OVER;
  const bool tr_c = stat == WK_PTRAIL && mm != MAP_OVER;
  const bool end_c = stat == WK_PEND && em != MAP_OVER;
  const bool endnd_c = stat == WK_PENDND;
  if (mid_c || tr_c || end_c || endnd_c) {
    int ev[EV_NF];
    ev[EV_KIND] = mid_c ? EVK_MID : tr_c ? EVK_TRAIL
                                         : end_c ? EVK_END : EVK_ENDND;
    ev[EV_XPOS] = st[WS_PEND_XPOS];
    ev[EV_AUX] = (end_c || endnd_c) ? st[WS_PEND_COV] : st[WS_PEND_EXLEN];
    ev[EV_ED] = end_c ? e_ed : endnd_c ? 0 : md_ed;
    ev[EV_INDEL] = end_c ? e_ind : endnd_c ? 0 : md_in;
    ev[EV_SCLEN] = end_c ? e_scl : 0;
    ev[EV_SCORE] = end_c ? e_scr : endnd_c ? 0 : sub32(0, md_ed);
    const int n = nev[x];
    int32_t* dst = events + ((size_t)t * EW + clampi(n, 0, EW - 1)) *
                                EV_NF * WPP + l;
#pragma unroll
    for (int q = 0; q < EV_NF; ++q) dst[(size_t)q * WPP] = ev[q];
    nev[x] = add32(n, 1);
  }
  if (mid_c) {
    // covered/remref advance + rescan positioning: right rspos =
    // iv_spos[pend] - 1, exlen = len(pend), i = pend + 1 (extend.py:
    // 421-428); left exlen = 0, i = pend - 1 (:545-547)
    const int pend = st[WS_PEND_IV];
    st[WS_COVERED] = add32(st[WS_COVERED], sub32(st[WS_PEND_EXLEN], md_in));
    st[WS_REMREF] = sub32(st[WS_REMREF], st[WS_PEND_EXLEN]);
    if (!left) {
      const int p = clampi(pend, 0, NIV - 1);
      st[WS_XPOS] = sub32(iv_spos[p], 1);
      st[WS_EXLEN] = add32(sub32(iv_epos[p], iv_spos[p]), 1);
      st[WS_I_ABS] = add32(pend, 1);
    } else {
      st[WS_EXLEN] = 0;
      st[WS_I_ABS] = sub32(pend, 1);
    }
    st[WS_STAT] = WK_SCAN;
  } else if (tr_c || end_c || endnd_c) {
    st[WS_STAT] = WK_DONE;
  }
#pragma unroll
  for (int q = 0; q < WS_NF; ++q) ws_out[q * plane + x] = st[q];
}

__global__ void wave_empty_kernel(int) {}

}  // namespace

// Each entry point launches its kernel on the given stream and returns the
// first non-zero CUDA error (0 when the launch was accepted).
// CM_WAVE_LAUNCH is the only launch site, so a host emulation can define
// it first.
#ifndef CM_WAVE_LAUNCH
// KERNEL on grid blocks of nt threads in clusters of `cluster` CTAs (none
// for 1), with smem bytes of dynamic shared memory.
template <typename... P, typename... A>
static int wave_launch(void (*kernel)(P...), int grid, int cluster, int nt,
                       size_t smem, cudaStream_t stream, A... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (cluster > 8) {                    // past the portable cluster size
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(nt);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1;           // walk_commit: a plain launch
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
#define CM_WAVE_LAUNCH(KERNEL, grid, cluster, nt, smem, stream, ...) \
  wave_launch(KERNEL, grid, cluster, nt, smem, stream, __VA_ARGS__)
#endif

// walk_init reads its byte flags 16 bytes at a time.
extern "C" int cm_walk_init(
    const void* act4, const void* pos4, const void* len4, const void* aiv4,
    const void* row4, const void* qs04, const void* fiv, const void* riv,
    const void* iv_epos, const void* iv_tids, const void* trans_start,
    const void* t2s_off, void* inv, void* n_act, void* over, void* act,
    void* p_live, void* over_tid, void* ws, void* slot, void* lane,
    void* prow, void* events, void* nev, int N, int WPP, int STW, int ST,
    int NIV, int NT, int EW, int band, int left_bits, void* stream) {
  if (STW > STW_MAX || STW > ST || N <= 0 || WPP <= 0)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)act4 % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const InitGeo g = init_geo(N, WPP);
  return CM_WAVE_LAUNCH(
      walk_init_kernel, g.ncl * CS, CS, g.nt, g.smem, (cudaStream_t)stream,
      (const uint8_t*)act4, (const int32_t*)pos4, (const int32_t*)len4,
      (const int32_t*)aiv4, (const int32_t*)row4, (const int32_t*)qs04,
      (const int32_t*)fiv, (const int32_t*)riv, (const int32_t*)iv_epos,
      (const int32_t*)iv_tids, (const int32_t*)trans_start,
      (const int32_t*)t2s_off, (int32_t*)inv, (int32_t*)n_act,
      (uint8_t*)over, (uint8_t*)act, (uint8_t*)p_live, (uint8_t*)over_tid,
      (int32_t*)ws, (int32_t*)slot, (int32_t*)lane, (int32_t*)prow,
      (int32_t*)events, (int32_t*)nev, N, WPP, STW, ST, NIV, NT, EW, band,
      left_bits, g.gpt, g.ncl, g.tpc);
}

// walk_pool's windows are at most 128 bases (a lane four of each).
extern "C" int cm_walk_pool(const void* ws, const void* lane,
                            const void* prow, const void* seqsf,
                            const void* genome, void* m_win, void* m_rows,
                            void* m_tiny, void* e_win, void* e_rows, void* n,
                            void* maps, int STW, int WPP, int RL, int G,
                            int L, int band, int MIDP, int ENDP, int W,
                            void* stream) {
  if (STW > STW_MAX || STW <= 0 || WPP <= 0 || MIDP <= 0 || ENDP <= 0 ||
      W <= 0 || W > 128)
    return (int)cudaErrorInvalidValue;
  const PoolGeo g = pool_geo(WPP, MIDP, ENDP, W);
  if (g.smem > SMEM_MAX) return (int)cudaErrorInvalidValue;  // its counts
  const bool fits = g.nchs == g.nch && g.rcap == g.rpc;
  return CM_WAVE_LAUNCH(
      (fits ? walk_pool_kernel<true> : walk_pool_kernel<false>), 2 * PCS,
      PCS, g.nt, g.smem, (cudaStream_t)stream,
      (const int32_t*)ws, (const int32_t*)lane, (const int32_t*)prow,
      (const int8_t*)seqsf, (const int8_t*)genome, (int8_t*)m_win,
      (int32_t*)m_rows, (uint8_t*)m_tiny, (int8_t*)e_win, (int32_t*)e_rows,
      (int32_t*)n, (int32_t*)maps, STW, WPP, RL, G, L, band, MIDP, ENDP, W,
      g.lpc, g.nch, g.rpc, g.nchs, g.rcap);
}

extern "C" int cm_walk_commit(const void* ws, const void* maps,
                              const void* md, const void* xres,
                              const void* e_rows, const void* lane,
                              const void* iv_spos, const void* iv_epos,
                              void* events, void* nev, void* ws_out, int STW,
                              int WPP, int EW, int MIDP, int ENDP, int NIV,
                              int mat, int mis, int band, int max_ed,
                              int max_sc, void* stream) {
  if (mat - mis <= 0 || EW <= 0 || NIV <= 0)
    return (int)cudaErrorInvalidValue;
  const long long slots = (long long)STW * WPP;
  return CM_WAVE_LAUNCH(
      walk_commit_kernel, (int)((slots + WT - 1) / WT), 1, WT, 0,
      (cudaStream_t)stream, (const int32_t*)ws, (const int32_t*)maps,
      (const int32_t*)md, (const int32_t*)xres, (const int32_t*)e_rows,
      (const int32_t*)lane, (const int32_t*)iv_spos, (const int32_t*)iv_epos,
      (int32_t*)events, (int32_t*)nev, (int32_t*)ws_out, STW, WPP, EW, MIDP,
      ENDP, NIV, mat, mis, band, max_ed, max_sc);
}

// An empty kernel on the grid (blocks, clusters, threads and dynamic
// shared memory) that an entry point (a WaveKernel) launches for these
// shapes: the launch floor under its device time.  Returns the number of
// grids launched (1), or -1 if the launch failed.  Not counted as a
// launch.
extern "C" int cm_wave_empty(int kernel, int STW, int WPP, int N, int MIDP,
                             int ENDP, int W, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  int err;
  if (kernel == WAVE_INIT) {
    const InitGeo g = init_geo(N, WPP);
    err = CM_WAVE_LAUNCH(wave_empty_kernel, g.ncl * CS, CS, g.nt, g.smem, s,
                         0);
  } else if (kernel == WAVE_POOL) {
    const PoolGeo g = pool_geo(WPP, MIDP, ENDP, W);
    err = CM_WAVE_LAUNCH(wave_empty_kernel, 2 * PCS, PCS, g.nt, g.smem, s, 0);
  } else {
    const long long slots = (long long)STW * WPP;
    err = CM_WAVE_LAUNCH(wave_empty_kernel, (int)((slots + WT - 1) / WT), 1,
                         WT, 0, s, 0);
  }
  return err ? -1 : 1;
}
