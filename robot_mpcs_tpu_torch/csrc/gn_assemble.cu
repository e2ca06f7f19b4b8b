// Gauss-Newton assembly of the augmented-Lagrangian stage model, hand-written
// for Hopper (sm_90a).
//
// Replaces the JAX package's hand-written batch rule _gn_assemble_vmap
// (robot_mpcs_tpu/solver/al_ilqr.py:228, the vmap rule of gn_assemble,
// :224-299) fused with the per-row coefficients it is fed (_coefs, :174,
// through _expansion_coefs, :301). Per (lane, stage) of the split expansion:
//
//   per row: residual rows  g = 2 w r,              h = 2 w
//            barrier rows   g = -w / b^2,           h = max(2 w / b^3, 0)
//                           (b = max(b, 1e-3); both 0 where b <= 1e-3)
//            constraint rows act = max(lam - mu c, 0), g = -act, h = mu [act > 0]
//                           (c the row plus C_OFF, the stage-0 pin, and for a
//                           q-family row with a slack column, plus s = W[0])
//   g = S^T g_aff + Jq^T g_q (+ the q constraint rows' sum at the slack column)
//   H = S^T diag(h_aff) S + Jq^T diag(h_q) Jq (+ the slack column's cross terms)
//
// written as the five Riccati blocks lx (nx), lw (nw), lxx (nx x nx), lxw
// (nx x nw), lww (nw x nw), with no (M, nv, nv) tensor between. Only the
// upper triangle j >= i is computed and it is mirrored, so H is exactly
// symmetric, as the JAX rule does (:280). The affine rows' Jacobian S_aff is
// a build-time constant with one or two non-zeros a row: the wrapper
// (ops/gn_assemble.py) re-indexes its non-zeros (the JAX rule's _S_nz, :200)
// by the output entry they feed, a CSR table per gradient entry (S[r, i]) and
// per upper entry of H (S[r, i] S[r, j]), so an entry's affine part is a
// loop over its own few rows instead of an (n_arows x nv^2) product.
//
// What bounds it on an H100: bytes. A (lane, stage) reads its q rows, their
// Jacobian, its affine rows, the four weight vectors and its multipliers
// (239 floats at the panda) and writes nv + nx^2 + nx nw + nw^2 floats (364);
// at B = 4096, N = 20 that is 198 MB, 59 us at 3.35 TB/s, against ~2,100
// flops an item (0.17 GFLOP, 2.5 us at the fp32 rate).
//
// The design. A thread per item cannot hold the nv (nv + 1) / 2 accumulators
// (231 at the panda, 496 at the mobile panda), and a warp per item (the first
// port) spent ~2,300 issue cycles an item on branches that split its threads
// (each thread its own entry, row kind and CSR trip count) and on chains of
// dependent table loads: 227 us at the panda's phase 1, 0.26 of the bound.
// Here the 32 lanes of every warp are 32 items, a group, and all the block's
// warps work on the same group (97.5 us, 0.61 of the bound; both in turns on
// an H100 SXM at 700 W, chip_kernel_pairs.py: 2.0 TB/s). What is left is
// each group's latency in its block (the B = 1 planner's one group takes
// 7.1 us), with two blocks an SM at the panda:
//   1. Inputs, block-staged two stages deep: while a group computes, the
//      block copies the next group's slabs (each input's rows of 32
//      consecutive items are contiguous) into the other stage buffer with
//      4-byte cp.async, consecutive threads on consecutive floats, as one
//      record per item (odd stride: a warp reading one field of its 32
//      items touches 32 banks): the rows' values (q rows, then affine rows),
//      their second scalars in the same order (the weights, then the
//      multipliers of the constraint rows), the q Jacobian, the slack.
//   2. Row coefficients, in place, segment by segment (residual, barrier,
//      constraint rows; q family, then affine): warp w takes rows w, w + 8,
//      ... of each, unrolled so that their loads are in flight together;
//      one warp instruction is one row for 32 items, with no branch; (value,
//      second scalar) become (g, h).
//   3. Entries: the gradient and H's upper triangle, one schedule entry at a
//      time per warp (entries w, w + 8, ...), the same entry for its 32
//      items: its kind, its CSR terms (row, coefficient) and its output
//      places are read from shared memory as broadcasts and every trip count
//      is uniform. Only the live entries are scheduled (63 of 252 at the
//      panda): an entry that no term feeds is 0 in every group, written into
//      the tile once per block. The schedule and the terms (ops/gn_assemble.py
//      entry_schedule: S_aff's non-zeros by the entry they feed, the entries
//      ordered by kind and trip count and dealt round robin, so the warps'
//      shares match) are copied once per block, which is persistent: a grid
//      of at most (SMs x resident blocks) walks over the groups. Each entry
//      sums its CSR rows in table order, then the q rows r = 0 ... RQ-1,
//      then the slack column's terms, in the JAX rule's order, as the first
//      port did: the results are the same bit for bit. Only the upper
//      triangle is computed and it is mirrored, so H is exactly symmetric,
//      as the JAX rule does (:280).
//   4. Stores: the five blocks land in a tile laid out as the group's
//      contiguous run of each block in device memory (lx ... lww of 32
//      consecutive items), which the block stores with 16-byte vectors.
// No atomics and no cross-item reduction: each item's result does not depend
// on its neighbours.
//
// One shape per library: ops/_build.py compiles this file for the segment
// sizes of a problem (-DGN_QR, _QB, _QC, _AR, _AB, _AC, _NQ, _NX, _NW, _NS)
// and the ring's depth (-DGN_D: 2, or 1 where two stage buffers do not fit a
// block) at first use.

#include "riccati_common.cuh"

#if !defined(GN_QR) || !defined(GN_QB) || !defined(GN_QC) || !defined(GN_AR) || !defined(GN_AB) || \
    !defined(GN_AC) || !defined(GN_NQ) || !defined(GN_NX) || !defined(GN_NW) || !defined(GN_NS) ||   \
    !defined(GN_D)
#error "compile with the shape defines that ops/_build.py passes"
#endif

namespace {

using namespace riccati;

constexpr float kBarrierEps = 1e-3f;  // models/components.py BARRIER_EPS

constexpr int QR = GN_QR, QB = GN_QB, QC = GN_QC, AR = GN_AR, AB = GN_AB, AC = GN_AC;
constexpr int NQ = GN_NQ, NX = GN_NX, NW = GN_NW, NS = GN_NS, D = GN_D;
constexpr int RQ = QR + QB + QC, RA = AR + AB + AC, R = RQ + RA, NV = NX + NW, NCON = QC + AC;
constexpr int NE = NV + NV * (NV + 1) / 2;  // gradient entries, then H's upper triangle
constexpr int G = 32;                       // items of a group: one per lane
constexpr int kWarps = 8, kThreads = 32 * kWarps;
// a row of S_aff with k non-zeros feeds k gradient entries and k (k + 1) / 2
// upper entries: at most 5 terms a row where k <= 2 (every robot's S_aff)
constexpr int kTermsMax = 5 * RA;

// the kinds of schedule entries (ops/gn_assemble.py ENTRY_KINDS): gradient
// entries before H entries; beside the CSR terms, a q-family part (i, j <
// NQ) or the slack column's terms
enum Kind { kGradAff, kGradQ, kGradSlack, kHessAff, kHessQ, kHessSlackQ, kHessSlack };

// An item's record (floats): V the rows' values (RQ q rows, then RA affine
// rows), U their second scalars (wrq, wbq, the q constraint rows'
// multipliers, wra, wba, the affine ones'), the q Jacobian (RQ x NQ), the
// slack column's entry; after step 2, V holds g and U holds h. The block's
// shared memory (floats): D stage buffers of G records, the output tile
// (each block's run of G items), the schedule (4 words an entry), the terms
// (row, coefficient).
struct Lay {
  static constexpr int V = 0, U = R, JQ = 2 * R, SL = JQ + RQ * NQ, RS = odd(SL + NS);
  static constexpr int LX = 0, LW = LX + G * NX, LXX = LW + G * NW, LXW = LXX + G * NX * NX,
                       LWW = LXW + G * NX * NW, OUT = LWW + G * NW * NW;
  static constexpr int RING = 0, TILE = RING + D * G * RS, SCHED = TILE + OUT, TERMS = SCHED + 4 * NE,
                       FLOATS = TERMS + 2 * kTermsMax;
};

struct Rows {
  const float *vq, *Jq, *va, *wrq, *wbq, *wra, *wba, *lam, *mu, *coff, *W;
};
struct Blocks {
  float *lx, *lw, *lxx, *lxw, *lww;
};
struct Term {
  int row;
  float coef;
};

// (g, h) of one row: residual, barrier or constraint (c already shifted)
__device__ __forceinline__ void residual(float w, float r, float& g, float& h) {
  g = 2.f * w * r;
  h = 2.f * w;
}
__device__ __forceinline__ void barrier(float w, float b, float& g, float& h) {
  const bool live = b > kBarrierEps;
  const float bs = fmaxf(b, kBarrierEps);
  g = live ? -w / (bs * bs) : 0.f;
  h = live ? fmaxf(2.f * w / (bs * bs * bs), 0.f) : 0.f;
}
__device__ __forceinline__ void constraint(float lam, float mu, float c, float& g, float& h) {
  const float act = fmaxf(lam - mu * c, 0.f);
  g = -act;
  h = act > 0.f ? mu : 0.f;
}

// Copy WIDTH floats a item of one input's slab (src: the group's first
// item) into the items' records, column c to field place(c)
template <int WIDTH, class Place>
__device__ __forceinline__ void stage_slab(float* buf, const float* src, int items, Place place) {
  if constexpr (WIDTH > 0) {
    for (int e = threadIdx.x; e < items * WIDTH; e += kThreads) {
      const int i = e / WIDTH, c = e - i * WIDTH;
      cp_async4(buf + i * Lay::RS + place(c), src + e);
    }
  }
}

// Stage the group of `items` items from item m0 into the buffer `buf`
__device__ __forceinline__ void stage_group(float* buf, const Rows& in, long long m0, int items) {
  stage_slab<RQ>(buf, in.vq + m0 * RQ, items, [](int c) { return Lay::V + c; });
  stage_slab<RA>(buf, in.va + m0 * RA, items, [](int c) { return Lay::V + RQ + c; });
  stage_slab<QR>(buf, in.wrq + m0 * QR, items, [](int c) { return Lay::U + c; });
  stage_slab<QB>(buf, in.wbq + m0 * QB, items, [](int c) { return Lay::U + QR + c; });
  stage_slab<AR>(buf, in.wra + m0 * AR, items, [](int c) { return Lay::U + RQ + c; });
  stage_slab<AB>(buf, in.wba + m0 * AB, items, [](int c) { return Lay::U + RQ + AR + c; });
  stage_slab<NCON>(buf, in.lam + m0 * NCON, items,
                   [](int c) { return c < QC ? Lay::U + QR + QB + c : Lay::U + RQ + AR + AB + c - QC; });
  stage_slab<RQ * NQ>(buf, in.Jq + m0 * RQ * NQ, items, [](int c) { return Lay::JQ + c; });
  if constexpr (NS > 0) {
    for (int i = threadIdx.x; i < items; i += kThreads) cp_async4(buf + i * Lay::RS + Lay::SL, in.W + (m0 + i) * NW);
  }
}

// (g, h) of rows [FIRST, FIRST + COUNT) of the records' rows, one kind: the
// warp's rows warp, warp + kWarps, ... of the segment, unrolled so that
// their loads are in flight together. KIND: 0 residual, 1 barrier, 2
// constraint; C0: the segment's first multiplier (its column of lam and
// c_off); SHIFT: add the slack column's entry (the q constraint rows)
template <int FIRST, int COUNT, int KIND, int C0, bool SHIFT>
__device__ __forceinline__ void segment(float* rec, const float* coff, float mu, float s, int warp) {
#pragma unroll
  for (int k = 0; k < ceil_div(COUNT, kWarps); ++k) {
    const int a = warp + k * kWarps;
    if (a < COUNT) {
      const int r = FIRST + a;
      const float v = rec[Lay::V + r], u = rec[Lay::U + r];
      float g, h;
      if constexpr (KIND == 0) {
        residual(u, v, g, h);
      } else if constexpr (KIND == 1) {
        barrier(u, v, g, h);
      } else {
        const float shifted = SHIFT ? v + s : v;
        constraint(u, mu, shifted + coff[C0 + a], g, h);
      }
      rec[Lay::V + r] = g;
      rec[Lay::U + r] = h;
    }
  }
}

// Step 2 for the record `rec` of item m: each segment's rows
__device__ __forceinline__ void coefficients(float* rec, const Rows& in, int m, int N, int warp) {
  const int b = m / N, k = m - b * N;
  const float mu = in.mu[b];
  const float s = NS ? rec[Lay::SL] : 0.f;  // the slack column of W
  const float* coff = in.coff + k * NCON;
  segment<0, QR, 0, 0, false>(rec, coff, mu, s, warp);
  segment<QR, QB, 1, 0, false>(rec, coff, mu, s, warp);
  segment<QR + QB, QC, 2, 0, NS != 0>(rec, coff, mu, s, warp);
  segment<RQ, AR, 0, 0, false>(rec, coff, mu, s, warp);
  segment<RQ + AR, AB, 1, 0, false>(rec, coff, mu, s, warp);
  segment<RQ + AR + AB, AC, 2, QC, false>(rec, coff, mu, s, warp);
}

// The tile place of an output code (ops/gn_assemble.py: block << 16 | the
// entry's offset in its item's block) for the item of `lane`
__device__ __forceinline__ int tile_place(int code, int lane) {
  const int off = code & 0xffff;
  switch (code >> 16) {
    case 0: return Lay::LX + lane * NX + off;
    case 1: return Lay::LW + lane * NW + off;
    case 2: return Lay::LXX + lane * NX * NX + off;
    case 3: return Lay::LXW + lane * NX * NW + off;
    default: return Lay::LWW + lane * NW * NW + off;
  }
}

// Step 3 for the record `rec` of the lane's item: schedule entries warp,
// warp + kWarps, ..., each summed in the JAX rule's order, into the tile
__device__ __forceinline__ void entries(const float* rec, float* tile, const int4* sched, int n_live,
                                        const Term* terms, int lane, int warp) {
  const float* GQ = rec + Lay::V;
  const float* HQ = rec + Lay::U;
  const float* JQ = rec + Lay::JQ;
  for (int e = warp; e < n_live; e += kWarps) {
    const int4 d = sched[e];  // begin | count << 16, kind | i << 8 | j << 16, place, place or -1
    const int kind = d.y & 0xff, i = (d.y >> 8) & 0xff, j = d.y >> 16;
    const float* rows = (kind < kHessAff ? GQ : HQ) + RQ;  // GA or HA
    float acc = 0.f;
    const int begin = d.x & 0xffff, end = begin + (d.x >> 16);
    for (int p = begin; p < end; ++p) {
      const Term tm = terms[p];
      acc = acc + tm.coef * rows[tm.row];
    }
    if (kind == kGradQ) {
#pragma unroll
      for (int r = 0; r < RQ; ++r) acc = acc + JQ[r * NQ + i] * GQ[r];
    } else if (kind == kGradSlack) {
#pragma unroll
      for (int r = QR + QB; r < RQ; ++r) acc = acc + GQ[r];
    } else if (kind == kHessQ) {
#pragma unroll
      for (int r = 0; r < RQ; ++r) acc = acc + HQ[r] * JQ[r * NQ + i] * JQ[r * NQ + j];
    } else if (kind == kHessSlackQ) {
#pragma unroll
      for (int r = QR + QB; r < RQ; ++r) acc = acc + HQ[r] * JQ[r * NQ + i];
    } else if (kind == kHessSlack) {
#pragma unroll
      for (int r = QR + QB; r < RQ; ++r) acc = acc + HQ[r];
    }
    tile[tile_place(d.z, lane)] = acc;
    if (d.w >= 0) tile[tile_place(d.w, lane)] = acc;
  }
}

// Copy `count` 4-byte words into shared memory, consecutive threads on
// consecutive words
__device__ __forceinline__ void stage_words(float* dst, const int* src, int count) {
  for (int e = threadIdx.x; e < count; e += kThreads) cp_async4(dst + e, reinterpret_cast<const float*>(src) + e);
}

__global__ void __launch_bounds__(kThreads, 2) gn_assemble_kernel(Rows in, const int* sched, int n_live,
                                                                   const int* terms, int n_terms, Blocks out,
                                                                   int M, int N) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int groups = ceil_div(M, G);
  float* tile = smem + Lay::TILE;
  const int4* sch = reinterpret_cast<const int4*>(smem + Lay::SCHED);
  const Term* trm = reinterpret_cast<const Term*>(smem + Lay::TERMS);

  // the tables, once per block, with the first group's rows; the entries
  // that no term feeds are 0 in every group: written once
  stage_words(smem + Lay::SCHED, sched, 4 * n_live);
  stage_words(smem + Lay::TERMS, terms, 2 * n_terms);
  for (int e = threadIdx.x; e < Lay::OUT; e += kThreads) tile[e] = 0.f;
  int group = blockIdx.x;
  stage_group(smem + Lay::RING, in, static_cast<long long>(group) * G, M - group * G < G ? M - group * G : G);
  cp_async_commit();
  for (int it = 0; group < groups; ++it, group += gridDim.x) {
    float* buf = smem + Lay::RING + (it % D) * G * Lay::RS;
    const long long m0 = static_cast<long long>(group) * G;
    const int items = M - m0 < G ? static_cast<int>(M - m0) : G;
    const int next = group + gridDim.x;
    const long long n0 = static_cast<long long>(next) * G;
    const int next_items = next < groups ? (M - n0 < G ? static_cast<int>(M - n0) : G) : 0;
    if constexpr (D == 2) {  // the next group into the other buffer, while this one computes
      stage_group(smem + Lay::RING + ((it + 1) % 2) * G * Lay::RS, in, n0, next_items);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (lane < items) coefficients(buf + lane * Lay::RS, in, static_cast<int>(m0) + lane, N, warp);
    __syncthreads();
    entries(buf + lane * Lay::RS, tile, sch, n_live, trm, lane, warp);
    __syncthreads();
    if constexpr (D == 1) {  // the next group into the one buffer, while this one is stored
      stage_group(buf, in, n0, next_items);
      cp_async_commit();
    }
    block_store(out.lx + m0 * NX, tile + Lay::LX, items * NX, threadIdx.x, kThreads);
    block_store(out.lw + m0 * NW, tile + Lay::LW, items * NW, threadIdx.x, kThreads);
    block_store(out.lxx + m0 * NX * NX, tile + Lay::LXX, items * NX * NX, threadIdx.x, kThreads);
    block_store(out.lxw + m0 * NX * NW, tile + Lay::LXW, items * NX * NW, threadIdx.x, kThreads);
    block_store(out.lww + m0 * NW * NW, tile + Lay::LWW, items * NW * NW, threadIdx.x, kThreads);
  }
}

int launch(const Rows& in, const int* sched, int n_live, const int* terms, int n_terms, const Blocks& out, int M,
           int N, cudaStream_t stream) {
  static const int limit = dynamic_shared_limit(gn_assemble_kernel);
  constexpr size_t bytes = Lay::FLOATS * sizeof(float);
  if (bytes > static_cast<size_t>(limit) || n_live > NE || n_terms > kTermsMax) return kNoRoom;
  static const int sms = multiprocessor_count();
  static const int resident = resident_blocks(gn_assemble_kernel, kThreads, bytes);
  // persistent blocks: as many as the card holds at once, fewer where the
  // groups take fewer rounds of them
  const int groups = ceil_div(M, G);
  const int rounds = ceil_div(groups, sms * resident);
  gn_assemble_kernel<<<ceil_div(groups, rounds), kThreads, bytes, stream>>>(in, sched, n_live, terms, n_terms, out,
                                                                            M, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). Per (lane, stage) m = b N + k,
// contiguous f32: vq (M, RQ), Jq (M, RQ, NQ), va (M, RA), the weights wrq
// (M, QR), wbq (M, QB), wra (M, AR), wba (M, AB), lam (M, QC + AC); mu (B,),
// c_off (N, QC + AC), W (M, NW) (its column 0 read where NS = 1). The tables
// (ops/gn_assemble.py entry_schedule): sched (n_live x 4 int32, n_live <=
// NE), terms (n_terms x (int32 row, f32 coefficient)). Outputs lx (M, NX), lw
// (M, NW), lxx (M, NX, NX), lxw (M, NX, NW), lww (M, NW, NW). Returns
// cudaGetLastError() after the launch; kNoInstantiation for segment sizes
// other than this library's; kNoRoom where the block's shared memory does
// not fit the card or the tables pass their room.
extern "C" int gn_assemble_launch(const float* vq, const float* Jq, const float* va, const float* wrq,
                                  const float* wbq, const float* wra, const float* wba, const float* lam,
                                  const float* mu, const float* c_off, const float* W, const int* sched,
                                  int n_live, const int* terms, int n_terms, float* lx, float* lw, float* lxx,
                                  float* lxw, float* lww, int B, int N, int qr, int qb, int qc, int ar, int ab,
                                  int ac, int nq, int nx, int nw, int ns, cudaStream_t stream) {
  if (qr != QR || qb != QB || qc != QC || ar != AR || ab != AB || ac != AC || nq != NQ || nx != NX ||
      nw != NW || ns != NS)
    return kNoInstantiation;
  if (B == 0 || N == 0) return 0;
  const Rows in{vq, Jq, va, wrq, wbq, wra, wba, lam, mu, c_off, W};
  const Blocks out{lx, lw, lxx, lxw, lww};
  return launch(in, sched, n_live, terms, n_terms, out, B * N, N, stream);
}

// Bytes of shared memory a block takes (ops/_build.py computes the same
// before it builds a library, and the tests hold the two equal)
extern "C" int gn_assemble_block_bytes() { return Lay::FLOATS * sizeof(float); }
