// Forward kinematics of a set of links, positions and geometric Jacobians,
// hand-written for Hopper (sm_90a).
//
// Replaces the JAX package's hand-written batch rule
// RobotKinematics._walk_scalar (robot_mpcs_tpu/models/fk.py:289), which its
// FK primitives dispatch to under vmap (_with_jac_cv, fk.py:431, and
// _fk_ad, fk.py:452): the chain walk in structure-of-arrays form, every
// rotation entry one batched scalar, fused by XLA into one elementwise loop.
// Here that loop is this kernel: one thread per row of q (a (lane, stage)
// of the solver's (B, N, n) configurations), which walks the chain in
// registers and writes
//
//   P (M, L, 3)      the position of each of the L links, and, with JAC,
//   J (M, L, 3, n)   its geometric Jacobian: a revolute joint with world
//                    axis w and origin o gives the column w x (P - o), a
//                    prismatic joint w, a diff-drive base e_x, e_y and
//                    z x (P - base) for q[0:3], every other column 0.
//
// The links share their chains' prefixes (serial collision links all lie on
// the root->end path), so the set costs one walk of the longest chain, as
// _walk_links does: the walk is a tree of FK_S nodes, each one segment (a
// constant transform, then a revolute or prismatic joint or none) after its
// parent node (node 0 is the base).
//
// The chain is baked in per robot and link set: ops/fk_walk.py passes its
// constants as -D defines (FK_N, FK_S, FK_L, FK_DIFFDRIVE and the tables
// below: each node's kind, parent and q index, its constant transform and
// axis, the structural zeros of its rotation and translation, each link's
// node and each Jacobian column's joint node), and ops/_build.py compiles
// one library per (robot, link set) at its first use. With every table a
// constant and every loop unrolled, the compiler folds the walk as the JAX
// rule folds it: a product with an entry that is structurally zero (a 0 of
// a constant transform, or an entry of R or p that the chain keeps at 0,
// found in ops/fk_walk.py by the JAX rule's own symbolic walk) is not
// computed, a product with a constant 1 is the other factor, and products
// of constants are constants. One source serves every robot; nothing is
// generated but the defines.
//
// What bounds it on an H100: bytes. A row reads n floats and writes 3L (P)
// and 3Ln (J) floats: at the panda's expansion (M = 4096 x 20, L = 3,
// n = 7) 25.9 MB, 7.7 us at 3.35 TB/s, against ~1,400 flops a row counted
// without the folds (one sin/cos pair per revolute joint), 111 MFLOP,
// 1.7 us at the fp32 rate.
//
// The design moves the data through shared memory and leaves the walk as it
// was. A block of R rows (one thread each) first copies its rows' q into a
// tile, consecutive threads on consecutive floats (4-byte cp.async: a row of
// n floats in a state of width nx is not 16-byte aligned), and each thread
// reads its q from there (row stride odd(n): no bank conflicts). The thread
// walks its row in registers (its nodes' rotations, its joints' origins and
// axes, the links' positions: ~60 floats at the panda) and writes P and J
// into tiles laid out as the block's contiguous runs of P and J in device
// memory; the block then stores each run with 16-byte vectors, consecutive
// threads on consecutive addresses (a ragged last run ends in a scalar
// tail). A thread that stored its 72 floats of J and P directly (the first
// port) issued 72 warp stores 252 B apart, 32 sectors each: 112-118 us at
// the panda's phase 1, 0.07 of the bound; staged, 10.0 us, 0.77 of it
// (chip_kernel_pairs.py, both in turns on an H100 SXM at 700 W). R is 128
// where the card's shared memory and the batch allow, halved down to a warp
// while the grid would leave SMs without two blocks (the rescue tier's
// 512 x 20 rows), and a multiple of 4, so that every block's runs start
// 16-byte aligned. Below ~10,000 rows the launch, not the bytes, takes the
// time (3.0 us at the rescue tier, 0.32 of the bound).

#include "riccati_common.cuh"

#if !defined(FK_N) || !defined(FK_S) || !defined(FK_L) || !defined(FK_DIFFDRIVE) || \
    !defined(FK_NODE) || !defined(FK_PRE) || !defined(FK_AXIS) || !defined(FK_ZERO) ||  \
    !defined(FK_LINK) || !defined(FK_COL)
#error "compile with the chain defines that ops/fk_walk.py passes"
#endif

namespace {

using namespace riccati;

constexpr int kFixed = 0, kRevolute = 1, kPrismatic = 2;

constexpr int N = FK_N;              // configuration width
constexpr int S = FK_S;              // nodes of the walk, base excluded
constexpr int L = FK_L;              // links
constexpr bool kDiffDrive = FK_DIFFDRIVE;
// a row's floats in the block's tiles: P (3L), J (3Ln), q (row stride odd(n))
constexpr int PW = 3 * L, JW = 3 * L * N, QS = odd(N);
template <bool JAC>
constexpr int kRowFloats = PW + (JAC ? JW : 0) + QS;

// The tables' defines list their entries as FKV(value) (a define holds no
// comma: nvcc would split the option there). Each is a constant in device
// memory, read at indices the unrolled loops make constant, so that the
// compiler folds every read. Every table carries one padding entry at its
// end, so that it is never empty. Node k (1..S) of the walk:
#define FKV(value) value,
// kNode[3k..3k+2] = kind, parent node (0 = the base), q index (-1: none)
__device__ constexpr int kNode[] = {FK_NODE};
// its constant transform: rotation (row-major 3x3), then translation
__device__ constexpr float kPre[] = {FK_PRE};
// its joint's unit axis, in the joint frame
__device__ constexpr float kAxis[] = {FK_AXIS};
// 1 where an entry is structurally zero, 27 flags per node (base = node 0):
// R after the transform (9), R after the joint (9), p after the transform
// (3, the joint's origin), p after the joint (3), the joint's world axis (3)
__device__ constexpr int kZero[] = {FK_ZERO};
// the node of each link
__device__ constexpr int kLink[] = {FK_LINK};
// per link and column of J, the joint node that moves it (0: none)
__device__ constexpr int kCol[] = {FK_COL};
#undef FKV

constexpr int kRpre = 0, kRpost = 9, kPpre = 18, kPpost = 21, kW = 24, kZ = 27;

__device__ __forceinline__ bool zero(int node, int field, int e) {
  return kZero[node * kZ + field + e] != 0;
}

// acc + a * b over a term list that starts empty (`any` false): the first
// term stands alone, so no 0 + x is computed either
__device__ __forceinline__ void fma_term(float& acc, bool& any, float a, float b) {
  acc = any ? acc + a * b : a * b;
  any = true;
}

// The walk of one row: its q at qs (shared memory), its P row (PW floats)
// to Pt and, with JAC, its J row (JW floats) to Jt, in their tiles
template <bool JAC>
__device__ __forceinline__ void walk_row(const float* qs, float* Pt, float* Jt) {
  float qv[N];
#pragma unroll
  for (int i = 0; i < N; ++i) qv[i] = qs[i];

  // R[k], p[k]: node k's rotation and translation after its joint; o[k],
  // w[k]: its joint's origin and world axis
  float R[S + 1][9], p[S + 1][3], o[S + 1][3], w[S + 1][3];
  if constexpr (kDiffDrive) {
    float s, c;
    sincosf(qv[2], &s, &c);
    const float R0[9] = {c, -s, 0.f, s, c, 0.f, 0.f, 0.f, 1.f};
#pragma unroll
    for (int e = 0; e < 9; ++e) R[0][e] = R0[e];
    p[0][0] = qv[0];
    p[0][1] = qv[1];
    p[0][2] = 0.f;
  } else {
#pragma unroll
    for (int e = 0; e < 9; ++e) R[0][e] = e % 4 == 0 ? 1.f : 0.f;
#pragma unroll
    for (int e = 0; e < 3; ++e) p[0][e] = 0.f;
  }

#pragma unroll
  for (int k = 1; k <= S; ++k) {
    const int kind = kNode[3 * k], par = kNode[3 * k + 1], qi = kNode[3 * k + 2];
    const float* pre = kPre + 12 * k;
    const float* ax = kAxis + 3 * k;
    // T <- T_parent @ pre: p = p_par + R_par t, R = R_par preR
    float Rp[9], pp[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float acc = 0.f;
      bool any = false;
      if (!zero(par, kPpost, i)) {
        acc = p[par][i];
        any = true;
      }
#pragma unroll
      for (int l = 0; l < 3; ++l)
        if (!zero(par, kRpost, 3 * i + l) && pre[9 + l] != 0.f) fma_term(acc, any, R[par][3 * i + l], pre[9 + l]);
      pp[i] = zero(k, kPpre, i) ? 0.f : acc;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        float r = 0.f;
        bool rany = false;
#pragma unroll
        for (int l = 0; l < 3; ++l)
          if (!zero(par, kRpost, 3 * i + l) && pre[3 * l + j] != 0.f)
            fma_term(r, rany, R[par][3 * i + l], pre[3 * l + j]);
        Rp[3 * i + j] = zero(k, kRpre, 3 * i + j) ? 0.f : r;
      }
    }
    if (kind != kFixed) {
      // the joint's world axis w = R_pre axis; its origin, p after the transform
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float acc = 0.f;
        bool any = false;
#pragma unroll
        for (int l = 0; l < 3; ++l)
          if (!zero(k, kRpre, 3 * i + l) && ax[l] != 0.f) fma_term(acc, any, Rp[3 * i + l], ax[l]);
        w[k][i] = zero(k, kW, i) ? 0.f : acc;
        o[k][i] = pp[i];
      }
    }
    if (kind == kRevolute) {
      // Rodrigues: R_axis = (I + K^2) + sin(q) K - cos(q) K^2, K = [axis]_x
      float s, c;
      sincosf(qv[qi], &s, &c);
      const float K[9] = {0.f, -ax[2], ax[1], ax[2], 0.f, -ax[0], -ax[1], ax[0], 0.f};
      float K2[9], Ra[9];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          K2[3 * i + j] = K[3 * i] * K[j] + K[3 * i + 1] * K[3 + j] + K[3 * i + 2] * K[6 + j];
      bool ra_const[9];
#pragma unroll
      for (int e = 0; e < 9; ++e) {
        const float base = (e % 4 == 0 ? 1.f : 0.f) + K2[e];
        ra_const[e] = K[e] == 0.f && K2[e] == 0.f;
        float acc = 0.f;
        bool any = false;
        if (base != 0.f) {
          acc = base;
          any = true;
        }
        if (K[e] != 0.f) fma_term(acc, any, s, K[e]);
        if (K2[e] != 0.f) fma_term(acc, any, c, -K2[e]);
        Ra[e] = acc;
      }
      // R = R_pre R_axis
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          float r = 0.f;
          bool any = false;
#pragma unroll
          for (int l = 0; l < 3; ++l)
            if (!zero(k, kRpre, 3 * i + l) && !(ra_const[3 * l + j] && Ra[3 * l + j] == 0.f))
              fma_term(r, any, Rp[3 * i + l], Ra[3 * l + j]);
          R[k][3 * i + j] = zero(k, kRpost, 3 * i + j) ? 0.f : r;
        }
#pragma unroll
      for (int i = 0; i < 3; ++i) p[k][i] = pp[i];
    } else {
#pragma unroll
      for (int e = 0; e < 9; ++e) R[k][e] = Rp[e];
      // a prismatic joint moves along its world axis: p = p_pre + w q
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        if (kind == kPrismatic && !zero(k, kW, i))
          p[k][i] = zero(k, kPpre, i) ? w[k][i] * qv[qi] : pp[i] + w[k][i] * qv[qi];
        else
          p[k][i] = pp[i];
      }
    }
  }

#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int node = kLink[l];
    float* Pl = Pt + l * 3;
#pragma unroll
    for (int i = 0; i < 3; ++i) Pl[i] = p[node][i];
    if constexpr (JAC) {
      float* Jl = Jt + l * 3 * N;
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const int a = kCol[l * N + c];
        float col[3] = {0.f, 0.f, 0.f};
        if (kDiffDrive && c < 2) {
          col[c] = 1.f;
        } else if (kDiffDrive && c == 2) {
          // z x (P - base) = (-(P_y - y), P_x - x, 0)
          col[0] = -(p[node][1] - qv[1]);
          col[1] = p[node][0] - qv[0];
        } else if (a > 0 && kNode[3 * a] == kRevolute) {
          // w x (P - o)
          float d[3];
#pragma unroll
          for (int i = 0; i < 3; ++i) d[i] = p[node][i] - o[a][i];
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const int i1 = (i + 1) % 3, i2 = (i + 2) % 3;
            float acc = 0.f;
            bool any = false;
            if (!zero(a, kW, i1)) fma_term(acc, any, w[a][i1], d[i2]);
            if (!zero(a, kW, i2)) fma_term(acc, any, -w[a][i2], d[i1]);
            col[i] = acc;
          }
        } else if (a > 0) {
#pragma unroll
          for (int i = 0; i < 3; ++i) col[i] = w[a][i];
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) Jl[i * N + c] = col[i];
      }
    }
  }
}

// One thread per row, R rows a block; shared memory: the P tile (R x PW),
// the J tile (R x JW, with JAC), the q tile (R x QS)
template <bool JAC>
__global__ void __launch_bounds__(kBlockThreads) fk_walk_kernel(const float* __restrict__ q,
                                                                 long long q_stride, int M,
                                                                 float* __restrict__ P,
                                                                 float* __restrict__ J) {
  extern __shared__ float smem[];
  const int rows = blockDim.x, t = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * rows;
  const int here = M - m0 < rows ? static_cast<int>(M - m0) : rows;
  float* tP = smem;
  float* tJ = tP + rows * PW;
  float* tq = tJ + (JAC ? rows * JW : 0);

  // 1. the block's q rows, consecutive threads on consecutive floats
  for (int e = t; e < here * N; e += rows) {
    const int r = e / N, c = e - r * N;
    cp_async4(tq + r * QS + c, q + (m0 + r) * q_stride + c);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // 2. each thread's walk, into the tiles
  if (t < here) walk_row<JAC>(tq + t * QS, tP + t * PW, tJ + t * JW);
  __syncthreads();

  // 3. the block's runs of P and J
  block_store(P + m0 * PW, tP, here * PW, t, rows);
  if constexpr (JAC) block_store(J + m0 * JW, tJ, here * JW, t, rows);
}

// Rows per block: kBlockThreads, fewer where `limit` bytes of shared memory
// hold fewer (a multiple of a warp, else of 4), halved down to a warp while
// the grid would give the card's `sms` SMs fewer than two blocks each; 0
// where not 4 rows fit
inline int rows_per_block(int M, size_t row_bytes, int limit, int sms) {
  const size_t fit = static_cast<size_t>(limit) / row_bytes;
  int rows = fit >= kBlockThreads ? kBlockThreads : static_cast<int>(fit >= 32 ? fit / 32 * 32 : fit / 4 * 4);
  while (rows > 32 && rows % 64 == 0 && ceil_div(M, rows) < 2 * sms) rows /= 2;
  return rows;
}

template <bool JAC>
int launch(const float* q, long long q_stride, int M, float* P, float* J, cudaStream_t stream) {
  static const int limit = dynamic_shared_limit(fk_walk_kernel<JAC>);
  static const int sms = multiprocessor_count();
  constexpr size_t row_bytes = kRowFloats<JAC> * sizeof(float);
  const int rows = rows_per_block(M, row_bytes, limit, sms);
  if (rows == 0) return kNoRoom;
  const size_t bytes = rows * row_bytes;
  fk_walk_kernel<JAC><<<ceil_div(M, rows), rows, bytes, stream>>>(q, q_stride, M, P, J);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). q: device pointer to M rows of n
// floats, row r at q + r * q_stride (the last axis contiguous); P: (M, L, 3)
// and, with want_jac, J: (M, L, 3, n), contiguous f32. Returns
// cudaGetLastError() after the launch, kNoInstantiation for an (n, L) other
// than the chain this library was compiled for, or kNoRoom where not 4 rows'
// tiles fit a block's shared memory.
extern "C" int fk_walk_launch(const float* q, long long q_stride, int M, int n, int L_, float* P, float* J,
                              int want_jac, cudaStream_t stream) {
  if (n != N || L_ != L) return kNoInstantiation;
  if (M == 0) return 0;
  return want_jac ? launch<true>(q, q_stride, M, P, J, stream) : launch<false>(q, q_stride, M, P, J, stream);
}

// Bytes of shared memory one row takes in a block's tiles, with and without
// J (ops/_build.py computes the same, and the tests hold the two equal)
extern "C" int fk_walk_row_bytes(int want_jac) {
  return (want_jac ? kRowFloats<true> : kRowFloats<false>) * static_cast<int>(sizeof(float));
}
