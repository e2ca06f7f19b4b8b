// Structured (holonomic) Riccati backward sweep, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel robot_mpcs_tpu/ops/riccati_packed.py:238
// (riccati_backward_packed, body _make_kernel). Per lane it runs the
// backward recursion over the N stages of the horizon for dynamics with the
// exact block form A = [[I, aI], [0, I]], B = [[0 | b1 I], [0 | b2 I]]
// (a, b1, b2 build-time scalars; the first NS columns of B are slack):
//
//   Qxx = lxx + A^T V A,  Qxw = lxw + A^T V B,  Qww = lww + B^T V B + reg I,
//   qx  = lx  + A^T vx,   qw  = lw  + B^T vx,
//   LDL^T of Qww solves [qw | Qxw^T]:  k_ff = -Qww^-1 qw,  K = -Qww^-1 Qxw^T,
//   vx' = qx + Qxw k_ff,  V' = Qxx + Qxw K  (Schur form, upper triangle mirrored).
//
// A pivot d <= 1e-12 (or NaN) is replaced by 1, the stage's gains are zeroed
// (multiplied by 0, as the TPU kernel does) and the lane is marked failed;
// the value update still runs with the zero gains. The terminal value
// function is zero (the solver's A = B = 0 at the last stage).
//
// What bounds it on an H100: bytes, then latency. Per stage a lane reads
// NX + NW + NX^2 + NX*NW + NW^2 floats (1,456 B at panda, NX=14, NW=7) and
// writes NW + NW*NX (420 B); at B=4096, N=20 that is 153.7 MB, 46 us at
// 3.35 TB/s, against O(NX^2 NW) flops per stage, far below the fp32 rate.
// The stages of a lane are sequential, so what is left is the latency of one
// stage times N, hidden only by how many lanes are in flight. The fleet's
// rescue tier runs most launches at B = 512 (panda) or 128 (pointRobot).
//
// The design: a team of T threads per lane (T = 32, a warp, at NX > 8; 16
// at NX <= 8), up to 128 / T lanes per block. Per stage the team
//   1. has the stage's block in shared memory already: it was copied there
//      with 4-byte cp.async by the whole team, consecutive threads on
//      consecutive floats (coalesced), while the previous stage computed
//      (two stage buffers). The solver's (B, N, ...) tensors are read in
//      place: no repacking, no padding.
//   2. assembles: thread 0 builds qw, threads 1..NX each one row of Qxw (the
//      right-hand columns [qw | Qxw^T] of the solve), the others the lower
//      triangle of Qww, all from the carry V, vx in shared memory. Where
//      1 + NX >= T (NX >= 32 at T = 32) no thread is left for Qww: the
//      team then assembles the 1 + NX columns and Qww's entries spread
//      over it, and solves after a barrier.
//   3. solves: each column of [qw | Qxw^T] is solved by one thread, which
//      factors Qww in registers (ldl_solve in riccati_common.cuh); thread t
//      takes columns t, t + T, ... The gains go to shared memory, then out
//      to device memory coalesced.
//   4. updates the value function, the NX + NX(NX+1)/2 entries of vx' and
//      V's upper triangle spread over the team, Qxx formed on the fly.
// Members synchronise with __syncwarp only (a team never spans two warps).
// The carry, the stage buffers and the workspace are ~4.8 KB of shared
// memory per panda lane, so each thread holds a few scalars and many teams
// fit on an SM to hide each other's latency. The launch bounds ask for one
// block per SM at least: without that, ptxas held (14, 8, 1) to 128
// registers and spilled.
//
// One shape per library: ops/_build.py compiles this file for the (NX, NW,
// NS) a solve asks for (-DRICCATI_NX, -DRICCATI_NW, -DRICCATI_NS), with the
// team size T and the number of stage buffers it chooses (-DRICCATI_T,
// -DRICCATI_DEPTH), at first use. Each lane's workspace is dynamic shared
// memory; the launcher puts as many lanes in a block as the card's opt-in
// shared memory holds (227 KB on an H100), up to 128 / T. The largest shape
// one lane fits: n = 49 (NX = 98, NW = 49, or 50 with slack: 55,762 / 56,552
// of the 58,112 floats in 227 KB), far past any arm; registers spill long
// before (ldl_solve keeps NW x NW in registers).
//
// No tensor cores: the sweep computes in full f32 (the solver's ground rule:
// lower-precision products stalled convergence), mma/wgmma would be TF32 or
// lower, and a lane's matrices (14 x 7) are far below a 64-row tile.

#include "riccati_common.cuh"

#if !defined(RICCATI_NX) || !defined(RICCATI_NW) || !defined(RICCATI_NS) || \
    !defined(RICCATI_T) || !defined(RICCATI_DEPTH)
#error "compile with the shape defines that ops/_build.py passes"
#endif

namespace {

using namespace riccati;

// Per-lane shared memory, in floats: DEPTH stage buffers (lx, lw, lxx, lxw,
// lww, as one (B, N, ...) stage of each tensor holds them), the carry V
// (row stride VS) and vx, Qxw (row stride QS), Qww and the gains Y = [k_ff |
// K] as (NW, 1 + NX).
template <int NX, int NW, int DEPTH>
struct PackedLayout {
  static constexpr int M = 1 + NX;
  static constexpr int LX = 0, LW = LX + NX, LXX = LW + NW, LXW = LXX + NX * NX,
                       LWW = LXW + NX * NW, STAGE = LWW + NW * NW;
  static constexpr int VS = odd(NX), QS = odd(NW);
  static constexpr int V = DEPTH * STAGE, VX = V + NX * VS, QXW = VX + NX, QWW = QXW + NX * QS,
                       Y = QWW + NW * NW, FLOATS = Y + NW * M;
};

template <int NX, int NW, int NS, int T, int DEPTH>
__global__ void __launch_bounds__(kBlockThreads, 1) riccati_packed_kernel(
    const float* __restrict__ lx, const float* __restrict__ lw,
    const float* __restrict__ lxx, const float* __restrict__ lxw,
    const float* __restrict__ lww, const float* __restrict__ reg,
    float* __restrict__ kff, float* __restrict__ Kout,
    unsigned char* __restrict__ failed, int B, int N, float a, float b1,
    float b2) {
  // DEPTH stage buffers: stages k-1 .. k-DEPTH+1 in flight while stage k
  // computes (ops/_build.py takes 2: a deeper ring measured no faster, a
  // stage's latency is its own arithmetic)
  using Lay = PackedLayout<NX, NW, DEPTH>;
  constexpr int n = NX / 2;
  constexpr int NU = NW - NS;
  constexpr int M = Lay::M;  // rhs columns of the stage solve: [qw | Qxw^T]
  constexpr int NQ = NW * (NW + 1) / 2;  // Qww's lower triangle
  constexpr int VS = Lay::VS, QS = Lay::QS;
  static_assert(NX % 2 == 0, "holonomic state is [q, qdot]");
  static_assert(NU == n, "one control per configuration dof");
  static_assert(32 % T == 0, "a team within one warp");

  extern __shared__ float smem[];  // the block's lanes, Lay::FLOATS floats each
  const int lanes = blockDim.x / T;
  const int t = threadIdx.x % T;
  const int lane = blockIdx.x * lanes + threadIdx.x / T;
  const bool live = lane < B;
  const int b = live ? lane : B - 1;  // a team past the batch mirrors the last lane, stores nothing
  float* sm = smem + (threadIdx.x / T) * Lay::FLOATS;
  float* V = sm + Lay::V;
  float* vx = sm + Lay::VX;
  float* QXW = sm + Lay::QXW;
  float* QWW = sm + Lay::QWW;
  float* Y = sm + Lay::Y;

  auto load_stage = [&](int k) {  // stage k into buffer k % DEPTH
    const size_t s = static_cast<size_t>(b) * N + k;
    float* dst = sm + (k % DEPTH) * Lay::STAGE;
    team_copy<NX, T>(dst + Lay::LX, lx + s * NX, t);
    team_copy<NW, T>(dst + Lay::LW, lw + s * NW, t);
    team_copy<NX * NX, T>(dst + Lay::LXX, lxx + s * NX * NX, t);
    team_copy<NX * NW, T>(dst + Lay::LXW, lxw + s * NX * NW, t);
    team_copy<NW * NW, T>(dst + Lay::LWW, lww + s * NW * NW, t);
  };

  for (int e = t; e < NX * VS; e += T) V[e] = 0.f;
  for (int e = t; e < NX; e += T) vx[e] = 0.f;
  const float r = reg[b];
#pragma unroll
  for (int j = 1; j <= DEPTH; ++j) {
    if (N - j >= 0) load_stage(N - j);
    cp_async_commit();
  }
  cp_async_wait<DEPTH - 1>();
  __syncwarp();

  float lane_bad = 0.f;
  for (int k = N - 1; k >= 0; --k) {
    const float* S = sm + (k % DEPTH) * Lay::STAGE;
    const float* LX = S + Lay::LX;
    const float* LW = S + Lay::LW;
    const float* LXX = S + Lay::LXX;
    const float* LXW = S + Lay::LXW;
    const float* LWW = S + Lay::LWW;
    // U = V B (control columns): U[i][c] = b1 V[i][c] + b2 V[i][n+c]
    auto U = [&](int i, int c) { return b1 * V[i * VS + c] + b2 * V[i * VS + n + c]; };

    // the assembly's three kinds of work: qw = lw + B^T vx; row i of Qxw =
    // lxw + A^T U (slack columns: lxw only), kept for the value update;
    // entry e of the lower triangle of Qww = lww + B^T U + reg I (slack
    // rows/columns: lww only; reg on all NW)
    auto assemble_qw = [&](float (&y)[NW]) {
#pragma unroll
      for (int w = 0; w < NW; ++w) y[w] = LW[w];
#pragma unroll
      for (int c = 0; c < NU; ++c) y[NS + c] = y[NS + c] + b1 * vx[c] + b2 * vx[n + c];
    };
    auto assemble_qxw_row = [&](int i, float (&y)[NW]) {
#pragma unroll
      for (int c = 0; c < NS; ++c) y[c] = LXW[i * NW + c];
#pragma unroll
      for (int c = 0; c < NU; ++c)
        y[NS + c] = i < n ? LXW[i * NW + NS + c] + U(i, c)
                          : LXW[i * NW + NS + c] + a * U(i - n, c) + U(i, c);
#pragma unroll
      for (int w = 0; w < NW; ++w) QXW[i * QS + w] = y[w];
    };
    auto assemble_qww_entry = [&](int e) {
      int i, c;
      lower_entry<NW>(e, i, c);
      float v = LWW[i * NW + c];
      if (i >= NS && c >= NS) v = v + (b1 * U(i - NS, c - NS) + b2 * U(n + i - NS, c - NS));
      if (i == c) v = v + r;
      QWW[i * NW + c] = v;
    };

    float y[NW];
    float bad = 0.f;
    if constexpr (M < T) {
      // 1. assembly: thread 0 qw, thread 1 + i row i of Qxw (each its own
      //    rhs column, kept in registers for the solve), threads M..T-1
      //    the lower triangle of Qww
      if (t == 0) {
        assemble_qw(y);
      } else if (t < M) {
        assemble_qxw_row(t - 1, y);
      } else {
#pragma unroll
        for (int q = 0; q < ceil_div(NQ, T - M); ++q) {
          const int e = t - M + q * (T - M);
          if (e < NQ) assemble_qww_entry(e);
        }
      }
      __syncwarp();

      // 2. the stage solve: gains k_ff = Y[:, 0], K = Y[:, 1:] (zero for a
      //    failed stage). Every solving thread sees the same pivots.
      if (t < M) {
        bad = ldl_solve<NW, false>(QWW, NW, y);
        const float good = 1.f - bad;
#pragma unroll
        for (int w = 0; w < NW; ++w) Y[w * M + t] = -y[w] * good;
      }
    } else {
      // 1. assembly with no thread to spare beside the rhs columns: the M
      //    columns (qw parked in Y's column 0) and then Qww's entries,
      //    spread over the team
#pragma unroll
      for (int q = 0; q < ceil_div(M + NQ, T); ++q) {
        const int e = t + q * T;
        if (e == 0) {
          assemble_qw(y);
#pragma unroll
          for (int w = 0; w < NW; ++w) Y[w * M] = y[w];
        } else if (e < M) {
          assemble_qxw_row(e - 1, y);
        } else if (e < M + NQ) {
          assemble_qww_entry(e - M);
        }
      }
      __syncwarp();

      // 2. the stage solve, columns t, t + T, ... (each thread reads its
      //    column before it writes it)
#pragma unroll
      for (int q = 0; q < ceil_div(M, T); ++q) {
        const int c = t + q * T;
        if (c < M) {
#pragma unroll
          for (int w = 0; w < NW; ++w) y[w] = c == 0 ? Y[w * M] : QXW[(c - 1) * QS + w];
          bad = ldl_solve<NW, false>(QWW, NW, y);
          const float good = 1.f - bad;
#pragma unroll
          for (int w = 0; w < NW; ++w) Y[w * M + c] = -y[w] * good;
        }
      }
    }
    lane_bad = fmaxf(lane_bad, bad);
    __syncwarp();

    // 3. value update, Schur form, into registers: vx' = qx + Qxw k_ff with
    //    qx = lx + A^T vx; V' = Qxx + Qxw K on the upper triangle, Qxx =
    //    lxx + A^T (V A) formed on the fly (T = V A: T[:, c] = V[:, c],
    //    T[:, n+c] = a V[:, c] + V[:, n+c]; row n+i of A^T T is a T[i] + T[n+i])
    constexpr int NE = NX + NX * (NX + 1) / 2;
    float out[ceil_div(NE, T)];
#pragma unroll
    for (int q = 0; q < ceil_div(NE, T); ++q) {
      const int e = t + q * T;
      if (e < NX) {
        float acc = e < n ? LX[e] + vx[e] : LX[e] + a * vx[e - n] + vx[e];
#pragma unroll
        for (int w = 0; w < NW; ++w) acc = acc + QXW[e * QS + w] * Y[w * M];
        out[q] = acc;
      } else if (e < NE) {
        int i, c;
        upper_entry<NX>(e - NX, i, c);
        auto Tv = [&](int row) {
          return c < n ? V[row * VS + c] : a * V[row * VS + c - n] + V[row * VS + c];
        };
        float acc = i < n ? LXX[i * NX + c] + Tv(i) : LXX[i * NX + c] + a * Tv(i - n) + Tv(i);
#pragma unroll
        for (int w = 0; w < NW; ++w) acc = acc + QXW[i * QS + w] * Y[w * M + 1 + c];
        out[q] = acc;
      }
    }
    if (live) {
      const size_t s = static_cast<size_t>(b) * N + k;
      for (int e = t; e < NW; e += T) kff[s * NW + e] = Y[e * M];
      for (int e = t; e < NW * NX; e += T) Kout[s * NW * NX + e] = Y[(e / NX) * M + 1 + e % NX];
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < ceil_div(NE, T); ++q) {
      const int e = t + q * T;
      if (e < NX) {
        vx[e] = out[q];
      } else if (e < NE) {
        int i, c;
        upper_entry<NX>(e - NX, i, c);
        V[i * VS + c] = out[q];
        V[c * VS + i] = out[q];
      }
    }
    // stage k's buffer is free: bring stage k - DEPTH into it, then wait for k - 1
    if (k >= DEPTH) load_stage(k - DEPTH);
    cp_async_commit();
    cp_async_wait<DEPTH - 1>();
    __syncwarp();
  }
  if (live && t == 0) failed[b] = lane_bad > 0.5f ? 1 : 0;
}

template <int NX, int NW, int NS, int T, int DEPTH>
int launch(const float* lx, const float* lw, const float* lxx, const float* lxw,
           const float* lww, const float* reg, float* kff, float* K,
           unsigned char* failed, int B, int N, float a, float b1, float b2,
           cudaStream_t stream) {
  auto kernel = riccati_packed_kernel<NX, NW, NS, T, DEPTH>;
  static const int limit = dynamic_shared_limit(kernel);
  constexpr size_t lane_bytes = PackedLayout<NX, NW, DEPTH>::FLOATS * sizeof(float);
  const int lanes = lanes_per_block(T, lane_bytes, 0, limit);
  if (lanes == 0) return kNoRoom;
  kernel<<<ceil_div(B, lanes), lanes * T, lanes * lane_bytes, stream>>>(
      lx, lw, lxx, lxw, lww, reg, kff, K, failed, B, N, a, b1, b2);
  return static_cast<int>(cudaGetLastError());
}

using Shape = PackedLayout<RICCATI_NX, RICCATI_NW, RICCATI_DEPTH>;

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers are device pointers to
// contiguous f32 (B, N, ...) tensors; `failed` is a (B,) bool tensor. Returns
// cudaGetLastError() after the launch; kNoInstantiation for an (nx, nw, ns)
// other than the one this library was compiled for; kNoRoom where not one
// lane's workspace fits the card's shared memory.
extern "C" int riccati_packed_launch(
    const float* lx, const float* lw, const float* lxx, const float* lxw,
    const float* lww, const float* reg, float* kff, float* K,
    unsigned char* failed, int B, int N, int nx, int nw, int ns, float a,
    float b1, float b2, cudaStream_t stream) {
  if (nx != RICCATI_NX || nw != RICCATI_NW || ns != RICCATI_NS) return kNoInstantiation;
  if (B == 0 || N == 0) return 0;
  return launch<RICCATI_NX, RICCATI_NW, RICCATI_NS, RICCATI_T, RICCATI_DEPTH>(
      lx, lw, lxx, lxw, lww, reg, kff, K, failed, B, N, a, b1, b2, stream);
}

// Bytes of shared memory one lane takes (ops/_build.py computes the same
// before it builds a library, and the tests hold the two equal)
extern "C" int riccati_packed_lane_bytes() { return Shape::FLOATS * sizeof(float); }
